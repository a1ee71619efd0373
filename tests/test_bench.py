"""bench.py: it measures only on a GPU (or in a labelled CPU rehearsal) and
never reports a value it did not measure."""

import json
import os
import re
import subprocess
import sys

import pytest

import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_without_gpu_exits_nonzero_no_value():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "bench.py"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 2
    assert proc.stdout.strip() == ""
    assert "no GPU" in proc.stderr


def test_bench_main_refuses_cpu_backend(capsys):
    assert bench.main([]) == 2
    assert '"value"' not in capsys.readouterr().out


def test_bench_cpu_rehearsal_is_labelled(capsys):
    rc = bench.main(["--cpu", "--width", "8", "--iters", "2",
                     "--repeats", "1"])
    assert rc == 0
    captured = capsys.readouterr()
    record = json.loads(captured.out.strip().splitlines()[-1])
    assert record["rehearsal"] == "cpu"
    assert record["metric"] == "icp_point_to_point_ms_per_iter_n64_cpu_rehearsal"
    assert record["device"]["platform"] == "cpu"
    assert record["value"] > 0
    details = json.loads(captured.err.strip().splitlines()[-1])
    assert set(details["results"]) == {"point", "plane",
                                       "morton_near_registered",
                                       "ndt_near_registered"}


@pytest.mark.parametrize("argv", [["--width", "1"], ["--repeats", "0"],
                                  ["--iters", "0"], ["--matcher", "grid"]])
def test_bench_rejects_bad_arguments(argv):
    with pytest.raises(SystemExit):
        bench._parse_args(argv)


_TPU_ONLY = re.compile(
    r"pallas\.tpu|pallas import tpu|pltpu|==\s*['\"]tpu['\"]|"
    r"!=\s*['\"]tpu['\"]|interpret\s*=\s*None")


@pytest.mark.parametrize("root", ["fpcr_tpu", "scripts", "bench.py",
                                  "chip_smoke.py"])
def test_no_tpu_only_code_left(root):
    """No Mosaic-TPU import, TPU platform branch or implicit interpret
    default; every Pallas call names the Triton route."""
    path = os.path.join(REPO, root)
    files = ([path] if path.endswith(".py") else
             [os.path.join(d, n) for d, _, ns in os.walk(path)
              for n in ns if n.endswith(".py")])
    assert files
    for fn in files:
        with open(fn, encoding="utf-8") as fh:
            text = fh.read()
        assert not _TPU_ONLY.search(text), fn
        for call in re.finditer(r"pl\.pallas_call\((.*?)\)\(", text, re.S):
            assert 'backend="triton"' in call.group(1), fn
