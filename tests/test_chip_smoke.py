"""chip_smoke.py: its phases at tiny sizes on the CPU, and its refusal to
report anything without a GPU. The card itself runs it in full."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_without_gpu(argv, capsys):
    assert cs.main(argv) == 2
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_without_gpu_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_phase_headline_tiny():
    rows = cs.phase_headline(width=32, matcher="xla")
    assert [r["metric"] for r in rows] == ["point", "plane"]
    for r in rows:
        assert r["gt_err"] < cs.GT_TOL
        assert abs(r["iterations"] - r["ref_iterations"]) <= 5


def test_phase_real_data_subsampled():
    rows = cs.phase_real_data(matcher="xla", bunny_stride=24,
                              hall_stride=12)
    assert [r["dataset"] for r in rows] == ["bunny-full", "hall"]
    assert all(r["gt_err"] < cs.GT_TOL for r in rows)


def test_phase_large_tiny():
    rows = cs.phase_large(widths=(48,), ndt_width=48, search_repeats=1)
    icp = [r for r in rows if r.get("matcher") == "morton"]
    assert [r["metric"] for r in icp] == ["point", "plane", "gicp"]
    ndt = [r for r in rows if r.get("model") == "ndt"]
    assert [r["lookup"] for r in ndt] == ["banded", "gather"]
    assert set(rows[-1]["searchsorted_ms"]) == {"scan", "sort"}


def test_phase_kernel_ab_interpret():
    rows = cs.phase_kernel_ab(widths=(12,), interpret=True, repeats=1)
    assert rows[0]["n"] == 144
    assert {"match_ms_xla", "match_ms_xla_exact",
            "match_ms_pallas"} <= set(rows[0])


def test_phase_four_cards_virtual_mesh():
    """The sharded phase on four virtual CPU devices (the rehearsal of
    ``--four-cards``)."""
    rows = cs.phase_four_cards(icp_width=40, ndt_width=40, n_devices=4)
    cases = [r["case"] for r in rows if "case" in r]
    assert cases == ["icp_point_morton", "icp_plane_morton", "ndt"]
    assert len(rows[-1]["peak_bytes"]) == 4


def test_timed_reports_first_call_and_median():
    calls = []

    def fn(x):
        calls.append(x)
        return x

    out, first, med = cs.timed(fn, 3, repeats=4)
    assert out == 3 and len(calls) == 5
    assert first >= 0 and med >= 0


def test_check_raises_with_message():
    cs.check(True, "fine")
    with pytest.raises(AssertionError, match="broken"):
        cs.check(False, "broken")


@pytest.mark.gpu
def test_kernel_ab_on_card(gpu):
    """The fused kernel against nn_argmin at the headline width, compiled
    for the card (phase 5 of chip_smoke.py)."""
    rows = cs.phase_kernel_ab(widths=(128,), repeats=3)
    assert rows[0]["n"] == 16384


@pytest.mark.gpu
def test_headline_on_card(gpu):
    """Point and plane ICP at 16,384 points with the fused kernel against
    ground truth and the float64 reference (phase 2 of chip_smoke.py)."""
    rows = cs.phase_headline()
    assert json.dumps(rows)
