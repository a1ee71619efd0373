"""CLI, timing utils, CSV emitters, sweeps."""

import json

import numpy as np
import pytest

from fpcr_tpu.cli import main as cli_main
from fpcr_tpu.utils.csvout import write_json, write_rows
from fpcr_tpu.utils.timing import PhaseTimer, benchmark, profile_icp


def test_cli_run_synthetic_json(capsys):
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "16",
                   "--max-iter", "30", "--json"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["n_source"] == 256
    assert payload["converged"]
    assert payload["transform_rmse_vs_gt"] < 1e-4
    assert len(payload["errors"]) == payload["iterations"]
    metrics = payload["iteration_metrics"]
    assert len(metrics) == payload["iterations"]
    assert {"rmse", "matched_fraction", "delta_t", "delta_rot"} <= set(metrics[0])


def test_cli_run_plane_distributed(capsys):
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "16",
                   "--metric", "plane", "--distributed", "--json"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["transform_rmse_vs_gt"] < 1e-4


def test_cli_run_human_output(capsys):
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--max-iter", "10"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "error sequence:" in out
    assert "transform RMSE" in out


def test_cli_run_output_file(tmp_path, capsys):
    out = tmp_path / "res.json"
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--max-iter", "5", "--json", "--output", str(out)])
    assert rc == 0
    saved = json.loads(out.read_text())
    assert saved["n_source"] == 144


def test_cli_sweep_csv(tmp_path, capsys):
    csv = tmp_path / "sweep.csv"
    rc = cli_main(["sweep", "--widths", "3:5", "--repeats", "1", "--csv", str(csv)])
    assert rc == 0
    lines = csv.read_text().strip().splitlines()
    assert lines[0] == "n,ms"
    rows = [line.split(",") for line in lines[1:]]
    assert [int(r[0]) for r in rows] == [9, 16, 25]
    assert all(float(r[1]) > 0 for r in rows)
    assert capsys.readouterr().out.strip().splitlines()[0].count(",") == 1


def test_cli_info(capsys):
    rc = cli_main(["info"])
    assert rc == 0
    assert "platform" in capsys.readouterr().out


def test_cli_profile(capsys):
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--profile", "--profile-iters", "2"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "matching" in out and "minimization" in out and "TOTAL" in out


def test_phase_timer_report():
    t = PhaseTimer()
    with t.phase("a"):
        pass
    with t.phase("b"):
        pass
    with t.phase("a"):
        pass
    rep = t.report()
    assert "a" in rep and "b" in rep and "TOTAL" in rep
    assert t.counts["a"] == 2


def test_benchmark_runs():
    import jax.numpy as jnp

    stats = benchmark(lambda: jnp.arange(16.0).sum(), repeats=3, warmup=1)
    assert stats["min"] <= stats["mean"] <= stats["max"]


def test_profile_icp_plane_includes_normals():
    import fpcr_tpu as f

    scene = f.synthetic_scene(width=12)
    timer = profile_icp(scene.source, scene.target,
                        f.ICPConfig(metric="plane"), iterations=2)
    d = timer.as_dict()
    assert "normals" in d and "matching" in d


def test_write_rows_reference_format(tmp_path):
    path = write_rows(tmp_path / "t.csv", [(1024, 1.104900), (4096, 2.344100)])
    lines = path.read_text().strip().splitlines()
    assert lines[0] == "1024,1.104900"


def test_write_json(tmp_path):
    p = write_json(tmp_path / "x.json", {"a": 1.5})
    assert json.loads(p.read_text()) == {"a": 1.5}


def test_iteration_metrics_records():
    import fpcr_tpu as f
    from fpcr_tpu.utils.csvout import iteration_metrics, write_iteration_metrics

    scene = f.synthetic_scene(width=12)
    res = f.run_icp(scene.source, scene.target, f.ICPConfig(max_iterations=10))
    recs = iteration_metrics(res)
    assert len(recs) == int(res.num_iterations)
    assert recs[0]["delta_rmse"] is None
    assert all(r["rmse"] >= 0 for r in recs)


def test_write_iteration_metrics_csv(tmp_path):
    import fpcr_tpu as f
    from fpcr_tpu.utils.csvout import write_iteration_metrics

    scene = f.synthetic_scene(width=12)
    res = f.run_icp(scene.source, scene.target, f.ICPConfig(max_iterations=5))
    p = write_iteration_metrics(tmp_path / "m.csv", res)
    lines = p.read_text().strip().splitlines()
    assert lines[0] == ("iteration,rmse,delta_rmse,matched_fraction,"
                        "delta_t,delta_rot")
    assert len(lines) == 1 + int(res.num_iterations)


def test_iteration_metrics_observability_fields():
    """SURVEY §5 metrics row: rmse, matched fraction, Δtransform per
    iteration, all emitted from inside the jitted loop."""
    import numpy as np

    import fpcr_tpu as f
    from fpcr_tpu.utils.csvout import iteration_metrics

    scene = f.synthetic_scene(width=12)
    res = f.run_icp(scene.source, scene.target, f.ICPConfig(max_iterations=15))
    recs = iteration_metrics(res)
    assert {"matched_fraction", "delta_t", "delta_rot"} <= set(recs[0])
    # untrimmed exhaustive matcher: everything matched, every iteration
    assert all(r["matched_fraction"] == 1.0 for r in recs)
    # increments shrink as the registration converges
    assert recs[-1]["delta_t"] < recs[0]["delta_t"]
    assert recs[-1]["delta_rot"] < recs[0]["delta_rot"]
    ni = int(res.num_iterations)
    assert np.isnan(np.asarray(res.delta_t)[ni:]).all()


def test_matched_fraction_recovers_on_partial_overlap():
    """Monotone-ish inlier recovery: on a partial-overlap trimmed run the
    post-trim inlier fraction must not collapse and must end at least as
    high as it started."""
    import numpy as np

    import fpcr_tpu as f

    rng = np.random.default_rng(19)
    full = rng.uniform(-2, 2, size=(3000, 3)).astype(np.float32)
    src = full[full[:, 0] < 0.5]
    gt = f.gt_transform((0.05, -0.03, 0.02), (0.03, -0.02, 0.04))
    tgt = gt.apply(full)
    res = f.run_icp(src, tgt, f.ICPConfig(
        max_iterations=40, max_correspondence_dist=0.25))
    ni = int(res.num_iterations)
    frac = np.asarray(res.matched_fraction)[:ni]
    assert (frac > 0.2).all(), frac
    assert frac[-1] >= frac[0] - 1e-6, frac
    assert float(f.transform_rmse(res.transform, gt, src)) < 5e-3


def test_cli_tune_morton_rejects_conflicting_matcher(capsys):
    """--tune-morton tunes the morton matcher; an explicitly different
    --matcher must error instead of being silently overridden."""
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--matcher", "xla", "--tune-morton"])
    assert rc == 2
    assert "cannot be combined" in capsys.readouterr().err


def test_cli_run_files_dataset(tmp_path, capsys):
    """--dataset files registers user-supplied PLY/PCD clouds (no GT)."""
    import fpcr_tpu as f
    from fpcr_tpu.data.pointcloud_io import write_pcd, write_ply

    scene = f.synthetic_scene(width=12)
    write_ply(tmp_path / "s.ply", np.asarray(scene.source))
    write_pcd(tmp_path / "t.pcd", np.asarray(scene.target))
    rc = cli_main(["run", "--dataset", "files",
                   "--source", str(tmp_path / "s.ply"),
                   "--target", str(tmp_path / "t.pcd"),
                   "--max-iter", "30", "--json"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    assert payload["n_source"] == 144
    assert payload["converged"]
    assert payload["transform_rmse_vs_gt"] is None
    assert payload["final_error"] < 1e-5


def test_cli_run_files_dataset_requires_paths(capsys):
    rc = cli_main(["run", "--dataset", "files"])
    assert rc == 2
    assert "--source" in capsys.readouterr().err


def test_cli_save_aligned(tmp_path, capsys):
    """--save-aligned exports the registered source; reading it back, it
    matches the target to registration accuracy."""
    import fpcr_tpu as f
    from fpcr_tpu.data.pointcloud_io import load_points

    out = tmp_path / "aligned.ply"
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--max-iter", "30", "--json",
                   "--save-aligned", str(out)])
    assert rc == 0
    aligned = load_points(out)
    target = np.asarray(f.synthetic_scene(width=12).target)
    np.testing.assert_allclose(aligned, target, atol=1e-4)


def test_cli_eval_dist(capsys):
    rc = cli_main(["run", "--dataset", "synthetic", "--width", "12",
                   "--max-iter", "30", "--json", "--eval-dist", "0.05"])
    assert rc == 0
    payload = json.loads(capsys.readouterr().out)
    ev = payload["evaluation"]
    assert ev["fitness"] == 1.0
    assert ev["inlier_rmse"] < 1e-4
    assert ev["num_inliers"] == 144


def test_cli_convert_formats(tmp_path, capsys):
    """convert: csv -> ply (binary) -> pcd (ascii) -> xyz, points preserved."""
    from fpcr_tpu.data.pointcloud_io import load_points

    rng = np.random.default_rng(9)
    pts = rng.normal(size=(64, 3)).astype(np.float32)
    np.savetxt(tmp_path / "a.csv", pts, delimiter=",")
    chain = [("a.csv", "b.ply", []), ("b.ply", "c.pcd", ["--ascii"]),
             ("c.pcd", "d.xyz", [])]
    for src, dst, extra in chain:
        rc = cli_main(["convert", "--input", str(tmp_path / src),
                       "--output", str(tmp_path / dst)] + extra)
        assert rc == 0
    np.testing.assert_allclose(load_points(tmp_path / "d.xyz"), pts,
                               atol=1e-5)
    rc = cli_main(["convert", "--input", str(tmp_path / "a.csv"),
                   "--output", str(tmp_path / "bad.obj")])
    assert rc == 2


def test_cli_pipeline_flags_mutually_exclusive(capsys):
    with pytest.raises(SystemExit):
        cli_main(["run", "--width", "12", "--sgd", "--distributed"])
    assert "not allowed with" in capsys.readouterr().err


def test_cli_profile_rejects_unsupported_combo(capsys):
    """--profile times the point/plane + brute-matcher breakdown; silently
    profiling a DIFFERENT algorithm than configured misleads (review r3)."""
    rc = cli_main(["run", "--width", "12", "--metric", "gicp", "--profile"])
    assert rc == 2
    assert "different solve structure" in capsys.readouterr().err
    rc = cli_main(["run", "--width", "12", "--matcher", "morton",
                   "--profile"])
    assert rc == 2


def test_cli_sweep_rejects_malformed_widths(capsys):
    for bad in ("64", "3:x", "9:3"):
        rc = cli_main(["sweep", "--widths", bad])
        assert rc == 2, bad
        assert "lo:hi" in capsys.readouterr().err


def test_matching_benchmark_rejects_unknown_variant():
    from fpcr_tpu.bench.sweeps import matching_benchmark

    with pytest.raises(ValueError, match="unknown matching variants"):
        matching_benchmark(n=256, variants=("xla", "nope"), repeats=1)


def test_matching_benchmark_default_variants_on_cpu():
    """The default ladder is what the backend runs: the fused kernel
    ('pallas') needs a GPU, so the CPU ladder leaves it out."""
    from fpcr_tpu.bench.sweeps import matching_benchmark

    res = matching_benchmark(n=64, repeats=1)
    assert set(res) == {"n", "xla", "xla_exact", "morton"}
    assert all(res[k] > 0 for k in ("xla", "xla_exact", "morton"))
