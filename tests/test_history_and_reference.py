"""History/checkpoint scan loop, numpy golden baseline, diagnostics."""

import jax.numpy as jnp
import numpy as np
import pytest

import fpcr_tpu as f
from fpcr_tpu.models.history import (
    load_checkpoint,
    resume_icp,
    run_icp_with_history,
    save_checkpoint,
)
from fpcr_tpu.models.reference_impl import icp_numpy
from fpcr_tpu.utils.diagnostics import RegistrationError, validate_result


def test_history_matches_while_loop_result():
    scene = f.synthetic_scene(width=16)
    cfg = f.ICPConfig(max_iterations=50)
    res = f.run_icp(scene.source, scene.target, cfg)
    hist = run_icp_with_history(scene.source, scene.target, cfg)
    assert int(hist.num_iterations) == int(res.num_iterations)
    np.testing.assert_allclose(
        np.asarray(hist.transform.rotation),
        np.asarray(res.transform.rotation), atol=1e-6,
    )
    ni = int(res.num_iterations)
    np.testing.assert_allclose(
        np.asarray(hist.errors)[:ni], np.asarray(res.errors)[:ni], atol=1e-7
    )
    # inactive tail iterations are frozen no-ops
    assert not np.asarray(hist.active)[ni:].any()
    tail_rots = np.asarray(hist.incremental_rotations)[ni:]
    np.testing.assert_allclose(
        tail_rots, np.broadcast_to(np.eye(3), tail_rots.shape), atol=0
    )


def test_history_accumulated_equals_compose_of_increments():
    scene = f.synthetic_scene(width=12)
    hist = run_icp_with_history(scene.source, scene.target,
                                f.ICPConfig(max_iterations=20))
    R = np.eye(3)
    t = np.zeros(3)
    for k in range(int(hist.num_iterations)):
        Rk = np.asarray(hist.incremental_rotations)[k]
        tk = np.asarray(hist.incremental_translations)[k]
        R = Rk @ R
        t = Rk @ t + tk
    np.testing.assert_allclose(R, np.asarray(hist.transform.rotation), atol=1e-5)
    np.testing.assert_allclose(t, np.asarray(hist.transform.translation), atol=1e-5)


def test_checkpoint_save_load_resume(tmp_path):
    scene = f.synthetic_scene(width=16)
    cfg_a = f.ICPConfig(max_iterations=3, tolerance=0.0)  # stop early
    hist_a = run_icp_with_history(scene.source, scene.target, cfg_a)
    path = save_checkpoint(tmp_path / "ckpt.npz", hist_a, cfg_a)
    loaded, cfg_loaded = load_checkpoint(path)
    assert cfg_loaded.max_iterations == 3
    np.testing.assert_allclose(loaded.errors, np.asarray(hist_a.errors))

    # resume until convergence; composed transform must recover GT
    cfg_b = f.ICPConfig(max_iterations=60)
    hist_b = resume_icp(loaded, scene.target, cfg_b)
    rmse = float(f.transform_rmse(hist_b.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-4


def test_numpy_baseline_recovers_gt():
    scene = f.synthetic_scene(width=16)
    res = icp_numpy(np.asarray(scene.source), np.asarray(scene.target))
    assert res.converged
    gtR = np.asarray(scene.ground_truth.rotation)
    np.testing.assert_allclose(res.rotation, gtR, atol=1e-4)


def test_tpu_matches_numpy_baseline_trajectory():
    """Cross-check (SURVEY.md §4): same error sequence as the f64 golden
    implementation to f32-accumulation tolerance."""
    scene = f.synthetic_scene(width=16)
    res_np = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                       max_iterations=40, tolerance=1e-6)
    res_j = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(max_iterations=40, tolerance=1e-6))
    k = min(res_np.iterations, int(res_j.num_iterations), 10)
    np.testing.assert_allclose(
        np.asarray(res_j.errors)[:k], res_np.errors[:k], rtol=1e-3, atol=1e-5
    )


def test_numpy_baseline_plane_metric():
    scene = f.synthetic_scene(width=16)
    res = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                    metric="plane", max_iterations=40, tolerance=1e-6)
    np.testing.assert_allclose(
        res.rotation, np.asarray(scene.ground_truth.rotation), atol=1e-4
    )


def test_validate_result_passes_good_run():
    scene = f.synthetic_scene(width=12)
    res = f.run_icp(scene.source, scene.target, f.ICPConfig(max_iterations=40))
    assert validate_result(res, require_converged=True) == []


def test_validate_result_raises_on_nan():
    import jax.numpy as jnp

    scene = f.synthetic_scene(width=12)
    res = f.run_icp(scene.source, scene.target, f.ICPConfig(max_iterations=5))
    bad = res._replace(transform=f.RigidTransform(
        jnp.full((3, 3), jnp.nan), res.transform.translation))
    with pytest.raises(RegistrationError):
        validate_result(bad)


@pytest.mark.slow
def test_flagship_width128_error_sequence_parity_strict():
    """Flagship-scale golden parity (VERDICT r1 #4): full error-sequence
    parity at the reference's headline size (width 128 = 16,384 points) in
    strict_reference mode vs the f64 golden implementation, and an
    iteration count in the reference's printed range
    (/root/reference/src/CUDA/ICP_point_to_point_clean.cu:458-465)."""
    scene = f.synthetic_scene(width=128)
    res_np = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                       max_iterations=40, tolerance=1e-6,
                       det_correction=False)
    res_j = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(max_iterations=40, tolerance=1e-6,
                                  strict_reference=True))
    k = min(res_np.iterations, int(res_j.num_iterations))
    assert k >= 10  # a real trajectory, not an immediate stop
    # measured drift (f32 loop vs f64 golden): rel <= 1.1e-3 through the
    # whole trajectory; the final converged error (~1e-6 vs ~1e-7) is only
    # comparable in absolute terms — hence the atol floor
    np.testing.assert_allclose(
        np.asarray(res_j.errors)[:k], res_np.errors[:k],
        rtol=5e-3, atol=1e-5,
    )
    # f32 vs f64 convergence tests may differ by a couple of trailing
    # iterations; the counts must agree to that tolerance (measured 28 vs 27)
    assert abs(int(res_j.num_iterations) - res_np.iterations) <= 3


@pytest.mark.slow
def test_flagship_width128_plane_trajectory_parity():
    """Plane metric at the flagship size: error-sequence parity vs the f64
    golden (normals tie-breaks on the regular grid differ slightly between
    the two kNN implementations, hence the looser early-trajectory rtol)."""
    scene = f.synthetic_scene(width=128)
    # only the first 6 errors are compared — cap the golden run's cost
    res_np = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                       metric="plane", max_iterations=10, tolerance=1e-6)
    res_j = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(metric="plane", max_iterations=50,
                                  tolerance=1e-6))
    k = min(res_np.iterations, int(res_j.num_iterations), 6)
    assert k >= 3
    # measured: rel <= 3.9e-3 on the descending trajectory; near-converged
    # errors (~4e-3 and below) carry normals-tie-break noise in absolute
    # terms — the atol floor covers them (diff <= 2.9e-4 measured)
    np.testing.assert_allclose(
        np.asarray(res_j.errors)[:k], res_np.errors[:k],
        rtol=1e-2, atol=5e-4,
    )
    assert int(res_j.num_iterations) == res_np.iterations  # measured 5 == 5
    assert float(f.transform_rmse(res_j.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


@pytest.mark.slow
def test_bunny_error_sequence_parity_strict():
    """Bunny (8,171 pts): full strict-mode error-sequence parity vs the
    f64 golden implementation."""
    from fpcr_tpu.data.bunny import bunny_scene

    scene = bunny_scene()
    res_np = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                       max_iterations=40, tolerance=1e-6,
                       det_correction=False)
    res_j = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(max_iterations=40, tolerance=1e-6,
                                  strict_reference=True))
    k = min(res_np.iterations, int(res_j.num_iterations))
    assert k >= 5
    assert int(res_j.num_iterations) == res_np.iterations  # measured 17 == 17
    # measured drift: rel <= 4e-2 at the second-to-last iteration, final
    # errors ~5e-8 vs ~1e-8 — absolute floor needed at the tail
    np.testing.assert_allclose(
        np.asarray(res_j.errors)[:k], res_np.errors[:k],
        rtol=5e-2, atol=1e-5,
    )


@pytest.mark.slow
def test_hall_strict_error_sequence_parity():
    """Hall scan, STRICT reference ordering (VERDICT r2 #1): the GT RyT is
    applied to the millimeter cloud BEFORE the mm->m scale
    (/root/reference/src/CUDA/GPU_point_to_plane_real.cu:851 then
    :350-352), so the effective meters-space translation is
    1e-3 x (0.001, -0.0202, 0.02). Full error-sequence + transform parity
    of the f32 JAX plane loop vs the f64 golden baseline on the
    reference's own flagship scene."""
    from fpcr_tpu.data.ouster import hall_scene

    scene = hall_scene(strict=True)
    # strictness check: the scene's GT translation is the pre-scale one
    np.testing.assert_allclose(
        np.asarray(scene.ground_truth.translation),
        1e-3 * np.array([0.001, -0.0202, 0.02]), rtol=1e-6)

    res_np = icp_numpy(np.asarray(scene.source), np.asarray(scene.target),
                       metric="plane", max_iterations=12, tolerance=1e-6)
    res_j = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(metric="plane", max_iterations=100,
                                  tolerance=1e-6))
    k = min(res_np.iterations, int(res_j.num_iterations), 6)
    assert k >= 3
    # both loops stop at the same iteration (measured 4 == 4)
    assert int(res_j.num_iterations) == res_np.iterations
    # measured drift: the structured 1024x16 scan has many equidistant
    # neighbors along scan lines, so the two independent kNN
    # implementations break normal ties differently — up to 11.5% relative
    # mid-trajectory (1.2e-3 absolute at error ~1e-2), converging to the
    # SAME transform (asserted below, the real parity contract)
    np.testing.assert_allclose(
        np.asarray(res_j.errors)[:k], res_np.errors[:k],
        rtol=0.15, atol=5e-4,
    )
    # transform parity: both recover the strict GT within the 1e-5 contract
    assert float(f.transform_rmse(res_j.transform, scene.ground_truth,
                                  scene.source)) < 1e-5
    gt_np = f.RigidTransform(jnp.asarray(res_np.rotation, jnp.float32),
                             jnp.asarray(res_np.translation, jnp.float32))
    assert float(f.transform_rmse(res_j.transform, gt_np,
                                  scene.source)) < 1e-5


@pytest.mark.slow
def test_hall_strict_point_metric_gt_recovery():
    """Point metric on the strict hall scene (the GPU_point_to_point_real
    program's workload, reference-ordered GT)."""
    from fpcr_tpu.data.ouster import hall_scene

    scene = hall_scene(strict=True)
    res = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(max_iterations=100))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-4


def test_checkpoint_foreign_suffix_roundtrip(tmp_path):
    """save/load agree on filenames for NON-.npz paths: numpy appends
    '.npz' on save, so load must do the same instead of replacing the
    suffix (review find r3: save('run.ckpt') wrote run.ckpt.npz but
    load('run.ckpt') looked for run.npz, and the config sidecar names
    diverged the same way)."""
    import fpcr_tpu as f
    from fpcr_tpu.models.history import load_checkpoint, run_icp_with_history

    scene = f.synthetic_scene(width=10)
    cfg = f.ICPConfig(max_iterations=15)
    hist = run_icp_with_history(scene.source, scene.target, cfg)

    written = save_checkpoint(tmp_path / "run.ckpt", hist, cfg)
    assert written.exists() and written.name == "run.ckpt.npz"
    loaded, cfg_back = load_checkpoint(tmp_path / "run.ckpt")
    assert cfg_back == cfg  # sidecar found, not silently None
    np.testing.assert_allclose(np.asarray(loaded.transform.translation),
                               np.asarray(hist.transform.translation),
                               atol=0)
    # loading by the actual npz name works too
    loaded2, cfg2 = load_checkpoint(written)
    assert cfg2 == cfg
    np.testing.assert_allclose(loaded2.errors, loaded.errors, atol=0)
