"""The parity contract (BASELINE.md): GT recovery on Bunny and the hall scan."""

import numpy as np
import pytest

import fpcr_tpu as f
from fpcr_tpu.data.bunny import bunny_scene
from fpcr_tpu.data.ouster import hall_scene


def test_bunny_point_to_point_recovery():
    """Reference workload: Bunny_res + GT t=(0.01,-0.04,0.02),
    r=(0.15,-0.1,0.05), 40 iterations cap
    (/root/reference/src/CUDA/GPU_point_to_point_bunny.cu)."""
    scene = bunny_scene()
    res = f.icp_point_to_point(scene.source, scene.target,
                               config=f.ICPConfig(max_iterations=40))
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-5, rmse


def test_bunny_point_to_plane_recovery():
    scene = bunny_scene()
    res = f.icp_point_to_plane(scene.source, scene.target,
                               config=f.ICPConfig(metric="plane", max_iterations=40))
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-5, rmse


@pytest.mark.slow
def test_hall_scan_point_to_plane_recovery():
    """Reference flagship: Ouster hall scan, plane metric, cap 100
    (/root/reference/src/CUDA/GPU_point_to_plane_real.cu)."""
    scene = hall_scene()
    res = f.icp_point_to_plane(scene.source, scene.target,
                               config=f.ICPConfig(metric="plane", max_iterations=100))
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-4, rmse


@pytest.mark.slow
def test_hall_scan_point_to_point_recovery():
    scene = hall_scene()
    res = f.icp_point_to_point(scene.source, scene.target,
                               config=f.ICPConfig(max_iterations=100))
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-4, rmse


def test_bunny_coarse_to_fine_production_path():
    """The production large-N recipe (coarse brute → Morton-banded fine) on
    real data: recovers the Bunny GT within the parity contract."""
    from fpcr_tpu.models.pipeline import icp_coarse_to_fine
    from fpcr_tpu.data.bunny import bunny_scene

    scene = bunny_scene()
    res = icp_coarse_to_fine(
        scene.source, scene.target,
        coarse_config=f.ICPConfig(max_iterations=40),
        fine_config=f.ICPConfig(matcher="morton", max_iterations=20),
        coarse_points=2048,
    )
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth, scene.source))
    assert rmse < 1e-5, rmse


@pytest.mark.slow
def test_hall_scan_morton_plane_near_registered():
    """Morton-banded plane ICP on the real LiDAR scan (its production
    regime: small residual displacement)."""
    from fpcr_tpu.data.ouster import hall_scene, load_hall_scan

    pts = load_hall_scan()
    gt = f.gt_transform((0.002, -0.003, 0.001), (0.001, -0.002, 0.002))
    res = f.run_icp(pts, gt.apply(pts),
                    f.ICPConfig(metric="plane", matcher="morton",
                                max_iterations=50))
    assert float(f.transform_rmse(res.transform, gt, pts)) < 1e-4


@pytest.mark.slow
def test_full_bunny_exact_recovery():
    """Full Bunny (35,947 pts): the reference SHIPS Bunny.csv but never
    registers it (VERDICT r1 #10) — close that loose end with an exact
    brute-force run to GT recovery."""
    scene = bunny_scene(resampled=False)
    assert scene.source.shape[0] == 35947
    res = f.icp_point_to_point(scene.source, scene.target,
                               config=f.ICPConfig(max_iterations=40))
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source))
    assert rmse < 1e-5, rmse


@pytest.mark.slow
def test_full_bunny_morton_coarse_to_fine():
    """Full Bunny via the production large-N path: brute coarse stage on a
    subset absorbs the displacement, Morton-banded fine stage registers the
    full 35,947-pt cloud."""
    from fpcr_tpu.models.pipeline import icp_coarse_to_fine

    scene = bunny_scene(resampled=False)
    res = icp_coarse_to_fine(
        scene.source, scene.target,
        coarse_config=f.ICPConfig(max_iterations=40),
        fine_config=f.ICPConfig(matcher="morton", max_iterations=20),
        coarse_points=2048,
    )
    rmse = float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source))
    assert rmse < 1e-4, rmse
