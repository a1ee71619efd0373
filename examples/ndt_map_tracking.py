"""Example 6 — NDT map tracking: register a scan stream against one map.

The voxel-Gaussian field (`build_ndt_grid`) is built ONCE from a map
cloud and reused for every incoming scan — the per-scan cost is just the
Gauss-Newton loop over the voxel lookups. This is the intended
deployment shape for localization: amortize the map prepass, stream the
scans.

The reference (brute-force CUDA ICP) has no NDT; see docs/api.md.

Run:  python examples/ndt_map_tracking.py [--cpu] [--quick]
(--quick shrinks the map and the scan stream for fast smoke runs)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

import numpy as np

import fpcr_tpu as f
from fpcr_tpu.models.ndt import NDTConfig, run_ndt


def main():
    # --quick cuts the scan stream, not the map: NDT accuracy depends on
    # points-per-voxel, so shrinking the map would change the physics
    quick = "--quick" in sys.argv
    # the "map": one saddle surface scan
    scene = f.synthetic_scene(width=64)
    map_cloud = scene.source

    # one-time prepass: voxelize the map into per-voxel Gaussians
    grid = f.build_ndt_grid(map_cloud, 0.3)
    print(f"map grid: {int(np.asarray(grid.valid).sum())} occupied voxels")

    # resolve the auto lookup/window policy ONCE against the grid — every
    # run_ndt below then skips the per-call host-side coverage probe
    cfg = f.resolve_ndt_config(
        NDTConfig(voxel_size=0.3, max_iterations=60), grid, map_cloud)

    # a stream of scans: the map observed from drifting poses
    rng = np.random.default_rng(0)
    pose_errors = []
    for t in range(2 if quick else 5):
        gt = f.gt_transform(
            tuple(0.01 * rng.standard_normal(3)),   # rotation (rad)
            tuple(0.05 * rng.standard_normal(3)))   # translation
        scan = gt.apply(map_cloud)

        # register scan -> map on the PREBUILT grid (no per-scan prepass)
        res = run_ndt(scan, map_cloud, cfg, grid=grid)
        # res.transform maps the scan back onto the map (it recovers
        # gt^-1); res.points is the aligned scan
        err = float(np.sqrt(np.mean(np.sum(
            (np.asarray(res.points) - np.asarray(map_cloud)) ** 2,
            axis=1))))
        pose_errors.append(err)
        print(f"scan {t}: converged={bool(res.converged)} "
              f"iters={int(res.num_iterations)} pose rmse={err:.2e}")

    assert max(pose_errors) < 5e-3, pose_errors
    print("all scans tracked")


if __name__ == "__main__":
    main()
