"""Symmetric point-to-plane metric (Rusinkiewicz, 'A Symmetric Objective
Function for ICP', 2019): residual (p−q)·(n_p+n_q). Converges in fewer
iterations than one-sided point-to-plane on smooth scenes."""

import numpy as np
import pytest

import fpcr_tpu as f


def test_symmetric_recovers_gt():
    scene = f.synthetic_scene(width=32)
    res = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(metric="symmetric", max_iterations=40))
    assert bool(res.converged)
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_symmetric_not_slower_than_plane():
    scene = f.synthetic_scene(width=32)
    plane = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(metric="plane", max_iterations=60))
    sym = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(metric="symmetric", max_iterations=60))
    assert int(sym.num_iterations) <= int(plane.num_iterations)


def test_symmetric_bunny():
    from fpcr_tpu.data.bunny import bunny_scene

    scene = bunny_scene()
    res = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(metric="symmetric", max_iterations=40))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_symmetric_morton_matcher():
    """Symmetric metric through the production large-N path: Morton bands
    supply matched points AND matched target normals; source normals ride
    the pre-sort order."""
    rng = np.random.default_rng(23)
    src = np.asarray(f.synthetic_scene(width=48).source)
    import jax.numpy as jnp

    src = jnp.asarray(src)
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.02, -0.01, 0.02))
    tgt = gt.apply(src)
    res = f.run_icp(src, tgt, f.ICPConfig(metric="symmetric",
                                          matcher="morton",
                                          max_iterations=20))
    assert float(f.transform_rmse(res.transform, gt, src)) < 1e-4


def test_symmetric_distributed():
    import jax

    from fpcr_tpu.parallel.dist_icp import distributed_icp, make_mesh

    assert len(jax.devices()) >= 8
    scene = f.synthetic_scene(width=24)
    res = distributed_icp(scene.source, scene.target,
                          f.ICPConfig(metric="symmetric", max_iterations=40),
                          mesh=make_mesh(8))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_symmetric_history_and_aa():
    from fpcr_tpu.models.anderson import run_aa_icp
    from fpcr_tpu.models.history import run_icp_with_history

    scene = f.synthetic_scene(width=24)
    cfg = f.ICPConfig(metric="symmetric", max_iterations=40)
    h = run_icp_with_history(scene.source, scene.target, cfg)
    assert float(f.transform_rmse(h.transform, scene.ground_truth,
                                  scene.source)) < 1e-5
    aa = run_aa_icp(scene.source, scene.target, cfg)
    assert float(f.transform_rmse(aa.transform, scene.ground_truth,
                                  scene.source)) < 1e-5
