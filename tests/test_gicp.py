"""Generalized-ICP (plane-to-plane, Segal et al. RSS 2009) — a
beyond-reference model family built on the framework's normals + moment
machinery (fpcr_tpu/ops/gicp.py)."""

import numpy as np

import jax
import jax.numpy as jnp

import fpcr_tpu as f
from fpcr_tpu.ops.gicp import (
    gicp_normal_equations,
    inv3x3_sym,
    normal_covariances,
)


def test_inv3x3_sym_matches_numpy():
    rng = np.random.default_rng(0)
    B = rng.normal(size=(64, 3, 3))
    A = B @ np.swapaxes(B, 1, 2) + 0.5 * np.eye(3)  # SPD batch
    M = np.asarray(inv3x3_sym(jnp.asarray(A, jnp.float32)))
    expected = np.linalg.inv(A)
    np.testing.assert_allclose(M, expected, rtol=2e-4, atol=2e-4)


def test_normal_covariances_eigenstructure():
    n = jnp.asarray([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])
    C = np.asarray(normal_covariances(n, epsilon=1e-3))
    # eigenvalues (eps, 1, 1); the eps-eigenvector is the normal
    w0 = np.linalg.eigvalsh(C[0])
    np.testing.assert_allclose(np.sort(w0), [1e-3, 1.0, 1.0], atol=1e-6)
    np.testing.assert_allclose(C[0] @ [0, 0, 1], [0, 0, 1e-3], atol=1e-6)
    # epsilon=1 degenerates to the isotropic (point-to-point) model
    C1 = np.asarray(normal_covariances(n, epsilon=1.0))
    np.testing.assert_allclose(C1, np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-7)


def test_gicp_normal_equations_vs_numpy_golden():
    """H/g assembly parity against a straightforward float64 numpy
    implementation of the Segal linearization."""
    rng = np.random.default_rng(3)
    n_pts = 50
    p = rng.normal(size=(n_pts, 3))
    q = p + 0.01 * rng.normal(size=(n_pts, 3))

    def unit(v):
        return v / np.linalg.norm(v, axis=1, keepdims=True)

    n_p = unit(rng.normal(size=(n_pts, 3)))
    n_q = unit(rng.normal(size=(n_pts, 3)))
    mask = (rng.random(n_pts) > 0.2)
    eps = 1e-3

    H, g = gicp_normal_equations(
        jnp.asarray(p, jnp.float32), jnp.asarray(q, jnp.float32),
        jnp.asarray(n_p, jnp.float32), jnp.asarray(n_q, jnp.float32),
        jnp.asarray(mask), epsilon=eps)

    H64 = np.zeros((6, 6))
    g64 = np.zeros(6)
    eye = np.eye(3)
    for i in range(n_pts):
        if not mask[i]:
            continue
        Cp = eye - (1 - eps) * np.outer(n_p[i], n_p[i])
        Cq = eye - (1 - eps) * np.outer(n_q[i], n_q[i])
        M = np.linalg.inv(Cp + Cq)
        S = np.array([[0, -p[i, 2], p[i, 1]],
                      [p[i, 2], 0, -p[i, 0]],
                      [-p[i, 1], p[i, 0], 0]])
        J = np.concatenate([-S, eye], axis=1)  # r(x) = r0 + J @ (w, t)
        r0 = p[i] - q[i]
        H64 += J.T @ M @ J
        g64 += J.T @ M @ r0
    np.testing.assert_allclose(np.asarray(H), H64, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(g), g64, rtol=1e-4, atol=1e-5)


def test_gicp_recovers_gt_synthetic():
    scene = f.synthetic_scene(width=32)
    res = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(metric="gicp", max_iterations=40))
    assert bool(res.converged)
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_icp_generalized_wrapper():
    scene = f.synthetic_scene(width=24)
    res = f.icp_generalized(scene.source, scene.target, max_iterations=40)
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_gicp_bunny():
    from fpcr_tpu.data.bunny import bunny_scene

    scene = bunny_scene()
    res = f.run_icp(scene.source, scene.target,
                    f.ICPConfig(metric="gicp", max_iterations=40))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_gicp_morton_matcher():
    """GICP through the production large-N path: the Morton bands supply
    matched points AND matched target normals; source normals ride the
    pre-sort order."""
    src = f.synthetic_scene(width=48).source
    gt = f.gt_transform((0.01, -0.02, 0.015), (0.02, -0.01, 0.02))
    tgt = gt.apply(src)
    res = f.run_icp(src, tgt, f.ICPConfig(metric="gicp", matcher="morton",
                                          max_iterations=25))
    assert float(f.transform_rmse(res.transform, gt, src)) < 1e-4


def test_gicp_distributed():
    from fpcr_tpu.parallel.dist_icp import distributed_icp, make_mesh

    assert len(jax.devices()) >= 8
    scene = f.synthetic_scene(width=24)
    res = distributed_icp(scene.source, scene.target,
                          f.ICPConfig(metric="gicp", max_iterations=40),
                          mesh=make_mesh(8))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_gicp_history_and_aa():
    from fpcr_tpu.models.anderson import run_aa_icp
    from fpcr_tpu.models.history import run_icp_with_history

    scene = f.synthetic_scene(width=24)
    cfg = f.ICPConfig(metric="gicp", max_iterations=40)
    h = run_icp_with_history(scene.source, scene.target, cfg)
    assert float(f.transform_rmse(h.transform, scene.ground_truth,
                                  scene.source)) < 1e-5
    aa = run_aa_icp(scene.source, scene.target, cfg)
    assert float(f.transform_rmse(aa.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_gicp_epsilon_validation():
    import pytest

    with pytest.raises(ValueError):
        f.ICPConfig(metric="gicp", gicp_epsilon=0.0)
    with pytest.raises(ValueError):
        f.ICPConfig(metric="gicp", gicp_epsilon=1.5)
    # direct op calls with degenerate epsilon stay finite (det floor)
    n = jnp.asarray([[0.0, 0.0, 1.0]] * 4)
    p = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)),
                    jnp.float32)
    H, g = gicp_normal_equations(p, p + 0.01, n, n, epsilon=1e-9)
    assert bool(jnp.all(jnp.isfinite(H))) and bool(jnp.all(jnp.isfinite(g)))
