"""Metamorphic properties of registration — invariances that must hold for
ANY correct implementation, independent of the specific scene:

* rigid equivariance: registering W-moved clouds recovers W∘T∘W⁻¹;
* scale equivariance (point metric): scaling both clouds scales the
  recovered translation, leaves the rotation;
* inverse consistency: T(src→tgt) ≈ T(tgt→src)⁻¹ at convergence;
* permutation invariance: shuffling the source rows changes nothing.

These catch frame-convention and accumulation-order bugs that
GT-recovery tests (which fix one scene) can miss.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import fpcr_tpu as f


def _compose(a: f.RigidTransform, b: f.RigidTransform) -> f.RigidTransform:
    # a ∘ b : apply b first, then a — the library's precision-pinned
    # compose (a hand-rolled default-precision matmul would build the
    # EXPECTED transform less accurately than the path under test)
    return a.compose(b)


def _tf_dist(a: f.RigidTransform, b: f.RigidTransform, pts) -> float:
    return float(f.transform_rmse(a, b, pts))


@pytest.fixture
def scene():
    return f.synthetic_scene(width=24)


@pytest.mark.parametrize("matcher", ["xla", "morton"])
def test_rigid_equivariance(scene, matcher):
    """For any rigid W: registering (W·src, W·tgt) must recover W∘T∘W⁻¹
    where T registers (src, tgt)."""
    cfg = f.ICPConfig(max_iterations=40, matcher=matcher)
    base = f.run_icp(scene.source, scene.target, cfg).transform

    w = f.gt_transform((0.3, -0.7, 0.4), (0.5, -0.3, 0.8))
    src_w = w.apply(scene.source)
    tgt_w = w.apply(scene.target)
    moved = f.run_icp(src_w, tgt_w, cfg).transform

    expected = _compose(w, _compose(base, w.inverse()))
    assert _tf_dist(moved, expected, src_w) < 1e-4


def test_scale_equivariance(scene):
    """Point-metric ICP on (s·src, s·tgt): rotation unchanged, translation
    scaled by s."""
    cfg = f.ICPConfig(max_iterations=40)
    base = f.run_icp(scene.source, scene.target, cfg).transform
    s = 3.5
    scaled = f.run_icp(scene.source * s, scene.target * s, cfg).transform
    np.testing.assert_allclose(np.asarray(scaled.rotation),
                               np.asarray(base.rotation), atol=1e-5)
    np.testing.assert_allclose(np.asarray(scaled.translation),
                               s * np.asarray(base.translation), atol=1e-4)


def test_inverse_consistency(scene):
    """T(src→tgt) composed with T(tgt→src) is the identity (both runs
    converge: the scenes are exact rigid copies)."""
    cfg = f.ICPConfig(max_iterations=60)
    fwd = f.run_icp(scene.source, scene.target, cfg).transform
    bwd = f.run_icp(scene.target, scene.source, cfg).transform
    round_trip = _compose(bwd, fwd)
    ident = f.RigidTransform(jnp.eye(3), jnp.zeros(3))
    assert _tf_dist(round_trip, ident, scene.source) < 1e-4


def test_source_permutation_invariance(scene):
    """Shuffling source rows must not change the recovered transform (the
    solve is a sum over correspondences)."""
    cfg = f.ICPConfig(max_iterations=40)
    base = f.run_icp(scene.source, scene.target, cfg).transform
    rng = np.random.default_rng(3)
    perm = rng.permutation(scene.source.shape[0])
    shuffled = f.run_icp(jnp.asarray(np.asarray(scene.source)[perm]),
                         scene.target, cfg).transform
    assert _tf_dist(base, shuffled, scene.source) < 1e-5


@pytest.mark.parametrize("metric", ["plane", "symmetric", "gicp"])
def test_rigid_equivariance_other_metrics(scene, metric):
    """The normals-carrying metrics obey the same rigid equivariance (their
    normals must rotate with the frame — the class of bug a bf16 normal
    rotation causes)."""
    cfg = f.ICPConfig(metric=metric, max_iterations=40)
    base = f.run_icp(scene.source, scene.target, cfg).transform
    w = f.gt_transform((0.2, -0.5, 0.3), (0.4, -0.2, 0.6))
    moved = f.run_icp(w.apply(scene.source), w.apply(scene.target),
                      cfg).transform
    expected = _compose(w, _compose(base, w.inverse()))
    assert _tf_dist(moved, expected, w.apply(scene.source)) < 5e-4
