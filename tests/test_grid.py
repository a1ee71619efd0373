"""Voxel-grid NN: exactness in-regime, ICP integration, coarse-to-fine."""

import numpy as np
import jax.numpy as jnp
import pytest

import fpcr_tpu as f
from fpcr_tpu.ops.grid import (
    build_voxel_table,
    grid_nn,
    suggest_cell_size,
)
from fpcr_tpu.ops.matching import nn_argmin

from helpers import np_nn


@pytest.fixture
def clouds():
    rng = np.random.default_rng(55)
    q = rng.uniform(-2, 2, size=(4000, 3)).astype(np.float32)
    p = (q[:1500] + rng.normal(scale=0.005, size=(1500, 3))).astype(np.float32)
    return p, q


def test_grid_nn_matches_brute_force_in_regime(clouds):
    """Near-registered clouds + sane cell size → exact brute-force answers."""
    p, q = clouds
    cell = float(suggest_cell_size(jnp.asarray(q)))
    table = build_voxel_table(jnp.asarray(q), cell)
    idx, d, found = grid_nn(jnp.asarray(p), table, cap=16)
    assert bool(np.asarray(found).all())
    ref_idx, ref_d = np_nn(p, q)
    agree = (np.asarray(idx) == ref_idx).mean()
    assert agree > 0.999, agree
    np.testing.assert_allclose(np.asarray(d)[np.asarray(idx) == ref_idx],
                               ref_d[np.asarray(idx) == ref_idx], rtol=1e-3)


def test_grid_nn_reports_unfound_for_distant_queries(clouds):
    p, q = clouds
    cell = float(suggest_cell_size(jnp.asarray(q)))
    table = build_voxel_table(jnp.asarray(q), cell)
    far = jnp.asarray(np.full((10, 3), 100.0, np.float32))
    idx, d, found = grid_nn(far, table)
    assert not bool(np.asarray(found).any())
    assert np.isinf(np.asarray(d)).all()


def test_grid_nn_with_target_mask(clouds):
    p, q = clouds
    mask = np.ones(len(q), bool)
    mask[2000:] = False
    cell = float(suggest_cell_size(jnp.asarray(q[:2000])))
    table = build_voxel_table(jnp.asarray(q), cell, q_mask=jnp.asarray(mask))
    idx, d, found = grid_nn(jnp.asarray(p[:100]), table, cap=16)
    got = np.asarray(idx)[np.asarray(found)]
    assert (got < 2000).all()  # masked targets never matched


def test_icp_grid_matcher_near_registered(clouds):
    """Grid-matched ICP refines a small displacement to high accuracy."""
    _, q = clouds
    src = jnp.asarray(q)
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004))
    tgt = gt.apply(src)
    res = f.run_icp(src, tgt,
                    f.ICPConfig(matcher="grid", max_iterations=30, grid_cap=16))
    assert float(f.transform_rmse(res.transform, gt, src)) < 1e-4


def test_coarse_to_fine_full_displacement():
    """Full reference-scale displacement (t=(0.8,-0.3,0.2)) on the synthetic
    scene via coarse brute + fine grid."""
    from fpcr_tpu.models.pipeline import icp_coarse_to_fine

    scene = f.synthetic_scene(width=64)  # 4096 pts
    res = icp_coarse_to_fine(
        scene.source, scene.target,
        coarse_config=f.ICPConfig(max_iterations=40),
        fine_config=f.ICPConfig(matcher="grid", max_iterations=20, grid_cap=16),
        coarse_points=1024,
    )
    assert float(f.transform_rmse(res.transform, scene.ground_truth, scene.source)) < 1e-4


def test_grid_handles_duplicate_points():
    pts = np.repeat(np.random.default_rng(1).uniform(-1, 1, (50, 3)), 20, axis=0)
    pts = pts.astype(np.float32)  # 1000 pts, 20 copies each — bucket overflow
    table = build_voxel_table(jnp.asarray(pts), 0.1)
    idx, d, found = grid_nn(jnp.asarray(pts[:100]), table, cap=4)
    # self (distance 0) may be beyond the cap cut, but a zero-distance
    # duplicate must still be found
    assert bool(np.asarray(found).all())
    assert float(np.asarray(d).max()) <= 1e-6


def test_grid_nn_rejects_worker_crashing_sizes():
    """A 1M-point grid query gathers ~226M candidate rows (~2.7 GB per
    iteration); the raw op's candidate-budget guard turns that into a clear
    error that points at the morton matcher, BEFORE any device compute is
    issued."""
    import pytest

    table = build_voxel_table(
        jnp.asarray(np.random.default_rng(0).uniform(-1, 1, (256, 3)),
                    dtype=jnp.float32), 0.2)
    big = jnp.zeros((1_048_576, 3), jnp.float32)
    with pytest.raises(ValueError, match="morton"):
        grid_nn(big, table, cap=8)
    # the override is REAL: a budget below even a tiny cloud's candidate
    # count trips the guard, raising it past the budget lets the same
    # call through (64 * 27 * 8 = 13,824 candidates)
    with pytest.raises(ValueError, match="morton"):
        grid_nn(big[:64], table, cap=8, max_candidate_gathers=10_000)
    idx, d, found = grid_nn(big[:64], table, cap=8,
                            max_candidate_gathers=20_000)
    assert idx.shape == (64,)


def test_icp_grid_matcher_degrades_to_morton_at_scale():
    """The DRIVER path never surfaces the grid guard: ICPConfig(matcher=
    'grid') above the candidate-gather budget transparently degrades
    to the morton matcher with a warning (VERDICT r3 #6). Traced at the
    real 1M size via eval_shape — the degrade decision is a trace-time
    property, no device compute needed."""
    import functools

    import jax

    from fpcr_tpu.models.icp import resolve_matcher
    from fpcr_tpu.ops.grid import MAX_CANDIDATE_GATHERS

    cfg = f.ICPConfig(matcher="grid", max_iterations=1)
    # direct resolution: over budget -> morton (+warning), under -> unchanged
    with pytest.warns(UserWarning, match="morton"):
        assert resolve_matcher(cfg, 1_048_576).matcher == "morton"
    assert resolve_matcher(cfg, 16_384) is cfg
    assert 16_384 * 27 * cfg.grid_cap <= MAX_CANDIDATE_GATHERS

    big = jax.ShapeDtypeStruct((1_048_576, 3), jnp.float32)
    tgt = jax.ShapeDtypeStruct((4096, 3), jnp.float32)
    with pytest.warns(UserWarning, match="morton"):
        out = jax.eval_shape(
            functools.partial(f.run_icp, config=cfg), big, tgt)
    assert out.points.shape == (1_048_576, 3)


def test_icp_grid_fallback_still_registers(monkeypatch, clouds):
    """With the budget forced tiny, the grid config runs the morton path
    end-to-end and still recovers the transform."""
    from fpcr_tpu.ops import grid as grid_mod

    monkeypatch.setattr(grid_mod, "MAX_CANDIDATE_GATHERS", 1_000)
    _, q = clouds
    src = jnp.asarray(q[:3100])  # distinct shape: avoid stale jit cache
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004))
    tgt = gt.apply(src)
    cfg = f.ICPConfig(matcher="grid", max_iterations=30, grid_cap=16)
    with pytest.warns(UserWarning, match="morton"):
        res = f.run_icp(src, tgt, cfg)
    assert float(f.transform_rmse(res.transform, gt, src)) < 1e-4


def test_icp_prebuilt_grid_state_degrades_consistently(monkeypatch, clouds):
    """ADVICE r4: the documented prebuilt-state pattern
    (build_matcher_state(cfg) then run_icp(..., matcher_state=...)) with an
    over-budget grid config must degrade to morton exactly like the
    state=None path, not crash deep inside the jit."""
    from fpcr_tpu.models.icp import build_matcher_state
    from fpcr_tpu.ops import grid as grid_mod

    monkeypatch.setattr(grid_mod, "MAX_CANDIDATE_GATHERS", 1_000)
    _, q = clouds
    src = jnp.asarray(q[:3300])  # distinct shape: avoid stale jit cache
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.003, -0.002, 0.004))
    tgt = gt.apply(src)
    cfg = f.ICPConfig(matcher="grid", max_iterations=30, grid_cap=16)
    state = build_matcher_state(tgt, None, cfg)  # a real (over-budget) grid table
    with pytest.warns(UserWarning, match="morton"):
        res = f.run_icp(src, tgt, cfg, matcher_state=state)
    assert float(f.transform_rmse(res.transform, gt, src)) < 1e-4


def test_voxel_downsample_matches_dict_oracle():
    """Static-shape voxel downsampling equals the classic hash-map
    formulation exactly (per-voxel centroids, one per occupied cell)."""
    from collections import defaultdict

    from fpcr_tpu.ops.grid import voxel_downsample

    rng = np.random.default_rng(0)
    pts = jnp.asarray(rng.uniform(-1, 1, (3000, 3)).astype(np.float32))
    c, valid = voxel_downsample(pts, 0.25)
    assert c.shape == (3000, 3) and valid.shape == (3000,)

    d = defaultdict(list)
    for p, cc in zip(np.asarray(pts),
                     map(tuple, np.floor(np.asarray(pts) / 0.25).astype(int))):
        d[cc].append(p)
    k = int(np.asarray(valid).sum())
    assert k == len(d)
    got = {tuple(np.round(np.asarray(c)[i], 5))
           for i in range(3000) if bool(valid[i])}
    want = {tuple(np.round(np.mean(v, axis=0).astype(np.float32), 5))
            for v in d.values()}
    assert got == want


def test_voxel_downsample_feeds_registration():
    """Downsampled clouds register through the standard masked loop."""
    from fpcr_tpu.ops.grid import voxel_downsample

    scene = f.synthetic_scene(width=48)
    src_c, src_m = voxel_downsample(scene.source, 0.35)
    tgt_c, tgt_m = voxel_downsample(scene.target, 0.35)
    res = f.run_icp(src_c, tgt_c,
                    f.ICPConfig(max_iterations=60),
                    source_mask=src_m, target_mask=tgt_m)
    # voxelization decimates + shifts points, so recovery is approximate
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 0.05


def test_suggest_cell_size_duplicate_heavy_cloud():
    """Duplicate points (zero NN spacing) must not collapse the suggested
    cell to 0 — the median is taken over POSITIVE spacings (fuzzer find:
    auto NDT voxel_size raised 'must be positive' on dup-heavy clouds)."""
    rng = np.random.default_rng(3)
    base = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    dup = base[rng.integers(0, 64, 4096)]  # every point duplicated ~64x
    cell = float(suggest_cell_size(jnp.asarray(dup)))
    assert np.isfinite(cell) and cell > 0

    # fully degenerate (a single repeated point): no extent -> 0, and the
    # NDT auto-resolution turns that into a clear error
    import pytest

    from fpcr_tpu.models.ndt import NDTConfig, resolve_voxel_size

    one = jnp.asarray(np.tile(np.float32([1, 2, 3]), (256, 1)))
    assert float(suggest_cell_size(one)) == 0.0
    with pytest.raises(ValueError, match="auto voxel_size failed"):
        resolve_voxel_size(NDTConfig(), one)


def test_suggest_cell_size_far_from_origin():
    """Global-frame coordinates: |p|² expansion noise must not swamp the
    measured spacing (the slice is centered before the 2-NN pass)."""
    rng = np.random.default_rng(4)
    local = rng.uniform(-1, 1, (4096, 3)).astype(np.float32)
    near = float(suggest_cell_size(jnp.asarray(local)))
    far = float(suggest_cell_size(jnp.asarray(local + np.float32([300.0, -450.0, 250.0]))))
    assert np.isfinite(far) and far > 0
    assert abs(far - near) < 0.5 * near, (near, far)
