"""NDT: voxel Gaussian grid build/lookup, registration, NDT+ICP pipeline."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

import fpcr_tpu as f
from fpcr_tpu.models.ndt import NDTConfig, register_ndt, run_ndt
from fpcr_tpu.ops.ndt import build_ndt_grid, gauss_d1_d2, ndt_lookup


def test_grid_stats_match_numpy():
    """Per-voxel mean/inverse-covariance agree with a numpy groupby."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 1.0, (2000, 3)).astype(np.float32)
    h = 0.25
    grid = build_ndt_grid(jnp.asarray(pts), h, min_points=4, eig_ratio=0.01)

    lo = pts.min(0)  # the grid's origin is the cloud min corner
    cells = np.floor((pts - lo) / h).astype(np.int64)
    keys = cells[:, 0] * (1 << 20) + cells[:, 1] * (1 << 10) + cells[:, 2]
    mu_g = np.asarray(grid.mu)
    keys_g = np.asarray(grid.keys)
    valid_g = np.asarray(grid.valid)
    for key in np.unique(keys):
        members = pts[keys == key]
        pos = np.searchsorted(keys_g, key)
        if len(members) < 4:
            assert not (keys_g[pos] == key and valid_g[pos])
            continue
        assert keys_g[pos] == key and valid_g[pos]
        np.testing.assert_allclose(mu_g[pos], members.mean(0), atol=1e-5)
        # inverse covariance: reconstruct and compare against the clamped
        # eigenvalue form
        cov = np.cov(members.T, bias=True)
        lam, v = np.linalg.eigh(cov)
        lam = np.maximum(lam, 0.01 * lam.max())
        sinv_ref = v @ np.diag(1.0 / lam) @ v.T
        np.testing.assert_allclose(np.asarray(grid.sinv)[pos], sinv_ref,
                                   rtol=0.03, atol=1e-3 * abs(sinv_ref).max())


def test_lookup_hits_and_misses():
    rng = np.random.default_rng(1)
    pts = rng.uniform(0, 1.0, (4000, 3)).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    mu, sinv, hit = ndt_lookup(jnp.asarray(pts), grid)
    assert float(hit.mean()) > 0.95  # dense cube: nearly every voxel occupied
    # far-away queries miss, with zeroed sinv
    far = jnp.asarray(pts + 50.0)
    _, sinv_f, hit_f = ndt_lookup(far, grid)
    assert not bool(hit_f.any())
    assert float(jnp.abs(sinv_f).max()) == 0.0


def test_lookup_neighbor_offset():
    """cell_offset queries the adjacent voxel's Gaussian."""
    rng = np.random.default_rng(2)
    pts = rng.uniform(0, 1.0, (4000, 3)).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    probe = jnp.asarray([[0.375, 0.375, 0.375]])
    mu0, _, hit0 = ndt_lookup(probe, grid)
    mu1, _, hit1 = ndt_lookup(probe, grid, cell_offset=jnp.asarray([1, 0, 0]))
    assert bool(hit0[0]) and bool(hit1[0])
    # the +x neighbor's mean is ~one voxel to the right
    assert float(mu1[0, 0] - mu0[0, 0]) == pytest.approx(0.25, abs=0.1)


def test_gauss_constants_match_published_form():
    """Magnusson eq. 6.8 at PCL defaults: d1 < 0, d2 > 0, finite."""
    d1, d2 = gauss_d1_d2(0.55, 1.0)
    assert d1 < 0 and np.isfinite(d1)
    assert d2 > 0 and np.isfinite(d2)


def test_ndt_registers_small_displacement():
    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt.apply(scene.source)
    res = run_ndt(scene.source, tgt, NDTConfig(voxel_size=0.4,
                                               max_iterations=60))
    assert bool(res.converged)
    assert float(res.matched_fraction) > 0.9
    # NDT converges to the voxel-field optimum (~1e-3 scale), not ICP's 1e-6
    assert float(f.transform_rmse(res.transform, gt, scene.source)) < 5e-3


def test_ndt_prebuilt_grid_reuse():
    """Map-tracking pattern: one grid, many registrations."""
    scene = f.synthetic_scene(width=32)
    cfg = NDTConfig(voxel_size=0.5, max_iterations=40)
    grid = f.build_ndt_grid(scene.source, cfg.voxel_size)
    for seed in (3, 4):
        rng = np.random.default_rng(seed)
        ang = 0.01 * rng.standard_normal(3)
        tr = 0.02 * rng.standard_normal(3)
        gt = f.gt_transform(tuple(ang), tuple(tr))
        # register the PERTURBED source back onto the original (grid target)
        res = run_ndt(gt.apply(scene.source), scene.source, cfg, grid=grid)
        err = float(f.transform_rmse(res.transform, gt.inverse(),
                                     gt.apply(scene.source)))
        assert err < 5e-3, err


def test_register_ndt_wide_basin_plus_refine():
    """Large displacement: NDT coarse-to-fine init + ICP refine hits the
    exact-ICP contract."""
    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.25, -0.2, 0.15), (0.3, -0.25, 0.2))
    tgt = gt.apply(scene.source)
    res = register_ndt(scene.source, tgt,
                       f.ICPConfig(max_iterations=40))
    assert float(f.transform_rmse(res.transform, gt, scene.source)) < 1e-5


def test_ndt_config_validation():
    with pytest.raises(ValueError, match="voxel_size"):
        NDTConfig(voxel_size=-1.0)
    with pytest.raises(ValueError, match="outlier_ratio"):
        NDTConfig(outlier_ratio=1.5)
    with pytest.raises(ValueError, match="neighborhood"):
        NDTConfig(neighborhood="direct27")


def test_ndt_masked_target():
    """Padded target rows don't contaminate voxel stats."""
    rng = np.random.default_rng(5)
    pts = rng.uniform(0, 1.0, (1000, 3)).astype(np.float32)
    junk = np.full((200, 3), 0.123, np.float32)  # would form a fake voxel
    padded = jnp.asarray(np.concatenate([pts, junk]))
    mask = jnp.asarray(np.concatenate([np.ones(1000, bool),
                                       np.zeros(200, bool)]))
    g_mask = build_ndt_grid(padded, 0.25, mask)
    g_ref = build_ndt_grid(jnp.asarray(pts), 0.25)
    assert int(g_mask.valid.sum()) == int(g_ref.valid.sum())
    # same voxel means for the real points
    mu_m = np.asarray(g_mask.mu)[np.asarray(g_mask.valid)]
    mu_r = np.asarray(g_ref.mu)[np.asarray(g_ref.valid)]
    np.testing.assert_allclose(np.sort(mu_m, axis=0),
                               np.sort(mu_r, axis=0), atol=1e-5)


def test_lookup_offset_off_grid_is_miss():
    """Stepping a neighbor offset off the min face must MISS, not clip
    back into the boundary voxel (review finding r2: double counting)."""
    rng = np.random.default_rng(7)
    pts = rng.uniform(0, 1.0, (3000, 3)).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    corner = jnp.asarray([[0.01, 0.01, 0.01]])  # min-corner voxel
    _, _, hit0 = ndt_lookup(corner, grid)
    _, _, hit_m = ndt_lookup(corner, grid, cell_offset=jnp.asarray([-1, 0, 0]))
    assert bool(hit0[0])
    assert not bool(hit_m[0])


def test_out_of_range_cloud_not_aliased():
    """Points beyond the 10-bit grid range are dropped from the build and
    miss on lookup — never aliased into boundary mega-voxels."""
    rng = np.random.default_rng(8)
    near = rng.uniform(0, 1.0, (2000, 3)).astype(np.float32)
    far = near + np.float32(500.0)  # ~2000 cells away at h=0.25
    both = jnp.asarray(np.concatenate([near, far]))
    grid = build_ndt_grid(both, 0.25)
    _, _, hit_far = ndt_lookup(jnp.asarray(far), grid)
    assert not bool(hit_far.any())
    _, _, hit_near = ndt_lookup(jnp.asarray(near), grid)
    assert float(hit_near.mean()) > 0.9


def test_disjoint_clouds_not_converged():
    """Zero matched fraction => converged must be False (review finding)."""
    rng = np.random.default_rng(9)
    a = jnp.asarray(rng.uniform(0, 1, (1000, 3)).astype(np.float32))
    b = a + 100.0
    res = run_ndt(a, b, NDTConfig(voxel_size=0.25, max_iterations=10))
    assert float(res.matched_fraction) == 0.0
    assert not bool(res.converged)


@pytest.mark.parametrize("offset", [0.0, 50.0, 500.0])
def test_ndt_far_from_origin(offset):
    """Global-frame coordinates (advisor finding r2): the identical local
    scene must register equally well at |x|~500 as at the origin. Before
    the fix, E[xx^T]-mu mu^T cancellation corrupted sinv (~97% error at
    +500) and the origin-anchored GN rotation block went indefinite in
    f32, NaN-poisoning the pose."""
    scene = f.synthetic_scene(width=48)
    src = scene.source + jnp.float32(offset)
    # identical LOCAL problem at every offset: rotate about the cloud
    # center, not the world origin (an origin-anchored rotation at +500
    # would displace the cloud by |dtheta|*500 ~ 13 units — a different,
    # unsolvable problem, not a conditioning probe)
    center = jnp.mean(src, axis=0)
    gt_local = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt_local.apply(src - center) + center
    res = run_ndt(src, tgt, NDTConfig(voxel_size=0.4, max_iterations=60))
    assert bool(jnp.isfinite(res.transform.translation).all())
    assert bool(res.converged)
    # compare recovered vs GT action on the actual points
    err = float(jnp.sqrt(jnp.mean(jnp.sum(
        (res.transform.apply(src) - tgt) ** 2, axis=1))))
    assert err < 5e-3, f"offset {offset}: {err}"


def test_ndt_grid_covariance_far_from_origin():
    """Voxel sinv at a +500 offset must match the origin's (advisor
    finding r2: f32 second-moment cancellation)."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(0, 1.0, (4000, 3)).astype(np.float32)
    g0 = build_ndt_grid(jnp.asarray(pts), 0.25)
    g5 = build_ndt_grid(jnp.asarray(pts + np.float32(500.0)), 0.25)
    v0 = np.asarray(g0.valid)
    v5 = np.asarray(g5.valid)
    assert v0.sum() == v5.sum()
    s0 = np.asarray(g0.sinv)[v0]
    s5 = np.asarray(g5.sinv)[v5]
    # same voxel order (keys sort identically for a pure translation)
    np.testing.assert_allclose(s5, s0, rtol=0.05,
                               atol=1e-3 * np.abs(s0).max())


def test_run_ndt_grid_voxel_size_mismatch_raises():
    """Passing a prebuilt grid plus a DIFFERING explicit voxel_size is an
    error (advisor finding r2: silent d1/d2 vs lookup mismatch)."""
    scene = f.synthetic_scene(width=24)
    grid = f.build_ndt_grid(scene.source, 0.5)
    with pytest.raises(ValueError, match="voxel_size"):
        run_ndt(scene.source, scene.source,
                NDTConfig(voxel_size=0.3), grid=grid)
    # matching explicit size is fine
    res = run_ndt(scene.source, scene.source,
                  NDTConfig(voxel_size=0.5, max_iterations=5), grid=grid)
    assert bool(jnp.isfinite(res.errors[0]))


def test_register_ndt_hall_scan():
    """Real LiDAR: NDT init + plane ICP refine on the Ouster hall scan
    recovers the GT transform (auto voxel sizing from real spacing)."""
    from fpcr_tpu.data.ouster import hall_scene

    scene = hall_scene()
    res = register_ndt(scene.source, scene.target,
                       f.ICPConfig(metric="plane", max_iterations=40))
    assert float(f.transform_rmse(res.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_banded_lookup_matches_gather():
    """ndt_lookup_banded == ndt_lookup exactly on voxel-key-coherent
    inputs (every offset of the direct7 neighborhood)."""
    from fpcr_tpu.ops.ndt import cell_key_order, ndt_lookup_banded

    rng = np.random.default_rng(21)
    pts = rng.uniform(0, 2.0, (6000, 3)).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    src = jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32))
    src = jnp.take(src, cell_key_order(src, grid), axis=0)
    offsets = [None, (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
               (0, 0, 1), (0, 0, -1)]
    for off in offsets:
        o = None if off is None else jnp.asarray(off, jnp.int32)
        mu_g, si_g, hit_g = ndt_lookup(src, grid, cell_offset=o)
        mu_b, si_b, hit_b = ndt_lookup_banded(src, grid, cell_offset=o,
                                              chunk=256, window=256)
        hg, hb = np.asarray(hit_g), np.asarray(hit_b)
        # banded may only MISS extra (band edge), never fabricate a hit
        assert not (hb & ~hg).any(), off
        # on coherent uniform data the band covers everything
        agree = hb == hg
        assert agree.mean() > 0.999, (off, 1 - agree.mean())
        both = hb & hg
        np.testing.assert_array_equal(np.asarray(mu_b)[both],
                                      np.asarray(mu_g)[both])
        np.testing.assert_array_equal(np.asarray(si_b)[both],
                                      np.asarray(si_g)[both])


def test_run_ndt_banded_registers():
    """The banded lookup drives the full NDT loop to the same quality as
    the gather path."""
    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt.apply(scene.source)
    res_g = run_ndt(scene.source, tgt,
                    NDTConfig(voxel_size=0.4, max_iterations=60,
                              lookup="gather"))
    res_b = run_ndt(scene.source, tgt,
                    NDTConfig(voxel_size=0.4, max_iterations=60,
                              lookup="banded", lookup_chunk=256,
                              lookup_window=256))
    assert bool(res_b.converged)
    e_g = float(f.transform_rmse(res_g.transform, gt, scene.source))
    e_b = float(f.transform_rmse(res_b.transform, gt, scene.source))
    assert e_b < 5e-3, e_b
    assert e_b < 2.0 * e_g + 1e-4, (e_b, e_g)
    # points come back in the ORIGINAL row order despite the internal sort
    np.testing.assert_allclose(
        np.asarray(res_b.points),
        np.asarray(res_b.transform.apply(scene.source)), atol=1e-6)


def _sheets_cloud(rng):
    """Plane-dominant cloud: dense (y, z) sheets at six x stations, so each
    x-plane of the voxel table holds hundreds of rows."""
    ys, zs = np.meshgrid(np.linspace(0, 5.0, 40, dtype=np.float32),
                         np.linspace(0, 5.0, 40, dtype=np.float32),
                         indexing="ij")
    sheets = [np.stack([np.full(ys.size, 0.25 * xi, np.float32),
                        ys.ravel(), zs.ravel()], 1) for xi in range(6)]
    pts = np.concatenate(sheets)
    return pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)


_GEOMETRIES = {
    "uniform_cube": lambda rng: rng.uniform(0, 2.0, (4000, 3)),
    "far_from_origin": lambda rng: rng.uniform(0, 2.0, (4000, 3))
    + np.array([300.0, -200.0, 150.0]),
    "surface": lambda rng: np.asarray(f.synthetic_scene(width=64).source),
    "sheets": _sheets_cloud,
}


@pytest.mark.parametrize("geometry", sorted(_GEOMETRIES))
def test_banded_lookup_matches_gather_geometries(geometry):
    """On voxel-key-sorted queries the band lookup returns the gather
    lookup's rows exactly, and misses only where the band cannot reach
    (never a fabricated hit), across geometries with small and large
    x-planes."""
    from fpcr_tpu.ops.ndt import cell_key_order, ndt_lookup_banded

    rng = np.random.default_rng(41)
    pts = _GEOMETRIES[geometry](rng).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    src = jnp.asarray(pts + rng.normal(0, 0.02, pts.shape).astype(np.float32))
    src = jnp.take(src, cell_key_order(src, grid), axis=0)
    for off in (None, (1, 0, 0), (0, 0, -1)):
        o = None if off is None else jnp.asarray(off, jnp.int32)
        mu_g, si_g, hit_g = ndt_lookup(src, grid, cell_offset=o)
        mu_b, si_b, hit_b = ndt_lookup_banded(src, grid, cell_offset=o,
                                              chunk=256, window=512)
        hg, hb = np.asarray(hit_g), np.asarray(hit_b)
        assert hg.any(), (geometry, off)
        assert not (hb & ~hg).any(), (geometry, off)
        assert (hb == hg).mean() > 0.99, (geometry, off)
        both = hb & hg
        np.testing.assert_array_equal(np.asarray(mu_b)[both],
                                      np.asarray(mu_g)[both])
        np.testing.assert_array_equal(np.asarray(si_b)[both],
                                      np.asarray(si_g)[both])


@pytest.mark.parametrize("method", ["scan", "sort"])
def test_gather_lookup_search_methods_agree(method):
    """Both searchsorted algorithms give the same voxel rows (the GPU's
    choice between them is a speed question only)."""
    rng = np.random.default_rng(42)
    pts = rng.uniform(0, 2.0, (3000, 3)).astype(np.float32)
    grid = build_ndt_grid(jnp.asarray(pts), 0.25)
    q = jnp.asarray(rng.uniform(-0.3, 2.3, (2000, 3)).astype(np.float32))
    for off in (None, jnp.asarray((0, 1, 0), jnp.int32)):
        ref = ndt_lookup(q, grid, cell_offset=off, method="compare_all")
        got = ndt_lookup(q, grid, cell_offset=off, method=method)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("width,voxel", [(40, 0.4), (56, 0.3)])
def test_run_ndt_banded_equals_gather(width, voxel):
    """The banded and gather lookups drive the full NDT loop to the same
    pose on near-registered surface scans."""
    scene = f.synthetic_scene(width=width)
    gt = f.gt_transform((0.01, -0.008, 0.006), (0.02, -0.015, 0.01))
    tgt = gt.apply(scene.source)
    out = {}
    for lookup in ("gather", "banded"):
        out[lookup] = run_ndt(scene.source, tgt,
                              NDTConfig(voxel_size=voxel, max_iterations=40,
                                        lookup=lookup, lookup_chunk=256,
                                        lookup_window=256))
    for res in out.values():
        assert float(f.transform_rmse(res.transform, gt,
                                      scene.source)) < 5e-3
    np.testing.assert_allclose(
        np.asarray(out["banded"].transform.rotation),
        np.asarray(out["gather"].transform.rotation), atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(out["banded"].transform.translation),
        np.asarray(out["gather"].transform.translation), atol=1e-4)


def test_config_rejects_bad_lookup_geometry():
    with pytest.raises(ValueError):
        NDTConfig(voxel_size=0.2, lookup_chunk=0)
    with pytest.raises(ValueError):
        NDTConfig(voxel_size=0.2, lookup_window=-1)
    # any positive chunk is a valid band height for the XLA band path
    assert NDTConfig(voxel_size=0.2, lookup_chunk=100).lookup_chunk == 100


def test_run_ndt_composes_under_outer_jit_with_prebuilt_grid():
    """The map-tracking shape, fully jitted: run_ndt(scan, map, grid=g)
    inside an outer jax.jit, the grid passed as a traced pytree. The grid's
    voxel_size is abstract at trace time, so the caller must assert the
    resolution via config.voxel_size (checked against the grid when
    concrete; trusted when traced)."""
    import jax

    scene = f.synthetic_scene(width=24)
    cfg = NDTConfig(voxel_size=0.3, max_iterations=25, lookup="gather")
    grid = f.build_ndt_grid(scene.source, cfg.voxel_size)

    @jax.jit
    def track(scan, map_cloud, g):
        return run_ndt(scan, map_cloud, cfg, grid=g).transform

    gt = f.gt_transform((0.02, -0.01, 0.015), (0.01, -0.02, 0.01))
    scan = gt.apply(scene.source)
    tf = track(scan, scene.source, grid)
    assert float(f.transform_rmse(tf, gt.inverse(), scan)) < 5e-3

    # traced grid without an explicit voxel_size: a clear error, not a
    # ConcretizationTypeError from float()
    bad_cfg = NDTConfig(max_iterations=5, lookup="gather")

    @jax.jit
    def bad(scan, map_cloud, g):
        return run_ndt(scan, map_cloud, bad_cfg, grid=g).transform

    with pytest.raises(ValueError, match="explicit config.voxel_size"):
        bad(scene.target, scene.source, grid)


def test_resolve_ndt_config_streaming_fast_path():
    """resolve_ndt_config pins lookup='auto' once for a representative
    scan; run_ndt with the pinned config produces the same registration."""
    scene = f.synthetic_scene(width=48)
    grid = build_ndt_grid(scene.source, 0.3)
    base = NDTConfig(voxel_size=0.3, max_iterations=25)
    resolved = f.resolve_ndt_config(base, grid, scene.source)
    assert resolved.lookup == "gather"  # 2,304 points < lookup_threshold
    big = f.resolve_ndt_config(
        dataclasses.replace(base, lookup_threshold=1000), grid, scene.source)
    assert big.lookup == "banded"

    gt = f.gt_transform((0.02, -0.01, 0.015), (0.01, -0.02, 0.01))
    scan = gt.apply(scene.source)
    res_resolved = run_ndt(scan, scene.source, resolved, grid=grid)
    res_fresh = run_ndt(scan, scene.source, base, grid=grid)
    np.testing.assert_allclose(np.asarray(res_resolved.transform.rotation),
                               np.asarray(res_fresh.transform.rotation),
                               atol=1e-6)
    err = float(f.transform_rmse(res_resolved.transform, gt.inverse(), scan))
    assert err < 5e-3, err
