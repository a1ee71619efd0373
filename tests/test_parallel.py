"""Multi-chip ICP on the virtual 8-device CPU mesh: parity vs single device."""

import jax
import numpy as np
import pytest

import fpcr_tpu as f
from fpcr_tpu.parallel.dist_icp import distributed_icp, make_mesh


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest should force 8 CPU devices"
    return make_mesh(8)


def test_mesh_creation(mesh8):
    assert mesh8.devices.size == 8
    assert mesh8.axis_names == ("points",)


def test_distributed_p2p_matches_single_device(mesh8):
    scene = f.synthetic_scene(width=32)
    cfg = f.ICPConfig(max_iterations=60)
    single = f.run_icp(scene.source, scene.target, cfg)
    dist = distributed_icp(scene.source, scene.target, cfg, mesh=mesh8)
    assert int(dist.num_iterations) == int(single.num_iterations)
    np.testing.assert_allclose(
        np.asarray(dist.transform.rotation),
        np.asarray(single.transform.rotation), atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(dist.transform.translation),
        np.asarray(single.transform.translation), atol=1e-5,
    )
    assert float(f.transform_rmse(dist.transform, scene.ground_truth, scene.source)) < 1e-5


def test_distributed_handles_non_divisible_n(mesh8):
    """N not a multiple of the shard count → padded + masked internally."""
    rng = np.random.default_rng(9)
    src = rng.uniform(-1, 1, size=(1003, 3)).astype(np.float32)  # prime-ish
    gt = f.gt_transform((0.05, -0.02, 0.04), (0.04, 0.02, -0.03))
    import jax.numpy as jnp

    tgt = gt.apply(jnp.asarray(src))
    dist = distributed_icp(jnp.asarray(src), tgt, f.ICPConfig(max_iterations=40), mesh=mesh8)
    assert float(f.transform_rmse(dist.transform, gt, jnp.asarray(src))) < 1e-4
    assert dist.points.shape == (1003, 3)


def test_distributed_plane_metric(mesh8):
    scene = f.synthetic_scene(width=24)
    cfg = f.ICPConfig(metric="plane", max_iterations=40)
    dist = distributed_icp(scene.source, scene.target, cfg, mesh=mesh8)
    assert float(f.transform_rmse(dist.transform, scene.ground_truth, scene.source)) < 1e-4


def test_distributed_smaller_mesh():
    mesh2 = make_mesh(2)
    scene = f.synthetic_scene(width=16)
    dist = distributed_icp(scene.source, scene.target,
                           f.ICPConfig(max_iterations=40), mesh=mesh2)
    assert float(f.transform_rmse(dist.transform, scene.ground_truth, scene.source)) < 1e-4


def test_distributed_morton_matcher(mesh8):
    """Morton matcher under shard_map: per-shard local sort + banded match,
    psum'd moments; matches GT."""
    import jax.numpy as jnp

    rng = np.random.default_rng(31)
    src = jnp.asarray(rng.uniform(-2, 2, (4096, 3)).astype(np.float32))
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.002, -0.003, 0.002))
    tgt = gt.apply(src)
    cfg = f.ICPConfig(matcher="morton", max_iterations=20)
    dist = distributed_icp(src, tgt, cfg, mesh=mesh8)
    assert float(f.transform_rmse(dist.transform, gt, src)) < 1e-4


@pytest.mark.parametrize("metric", ["point", "plane", "gicp"])
def test_distributed_morton_metrics_match_single_device(mesh8, metric):
    """The large-N path of every ICP metric under shard_map (XLA band
    matcher, per-shard source sort, psum'd moments) reproduces the
    single-device registration."""
    import jax.numpy as jnp

    src = f.synthetic_scene(width=48).source
    gt = f.gt_transform((0.004, -0.003, 0.002), (0.002, -0.003, 0.002))
    tgt = gt.apply(src)
    cfg = f.ICPConfig(metric=metric, matcher="morton", max_iterations=20)
    single = f.run_icp(src, tgt, cfg)
    dist = distributed_icp(src, tgt, cfg, mesh=mesh8)
    assert float(f.transform_rmse(dist.transform, single.transform,
                                  src)) < 1e-5
    assert float(f.transform_rmse(dist.transform, gt, src)) < 1e-4
    assert dist.points.shape == src.shape
    assert isinstance(dist.points, jnp.ndarray)


def test_distributed_observability_replicated(mesh8):
    """matched_fraction / delta-transform come out of the sharded loop
    replicated and already psum-normalized."""
    scene = f.synthetic_scene(width=16)
    dist = distributed_icp(scene.source, scene.target,
                           f.ICPConfig(max_iterations=20), mesh=mesh8)
    ni = int(dist.num_iterations)
    frac = np.asarray(dist.matched_fraction)[:ni]
    assert np.allclose(frac, 1.0), frac
    assert np.isfinite(np.asarray(dist.delta_t)[:ni]).all()


def test_distributed_ndt_matches_single_device(mesh8):
    """NDT's H/g/counter psums ride the same mesh axis as ICP's moments."""
    from fpcr_tpu.models.ndt import NDTConfig, run_ndt
    from fpcr_tpu.parallel.dist_icp import distributed_ndt

    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt.apply(scene.source)
    cfg = NDTConfig(voxel_size=0.4, max_iterations=50)
    single = run_ndt(scene.source, tgt, cfg)
    dist = distributed_ndt(scene.source, tgt, cfg, mesh=mesh8)
    # 1e-5 (not 1e-6): the 8-shard psum reduces in a different order than
    # the flat single-device sum, and f32 reassociation noise over ~9k
    # moments sits right at 1e-6 — the sibling banded/fused parity tests
    # already use this tolerance
    np.testing.assert_allclose(np.asarray(dist.transform.rotation),
                               np.asarray(single.transform.rotation),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dist.transform.translation),
                               np.asarray(single.transform.translation),
                               atol=1e-5)
    assert float(dist.matched_fraction) > 0.9
    assert float(f.transform_rmse(dist.transform, gt, scene.source)) < 5e-3


def test_distributed_ndt_banded_lookup(mesh8):
    """The banded (gather-free) lookup under shard_map: the global
    voxel-key sort happens BEFORE sharding, so each shard holds a
    coherent block; results match the single-device banded run and the
    returned points come back in original row order."""
    from fpcr_tpu.models.ndt import NDTConfig, run_ndt
    from fpcr_tpu.parallel.dist_icp import distributed_ndt

    scene = f.synthetic_scene(width=48)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    tgt = gt.apply(scene.source)
    cfg = NDTConfig(voxel_size=0.4, max_iterations=50, lookup="banded",
                    lookup_chunk=256, lookup_window=256)
    single = run_ndt(scene.source, tgt, cfg)
    dist = distributed_ndt(scene.source, tgt, cfg, mesh=mesh8)
    np.testing.assert_allclose(np.asarray(dist.transform.rotation),
                               np.asarray(single.transform.rotation),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(dist.transform.translation),
                               np.asarray(single.transform.translation),
                               atol=1e-5)
    assert float(f.transform_rmse(dist.transform, gt, scene.source)) < 5e-3
    # original row order despite the internal coherence sort
    np.testing.assert_allclose(
        np.asarray(dist.points),
        np.asarray(dist.transform.apply(scene.source)), atol=1e-5)


@pytest.mark.parametrize("lookup", ["gather", "banded"])
def test_distributed_ndt_spreads_over_mesh(mesh8, lookup):
    """Both NDT lookups under shard_map: the sharded output lives on every
    device of the mesh (nothing lands on device 0 only) and recovers the
    pose."""
    from fpcr_tpu.models.ndt import NDTConfig
    from fpcr_tpu.parallel.dist_icp import distributed_ndt

    scene = f.synthetic_scene(width=40)
    gt = f.gt_transform((0.02, -0.015, 0.01), (0.03, -0.02, 0.015))
    cfg = NDTConfig(voxel_size=0.4, max_iterations=40, lookup=lookup,
                    lookup_chunk=128, lookup_window=256)
    dist = distributed_ndt(scene.source, gt.apply(scene.source), cfg,
                           mesh=mesh8)
    assert float(f.transform_rmse(dist.transform, gt, scene.source)) < 5e-3
    assert len(dist.transform.rotation.sharding.device_set) == 8


@pytest.mark.slow
def test_multihost_two_process_dryrun():
    """Real multi-controller validation: 2 OS processes x 4 virtual CPU
    devices through jax.distributed + the standard sharded loop
    (scripts/multihost_dryrun.py). SURVEY §2.4's DCN axis, exercised."""
    import pathlib
    import subprocess
    import sys

    script = pathlib.Path(__file__).resolve().parents[1] / "scripts" / "multihost_dryrun.py"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("MULTIHOST OK") == 2, out.stdout
