"""platform helpers, multihost bounds, pipeline defaults, matching precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fpcr_tpu.parallel.multihost import initialize_multihost, local_shard_bounds
from fpcr_tpu.utils import platform as platform_utils
from fpcr_tpu.utils.platform import backend_name


def test_platform_helpers_cpu():
    assert backend_name() == "cpu"  # conftest forces cpu
    assert jax.default_backend() == backend_name()


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """JAX_COMPILATION_CACHE_DIR is JAX's own setting: the helper returns
    it and sets no other directory."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert platform_utils.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_fixed_dir_in_checkout(monkeypatch, restore_cache_dir):
    """Without the variable the cache is one fixed, git-ignored directory
    inside the checkout: never a temp or per-process path."""
    import os
    import tempfile

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = platform_utils.enable_compile_cache()
    assert platform_utils.enable_compile_cache() == first
    assert jax.config.jax_compilation_cache_dir == first
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert first == os.path.join(repo, ".jax_cache")
    assert not first.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in first
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_initialize_multihost_noop_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)
    assert initialize_multihost() is False


def test_local_shard_bounds_single_process():
    lo, hi = local_shard_bounds(1000)
    assert (lo, hi) == (0, 1000)


def test_matching_precision_default_vs_highest():
    from fpcr_tpu.ops.matching import pairwise_sqdist

    rng = np.random.default_rng(0)
    p = jnp.asarray(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    q = jnp.asarray(rng.uniform(-2, 2, (64, 3)).astype(np.float32))
    d_hi = np.asarray(pairwise_sqdist(p, q))
    d_lo = np.asarray(pairwise_sqdist(p, q, precision=jax.lax.Precision.DEFAULT))
    # on CPU both are f32 exact; the call path just must work
    np.testing.assert_allclose(d_hi, d_lo, rtol=1e-2, atol=1e-2)
    assert (d_hi >= 0).all()


def test_morton_unroll_variants_agree():
    from fpcr_tpu.ops.morton import build_morton_table, morton_nn, source_morton_order

    rng = np.random.default_rng(1)
    q = jnp.asarray(rng.uniform(-1, 1, (2048, 3)).astype(np.float32))
    p = q + 0.001
    table = build_morton_table(q)
    order = source_morton_order(p, table)
    ps = jnp.take(p, order, axis=0)
    m1, d1, i1, _ = morton_nn(ps, table, unroll=1)
    m8, d8, i8, _ = morton_nn(ps, table, unroll=8)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i8))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d8), atol=0)


def test_import_does_not_initialize_backend():
    """Importing fpcr_tpu must not create any XLA backend: multihost
    processes call jax.distributed.initialize() AFTER importing the
    library, which raises if an import-time jnp constant already
    initialized a backend (regression: ops/ndt.py's _KEY_PAD)."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", (
        "import fpcr_tpu\n"
        # _backends is a private JAX internal; if a future JAX moves it,
        # report SKIP rather than a phantom regression
        "try:\n"
        "    from jax._src import xla_bridge\n"
        "    backends = xla_bridge._backends\n"
        "except (ImportError, AttributeError):\n"
        "    print('SKIP-INTERNAL'); raise SystemExit(0)\n"
        "assert not backends, list(backends)\n"
        "print('CLEAN')")], capture_output=True, text=True, timeout=300,
        cwd=repo)
    assert out.returncode == 0 and (
        "CLEAN" in out.stdout or "SKIP-INTERNAL" in out.stdout), (
        out.stdout + out.stderr)


def test_evaluate_registration_metrics():
    """Fitness + inlier RMSE on a known alignment: aligned clouds evaluate
    to fitness 1 / ~0 RMSE; an unaligned pose drops fitness; outliers in
    the target don't change the source-side evaluation."""
    import fpcr_tpu as f

    scene = f.synthetic_scene(width=24)
    res = f.icp_point_to_point(scene.source, scene.target,
                               config=f.ICPConfig(max_iterations=40))
    ev = f.evaluate_registration(scene.source, scene.target, res.transform,
                                 max_correspondence_dist=0.05)
    assert float(ev["fitness"]) == 1.0
    assert float(ev["inlier_rmse"]) < 1e-4
    assert int(ev["num_inliers"]) == scene.source.shape[0]

    # identity transform on a displaced pair: most points miss the gate
    ev_bad = f.evaluate_registration(scene.source, scene.target, None,
                                     max_correspondence_dist=0.05)
    assert float(ev_bad["fitness"]) < 0.5
    # inlier RMSE never exceeds the gate
    assert float(ev_bad["inlier_rmse"]) <= 0.05 + 1e-6


def test_fit_unroll_contract():
    """Largest power-of-two divisor <= unroll; validates unroll >= 1."""
    import pytest

    from fpcr_tpu.core.cloud import fit_unroll

    assert fit_unroll(4, 6) == 4      # non-power-of-two unroll
    assert fit_unroll(4, 16) == 4
    assert fit_unroll(12, 8) == 4
    assert fit_unroll(7, 8) == 1      # odd chunk counts
    assert fit_unroll(64, 16) == 16
    with pytest.raises(ValueError):
        fit_unroll(4, 0)


def test_padded_chunks_restores_unroll():
    """Awkward chunk counts pad up (<=12.5% waste) so the static unroll
    survives; past that the natural count keeps its best divisor."""
    from fpcr_tpu.core.cloud import padded_chunks

    # the wide-plane smoke scene: 259,200 pts / 512 = 507 chunks (odd) —
    # fit_unroll gave 1 (one chunk per loop step); now pads 5 extra chunks
    # to 512 and keeps u=8
    assert padded_chunks(259_200, 512, 8) == (512, 8)
    assert padded_chunks(1_048_576, 512, 8) == (2048, 8)
    assert padded_chunks(16_384, 512, 8) == (32, 8)
    # tiny inputs: padding 2 -> 8 chunks would 4x the work — keep 2, u=2
    assert padded_chunks(1_000, 512, 8) == (2, 2)
    assert padded_chunks(100, 512, 8) == (1, 1)
    # exactly one chunk short of a multiple always pads (waste <= 1 chunk)
    assert padded_chunks(512 * 7, 512, 8) == (8, 8)


def test_evaluate_registration_auto_threshold():
    """max_correspondence_dist=None resolves to 2x the target's median
    spacing — scale-free fitness: the same aligned pair evaluates to
    fitness 1 at ANY scene scale."""
    import fpcr_tpu as f

    scene = f.synthetic_scene(width=20)
    res = f.icp_point_to_point(scene.source, scene.target,
                               config=f.ICPConfig(max_iterations=40))
    for s in (1.0, 100.0):
        ev = f.evaluate_registration(scene.source * s, scene.target * s,
                                     f.RigidTransform(res.transform.rotation,
                                                      res.transform.translation * s))
        assert float(ev["fitness"]) == 1.0, s
        assert float(ev["max_correspondence_dist"]) > 0
