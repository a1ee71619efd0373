"""The fused Triton brute matcher against the XLA path and numpy (Pallas
interpret mode on the CPU; the compiled kernel runs in chip_smoke.py)."""

import numpy as np
import jax.numpy as jnp
import pytest

from fpcr_tpu.ops.matching import nn_argmin
from fpcr_tpu.ops.matching_pallas import nn_argmin_pallas

from helpers import np_nn


def _nn(p, q, mask=None, **kw):
    return nn_argmin_pallas(jnp.asarray(p), jnp.asarray(q),
                            None if mask is None else jnp.asarray(mask),
                            interpret=True, **kw)


@pytest.fixture
def clouds():
    rng = np.random.default_rng(77)
    p = rng.uniform(-2, 2, size=(300, 3)).astype(np.float32)
    q = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    return p, q


def test_pallas_matches_numpy(clouds):
    p, q = clouds
    idx, d = _nn(p, q)
    ref_idx, ref_d = np_nn(p, q)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(d), ref_d, atol=1e-5)


def test_pallas_matches_xla_path(clouds):
    """Same difference-form f32 arithmetic as nn_argmin(exact=True)."""
    p, q = clouds
    idx_p, d_p = _nn(p, q)
    idx_x, d_x = nn_argmin(jnp.asarray(p), jnp.asarray(q), exact=True)
    np.testing.assert_array_equal(np.asarray(idx_p), np.asarray(idx_x))
    np.testing.assert_allclose(np.asarray(d_p), np.asarray(d_x), rtol=1e-6)


def test_pallas_target_mask(clouds):
    p, q = clouds
    mask = np.ones(q.shape[0], bool)
    mask[200:] = False
    idx, d = _nn(p, q, mask)
    ref_idx, ref_d = np_nn(p, q[:200])
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(d), ref_d, atol=1e-5)


def test_pallas_tie_break_first_min():
    p = jnp.asarray([[0.0, 0.0, 0.0]], dtype=jnp.float32)
    q = jnp.asarray([[5, 0, 0], [1, 0, 0], [2, 0, 0], [1, 0, 0]],
                    dtype=jnp.float32)
    idx, _ = nn_argmin_pallas(p, q, interpret=True)
    assert int(idx[0]) == 1


def test_pallas_odd_sizes():
    """Non-multiple-of-block sizes pad correctly."""
    rng = np.random.default_rng(78)
    p = rng.uniform(-1, 1, size=(131, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, size=(259, 3)).astype(np.float32)
    idx, d = _nn(p, q)
    ref_idx, _ = np_nn(p, q)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)


def test_pallas_in_icp_loop(monkeypatch):
    """ICP with matcher='pallas' (the kernel interpreted here) takes the
    same steps as the exact XLA matcher and recovers the pose."""
    import functools

    import fpcr_tpu as f
    from fpcr_tpu.ops import matching_pallas

    monkeypatch.setattr(matching_pallas, "nn_argmin_pallas", functools.partial(
        matching_pallas.nn_argmin_pallas, interpret=True))
    scene = f.synthetic_scene(width=14)
    res_p = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(max_iterations=37, matcher="pallas"))
    res_x = f.run_icp(scene.source, scene.target,
                      f.ICPConfig(max_iterations=37, exact_distances=True))
    assert int(res_p.num_iterations) == int(res_x.num_iterations)
    np.testing.assert_allclose(np.asarray(res_p.errors),
                               np.asarray(res_x.errors), rtol=1e-5, atol=1e-9)
    assert float(f.transform_rmse(res_p.transform, scene.ground_truth,
                                  scene.source)) < 1e-5


def test_pallas_in_icp_loop_needs_gpu():
    """matcher='pallas' names the GPU kernel: on the CPU it refuses with a
    clear error instead of falling back to the interpreter."""
    import fpcr_tpu as f

    scene = f.synthetic_scene(width=16)
    with pytest.raises(ValueError, match="GPU kernel"):
        f.icp_point_to_point(
            scene.source, scene.target,
            config=f.ICPConfig(max_iterations=5, matcher="pallas"))


def test_pallas_all_masked_target_returns_inf(clouds):
    """No valid target => index 0 and dmin inf, nn_argmin's convention."""
    p, q = clouds
    mask = np.zeros(q.shape[0], bool)
    idx, d = _nn(p, q, mask)
    assert np.isinf(np.asarray(d)).all()
    assert (np.asarray(idx) == 0).all()
    _, d_ref = nn_argmin(jnp.asarray(p), jnp.asarray(q), jnp.asarray(mask))
    assert np.isinf(np.asarray(d_ref)).all()


@pytest.mark.parametrize("n,m,block_n,block_m", [
    (1, 1, 64, 64),       # single point each
    (7, 300, 64, 64),     # N < block_n
    (64, 64, 64, 64),     # exact single block
    (65, 129, 64, 64),    # one past a block on both sides
    (200, 1000, 16, 128),
    (333, 77, 32, 32),    # M < one tile after padding
])
def test_pallas_padding_shapes(n, m, block_n, block_m):
    rng = np.random.default_rng(n * 1000 + m)
    p = rng.uniform(-3, 3, size=(n, 3)).astype(np.float32)
    q = rng.uniform(-3, 3, size=(m, 3)).astype(np.float32)
    idx, d = _nn(p, q, block_n=block_n, block_m=block_m)
    assert idx.shape == (n,) and d.shape == (n,)
    assert idx.dtype == jnp.int32 and d.dtype == jnp.float32
    ref_idx, ref_d = np_nn(p, q)
    np.testing.assert_array_equal(np.asarray(idx), ref_idx)
    np.testing.assert_allclose(np.asarray(d), ref_d, atol=1e-5)


@pytest.mark.parametrize("block_m", [2, 4, 64])
def test_pallas_ties_across_tiles(block_m):
    """Equal minima in different tiles and columns: the lowest index wins,
    whichever tile holds it."""
    q = np.zeros((40, 3), np.float32)
    q[:, 0] = 5.0
    q[[3, 9, 17, 33], 0] = 1.0   # four equidistant minima
    p = np.zeros((5, 3), np.float32)
    idx, d = _nn(p, q, block_m=block_m)
    assert (np.asarray(idx) == 3).all()
    np.testing.assert_allclose(np.asarray(d), 1.0)


@pytest.mark.parametrize("pattern", ["first_half", "strided", "last_only"])
def test_pallas_mask_patterns(pattern):
    rng = np.random.default_rng(5)
    p = rng.uniform(-1, 1, size=(90, 3)).astype(np.float32)
    q = rng.uniform(-1, 1, size=(150, 3)).astype(np.float32)
    mask = np.zeros(150, bool)
    if pattern == "first_half":
        mask[:75] = True
    elif pattern == "strided":
        mask[::3] = True
    else:
        mask[-1] = True
    idx, d = _nn(p, q, mask, block_m=32)
    keep = np.flatnonzero(mask)
    ref_local, ref_d = np_nn(p, q[keep])
    np.testing.assert_array_equal(np.asarray(idx), keep[ref_local])
    np.testing.assert_allclose(np.asarray(d), ref_d, atol=1e-5)


def test_pallas_far_from_origin_no_cancellation():
    """Difference form: distances stay exact at global-frame coordinates,
    where the |p|² − 2p·q + |q|² expansion loses the small terms."""
    rng = np.random.default_rng(9)
    base = np.array([4000.0, -2500.0, 1200.0], np.float32)
    q = (rng.uniform(-1, 1, (256, 3)) * 0.05 + base).astype(np.float32)
    p = (q[::2] + 1e-3).astype(np.float32)
    idx, d = _nn(p, q)
    diff = p.astype(np.float64) - q[np.asarray(idx)].astype(np.float64)
    np.testing.assert_allclose(np.asarray(d), (diff ** 2).sum(1), rtol=1e-3)
    assert (np.asarray(idx) == np.arange(0, 256, 2)).all()


@pytest.mark.parametrize("bad", [
    dict(p_shape=(4, 2)),             # not 3-D
    dict(q_shape=(4, 33)),            # feature vectors
    dict(block_n=48),                 # not a power of two
    dict(block_m=100),
])
def test_pallas_rejects_bad_arguments(bad):
    p = jnp.zeros(bad.get("p_shape", (4, 3)), jnp.float32)
    q = jnp.zeros(bad.get("q_shape", (4, 3)), jnp.float32)
    kw = {k: v for k, v in bad.items() if k.startswith("block")}
    with pytest.raises(ValueError):
        nn_argmin_pallas(p, q, interpret=True, **kw)


def test_pallas_without_interpret_needs_gpu():
    p = jnp.zeros((4, 3), jnp.float32)
    with pytest.raises(ValueError, match="GPU kernel"):
        nn_argmin_pallas(p, p)


def test_scaled_icp_rejects_pallas_off_gpu():
    """The exhaustive-matcher family routes matcher='pallas' to the same
    kernel and the same clear refusal on the CPU."""
    import fpcr_tpu as f

    scene = f.synthetic_scene(width=12)
    with pytest.raises(ValueError, match="GPU kernel"):
        f.run_scaled_icp(scene.source, scene.target,
                         f.ICPConfig(matcher="pallas", max_iterations=3))
