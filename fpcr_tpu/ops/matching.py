"""Brute-force nearest-neighbor correspondence search in XLA.

This replaces the reference's ``Matching`` CUDA kernel family
(/root/reference/src/ICP_standard.cu:21-39 naive;
/root/reference/src/CUDA/ICP_point_to_point_clean.cu:32-73 optimized ladder:
sqrt dropped, pow -> mult, query point in registers, split j-loop). The CUDA
design is one scalar thread per source point scanning all targets (the
fused GPU kernel in ``ops/matching_pallas.py`` keeps that shape). Here the
O(N·M) distance computation is reformulated for XLA so the dominant term
``-2 P·Qᵀ`` is a matmul:

    d(i, j) = |p_i|² - 2 p_i·q_j + |q_j|²   (sqrt dropped: monotone, same
    argmin — the reference applies the identical optimization at
    /root/reference/src/CUDA/Matching_opt.cu:15-56)

and the argmin runs as a *streaming* reduction over target tiles, so the
``[N, M]`` distance matrix is never materialized in HBM (unlike the
reference's kNN path which allocates the full N·M float matrix,
/root/reference/src/CUDA/ICP_point_to_plane_clean.cu:442).

Tie-breaking parity: the reference keeps the *first* minimum (strict ``<``,
/root/reference/src/CUDA/ICP_point_to_point_clean.cu:53-57). ``jnp.argmin``
returns the first occurrence inside a tile, and the cross-tile combine uses
strict ``<`` with tiles visited in index order, so the first global minimum
wins here too. Unmatched rows (all-masked target) get index 0 — the reference
leaves ``idx[i]`` unwritten in that (impossible on its data) case
(SURVEY.md §8).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.cloud import round_up

# plain python float: a module-level jnp scalar would eagerly
# initialize the backend (and could leak a tracer) at import time.
_BIG = float("inf")


def pairwise_sqdist(p: jnp.ndarray, q: jnp.ndarray,
                    precision=None) -> jnp.ndarray:
    """Squared Euclidean distances ``[n, m]`` via the MXU-friendly
    ``|p|² - 2p·q + |q|²`` expansion (f32 accumulation).

    ``precision=None`` → HIGHEST (full f32: bf16/TF32 passes perturb
    distances ~0.4% and break argmin parity near ties). Pass
    ``jax.lax.Precision.DEFAULT`` for the fast bf16 path when approximate
    matches are acceptable (ICP self-corrects across iterations)."""
    p_sq = jnp.sum(p * p, axis=-1, keepdims=True)  # [n, 1]
    q_sq = jnp.sum(q * q, axis=-1)  # [m]
    cross = jax.lax.dot_general(
        p, q,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision or jax.lax.Precision.HIGHEST,
    )  # [n, m] on the MXU
    # clamp: f32 cancellation can drive near-zero distances slightly
    # negative, which breaks downstream robust statistics
    return jnp.maximum(p_sq - 2.0 * cross + q_sq[None, :], 0.0)


def pairwise_sqdist_exact(p: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
    """Difference-form distances (the reference kernel's exact arithmetic,
    /root/reference/src/CUDA/Matching_opt.cu:29-45). VPU-bound; use for small
    tiles or when exact cancellation-free values matter."""
    diff = p[:, None, :] - q[None, :, :]
    return jnp.sum(diff * diff, axis=-1)


def _pad_to(x: jnp.ndarray, size: int, value) -> jnp.ndarray:
    n = x.shape[0]
    if n == size:
        return x
    pad_width = [(0, size - n)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, pad_width, constant_values=value)


@functools.partial(
    jax.jit,
    static_argnames=("source_chunk", "target_tile", "exact"),
)
def nn_argmin(
    p: jnp.ndarray,
    q: jnp.ndarray,
    q_mask: Optional[jnp.ndarray] = None,
    *,
    source_chunk: int = 2048,
    target_tile: int = 2048,
    exact: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """For every source point, the index of its nearest target point.

    Args:
      p: ``[N, D]`` source points (D=3 clouds, or feature vectors — the
        search is dimension-generic; the D-dim cross terms ride the MXU).
      q: ``[M, D]`` target points.
      q_mask: optional ``[M]`` validity mask for padded targets.
      source_chunk / target_tile: streaming tile sizes; memory footprint is
        ``O(source_chunk * target_tile)``, never ``O(N·M)``.
      exact: use difference-form distances instead of the matmul expansion.

    Returns:
      ``(idx int32[N], dmin float32[N])`` — nearest index and its *squared*
      distance (the reference also works in squared distances).
    """
    n, m = p.shape[0], q.shape[0]
    p = p.astype(jnp.float32)
    q = q.astype(jnp.float32)

    sc = min(source_chunk, round_up(n, 8))
    tt = min(target_tile, round_up(m, 8))
    n_pad = round_up(n, sc)
    m_pad = round_up(m, tt)

    p_padded = _pad_to(p, n_pad, 0.0)
    q_padded = _pad_to(q, m_pad, 0.0)
    if q_mask is None:
        valid_q = jnp.arange(m_pad) < m
    else:
        valid_q = _pad_to(q_mask, m_pad, False)

    num_tiles = m_pad // tt
    q_tiles = q_padded.reshape(num_tiles, tt, q.shape[1])
    mask_tiles = valid_q.reshape(num_tiles, tt)
    tile_bases = (jnp.arange(num_tiles, dtype=jnp.int32) * tt)

    dist_fn = pairwise_sqdist_exact if exact else pairwise_sqdist

    def per_chunk(p_chunk: jnp.ndarray):
        def step(carry, tile):
            best_d, best_i = carry
            q_tile, tile_mask, base = tile
            d = dist_fn(p_chunk, q_tile)
            d = jnp.where(tile_mask[None, :], d, _BIG)
            arg = jnp.argmin(d, axis=1).astype(jnp.int32)  # first min in tile
            dmin = jnp.min(d, axis=1)
            better = dmin < best_d  # strict: earlier tile wins ties
            best_d = jnp.where(better, dmin, best_d)
            best_i = jnp.where(better, base + arg, best_i)
            return (best_d, best_i), None

        init = (
            jnp.full((p_chunk.shape[0],), _BIG, dtype=jnp.float32),
            jnp.zeros((p_chunk.shape[0],), dtype=jnp.int32),
        )
        (best_d, best_i), _ = lax.scan(step, init, (q_tiles, mask_tiles, tile_bases))
        return best_d, best_i

    num_chunks = n_pad // sc
    if num_chunks == 1:
        best_d, best_i = per_chunk(p_padded)
    else:
        p_chunks = p_padded.reshape(num_chunks, sc, p.shape[1])
        best_d, best_i = lax.map(per_chunk, p_chunks)
        best_d = best_d.reshape(n_pad)
        best_i = best_i.reshape(n_pad)

    return best_i[:n], best_d[:n]


def gather_correspondences(q: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """Gather matched target points into source order — the reference's
    ``Q_index`` kernel (/root/reference/src/CUDA/ICP_point_to_point_clean.cu:75-85)."""
    return jnp.take(q, idx, axis=0)
