"""Voxel-hash spatial grid for fixed-radius nearest-neighbor search.

The reference has no acceleration structure — its matching is O(N·M) brute
force, which caps it at ~16k points (BASELINE.md). At 1M points brute force
is out of reach (10¹² distance pairs per iteration), so this
module adds the classic spatial-hash grid, redesigned with static shapes:

* **Build** (once per target cloud): quantize points to ``cell = floor(q/h)``,
  spatial-hash each cell into a power-of-two table (the 73856093/19349663/
  83492791 prime XOR hash), sort points by bucket (one XLA sort), and keep a
  dense ``starts``/``counts`` table — every query is then O(1) gathers, no
  binary search, no dynamic shapes.
* **Query**: each source point inspects its 27 neighboring cells, reads up to
  ``cap`` candidates per bucket (static candidate tensor
  ``[chunk, 27·cap]``), computes masked distances and takes the argmin.
  Bucket collisions only *add* candidates (they can never produce a wrong
  match — distances decide); candidates beyond ``cap`` in an overfull bucket
  are dropped, making the search approximate for pathological densities.
  ``found`` reports rows with no candidate in range — ICP masks those out of
  the solve (the same mechanism as trimmed ICP).

Guarantee: for clouds whose true NN lies within one cell (``dist ≤ h``) and
buckets under ``cap`` occupancy, the result equals brute force. Use
``suggest_cell_size`` (≈ 2× median spacing) and the coarse-to-fine pipeline
(models/pipeline.py) to stay in that regime.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.cloud import round_up
from .matching import _pad_to

_P1, _P2, _P3 = np.int32(73856093), np.int32(19349663), np.int32(83492791)


def _hash_cells(cells: jnp.ndarray, table_bits: int) -> jnp.ndarray:
    """Spatial hash of integer cell coords ``[..., 3]`` → bucket id."""
    h = (
        (cells[..., 0] * _P1)
        ^ (cells[..., 1] * _P2)
        ^ (cells[..., 2] * _P3)
    )
    return (h & ((1 << table_bits) - 1)).astype(jnp.int32)


class VoxelTable(NamedTuple):
    points_sorted: jnp.ndarray  # [M, 3] bucket-sorted target points
    orig_index: jnp.ndarray  # [M] sorted position -> original target index
    starts: jnp.ndarray  # [H] first sorted row of each bucket
    counts: jnp.ndarray  # [H] bucket occupancy
    cell_size: jnp.ndarray  # scalar f32
    table_bits: int


@functools.partial(jax.jit, static_argnames=("table_bits",))
def build_voxel_table(
    q: jnp.ndarray,
    cell_size,
    table_bits: int = 20,
    q_mask: Optional[jnp.ndarray] = None,
) -> VoxelTable:
    """Hash-bucket the target cloud. O(M log M) (one sort), fully on device."""
    m = q.shape[0]
    q = q.astype(jnp.float32)
    h = jnp.asarray(cell_size, jnp.float32)
    H = 1 << table_bits

    cells = jnp.floor(q / h).astype(jnp.int32)
    key = _hash_cells(cells, table_bits)
    if q_mask is not None:
        key = jnp.where(q_mask, key, H)  # invalid points -> overflow bucket

    order = jnp.argsort(key)
    points_sorted = jnp.take(q, order, axis=0)

    counts = jnp.zeros((H + 1,), jnp.int32).at[key].add(1)
    starts = jnp.concatenate(
        [jnp.zeros((1,), jnp.int32),
         jnp.cumsum(counts[:-1], dtype=jnp.int32)]
    )
    return VoxelTable(
        points_sorted=points_sorted,
        orig_index=order.astype(jnp.int32),
        starts=starts[:H],
        counts=counts[:H],
        cell_size=h,
        table_bits=table_bits,
    )


def _neighbor_offsets() -> np.ndarray:
    g = np.arange(-1, 2)
    return np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(27, 3)


# Bound on the candidate rows one query pass gathers (N × 27 × cap): each
# row is a 12-byte f32 point, so the cap is ~1.4 GB of random gathers per
# ICP iteration. The banded Morton matcher reads contiguous bands instead
# and is the large-N path above it.
MAX_CANDIDATE_GATHERS = 120_000_000
CANDIDATE_ROW_BYTES = 12


@functools.partial(
    jax.jit, static_argnames=("cap", "chunk", "max_candidate_gathers"))
def grid_nn(
    p: jnp.ndarray,
    table: VoxelTable,
    cap: int = 8,
    chunk: int = 65536,
    max_candidate_gathers: int = MAX_CANDIDATE_GATHERS,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fixed-radius NN via the voxel table.

    Returns ``(idx int32[N], sqdist f32[N], found bool[N])`` — ``idx`` into
    the ORIGINAL target order; rows with no candidate have found=False.

    Raises ``ValueError`` when the total candidate gather volume
    (``N × 27 × cap`` rows) exceeds ``max_candidate_gathers``; use
    ``matcher='morton'`` for such clouds.
    """
    n = p.shape[0]
    budget = n * 27 * cap
    if budget > max_candidate_gathers:
        raise ValueError(
            f"grid_nn candidate budget {budget:,} rows (N={n:,} x 27 x "
            f"cap={cap}, {budget * CANDIDATE_ROW_BYTES / 1e9:.1f} GB of "
            f"gathered points) exceeds the limit {max_candidate_gathers:,}. "
            "Use ICPConfig(matcher='morton') for large clouds (the "
            "production large-N path), or lower cap / raise "
            "max_candidate_gathers explicitly.")
    p = p.astype(jnp.float32)
    offsets = jnp.asarray(_neighbor_offsets(), jnp.int32)  # [27, 3]
    m = table.points_sorted.shape[0]

    sc = min(chunk, round_up(n, 8))
    n_pad = round_up(n, sc)
    p_padded = _pad_to(p, n_pad, 0.0)

    def per_chunk(p_chunk):
        rows = p_chunk.shape[0]
        cells = jnp.floor(p_chunk / table.cell_size).astype(jnp.int32)  # [r,3]
        nbr_cells = cells[:, None, :] + offsets[None, :, :]  # [r,27,3]
        keys = _hash_cells(nbr_cells, table.table_bits)  # [r,27]
        start = jnp.take(table.starts, keys)  # [r,27]
        count = jnp.take(table.counts, keys)  # [r,27]

        lane = jnp.arange(cap, dtype=jnp.int32)  # [cap]
        cand_rows = start[:, :, None] + lane[None, None, :]  # [r,27,cap]
        valid = lane[None, None, :] < jnp.minimum(count[:, :, None], cap)
        cand_rows = jnp.clip(cand_rows, 0, m - 1).reshape(rows, 27 * cap)
        valid = valid.reshape(rows, 27 * cap)

        cand_pts = jnp.take(table.points_sorted, cand_rows, axis=0)  # [r,K,3]
        diff = cand_pts - p_chunk[:, None, :]
        d = jnp.sum(diff * diff, axis=-1)
        d = jnp.where(valid, d, jnp.inf)

        best = jnp.argmin(d, axis=1)
        dmin = jnp.take_along_axis(d, best[:, None], axis=1)[:, 0]
        sorted_idx = jnp.take_along_axis(cand_rows, best[:, None], axis=1)[:, 0]
        orig = jnp.take(table.orig_index, sorted_idx)
        found = jnp.isfinite(dmin)
        return jnp.where(found, orig, 0), dmin, found

    if n_pad == sc:
        idx, dmin, found = per_chunk(p_padded)
    else:
        idx, dmin, found = lax.map(
            per_chunk, p_padded.reshape(n_pad // sc, sc, 3)
        )
        idx = idx.reshape(n_pad)
        dmin = dmin.reshape(n_pad)
        found = found.reshape(n_pad)
    return idx[:n], dmin[:n], found[:n]


def suggest_cell_size(q: jnp.ndarray, sample: int = 2048,
                      scale: float = 2.0) -> jnp.ndarray:
    """≈ ``scale`` × median nearest-neighbor spacing of a sample — a cell
    size that keeps the true NN within the 27-cell neighborhood for
    near-registered clouds while keeping bucket occupancy low.

    Robustness (fuzzer finds): the slice is centered before the 2-NN pass
    (expansion-form f32 noise scales with |p|² — on global-frame clouds at
    |p|~500 it swamps real sub-millimeter spacings), and zero-distance
    neighbors (duplicate points) are excluded from the median; a cloud too
    degenerate to measure (all duplicates) falls back to an extent-based
    size, 0 only when the cloud has no extent at all."""
    from .normals import knn

    m = q.shape[0]
    q_slice = q[: min(m, 65536)]
    q_slice = q_slice - jnp.mean(q_slice, axis=0)
    step = max(1, q_slice.shape[0] // sample)
    sub = q_slice[::step][:sample]
    # 2-NN against the slice containing sub: slot 0 is self (distance 0),
    # slot 1 is the true nearest neighbor.
    _, d = knn(sub, q_slice, 2)
    d1 = jnp.maximum(d[:, 1], 0.0)
    pos = d1 > 0
    n_pos = jnp.sum(pos)
    # lower median of the POSITIVE spacings (duplicates sort to +inf)
    sorted_d = jnp.sort(jnp.where(pos, d1, jnp.inf))
    med = jnp.sqrt(sorted_d[jnp.maximum(n_pos - 1, 0) // 2])
    # all-duplicate sample: fall back to bbox-extent / cbrt(n) spacing
    ext = jnp.linalg.norm(jnp.max(q_slice, axis=0) - jnp.min(q_slice, axis=0))
    fallback = ext / jnp.cbrt(jnp.float32(max(q_slice.shape[0], 1)))
    med = jnp.where((n_pos > 0) & jnp.isfinite(med) & (med > 0),
                    med, fallback)
    return (scale * med).astype(jnp.float32)


@functools.partial(jax.jit, static_argnames=())
def voxel_downsample(
    points: jnp.ndarray,
    voxel_size,
    mask: Optional[jnp.ndarray] = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Voxel-grid downsampling: one centroid per occupied voxel.

    Static-shape formulation: quantize → spatial-hash-free exact
    voxel keys (sorted lexicographic cell ids) → one XLA sort → run-length
    segment ids by `cumsum(key_change)` → `segment_sum` centroids with a
    static ``num_segments = N`` bound. Returns ``(centroids [N, 3],
    valid [N] bool)`` — the fixed-size padded-cloud convention every loop
    in this framework already accepts via masks (no dynamic shapes under
    jit). Order of valid centroids follows the voxel key sort.

    The reference has no downsampling utility; this is the standard
    pipeline prepass (e.g. coarse stages, map maintenance) built with
    static shapes instead of the usual hash map.
    """
    n = points.shape[0]
    points = points.astype(jnp.float32)
    h = jnp.float32(voxel_size)
    cells = jnp.floor(points / h).astype(jnp.int32)  # [N, 3]
    # collision-free exact grouping without 64-bit keys: lexsort the raw
    # cell columns (invalid rows pushed to the end as the primary key)
    invalid = (jnp.zeros((n,), jnp.int32) if mask is None
               else (~mask).astype(jnp.int32))
    order = jnp.lexsort((cells[:, 2], cells[:, 1], cells[:, 0], invalid))
    cells_s = jnp.take(cells, order, axis=0)
    pts_s = jnp.take(points, order, axis=0)
    valid_s = (jnp.ones((n,), bool) if mask is None
               else jnp.take(mask, order))

    changed = jnp.any(cells_s[1:] != cells_s[:-1], axis=1)
    new_seg = jnp.concatenate([
        jnp.ones((1,), jnp.int32), changed.astype(jnp.int32)])
    seg_id = jnp.cumsum(new_seg) - 1  # [N] in 0..K-1, K ≤ N

    w = valid_s.astype(jnp.float32)
    sums = jax.ops.segment_sum(pts_s * w[:, None], seg_id, num_segments=n)
    counts = jax.ops.segment_sum(w, seg_id, num_segments=n)
    centroids = sums / jnp.maximum(counts, 1.0)[:, None]
    return centroids, counts > 0
