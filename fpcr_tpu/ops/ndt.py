"""NDT voxel Gaussian grid: per-voxel (mean, inverse covariance) tables.

The Normal Distributions Transform (Biber & Strasser 2003; Magnusson 2009)
replaces point-to-point correspondences with a piecewise-smooth Gaussian
field: the target cloud is voxelized once, each occupied voxel keeps the
mean and covariance of its points, and registration maximizes the
likelihood of the transformed source under that field. The CUDA reference
has no NDT; this is a beyond-reference model family.

Design (static shapes throughout, no hash maps):

* **Grid build = one sort + segment_sums.** Voxel cells are packed into a
  30-bit scalar key (10 bits/axis relative to the cloud min corner — the
  same bound the Morton tables use), rows are sorted by key once (XLA
  sort), run-length segment ids come from ``cumsum(key changed)``, and the
  count/mean/second-moment of every voxel are ``segment_sum``s with the
  static bound ``num_segments = N``. The result is a fixed-shape table of
  ≤N voxels with a validity mask — the padded-cloud convention every loop
  in this framework uses (compare ``ops/grid.py::voxel_downsample``).
* **Covariance regularization on device.** Near-planar voxels make Σ
  singular; Magnusson's fix (thesis §6.2.3) clamps eigenvalues to
  ``λ_k ≥ eig_ratio · λ_max``. The batched closed-form ``ops/eigh3``
  does this without LAPACK round trips, and the *inverse* covariance is
  rebuilt directly as ``V diag(1/λ') Vᵀ`` — the solver never inverts.
* **Lookup = searchsorted, not pointer chasing.** The unique voxel keys
  are ascending by construction (segments of a sorted array), so a source
  point finds its voxel with one binary search over a [N] vector plus one
  row gather — no tree, no hash probing, no dynamic shapes.

Reference for behavior only: the CUDA reference implements brute-force ICP
(/root/reference/src/CUDA/ICP_point_to_point_clean.cu); NDT is additional
capability at the same API surface.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .eigh3 import eigh3

_AXIS_BITS = 10  # 1024 cells per axis — ample for NDT resolutions
# padding key; sorts after all real keys. Plain Python int, NOT jnp.int32:
# a module-level jnp constant would initialize the XLA backend at import
# time, which breaks jax.distributed.initialize() in multihost processes
# (same trap ops/eigh3.py documents for trace leakage).
_KEY_PAD = 2 ** 31 - 1
# jnp.searchsorted algorithm of the gather lookup: 'scan' (a binary search,
# ~log2(K) dependent gathers) or 'sort' (one sort of queries + keys). At
# 262,144 queries on an H100 80GB HBM3, three runs gave sort 0.474 / 0.378 /
# 0.406 ms against scan 0.494 / 0.539 / 0.367 ms: close, sort ahead twice.
SEARCH_METHOD = "sort"


class NDTGrid(NamedTuple):
    """Fixed-shape voxel Gaussian table (rows ≤ N voxels, mask-padded)."""

    keys: jnp.ndarray       # [N] int32 ascending unique voxel keys (pad=MAX)
    mu: jnp.ndarray         # [N, 3] voxel means
    sinv: jnp.ndarray       # [N, 3, 3] regularized inverse covariances
    valid: jnp.ndarray      # [N] bool — voxel exists and has >= min_points
    lo: jnp.ndarray         # [3] grid origin (min corner)
    voxel_size: jnp.ndarray  # scalar f32
    # fused per-voxel row for single-gather lookup (one [N, 16] row take
    # instead of four separate takes of keys/valid/mu/sinv):
    # lanes [mu(3) | sinv upper-triangle(6) | valid(1) | key_hi(1) |
    #        key_lo(1) | pad(4)] — the 30-bit key is split 15/15 so both
    # halves are exact in f32 (< 2^24)
    table: jnp.ndarray      # [N, 16] f32


def _cells_raw(points: jnp.ndarray, lo: jnp.ndarray, h) -> jnp.ndarray:
    """Integer voxel coordinates per point, UNclipped (may be out of the
    10-bit range for clouds spanning >1024 voxels per axis)."""
    return jnp.floor((points - lo) / h).astype(jnp.int32)


def _in_range(cells: jnp.ndarray) -> jnp.ndarray:
    """[N] bool — all three coordinates inside the addressable grid.
    Out-of-range cells must NOT be clipped: clipping aliases distant
    points into boundary mega-voxels whose flat Gaussians still carry
    real weight in the solve. They are treated as misses instead."""
    return jnp.all((cells >= 0) & (cells < (1 << _AXIS_BITS)), axis=-1)


def _pack(cells: jnp.ndarray) -> jnp.ndarray:
    """Packed 30-bit scalar key from ``[N, 3]`` voxel coordinates."""
    return ((cells[..., 0] << (2 * _AXIS_BITS))
            | (cells[..., 1] << _AXIS_BITS) | cells[..., 2])


def _cell_keys(points: jnp.ndarray, lo: jnp.ndarray, h) -> jnp.ndarray:
    """Packed 30-bit voxel key per point; out-of-range points (cloud spans
    >1024 voxels on some axis at this resolution) get the pad key, i.e.
    they simply don't participate — no silent aliasing."""
    c = _cells_raw(points, lo, h)
    return jnp.where(_in_range(c), _pack(c), _KEY_PAD)


@functools.partial(jax.jit, static_argnames=("min_points",))
def build_ndt_grid(
    target: jnp.ndarray,
    voxel_size,
    mask: Optional[jnp.ndarray] = None,
    *,
    min_points: int = 4,
    eig_ratio: float = 0.01,
) -> NDTGrid:
    """Voxelize ``target`` into per-voxel Gaussians (one-time prepass).

    Args:
      target: ``[N, 3]`` cloud.
      voxel_size: edge length of the cubic voxels (the NDT resolution).
      mask: optional validity mask for padded clouds.
      min_points: voxels with fewer points are invalid (a covariance from
        <4 points is rank-deficient; Magnusson uses 5, PCL 6 — exposed).
      eig_ratio: eigenvalue floor ``λ_k >= eig_ratio * λ_max``.
    """
    n = target.shape[0]
    pts = target.astype(jnp.float32)
    h = jnp.float32(voxel_size)
    w_in = (jnp.ones((n,), jnp.float32) if mask is None
            else mask.astype(jnp.float32))
    lo = jnp.min(jnp.where(w_in[:, None] > 0, pts, jnp.inf), axis=0)

    keys = jnp.where(w_in > 0, _cell_keys(pts, lo, h), _KEY_PAD)
    order = jnp.argsort(keys)
    keys_s = jnp.take(keys, order)
    pts_s = jnp.take(pts, order, axis=0)
    w_s = jnp.take(w_in, order)

    changed = keys_s[1:] != keys_s[:-1]
    seg_id = jnp.cumsum(
        jnp.concatenate([jnp.ones((1,), jnp.int32),
                         changed.astype(jnp.int32)])) - 1  # [N] in 0..K-1

    counts = jax.ops.segment_sum(w_s, seg_id, num_segments=n)  # [N]
    # Accumulate about the grid origin ``lo``: E[xx^T] - mu mu^T on ABSOLUTE
    # coordinates catastrophically cancels in f32 (at |x|~500 the two terms
    # agree to ~6 digits and the voxel-scale difference is pure rounding —
    # measured ~97% error in sinv). Local coordinates are bounded by the
    # cloud extent, so the subtraction keeps full precision; ``lo`` is added
    # back to the means only.
    loc_s = pts_s - lo
    sums = jax.ops.segment_sum(loc_s * w_s[:, None], seg_id, num_segments=n)
    # second moments of the LOCAL coordinates, summed per voxel
    xx = loc_s[:, :, None] * loc_s[:, None, :] * w_s[:, None, None]
    moments = jax.ops.segment_sum(
        xx.reshape(n, 9), seg_id, num_segments=n).reshape(n, 3, 3)
    # the key of each segment (rows of a segment share it); empty segments
    # (beyond K) get iinfo.min from segment_max — rewritten to the pad key
    seg_keys = jax.ops.segment_max(keys_s, seg_id, num_segments=n)

    c_safe = jnp.maximum(counts, 1.0)
    mu_loc = sums / c_safe[:, None]
    cov = (moments / c_safe[:, None, None]
           - mu_loc[:, None, :] * mu_loc[:, :, None])
    mu = mu_loc + jnp.where(jnp.isfinite(lo), lo, 0.0)
    # empty segments (beyond K) carry segment_max's int32 min — rewrite to
    # the pad key so the table stays ascending (real keys < 2^30 < pad)
    seg_keys = jnp.where((seg_keys >= 0) & (counts > 0), seg_keys, _KEY_PAD)
    valid = (counts >= float(min_points)) & (seg_keys != _KEY_PAD)

    # Magnusson §6.2.3 eigenvalue clamp, then invert in the eigenbasis
    lams, vecs = eigh3(jnp.where(valid[:, None, None], cov, jnp.eye(3)))
    lam_max = jnp.maximum(lams[:, 2], 1e-12)
    lam_c = jnp.maximum(lams, eig_ratio * lam_max[:, None])
    sinv = jnp.einsum("nik,nk,njk->nij", vecs, 1.0 / lam_c, vecs,
                      precision=jax.lax.Precision.HIGHEST)
    sinv = jnp.where(valid[:, None, None], sinv,
                     jnp.zeros((3, 3), jnp.float32))

    table = jnp.concatenate([
        mu,                                             # 0:3
        sinv[:, 0, 0:1], sinv[:, 0, 1:2], sinv[:, 0, 2:3],   # 3:6
        sinv[:, 1, 1:2], sinv[:, 1, 2:3], sinv[:, 2, 2:3],   # 6:9
        valid[:, None].astype(jnp.float32),             # 9
        (seg_keys >> 15).astype(jnp.float32)[:, None],  # 10 key_hi
        (seg_keys & 0x7FFF).astype(jnp.float32)[:, None],  # 11 key_lo
        jnp.zeros((n, 4), jnp.float32),                 # 12:16 pad
    ], axis=1)

    return NDTGrid(keys=seg_keys, mu=mu, sinv=sinv, valid=valid,
                   lo=lo, voxel_size=h, table=table)


def ndt_lookup(
    points: jnp.ndarray,
    grid: NDTGrid,
    cell_offset: Optional[jnp.ndarray] = None,
    *,
    method: str = SEARCH_METHOD,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-point voxel stats: ``(mu [N,3], sinv [N,3,3], valid [N])``.

    One searchsorted over the ascending unique-key table + one row gather.
    ``cell_offset`` ([3] ints) queries a *neighboring* voxel (the PCL
    DIRECT7-style multi-voxel field — see ``models/ndt.py``). Points whose
    queried voxel is unoccupied (or under-populated) come back with
    ``valid=False`` and zero ``sinv`` — they drop out of the Newton
    assembly through the weight, not through control flow. ``method`` is
    ``jnp.searchsorted``'s algorithm (see ``SEARCH_METHOD``).
    """
    c = _cells_raw(points.astype(jnp.float32), grid.lo, grid.voxel_size)
    if cell_offset is not None:
        c = c + jnp.asarray(cell_offset, jnp.int32)[None, :]
    # out-of-grid queries (including neighbor offsets stepping off the min/
    # max faces) are MISSES — clipping would double-count boundary voxels
    inb = _in_range(c)
    k = jnp.where(inb, _pack(jnp.clip(c, 0, (1 << _AXIS_BITS) - 1)),
                  jnp.int32(-1))  # -1 < every real key and != pad
    pos = jnp.searchsorted(grid.keys, k, method=method)
    pos = jnp.clip(pos, 0, grid.keys.shape[0] - 1)
    # ONE fused row gather (see NDTGrid.table)
    row = jnp.take(grid.table, pos, axis=0)  # [N, 16]
    key_match = ((row[:, 10] == (k >> 15).astype(jnp.float32))
                 & (row[:, 11] == (k & 0x7FFF).astype(jnp.float32)))
    hit = key_match & (row[:, 9] > 0.5) & inb
    return _unpack_rows(row, hit)


def _unpack_rows(row: jnp.ndarray, hit: jnp.ndarray):
    """Decode fused-table rows (``NDTGrid.table`` lane layout
    [mu(3)|sinv(6)|valid|key_hi|key_lo|pad]) to ``(mu, sinv, hit)`` —
    the one place the layout is read back."""
    mu = row[:, 0:3]
    s00, s01, s02 = row[:, 3], row[:, 4], row[:, 5]
    s11, s12, s22 = row[:, 6], row[:, 7], row[:, 8]
    sinv = jnp.stack([
        jnp.stack([s00, s01, s02], axis=-1),
        jnp.stack([s01, s11, s12], axis=-1),
        jnp.stack([s02, s12, s22], axis=-1),
    ], axis=-2)
    sinv = jnp.where(hit[:, None, None], sinv, 0.0)
    return mu, sinv, hit


@functools.partial(jax.jit, static_argnames=("chunk", "window", "unroll"))
def ndt_lookup_banded(
    points: jnp.ndarray,
    grid: NDTGrid,
    cell_offset: Optional[jnp.ndarray] = None,
    chunk: int = 512,
    window: int = 512,
    unroll: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Gather-free ``ndt_lookup``: contiguous band reads + one-hot matmuls.

    The per-point voxel row fetch is the one random gather in the NDT
    loop. This variant applies the Morton-band pattern (ops/morton.py) to
    the voxel table instead:

    * ``points`` rows must be spatially coherent in VOXEL-KEY order (sort
      the source once by its cell key in the grid's frame before the loop;
      rigid iterates stay coherent — same contract as the Morton matcher);
    * each chunk of ``chunk`` consecutive points locates its key rank in
      the ascending unique-key table with ONE searchsorted probe — the
      chunk's MAX valid key (robust to leading miss rows; every other
      query in the chunk sits BELOW the probe rank) — then reads the
      contiguous table band centered on it with ``dynamic_slice`` — zero
      random gathers;
    * per point, the band row with the matching key is selected by an
      exact equality compare ``[chunk, band]`` and extracted with a
      one-hot × band matmul (HIGHEST precision — a bf16 or TF32 pass
      would round the extracted μ/Σ⁻¹).

    Approximation contract: a key that exists in the table but lies
    outside the chunk's band reads as a MISS (w=0 in the solve) — same
    failure semantics as an unoccupied voxel, bounded by the window. Exact
    agreement with the gather path on coherent inputs is asserted in
    tests; ``chip_smoke.py`` compares the two registrations at 262,144
    points on the GPU.
    """
    from ..core.cloud import fit_unroll, round_up
    from jax import lax

    n = points.shape[0]
    c = _cells_raw(points.astype(jnp.float32), grid.lo, grid.voxel_size)
    if cell_offset is not None:
        c = c + jnp.asarray(cell_offset, jnp.int32)[None, :]
    inb = _in_range(c)
    k = jnp.where(inb, _pack(jnp.clip(c, 0, (1 << _AXIS_BITS) - 1)),
                  jnp.int32(-1))  # -1 matches no table key

    n_pad = round_up(n, chunk)
    k_pad = jnp.full((n_pad,), -1, jnp.int32).at[:n].set(k)
    m = grid.keys.shape[0]
    band = chunk + 2 * window
    m_pad = max(round_up(m, 8), band)
    keys_t = jnp.full((m_pad,), _KEY_PAD, jnp.int32).at[:m].set(grid.keys)
    table_t = jnp.zeros((m_pad, 16), jnp.float32).at[:m].set(grid.table)

    num_chunks = n_pad // chunk
    kc_all = k_pad.reshape(num_chunks, chunk)
    # per-chunk probe: the chunk's largest valid key is robust to leading
    # miss rows (k=-1 sorts before every real key)
    probe = jnp.max(kc_all, axis=1)
    ranks = jnp.searchsorted(grid.keys, probe).astype(jnp.int32)
    bases = jnp.clip(ranks - band // 2, 0, m_pad - band)

    def one_chunk(kc, base):
        bk = lax.dynamic_slice(keys_t, (base,), (band,))
        bt = lax.dynamic_slice(table_t, (base, jnp.int32(0)), (band, 16))
        eq = kc[:, None] == bk[None, :]  # at most one True per row
        hit = jnp.any(eq, axis=1)
        row = jax.lax.dot_general(
            eq.astype(jnp.float32), bt,
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
        )  # [chunk, 16] — one-hot extraction, exact in f32
        return row, hit

    u = fit_unroll(num_chunks, unroll)

    def per_group(args):
        kcs, bs = args  # [u, chunk], [u]
        outs = [one_chunk(kcs[i], bs[i]) for i in range(u)]
        return (jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]))

    rows, hits = lax.map(
        per_group,
        (kc_all.reshape(num_chunks // u, u, chunk),
         bases.reshape(num_chunks // u, u)),
    )
    row = rows.reshape(n_pad, 16)[:n]
    hit = hits.reshape(n_pad)[:n]

    hit = hit & (row[:, 9] > 0.5) & inb
    return _unpack_rows(row, hit)


def cell_key_order(points: jnp.ndarray, grid: NDTGrid) -> jnp.ndarray:
    """Sort order of ``points`` by their voxel key in ``grid``'s frame —
    the coherence prep for ``ndt_lookup_banded`` (applied ONCE before the
    loop; the solve is permutation-invariant).

    Ordering uses the CLIPPED key (not the out-of-range pad): a boundary
    point one cell below the grid is a base-lookup miss either way, but
    under a neighbor offset it becomes a valid query — sorting it next to
    its clipped position keeps that query inside its chunk's band (pad-
    sorted tails mixed coherent and arbitrary offset keys, measured 0.3%
    spurious band misses on the +x offset)."""
    c = _cells_raw(points.astype(jnp.float32), grid.lo, grid.voxel_size)
    k = _pack(jnp.clip(c, 0, (1 << _AXIS_BITS) - 1))
    return jnp.argsort(k).astype(jnp.int32)


def gauss_d1_d2(outlier_ratio: float, resolution: float) -> Tuple[float, float]:
    """Magnusson thesis eq. 6.8: mixture constants for the robust NDT score
    ``-d1 exp(-d2/2 * r^T S r)`` given the uniform-outlier ratio and the
    voxel resolution. Python floats (config-time, not traced)."""
    import math

    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / (resolution ** 3)
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    d2 = -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)
    return d1, d2


# the direct7 neighbor field: the point's own voxel + its 6 face neighbors
# (Magnusson 2009 §6.3 sampling; None = no cell offset)
DIRECT7_OFFSETS = (None, (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
                   (0, 0, 1), (0, 0, -1))
