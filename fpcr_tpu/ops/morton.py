"""Morton-order windowed nearest-neighbor matching — the large-N matcher.

Random gathers stream poorly compared with contiguous reads: the voxel-hash
matcher (ops/grid.py) is correct but gather-bound (µs per point). This module
replaces gathers with *contiguous band reads*:

1. **Target prep** (once per registration): quantize target coords to a
   30-bit Morton code (10 bits/axis, int32-safe), sort the cloud along the
   curve. Spatially close points land at close ranks.
2. **Source prep** (once): sort the source along the same Morton frame
   (``source_morton_order``). A rigid motion preserves neighborhoods, so a
   run of consecutive sorted source points stays spatially coherent through
   every ICP iteration — no per-iteration re-sorting.
3. **Per iteration**: for each chunk of ``chunk`` consecutive source points,
   locate the chunk's *probe rank* in the target order (one searchsorted on
   ~N/chunk probes — cheap) and read the contiguous target band
   ``[rank - window, rank + window + chunk]`` with ``dynamic_slice``. Brute
   force the chunk against its band: MXU cross-term + VPU argmin, exactly
   the 16k-scale matcher but per-band. Cost is O(N · band) dense FLOPs with
   zero random gathers.

The result is approximate: a true NN outside the band is missed (Morton
curve discontinuities; large rotations). ICP absorbs this — matches are
still *near*-nearest, the solve is dominated by the 99%+ correct majority,
and the next iteration re-matches; `max_correspondence_dist` masking covers
the tail. Exactness in the near-registered regime is asserted in tests.

No reference counterpart (the CUDA code is brute-force only — SURVEY.md §5
'long-context' row: point count is the scaling axis this rebuild innovates).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..core.cloud import fit_unroll, round_up
from .matching import _pad_to, pairwise_sqdist

_BITS = 10  # 10 bits/axis -> 30-bit codes, int32-safe


def _part1by2(x: jnp.ndarray) -> jnp.ndarray:
    """Spread the low 10 bits of x so there are two zero bits between each
    (classic Morton bit-twiddle, vectorized int32)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(
    points: jnp.ndarray, lo: jnp.ndarray, inv_extent: jnp.ndarray
) -> jnp.ndarray:
    """30-bit Morton codes for ``[N, 3]`` points given bounds (lo, 1/extent)."""
    u = jnp.clip(
        ((points - lo) * inv_extent * (1 << _BITS)).astype(jnp.int32),
        0, (1 << _BITS) - 1,
    )
    return (
        (_part1by2(u[:, 0]) << 2)
        | (_part1by2(u[:, 1]) << 1)
        | _part1by2(u[:, 2])
    )


class MortonTable(NamedTuple):
    points_sorted: jnp.ndarray  # [M, 3] target along the curve
    codes_sorted: jnp.ndarray  # [M] int32 (masked rows pushed to the end)
    orig_index: jnp.ndarray  # [M] sorted pos -> original target index
    lo: jnp.ndarray  # [3] bounds used for quantization
    inv_extent: jnp.ndarray  # [3]
    valid_count: jnp.ndarray  # scalar int32 — rows beyond are masked


@functools.partial(jax.jit, static_argnames=("shift",))
def build_morton_table(
    q: jnp.ndarray, q_mask: Optional[jnp.ndarray] = None,
    shift: float = 0.0,
) -> MortonTable:
    """``shift`` (in cells, e.g. 0.5) offsets the quantization grid — a
    second half-cell-shifted table covers the first curve's seams (query
    both, keep the closer match)."""
    m = q.shape[0]
    q = q.astype(jnp.float32)
    if q_mask is not None:
        q_for_bounds = jnp.where(q_mask[:, None], q, jnp.nan)
        lo = jnp.nanmin(q_for_bounds, axis=0)
        hi = jnp.nanmax(q_for_bounds, axis=0)
        valid_count = jnp.sum(q_mask.astype(jnp.int32))
    else:
        lo = jnp.min(q, axis=0)
        hi = jnp.max(q, axis=0)
        valid_count = jnp.int32(m)
    inv_extent = 1.0 / jnp.maximum(hi - lo, 1e-12)
    if shift:
        lo = lo - shift * (1.0 / inv_extent) / (1 << _BITS)

    codes = morton_codes(q, lo, inv_extent)
    if q_mask is not None:
        codes = jnp.where(q_mask, codes, jnp.int32(2**31 - 1))
    order = jnp.argsort(codes).astype(jnp.int32)
    return MortonTable(
        points_sorted=jnp.take(q, order, axis=0),
        codes_sorted=jnp.take(codes, order),
        orig_index=order,
        lo=lo,
        inv_extent=inv_extent,
        valid_count=valid_count,
    )


@jax.jit
def source_morton_order(p: jnp.ndarray, table: MortonTable) -> jnp.ndarray:
    """Morton sort order for the source in the target's frame. Applied ONCE
    before the ICP loop (the solve/error are permutation-invariant); rigid
    iterates keep consecutive sorted points spatially coherent, so the loop
    itself needs no per-iteration reordering or index translation."""
    codes = morton_codes(p.astype(jnp.float32), table.lo, table.inv_extent)
    return jnp.argsort(codes).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("chunk", "window", "unroll"))
def morton_nn(
    p: jnp.ndarray,
    table: MortonTable,
    extra: Optional[jnp.ndarray] = None,
    chunk: int = 256,
    window: int = 1024,
    unroll: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, Optional[jnp.ndarray]]:
    """Windowed NN against the Morton table.

    ``p`` rows must be spatially coherent (pre-sort the initial source with
    ``source_morton_order``; rigid iterates preserve coherence). Returns
    ``(matched_points[N,3], sqdist[N], idx_sorted[N], matched_extra)`` —
    matched values are selected directly from the dense band, so the caller
    performs NO random gathers. ``extra`` (e.g. target normals) must already
    be in table order (``extra_sorted = extra[table.orig_index]``).
    """
    n = p.shape[0]
    p = p.astype(jnp.float32)

    n_pad = round_up(n, chunk)
    # pad with the LAST REAL point, not zeros: the per-chunk probe below
    # reads a fixed row of each chunk, and a zero-pad probe would quantize
    # to the origin cell and center the final chunk's band at an arbitrary
    # rank — silently mismatching up to chunk/2 real tail points whenever
    # n % chunk lands the probe row in the padding (review find r3)
    p_sorted = jnp.concatenate(
        [p, jnp.broadcast_to(p[n - 1], (n_pad - n, 3))]
    ) if n_pad > n else p

    band = chunk + 2 * window
    num_chunks = n_pad // chunk

    # pad the target band source so dynamic_slice always fits
    m = table.points_sorted.shape[0]
    m_pad = max(round_up(m, 8), band)
    t_sorted = _pad_to(table.points_sorted, m_pad, 0.0)
    e_sorted = None if extra is None else _pad_to(
        extra.astype(jnp.float32), m_pad, 0.0)

    # per-chunk probe: the chunk's middle point's Morton rank in the target
    probe_pts = p_sorted.reshape(num_chunks, chunk, 3)[:, chunk // 2, :]
    probe_codes = morton_codes(probe_pts, table.lo, table.inv_extent)
    ranks = jnp.searchsorted(table.codes_sorted, probe_codes).astype(jnp.int32)
    bases = jnp.clip(ranks - (band // 2), 0, m_pad - band)

    band_iota = lax.broadcasted_iota(jnp.int32, (1, band), 1)

    def one_chunk(pc, base):
        tb = lax.dynamic_slice(t_sorted, (base, jnp.int32(0)), (band, 3))
        # validity computed arithmetically — one fewer DMA per chunk
        vmask = (base + band_iota) < table.valid_count
        d = pairwise_sqdist(pc, tb)
        d = jnp.where(vmask, d, jnp.inf)
        arg = jnp.argmin(d, axis=1).astype(jnp.int32)
        dmin = jnp.min(d, axis=1)
        matched = jnp.take(tb, arg, axis=0)  # VMEM-local select
        if e_sorted is None:
            eb = jnp.zeros((chunk, 3), jnp.float32)
        else:
            eband = lax.dynamic_slice(e_sorted, (base, jnp.int32(0)),
                                      (band, 3))
            eb = jnp.take(eband, arg, axis=0)
        return matched, dmin, base + arg, eb

    # Statically unroll `unroll` chunks per map step: each per-chunk tile is
    # tiny (band reads + a [chunk, band] distance block), so the XLA loop
    # step overhead would dominate at large N.
    u = fit_unroll(num_chunks, unroll)

    def per_group(args):
        pcs, bs = args  # [u, chunk, 3], [u]
        outs = [one_chunk(pcs[i], bs[i]) for i in range(u)]
        return tuple(jnp.stack([o[k] for o in outs]) for k in range(4))

    matched, dmin, idx_sorted, exm = lax.map(
        per_group,
        (p_sorted.reshape(num_chunks // u, u, chunk, 3),
         bases.reshape(num_chunks // u, u)),
    )
    matched = matched.reshape(n_pad, 3)[:n]
    dmin = dmin.reshape(n_pad)[:n]
    idx_sorted = jnp.clip(idx_sorted.reshape(n_pad)[:n], 0, m - 1)
    exm = None if extra is None else exm.reshape(n_pad, 3)[:n]
    return matched, dmin, idx_sorted, exm


@functools.partial(jax.jit, static_argnames=("k", "chunk", "window", "unroll"))
def knn_morton(
    q: jnp.ndarray,
    k: int,
    q_mask: Optional[jnp.ndarray] = None,
    chunk: int = 256,
    window: int = 256,
    unroll: int = 8,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Self-kNN via Morton bands — the O(M·band) replacement for the
    streaming O(M²) ``normals.knn`` at large M (the normals prepass is the
    only remaining quadratic step at 1M points).

    Returns ``(idx int32[M, k], sqdist f32[M, k])`` ascending, indices into
    the ORIGINAL order, self included as slot 0 (same contract as
    ``normals.knn(q, q, k)``). Approximate near Morton-curve seams like
    ``morton_nn`` — fine for PCA normals (any k near neighbors work).
    """
    m = q.shape[0]
    q = q.astype(jnp.float32)
    table = build_morton_table(q, q_mask)
    qs = table.points_sorted

    n_pad = round_up(m, chunk)
    qs_pad = _pad_to(qs, n_pad, 1e30)
    band = chunk + 2 * window
    m_pad = max(round_up(m, 8), band)
    t_sorted = _pad_to(qs, m_pad, 0.0)
    num_chunks = n_pad // chunk
    band_iota = lax.broadcasted_iota(jnp.int32, (1, band), 1)

    # chunk c of the sorted cloud sits at rank c*chunk by construction
    bases = jnp.clip(
        jnp.arange(num_chunks, dtype=jnp.int32) * chunk - window,
        0, m_pad - band,
    )

    def one_chunk(pc, base):
        tb = lax.dynamic_slice(t_sorted, (base, jnp.int32(0)), (band, 3))
        vmask = (base + band_iota) < table.valid_count
        d = pairwise_sqdist(pc, tb)
        d = jnp.where(vmask, d, jnp.inf)
        neg_top, pos = lax.top_k(-d, k)
        return base + pos.astype(jnp.int32), -neg_top

    u = fit_unroll(num_chunks, unroll)

    def per_group(args):
        pcs, bs = args
        outs = [one_chunk(pcs[i], bs[i]) for i in range(u)]
        return (jnp.stack([o[0] for o in outs]),
                jnp.stack([o[1] for o in outs]))

    idx_sorted_pos, dists = lax.map(
        per_group,
        (qs_pad.reshape(num_chunks // u, u, chunk, 3),
         bases.reshape(num_chunks // u, u)),
    )
    idx_sorted_pos = jnp.clip(
        idx_sorted_pos.reshape(n_pad, k)[:m], 0, m - 1)
    dists = dists.reshape(n_pad, k)[:m]

    # sorted position -> original index, then un-sort the row order
    idx_orig = jnp.take(table.orig_index, idx_sorted_pos)
    inverse = jnp.zeros((m,), jnp.int32).at[table.orig_index].set(
        jnp.arange(m, dtype=jnp.int32))
    idx = jnp.take(idx_orig, inverse, axis=0)
    d = jnp.take(dists, inverse, axis=0)
    return idx, d


def band_quality_probe(
    p: jnp.ndarray,
    table: MortonTable,
    chunk: int = 512,
    window: int = 64,
    sample: int = 2048,
) -> dict:
    """Scale-aware banded match quality at a (chunk, window) candidate.

    Measured facts behind this probe's design (round 5, 262k surface +
    uniform scenes): the exact-NN rank reach |rank(NN) − band center| is
    HEAVY-TAILED — p50 ≈ chunk/2 (the chunk's own span) but p99 ≈ 3.6-6.8k
    and p99.9 ≥ 32k, far beyond any affordable window. No percentile of
    the rank spread justifies a window; the production w=64 already
    operates deep in the miss-absorbing regime where auto_trim masks the
    tail and re-matching converges. So candidate band geometries are
    compared by *match quality* (the thing the solve sees), not coverage:

    * ``miss_rate`` — sampled rows whose banded squared distance exceeds
      the exact one beyond f32 noise (same scale-aware floors as
      ``tune_morton``);
    * ``damaging_rate`` — misses whose excess is large relative to the
      geometry extent (the only ones that bias the solve);
    * ``mean_excess_rel`` — mean distance excess over the sample, relative
      to the mean exact distance (solve-bias proxy).

    Pick the smallest band ratio ``(chunk + 2·window + 128)/chunk`` whose
    damaging_rate/mean_excess match the proven production config's —
    see ``scripts/exp_morton_band.py`` for the hardware A/B that consumes
    this. ``p`` must be in source-coherent order (``source_morton_order``).
    """
    import numpy as np

    n = p.shape[0]
    p = p.astype(jnp.float32)
    _, d_band, _, _ = morton_nn(p, table, None, chunk=chunk, window=window)

    stride = max(1, -(-n // sample))
    rows = jnp.clip(jnp.arange(sample, dtype=jnp.int32) * stride, 0, n - 1)
    p_s = jnp.take(p, rows, axis=0)
    d_band_s = np.asarray(jnp.take(d_band, rows))

    # streaming exact NN (never O(sample·M) memory — a dense [sample, M]
    # matrix is 17 GB at M=1M)
    from .matching import nn_argmin

    q = table.points_sorted
    valid = jnp.arange(q.shape[0]) < table.valid_count
    _, d_exact = nn_argmin(p_s, q, q_mask=valid, exact=True)
    d_exact = np.asarray(jnp.maximum(d_exact, 0.0))

    # scale-aware noise floors (same reasoning as tune_morton's probe):
    # f32 expansion-form disagreement scales with |p|²; damaging scales
    # with the geometry extent
    p_np = np.asarray(p_s, dtype=np.float64)
    excess = d_band_s - d_exact
    abs2 = float(np.mean(np.sum(p_np ** 2, axis=1)))
    extent2 = float(np.mean(np.sum((p_np - p_np.mean(axis=0)) ** 2, axis=1)))
    noise = max(1e-6 * max(extent2, 1e-12), 4e-6 * abs2)
    miss = excess > np.maximum(noise, 1e-4 * d_exact)
    damaging = excess > max(1e-4 * max(extent2, 1e-12), 4.0 * noise)
    return {
        "chunk": chunk,
        "window": window,
        "band_ratio": (chunk + 2 * window + 128) / chunk,
        "miss_rate": float(miss.mean()),
        "damaging_rate": float(damaging.mean()),
        "mean_excess_rel": float(np.clip(excess, 0, None).mean()
                                 / max(d_exact.mean(), 1e-30)),
    }


@functools.partial(jax.jit, static_argnames=("sample", "chunk", "window",
                                             "unroll", "rel_tol"))
def seam_miss_rate(
    p: jnp.ndarray,
    table: MortonTable,
    sample: int = 1024,
    chunk: int = 256,
    window: int = 256,
    unroll: int = 8,
    rel_tol: float = 1e-4,
) -> jnp.ndarray:
    """Fraction of banded matches measurably worse than brute force.

    The Morton-banded matcher misses a true nearest neighbor when it lies
    across a curve seam outside the rank window. This probe quantifies
    that for a given (cloud, window): it takes an evenly-strided ``sample``
    of the (coherently ordered) query rows, brute-forces their exact NN
    against the full table, runs the banded search with the same rows kept
    in their original band positions, and returns the fraction whose banded
    squared distance exceeds the exact one by more than ``rel_tol``
    (relative). 0.0 = the window is lossless on this cloud; use it to size
    ``ICPConfig.morton_window`` on adversarial geometry (the companion
    ``auto_trim`` gate handles the surviving tail at solve time).

    ``p`` must already be in source-coherent order (``source_morton_order``),
    matching how the ICP loop drives the matcher.
    """
    n = p.shape[0]
    p = p.astype(jnp.float32)
    # full banded pass (identical band geometry to the production loop)
    _, d_band, _, _ = morton_nn(p, table, None, chunk=chunk, window=window,
                                unroll=unroll)

    # ceil stride: floor would leave the highest-Morton-rank tail (a whole
    # curve corner, where top-bit seam misses concentrate) unprobed
    # whenever n is not a multiple of sample (review find r3, same fix as
    # tune_morton's probe)
    stride = max(1, -(-n // sample))
    rows = jnp.arange(sample, dtype=jnp.int32) * stride
    rows = jnp.clip(rows, 0, n - 1)
    p_s = jnp.take(p, rows, axis=0)
    d_band_s = jnp.take(d_band, rows)

    # exact NN of the sampled rows against the full (valid) table
    q = table.points_sorted
    q_sq = jnp.sum(q * q, axis=1)
    valid = jnp.arange(q.shape[0]) < table.valid_count
    q_sq = jnp.where(valid, q_sq, jnp.inf)
    d_full = (jnp.sum(p_s * p_s, axis=1)[:, None]
              - 2.0 * jax.lax.dot_general(
                  p_s, q,
                  dimension_numbers=(((1,), (1,)), ((), ())),
                  precision=jax.lax.Precision.HIGHEST)
              + q_sq[None, :])
    d_exact = jnp.maximum(jnp.min(d_full, axis=1), 0.0)

    miss = d_band_s > d_exact * (1.0 + rel_tol) + 1e-12
    return jnp.mean(miss.astype(jnp.float32))
