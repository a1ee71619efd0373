"""Fused brute-force nearest-neighbour search for the GPU (Pallas, Triton).

This is the reference's ``Matching`` kernel
(/root/reference/src/CUDA/ICP_point_to_point_clean.cu:32-73) rewritten for
Hopper through Pallas's Triton route. The reference runs one thread per
source point, keeps the query in registers and scans every target with a
strict-``<`` first minimum. The plain XLA path (``ops/matching.py``) instead
writes each ``[source_chunk, target_tile]`` distance tile to device memory
and reads it back for the argmin. This kernel never materialises a distance
tile outside registers:

* each program (one thread block) owns ``block_n`` source rows, kept in
  registers, and loops over the whole target in ``block_m``-wide tiles. No
  state is shared between blocks and no atomics are needed;
* the target is stored structure-of-arrays ``[3, M]`` so a tile is three
  contiguous power-of-two loads;
* distances use the difference form ``(p-q)·(p-q)`` in f32 on the CUDA
  cores: no matrix unit, no TF32 and no cancellation, the arithmetic of
  ``matching.pairwise_sqdist_exact``;
* the running minimum is kept per ``(row, column-in-tile)`` element, with
  the tile index of its first occurrence. Only after the last tile is it
  reduced across the columns, so the loop body has no cross-thread
  reduction. Strict ``<`` across tiles plus the smallest index among equal
  column minima gives the reference's first-min tie-break;
* masked and padded targets have ``x = +inf``: their distance overflows to
  ``+inf`` and they never win. A row with no valid target keeps index 0 and
  distance ``+inf``, the convention of ``matching.nn_argmin``.

The kernel serves 3-D clouds only. Feature-space searches (FPFH's 33-D
descriptors) keep ``matching.nn_argmin``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.cloud import round_up


def _nn_kernel(p_ref, q_ref, d_ref, i_ref, *, block_n: int, block_m: int,
               num_tiles: int):
    rows = pl.ds(pl.program_id(0) * block_n, block_n)
    px = p_ref[0, rows][:, None]
    py = p_ref[1, rows][:, None]
    pz = p_ref[2, rows][:, None]

    def body(j, carry):
        best, tile = carry
        cols = pl.ds(pl.multiple_of(j * block_m, block_m), block_m)
        dx = px - q_ref[0, cols][None, :]
        dy = py - q_ref[1, cols][None, :]
        dz = pz - q_ref[2, cols][None, :]
        d = dx * dx + dy * dy + dz * dz
        better = d < best  # strict: the earlier tile keeps a tie
        return jnp.where(better, d, best), jnp.where(better, j, tile)

    init = (jnp.full((block_n, block_m), jnp.inf, jnp.float32),
            jnp.zeros((block_n, block_m), jnp.int32))
    best, tile = lax.fori_loop(0, num_tiles, body, init)

    dmin = jnp.min(best, axis=1)
    col = lax.broadcasted_iota(jnp.int32, (block_n, block_m), 1)
    index = jnp.where(best == dmin[:, None], tile * block_m + col,
                      jnp.iinfo(jnp.int32).max)
    d_ref[rows] = dmin
    i_ref[rows] = jnp.min(index, axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("block_n", "block_m", "num_warps", "interpret"))
def nn_argmin_pallas(
    p: jnp.ndarray,
    q: jnp.ndarray,
    q_mask: Optional[jnp.ndarray] = None,
    *,
    block_n: int = 64,
    block_m: int = 64,
    num_warps: int = 4,
    interpret: bool = False,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Drop-in for ``matching.nn_argmin`` on 3-D clouds, on the GPU.

    ``block_n`` source rows per program and ``block_m`` targets per loop
    step must be powers of two. ``interpret=True`` runs the kernel in the
    Pallas interpreter (any backend; tests). Otherwise a GPU is required.

    Returns ``(idx int32[N], sqdist float32[N])``.
    """
    if p.ndim != 2 or p.shape[1] != 3 or q.ndim != 2 or q.shape[1] != 3:
        raise ValueError(
            f"nn_argmin_pallas serves 3-D clouds only (got source "
            f"{p.shape}, target {q.shape}); use ops.matching.nn_argmin")
    for name, b in (("block_n", block_n), ("block_m", block_m)):
        if b < 1 or b & (b - 1):
            raise ValueError(f"{name} must be a power of two (got {b})")
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "nn_argmin_pallas is a GPU kernel (Pallas, Triton route); the "
            f"'{jax.default_backend()}' backend cannot run it. Use "
            "matcher='xla' here, or interpret=True for a test.")

    n, m = p.shape[0], q.shape[0]
    n_pad = round_up(n, block_n)
    m_pad = round_up(m, block_m)

    p_t = jnp.zeros((3, n_pad), jnp.float32).at[:, :n].set(
        p.astype(jnp.float32).T)
    valid = jnp.arange(m_pad) < m
    if q_mask is not None:
        valid = valid & jnp.pad(q_mask.astype(bool), (0, m_pad - m))
    q_t = jnp.zeros((3, m_pad), jnp.float32).at[:, :m].set(
        q.astype(jnp.float32).T)
    q_t = jnp.where(valid[None, :], q_t,
                    jnp.array([[jnp.inf], [0.0], [0.0]], jnp.float32))

    kernel = functools.partial(_nn_kernel, block_n=block_n, block_m=block_m,
                               num_tiles=m_pad // block_m)
    d, idx = pl.pallas_call(
        kernel,
        grid=(n_pad // block_n,),
        out_shape=(jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=2),
        interpret=interpret,
        name="nn_argmin_fused",
    )(p_t, q_t)
    return idx[:n], d[:n]
