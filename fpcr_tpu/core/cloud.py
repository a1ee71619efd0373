"""Point-cloud containers and padding helpers.

Clouds are plain ``float32[N, 3]`` row-major jnp arrays everywhere in this
framework (the reference stores the transpose, interleaved x1 y1 z1 ... —
/root/reference/src/my_lib.cpp:3). Compiled XLA programs want static shapes, so ragged
sizes are handled by padding to a tile multiple plus a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp
import numpy as np


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def fit_unroll(num_chunks: int, unroll: int) -> int:
    """Largest power-of-two divisor of ``num_chunks`` that is <= ``unroll``
    (>= 1). Every chunked kernel statically unrolls ``u`` chunks per loop
    step to amortize the XLA loop-step overhead; the unroll must
    divide the chunk count exactly."""
    if unroll < 1:
        raise ValueError(f"unroll must be >= 1, got {unroll}")
    # start from the largest power of two <= unroll (halving from a
    # non-power-of-two like 6 would skip the valid divisor 4)
    u = 1 << (unroll.bit_length() - 1)
    while num_chunks % u:
        u //= 2
    return max(u, 1)


def padded_chunks(n: int, chunk: int, unroll: int) -> Tuple[int, int]:
    """(num_chunks, u): chunk count for ``n`` rows padded so the static
    unroll divides it — keeping the full unroll on awkward counts (259,200
    pts → 507 chunks, largest pow2 divisor 1 → one chunk per loop step).
    Pads at most ~12.5% extra chunks; past that the waste outweighs the
    unroll and the natural count keeps its best divisor."""
    raw = round_up(max(n, 1), chunk) // chunk
    want = 1 << (max(unroll, 1).bit_length() - 1)
    padded = round_up(raw, want)
    if padded - raw <= max(1, raw // 8):
        return padded, want
    return raw, fit_unroll(raw, unroll)


class MaskedCloud(NamedTuple):
    """A fixed-capacity cloud: ``points[i]`` is valid iff ``mask[i]``."""

    points: jnp.ndarray  # [capacity, 3]
    mask: jnp.ndarray  # [capacity] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> jnp.ndarray:
        return jnp.sum(self.mask.astype(jnp.int32))


def pad_cloud(
    points: jnp.ndarray,
    multiple: int = 8,
    capacity: Optional[int] = None,
    pad_value: float = 0.0,
) -> MaskedCloud:
    """Pad ``[N, 3]`` points up to ``capacity`` (default: next multiple) with a
    validity mask. Padding rows get ``pad_value`` so they are finite and cheap.
    """
    n = points.shape[0]
    cap = capacity if capacity is not None else round_up(max(n, 1), multiple)
    if cap < n:
        raise ValueError(f"capacity {cap} < number of points {n}")
    pts = jnp.asarray(points, dtype=jnp.float32)
    padded = jnp.full((cap, 3), pad_value, dtype=jnp.float32).at[:n].set(pts)
    mask = (jnp.arange(cap) < n)
    return MaskedCloud(points=padded, mask=mask)


def as_points(x, dtype=jnp.float32) -> jnp.ndarray:
    """Coerce array-like to ``[N, 3]`` float array."""
    arr = jnp.asarray(x, dtype=dtype)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {arr.shape}")
    return arr


def to_numpy(points) -> np.ndarray:
    return np.asarray(points, dtype=np.float32)
