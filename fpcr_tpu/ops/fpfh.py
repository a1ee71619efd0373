"""FPFH descriptors (Fast Point Feature Histograms, Rusu et al. ICRA 2009)
— the standard local geometric feature for global registration, computed
entirely on device with static shapes.

Beyond-reference capability: the reference has no features and no global
alignment at all — every driver initializes ICP from a known-small
displacement (SURVEY.md §0). FPFH + the RANSAC aligner in
``models/global_reg.py`` remove that requirement.

Design:

* neighbor pairs come from the existing streaming kNN (``ops/normals.knn``
  — O(chunk x tile) memory, never O(N²)); the per-pair Darboux angle
  features (alpha, phi, theta) are one batched [N, k] VPU computation;
* histogram binning is a ONE-HOT ENCODE + SUM over the neighbor axis —
  dense [N, k, bins] arithmetic instead of scatter-adds;
* the SPFH -> FPFH neighbor mixing (weighted by 1/distance) is a gather +
  weighted sum, one-time prepass cost like the normals prepass.

Normals must be consistently oriented for the angle signs to be
informative (``ops.normals.orient_normals``); the pipeline in
``models/global_reg.py`` does that automatically.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .normals import self_knn

_EPS = 1e-12


def _pair_features(p_i, n_i, p_j, n_j):
    """Darboux-frame angle features for point pairs.

    p_i, n_i: [N, 1, 3] query points/normals; p_j, n_j: [N, k, 3] neighbors.
    Returns (f1, f2, f3, dist): f1 = v·n_j in [-1,1], f2 = u·d̂ in [-1,1],
    f3 = atan2(w·n_j, u·n_j) in [-pi,pi], dist = ||p_j - p_i||.
    """
    d = p_j - p_i  # [N, k, 3]
    dist = jnp.sqrt(jnp.maximum(jnp.sum(d * d, axis=-1), 0.0))  # [N, k]
    dn = d / jnp.maximum(dist[..., None], _EPS)
    u = n_i  # [N, 1, 3]
    v = jnp.cross(dn, u)  # [N, k, 3]
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), _EPS)
    w = jnp.cross(u, v)
    f1 = jnp.sum(v * n_j, axis=-1)
    f2 = jnp.sum(u * dn, axis=-1)
    f3 = jnp.arctan2(jnp.sum(w * n_j, axis=-1), jnp.sum(u * n_j, axis=-1))
    return f1, f2, f3, dist


def _hist(values, lo, hi, bins, weights):
    """Weighted histogram over the neighbor axis via one-hot sums.

    values/weights: [N, k]; returns [N, bins]. No scatters — the one-hot
    comparison keeps everything dense VPU arithmetic.
    """
    t = (values - lo) / (hi - lo) * bins
    b = jnp.clip(t.astype(jnp.int32), 0, bins - 1)  # [N, k]
    onehot = (b[..., None] == jnp.arange(bins)[None, None, :])
    return jnp.sum(onehot * weights[..., None], axis=1)


@functools.partial(
    jax.jit,
    static_argnames=("k", "bins", "chunk", "tile", "banded_threshold"),
)
def fpfh_features(
    points: jnp.ndarray,
    normals: jnp.ndarray,
    k: int = 16,
    mask: Optional[jnp.ndarray] = None,
    *,
    bins: int = 11,
    chunk: int = 1024,
    tile: int = 2048,
    banded_threshold: int = 100_000,
) -> jnp.ndarray:
    """FPFH descriptor ``[N, 3*bins]`` for every point (default 33-D, the
    PCL standard 3x11 layout).

    SPFH(p) histograms the three Darboux angles over p's k neighbors; then
    FPFH(p) = SPFH(p) + (1/k) sum_j SPFH(p_j)/dist_j, each sub-histogram
    L1-normalized. ``mask`` rows (padded points) get zero descriptors.
    """
    pi = jnp.float32(jnp.pi)
    points = points.astype(jnp.float32)
    normals = normals.astype(jnp.float32)
    m = points.shape[0]

    idx_all, sqd_all = self_knn(points, k + 1, mask, chunk=chunk, tile=tile,
                                banded_threshold=banded_threshold)
    nbr_idx = idx_all[:, 1:]  # drop self
    nbr_sqd = jnp.maximum(sqd_all[:, 1:], 0.0)

    p_j = jnp.take(points, nbr_idx, axis=0)  # [N, k, 3]
    n_j = jnp.take(normals, nbr_idx, axis=0)
    f1, f2, f3, dist = _pair_features(points[:, None, :],
                                      normals[:, None, :], p_j, n_j)

    # degenerate pairs (duplicate points) contribute nothing
    wpair = (dist > 1e-9).astype(jnp.float32)
    if mask is not None:
        # pairs into padded neighbors contribute nothing either
        wpair = wpair * jnp.take(mask.astype(jnp.float32), nbr_idx)
    spfh = jnp.concatenate([
        _hist(f1, -1.0, 1.0, bins, wpair),
        _hist(f2, -1.0, 1.0, bins, wpair),
        _hist(f3, -pi, pi, bins, wpair),
    ], axis=1)  # [N, 3*bins]

    # FPFH mixing: neighbors' SPFH weighted by 1/distance
    inv_d = 1.0 / jnp.maximum(jnp.sqrt(nbr_sqd), 1e-6)  # [N, k]
    nbr_spfh = jnp.take(spfh, nbr_idx, axis=0)  # [N, k, 3*bins]
    fpfh = spfh + jnp.sum(nbr_spfh * (inv_d * wpair)[..., None],
                          axis=1) / float(k)

    # L1-normalize each of the three sub-histograms independently
    out = []
    for s in range(3):
        h = fpfh[:, s * bins:(s + 1) * bins]
        out.append(h / jnp.maximum(jnp.sum(h, axis=1, keepdims=True), _EPS))
    fpfh = jnp.concatenate(out, axis=1)
    if mask is not None:
        fpfh = fpfh * mask.astype(jnp.float32)[:, None]
    return fpfh
