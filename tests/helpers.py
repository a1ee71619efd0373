"""Shared test oracles and adversarial geometry builders.

One implementation each (review r3: ``np_nn`` was copy-pasted into four
modules and the crossing-walls cloud into three — drift risk for the exact
tolerance/geometry the adversarial tests depend on).
"""

import numpy as np


def np_nn(p, q):
    """Brute-force exact nearest neighbor in the inputs' dtype (difference
    form — the same expression the four former per-module copies used, so
    near-tie argmin ordering is unchanged), blocked for memory:
    (idx int[N], sqdist[N])."""
    p = np.asarray(p)
    q = np.asarray(q)
    idx = np.empty(p.shape[0], np.int64)
    d = np.empty(p.shape[0], p.dtype)
    block = 2048
    for s in range(0, p.shape[0], block):
        d2 = ((p[s:s + block, None, :] - q[None, :, :]) ** 2).sum(-1)
        idx[s:s + block] = d2.argmin(1)
        d[s:s + block] = d2.min(1)
    return idx, d


def crossing_walls(seed: int, n_half: int = 4096, noise: float = 0.01):
    """The adversarial Morton-seam cloud: two thin walls crossing at the
    curve's top-bit boundary — the geometry where window widening alone
    plateaus. Wall A spans
    x,z with y ~ 0; wall B spans y,z with x ~ 0 (bit-identical to the
    former per-test constructions for the same seed)."""
    rng = np.random.default_rng(seed)
    wall_a = np.stack([rng.uniform(-1, 1, n_half),
                       rng.normal(0, noise, n_half),
                       rng.uniform(-1, 1, n_half)], axis=1)
    wall_b = np.stack([rng.normal(0, noise, n_half),
                       rng.uniform(-1, 1, n_half),
                       rng.uniform(-1, 1, n_half)], axis=1)
    return np.concatenate([wall_a, wall_b]).astype(np.float32)
