"""NDT registration: Gauss-Newton on the voxel Gaussian field, one jit.

``run_ndt`` registers a source cloud against the NDT grid of the target
(``ops/ndt.py``): each iteration transforms the source, looks up every
point's voxel Gaussian (searchsorted + row gather — no trees), weights the
residual by the robust Magnusson mixture score, and takes a damped
Gauss-Newton step on the 6-dof pose. The whole iterate → converge loop is
a single ``lax.while_loop`` under jit, exactly like ``models/icp.py``.

Step math (small-displacement linearization per iteration, exact SO(3)
exponential retraction — the same scheme GICP uses here):

    r_i = T(p_i) − μ_v(i)            voxel residual
    w_i = d1 d2 exp(−d2/2 · r_iᵀ S_i r_i)   (robust score curvature weight)
    J_i = [I | −[T(p_i)]×]           ∂r/∂(δt, δθ)
    H   = Σ w_i J_iᵀ S_i J_i ,  g = Σ w_i J_iᵀ S_i r_i  → H δ = −g

Misses (points in unoccupied voxels) carry w=0 — they leave the assembly
through the weights, never through control flow, so shapes stay static.

The reference (brute-force CUDA ICP) has no NDT; parity anchor for the
*loop structure* is the reference's convergence-gated ICP driver
(/root/reference/src/CUDA/ICP_point_to_point_clean.cu:458-465).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.transforms import RigidTransform, rotation_exp
from ..ops.ndt import NDTGrid, build_ndt_grid, gauss_d1_d2, ndt_lookup


@dataclasses.dataclass(frozen=True)
class NDTConfig:
    """NDT knobs (mirrors ``ICPConfig``'s role for the NDT family)."""

    # grid resolution (the NDT length scale); None = auto from the target's
    # median point spacing (suggest_cell_size × 6 — aims for >=min_points
    # per occupied surface voxel)
    voxel_size: Optional[float] = None
    max_iterations: int = 50
    # stop when the GN step norm drops below this (|δθ| absolute;
    # |δt| scale-relative — normalized by 1 + |source centroid|)
    tolerance: float = 1e-6
    outlier_ratio: float = 0.55   # Magnusson mixture weight (PCL default)
    min_points: int = 4           # voxel occupancy floor
    eig_ratio: float = 0.01      # covariance eigenvalue clamp
    damping: float = 1e-6         # Levenberg diagonal added to H
    step_scale: float = 1.0       # fixed step length on δ (1 = full GN)
    neighborhood: str = "direct7"  # 'direct1' (own voxel) | 'direct7' (+6 faces)
    # voxel-row fetch strategy: 'gather' (searchsorted + row gather —
    # exact), 'banded' (Morton-band pattern: contiguous table reads +
    # one-hot extraction; needs the source sorted by voxel key — the entry
    # points handle that), 'auto' = banded at >= lookup_threshold pts
    lookup: str = "auto"
    lookup_threshold: int = 65536
    lookup_chunk: int = 512       # source rows per band read
    lookup_window: int = 512      # table rows each side of the probe rank

    def __post_init__(self):
        if self.voxel_size is not None and self.voxel_size <= 0:
            raise ValueError("voxel_size must be positive")
        if not (0.0 < self.outlier_ratio < 1.0):
            raise ValueError("outlier_ratio must be in (0, 1)")
        if self.neighborhood not in ("direct1", "direct7"):
            raise ValueError(f"unknown neighborhood {self.neighborhood!r}")
        if self.lookup not in ("auto", "gather", "banded"):
            raise ValueError(f"unknown lookup {self.lookup!r}")
        if self.lookup_chunk <= 0:
            raise ValueError("lookup_chunk must be positive")
        if self.lookup_window <= 0:
            raise ValueError("lookup_window must be positive")


def resolve_voxel_size(config: NDTConfig, target: jnp.ndarray) -> NDTConfig:
    """Fill ``voxel_size=None`` from the target's median point spacing
    (``suggest_cell_size`` × 6 — aims for ≥ ``min_points`` per occupied
    surface voxel). The ONE place the auto heuristic lives — every entry
    point (``run_ndt``, ``register_ndt``, ``distributed_ndt``) resolves
    through here."""
    if config.voxel_size is not None:
        return config
    from ..ops.grid import suggest_cell_size

    vs = float(suggest_cell_size(target, scale=6.0))
    if not (vs > 0.0) or not np.isfinite(vs):
        raise ValueError(
            "auto voxel_size failed: the target cloud has no measurable "
            "point spacing (all-duplicate or single-point); pass an "
            "explicit NDTConfig(voxel_size=...)")
    return dataclasses.replace(config, voxel_size=vs)


def _resolve_lookup(config: NDTConfig, n: int) -> NDTConfig:
    """Pin ``lookup='auto'`` to a concrete strategy for this cloud size
    (static under jit). One place, used by every entry point."""
    if config.lookup != "auto":
        return config
    mode = "banded" if n >= config.lookup_threshold else "gather"
    return dataclasses.replace(config, lookup=mode)


def resolve_ndt_config(config: NDTConfig, grid,
                       source: jnp.ndarray) -> NDTConfig:
    """Pin ``lookup='auto'`` once for a (map grid, representative scan)
    pair, so every scan of a stream runs the same compiled loop even when
    scan sizes straddle ``lookup_threshold``.

    The map-tracking pattern::

        grid = build_ndt_grid(map_cloud, 0.2)
        cfg = resolve_ndt_config(NDTConfig(voxel_size=0.2), grid, scan0)
        for scan in stream:
            run_ndt(scan, map_cloud, cfg, grid=grid)
    """
    del grid  # the lookup choice depends on the scan size only
    return _resolve_lookup(config, int(source.shape[0]))


def _assemble_Hg(w, s, sr, y):
    """Component-form GN assembly on [N] lanes: Σ over points of the
    6×6 H blocks and gradient for J = [I | −[y]×] (see the derivation in
    ``_ndt_loop``). ``s`` = (s00, s01, s02, s11, s12, s22) and ``sr`` =
    S·r per point, each weighted by ``w``.

    The component form is elementwise work plus fused reductions; batched
    3×3 einsums would turn each into a tiny matrix product.
    """
    s00, s01, s02, s11, s12, s22 = (w * c for c in s)
    sr0, sr1, sr2 = (w * c for c in sr)
    y0, y1, y2 = y

    # Jᵀ S r: t-block = S r, θ-block = (−K)ᵀ S r = y × (S r)
    g_t = jnp.stack([jnp.sum(sr0), jnp.sum(sr1), jnp.sum(sr2)])
    g_th = jnp.stack([
        jnp.sum(y1 * sr2 - y2 * sr1),
        jnp.sum(y2 * sr0 - y0 * sr2),
        jnp.sum(y0 * sr1 - y1 * sr0),
    ])
    # H blocks (6×6 symmetric), J = [I | −K], K = [y]×, Kᵀ = −K:
    #   A = Σ w S                       (t,t)
    #   B = Σ w S(−K) = −Σ w S·K        (t,θ)
    #   C = Σ w (−K)ᵀS(−K) = Σ w KᵀSK   (θ,θ) — PSD: vᵀKᵀSKv ≥ 0
    # K's columns: k0=(0,y2,−y1), k1=(−y2,0,y0), k2=(y1,−y0,0);
    # m_j = S k_j, B[:,j] = −Σ w m_j, C[i,j] = Σ w (k_i · m_j).
    m00 = s01 * y2 - s02 * y1  # (S k0)_x
    m01 = s11 * y2 - s12 * y1  # (S k0)_y
    m02 = s12 * y2 - s22 * y1  # (S k0)_z
    m10 = -s00 * y2 + s02 * y0
    m11 = -s01 * y2 + s12 * y0
    m12 = -s02 * y2 + s22 * y0
    m20 = s00 * y1 - s01 * y0
    m21 = s01 * y1 - s11 * y0
    m22 = s02 * y1 - s12 * y0
    A = jnp.stack([
        jnp.stack([jnp.sum(s00), jnp.sum(s01), jnp.sum(s02)]),
        jnp.stack([jnp.sum(s01), jnp.sum(s11), jnp.sum(s12)]),
        jnp.stack([jnp.sum(s02), jnp.sum(s12), jnp.sum(s22)]),
    ])
    B = -jnp.stack([
        jnp.stack([jnp.sum(m00), jnp.sum(m10), jnp.sum(m20)]),
        jnp.stack([jnp.sum(m01), jnp.sum(m11), jnp.sum(m21)]),
        jnp.stack([jnp.sum(m02), jnp.sum(m12), jnp.sum(m22)]),
    ])
    # C[i,j] = Σ w k_i·m_j (symmetric — 6 unique sums)
    c00 = jnp.sum(y2 * m01 - y1 * m02)
    c01 = jnp.sum(y2 * m11 - y1 * m12)
    c02 = jnp.sum(y2 * m21 - y1 * m22)
    c11 = jnp.sum(-y2 * m10 + y0 * m12)
    c12 = jnp.sum(-y2 * m20 + y0 * m22)
    c22 = jnp.sum(y1 * m20 - y0 * m21)
    C = jnp.stack([
        jnp.stack([c00, c01, c02]),
        jnp.stack([c01, c11, c12]),
        jnp.stack([c02, c12, c22]),
    ])
    H = jnp.block([[A, B], [B.T, C]])
    g = jnp.concatenate([g_t, g_th])
    return H, g


class NDTResult(NamedTuple):
    transform: RigidTransform
    errors: jnp.ndarray          # [max_iterations] mean Mahalanobis, NaN after stop
    num_iterations: jnp.ndarray  # int32
    converged: jnp.ndarray       # bool
    points: jnp.ndarray          # final transformed source
    matched_fraction: jnp.ndarray  # fraction of source points in occupied voxels


@functools.partial(jax.jit, static_argnames=("config", "axis_name"))
def _ndt_loop(source, grid: NDTGrid, config: NDTConfig,
              source_mask=None, axis_name=None):
    def _psum(v):
        return lax.psum(v, axis_name) if axis_name is not None else v

    d1f, d2f = gauss_d1_d2(config.outlier_ratio, config.voxel_size)
    d1f = abs(d1f)  # d1 < 0 in the score convention; weight uses |d1|
    d1 = jnp.float32(d1f)
    d2 = jnp.float32(d2f)
    prec = jax.lax.Precision.HIGHEST

    if config.neighborhood == "direct7":
        from ..ops.ndt import DIRECT7_OFFSETS

        offsets = list(DIRECT7_OFFSETS)
    else:
        offsets = [None]

    if config.lookup == "banded":
        from ..ops.ndt import ndt_lookup_banded

        def lookup_fn(x, g, off):
            return ndt_lookup_banded(x, g, cell_offset=off,
                                     chunk=config.lookup_chunk,
                                     window=config.lookup_window)
    else:  # 'gather' ('auto' is resolved to a concrete choice upstream)
        def lookup_fn(x, g, off):
            return ndt_lookup(x, g, cell_offset=off)

    def body(state):
        R, t, it, err_hist, delta_norm, frac = state
        # HIGHEST is mandatory: a reduced-precision (bf16/TF32) matmul
        # perturbs the transformed coordinates ~1e-3 relative, which caps
        # the NDT pose at ~1e-2 error
        x = jnp.einsum("ni,ji->nj", source, R, precision=prec) + t
        # Linearize the GN step about the source centroid, not the origin:
        # with absolute coordinates the rotation block of H scales as |x|²
        # and goes indefinite in f32 at typical global-frame LiDAR offsets
        # (|x|~500). The lever arm y = x − c is bounded by the cloud
        # extent; the pose update below is re-anchored to match.
        w_c = (source_mask.astype(jnp.float32) if source_mask is not None
               else jnp.ones((x.shape[0],), jnp.float32))
        c = (_psum(jnp.einsum("n,ni->i", w_c, x, precision=prec))
             / jnp.maximum(_psum(jnp.sum(w_c)), 1.0))
        y = x - c
        y_comp = (y[:, 0], y[:, 1], y[:, 2])

        H = jnp.zeros((6, 6), jnp.float32)
        g = jnp.zeros((6,), jnp.float32)
        err_num = jnp.float32(0.0)
        err_den = jnp.float32(0.0)
        any_hit = jnp.zeros((x.shape[0],), bool)
        # DIRECT7-style multi-voxel field: every occupied voxel in the
        # face neighborhood contributes its Gaussian (static unrolled
        # loop — no dynamic shapes, just K× the lookup + assembly).
        for off in offsets:
            mu, sinv, hit = lookup_fn(x, grid, off)
            if source_mask is not None:
                hit = hit & source_mask
            r = x - mu
            r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]
            s = (sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 0, 2],
                 sinv[:, 1, 1], sinv[:, 1, 2], sinv[:, 2, 2])
            # S r
            sr = (s[0] * r0 + s[1] * r1 + s[2] * r2,
                  s[1] * r0 + s[3] * r1 + s[4] * r2,
                  s[2] * r0 + s[4] * r1 + s[5] * r2)
            q = r0 * sr[0] + r1 * sr[1] + r2 * sr[2]  # Mahalanobis²
            w = d1 * d2 * jnp.exp(jnp.clip(-0.5 * d2 * q, -60.0, 0.0))
            w = jnp.where(hit, w, 0.0)
            any_hit = any_hit | hit
            Hc, gc = _assemble_Hg(w, s, sr, y_comp)
            H = H + Hc
            g = g + gc
            err_num = err_num + jnp.sum(jnp.where(hit, q, 0.0))
            err_den = err_den + jnp.sum(hit.astype(jnp.float32))

        # the 6x6 H / 6-vector g / scalar counters are the ONLY per-
        # iteration traffic between devices (same pattern as dist ICP's
        # moments)
        H = _psum(H)
        g = _psum(g)
        err_num = _psum(err_num)
        err_den = _psum(err_den)

        floor = config.damping + 1e-7 * (jnp.trace(H) / 6.0) + 1e-30
        Hd = H + floor * jnp.eye(6, dtype=H.dtype)
        chol, lower = jax.scipy.linalg.cho_factor(Hd)
        delta = -config.step_scale * jax.scipy.linalg.cho_solve(
            (chol, lower), g)
        # never-NaN contract (same guard as gicp/plane_solve_update): a
        # non-finite Cholesky holds the pose (identity update) and reports
        # non-convergence via delta_norm=inf instead of poisoning it
        finite = jnp.isfinite(delta).all()
        delta = jnp.where(finite, delta, 0.0)

        # centroid-anchored update: x_new = R_inc (x − c) + c + δt
        R_inc = rotation_exp(delta[3:6])
        R_new = jnp.matmul(R_inc, R, precision=prec)
        t_new = (jnp.matmul(R_inc, t - c, precision=prec) + c
                 + delta[0:3])

        err = err_num / jnp.maximum(err_den, 1.0)
        err_hist = err_hist.at[it].set(err)
        n_valid = (jnp.sum(source_mask.astype(jnp.float32))
                   if source_mask is not None
                   else jnp.float32(x.shape[0]))
        frac = (_psum(jnp.sum(any_hit.astype(jnp.float32)))
                / jnp.maximum(_psum(n_valid), 1.0))
        # scale-relative step norm, TRANSLATION ONLY: at coordinate
        # magnitude |c| the f32 representable floor of the translation is
        # ~|c|·eps per op, so an absolute |δt| < tol test can never fire
        # far from the origin — normalize δt by (1 + |c|). The rotation
        # step is centroid-anchored (lever = cloud extent, not |c|) and
        # its entries are O(1) radians: scaling it too would loosen the
        # rotation tolerance ~|c|× for global-frame clouds.
        dn = jnp.sqrt(jnp.sum(jnp.square(delta[0:3]))
                      / jnp.square(1.0 + jnp.linalg.norm(c))
                      + jnp.sum(jnp.square(delta[3:6])))
        return (R_new, t_new, it + 1, err_hist,
                jnp.where(finite, dn, jnp.inf), frac)

    def cond(state):
        _, _, it, _, delta_norm, _ = state
        return (it < config.max_iterations) & (delta_norm > config.tolerance)

    state0 = (
        jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32),
        jnp.int32(0),
        jnp.full((config.max_iterations,), jnp.nan, jnp.float32),
        jnp.float32(jnp.inf),
        jnp.float32(0.0),
    )
    R, t, it, err_hist, delta_norm, frac = lax.while_loop(cond, body, state0)
    # zero hits also yields delta = 0 (H = floor·I, g = 0) — that is a
    # registration FAILURE (disjoint clouds / empty grid), not convergence
    converged = (delta_norm <= config.tolerance) & (frac > 0.0)
    return R, t, it, err_hist, converged, frac


def run_ndt(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: Optional[NDTConfig] = None,
    *,
    grid: Optional[NDTGrid] = None,
    target_mask: Optional[jnp.ndarray] = None,
) -> NDTResult:
    """Register ``source`` onto ``target`` with NDT.

    Pass a prebuilt ``grid`` to amortize the voxelization across scans
    (the map-tracking pattern: build once, register every frame — compare
    ``models/odometry.py``).
    """
    config = config or NDTConfig()
    src = source.astype(jnp.float32)
    if grid is not None:
        # the grid's resolution is authoritative: the Magnusson d1/d2
        # constants and the direct7 neighborhood stepping must use the SAME
        # size the lookups quantize with, so a differing explicit
        # config.voxel_size is an error, not a silent override
        if isinstance(grid.voxel_size, jax.core.Tracer):
            # outer-jit composition: the grid's size is abstract, so the
            # mismatch check cannot run — require the caller to assert the
            # resolution explicitly via config.voxel_size
            if config.voxel_size is None:
                raise ValueError(
                    "run_ndt under an outer jit with a traced grid needs an "
                    "explicit config.voxel_size (the grid's resolution is "
                    "abstract at trace time); pass the size the grid was "
                    "built with")
        else:
            gvs = float(grid.voxel_size)
            if (config.voxel_size is not None
                    and abs(config.voxel_size - gvs) > 1e-6 * max(gvs, 1.0)):
                raise ValueError(
                    f"config.voxel_size={config.voxel_size} disagrees with "
                    f"the prebuilt grid's voxel_size={gvs}; pass "
                    "voxel_size=None (it is taken from the grid) or rebuild "
                    "the grid")
            config = dataclasses.replace(config, voxel_size=gvs)
    elif config.voxel_size is None:
        config = resolve_voxel_size(config, target)
    if grid is None:
        grid = build_ndt_grid(target, config.voxel_size, target_mask,
                              min_points=config.min_points,
                              eig_ratio=config.eig_ratio)
    config = _resolve_lookup(config, src.shape[0])
    src_run = src
    if config.lookup == "banded":
        # band reads need voxel-key-coherent rows; the solve is
        # permutation-invariant and the returned points are recomputed
        # from the ORIGINAL order below, so the sort never leaks out
        from ..ops.ndt import cell_key_order

        src_run = jnp.take(src, cell_key_order(src, grid), axis=0)
    R, t, it, errs, converged, frac = _ndt_loop(src_run, grid, config)
    tf = RigidTransform(rotation=R, translation=t)
    return NDTResult(transform=tf, errors=errs, num_iterations=it,
                     converged=converged, points=tf.apply(src),
                     matched_fraction=frac)


def register_ndt(
    source: jnp.ndarray,
    target: jnp.ndarray,
    icp_config=None,
    ndt_config: Optional[NDTConfig] = None,
    *,
    coarse_scale: float = 3.0,
    ndt_points: int = 16384,
):
    """NDT initialization + ICP refinement (the wide-basin pipeline).

    Two NDT stages (coarse voxels ``coarse_scale``× the fine size, then
    fine) pull the pose into ICP's convergence basin; the framework's
    exact ICP (``models/icp.py``) then polishes to its usual ~1e-6
    contract. Mirrors ``models/global_reg.register_global``'s shape: the
    returned ``ICPResult.transform`` is the COMPOSED source→target
    estimate, so downstream code (CLI, tests) treats it exactly like a
    plain ``run_icp`` result.

    Clouds larger than ``ndt_points`` are strided down for the NDT init
    stages only (the pose is what NDT produces — voxel Gaussians don't
    need full density, and the per-point voxel lookup is the one
    random-gather step in the framework). The ICP
    refinement always sees the full clouds.
    """
    import dataclasses as _dc

    from .icp import ICPConfig, run_icp

    icp_config = icp_config or ICPConfig()
    ndt_config = ndt_config or NDTConfig()
    ndt_config = resolve_voxel_size(ndt_config, target)

    src_i = source
    if ndt_points and source.shape[0] > ndt_points:
        stride = -(-source.shape[0] // ndt_points)
        src_i = source[::stride]

    coarse = _dc.replace(ndt_config,
                         voxel_size=coarse_scale * ndt_config.voxel_size)
    res_c = run_ndt(src_i, target, coarse)
    res_f = run_ndt(res_c.points, target, ndt_config)
    init = res_f.transform.compose(res_c.transform)

    res = run_icp(init.apply(source), target, icp_config)
    return res._replace(transform=res.transform.compose(init))
