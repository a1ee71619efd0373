"""Pose-graph optimization: SE(3) Gauss-Newton over a trajectory, one jit.

Completes the odometry family (``models/odometry.py``): open-loop
odometry accumulates drift; loop-closure edges (re-registrations of
non-consecutive frames, e.g. when the sensor revisits a place) constrain
the graph, and this module redistributes the error over the whole
trajectory.

Problem: poses ``X_t`` ∈ SE(3) (frame t → frame 0), edges
``(i, j, Z_ij)`` with ``Z_ij`` the measured j→i relative transform
(exactly what pairwise ICP returns). Minimize

    Σ_e  w_e · ‖ log( Z_e⁻¹ · X_i⁻¹ · X_j ) ‖²

by Gauss-Newton with right-multiplicative updates ``X ← X·exp(δ)``:
with ``A = X_i⁻¹X_j`` and ``r = log(Z⁻¹A)``, first order gives
``J_j = Jr⁻¹(r) ≈ I + ½·ad(r)`` and ``J_i = −J_j·Ad(A⁻¹)``.

Structure:

* all E edge residuals/Jacobians are built **batched** (vmapped SE(3)
  log/adjoint — closed forms, no host loops);
* the 6T×6T normal matrix is assembled **dense** with four scatter-adds
  of [E,6,6] blocks — for trajectory-scale T (tens to a few thousand
  frames) a dense on-device Cholesky beats any sparse structure
  the device can't vectorize (6T = 6,000 → one 36 MB factorization);
* gauge freedom is fixed by a strong prior on pose 0, not by matrix
  surgery — shapes stay static;
* the whole GN iteration loop is one ``lax.fori_loop`` under jit.

The CUDA reference has no multi-frame machinery at all (SURVEY §0: one
pair per executable); this is a beyond-reference subsystem.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

_PREC = jax.lax.Precision.HIGHEST


# --------------------------------------------------------------- SE(3) core
def _skew(v):
    return jnp.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])


def _so3_exp_V(w):
    """(exp([w]×), V(w)) — rotation (via ``core.transforms.rotation_exp``,
    the single SO(3)-exp implementation in this repo) and the SE(3)
    translation mixer ``V = I + b·K + c·K²`` with Taylor-safe b, c."""
    from ..core.transforms import rotation_exp

    th2 = jnp.sum(w * w)
    th = jnp.sqrt(th2)
    small = th < 1e-6
    a = jnp.where(small, 1.0 - th2 / 6.0,
                  jnp.sin(th) / jnp.where(th > 0, th, 1.0))
    b = jnp.where(small, 0.5 - th2 / 24.0,
                  (1.0 - jnp.cos(th)) / jnp.where(th2 > 0, th2, 1.0))
    c = jnp.where(small, 1.0 / 6.0 - th2 / 120.0,
                  (1.0 - a) / jnp.where(th2 > 0, th2, 1.0))
    K = _skew(w)
    K2 = jnp.matmul(K, K, precision=_PREC)
    V = jnp.eye(3) + b * K + c * K2
    return rotation_exp(w), V


def se3_exp(xi):
    """``xi = [ρ, w]`` (translation part first, matching J = [I | −K]
    conventions elsewhere in this repo) → 4×4 homogeneous matrix."""
    rho, w = xi[0:3], xi[3:6]
    R, V = _so3_exp_V(w)
    t = jnp.matmul(V, rho, precision=_PREC)
    top = jnp.concatenate([R, t[:, None]], axis=1)
    return jnp.concatenate(
        [top, jnp.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def _so3_log(R):
    """SO(3) log valid over the whole group, including θ → π.

    The skew-part formula ``v·θ/sin(θ)`` degenerates near π (v → 0 while
    the scale diverges) — and ~180° relative rotations are exactly the
    loop-closure geometry (sensor returns facing the other way). Near π
    the axis is recovered from the symmetric part instead:
    ``aaᵀ = (S − cosθ·I)/(1−cosθ)`` with ``S = (R+Rᵀ)/2`` — read off the
    strongest row — and the sign is disambiguated by the skew part.
    Both branches are computed and selected (branch-free under jit).
    """
    cos_t = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = jnp.arccos(cos_t)
    v = 0.5 * jnp.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])  # = sin(θ)·axis

    # small/moderate-angle branch
    s = jnp.where(th < 1e-6, 1.0 + th * th / 6.0,
                  th / jnp.where(jnp.sin(th) != 0.0, jnp.sin(th), 1.0))
    w_skew = v * s

    # near-π branch: axis from the symmetric part
    one_minus = jnp.maximum(1.0 - cos_t, 1e-12)
    S = 0.5 * (R + R.T)
    aaT = (S - cos_t * jnp.eye(3)) / one_minus
    diag = jnp.clip(jnp.diagonal(aaT), 0.0, None)
    k = jnp.argmax(diag)
    ak = jnp.sqrt(jnp.maximum(diag[k], 1e-12))
    a = aaT[k] / ak  # k-th row of aaᵀ / a_k = the full axis
    a = a / jnp.maximum(jnp.linalg.norm(a), 1e-12)
    # sign: match the (small but nonzero) skew part; at exactly π both
    # signs are equivalent (w and −w give the same R)
    a = jnp.where(jnp.dot(a, v) < 0.0, -a, a)
    w_sym = a * th

    return jnp.where(th > 2.9, w_sym, w_skew)


def se3_log(M):
    """4×4 homogeneous → ``xi = [ρ, w]`` with ``se3_exp(se3_log(M)) = M``."""
    R = M[:3, :3]
    t = M[:3, 3]
    w = _so3_log(R)
    _, V = _so3_exp_V(w)
    rho = jnp.linalg.solve(V, t)
    return jnp.concatenate([rho, w])


def se3_inv(M):
    R = M[:3, :3]
    t = M[:3, 3]
    Rt = R.T
    top = jnp.concatenate(
        [Rt, -jnp.matmul(Rt, t, precision=_PREC)[:, None]], axis=1)
    return jnp.concatenate(
        [top, jnp.array([[0.0, 0.0, 0.0, 1.0]])], axis=0)


def se3_adjoint(M):
    """Ad(M) [6,6] for the [ρ, w] ordering: δ' = Ad(M) δ with
    ``M·exp(δ)·M⁻¹ = exp(δ')``."""
    R = M[:3, :3]
    t = M[:3, 3]
    tx_R = jnp.matmul(_skew(t), R, precision=_PREC)
    top = jnp.concatenate([R, tx_R], axis=1)
    bot = jnp.concatenate([jnp.zeros((3, 3)), R], axis=1)
    return jnp.concatenate([top, bot], axis=0)


def _ad_small(r):
    """ad(r) [6,6] (algebra adjoint) for [ρ, w]: [[w×, ρ×], [0, w×]]."""
    rho, w = r[0:3], r[3:6]
    top = jnp.concatenate([_skew(w), _skew(rho)], axis=1)
    bot = jnp.concatenate([jnp.zeros((3, 3)), _skew(w)], axis=1)
    return jnp.concatenate([top, bot], axis=0)


# --------------------------------------------------------------- the solver
class PoseGraphResult(NamedTuple):
    poses: jnp.ndarray           # [T, 4, 4] optimized frame→frame-0 poses
    residual_rms: jnp.ndarray    # [iters] edge-residual RMS per GN iteration
    num_iterations: jnp.ndarray  # int32


@functools.partial(jax.jit, static_argnames=("iterations",))
def optimize_pose_graph(
    poses: jnp.ndarray,
    edges_i: jnp.ndarray,
    edges_j: jnp.ndarray,
    measurements: jnp.ndarray,
    weights: Optional[jnp.ndarray] = None,
    *,
    iterations: int = 10,
    damping: float = 1e-6,
    anchor_weight: float = 1e6,
) -> PoseGraphResult:
    """Gauss-Newton pose-graph optimization.

    Args:
      poses: ``[T, 4, 4]`` initial poses (e.g. ``OdometryResult.poses``).
      edges_i / edges_j: ``[E]`` int32 endpoint indices.
      measurements: ``[E, 4, 4]`` measured ``Z_ij`` = (frame j → frame i)
        relative transforms — the composition convention of
        ``models/odometry.py`` (``X_i · Z_ij ≈ X_j``).
      weights: per-edge information — either ``[E]`` scalars (Λ = w·I,
        default 1) or full ``[E, 6, 6]`` information matrices in the
        ``[ρ, w]`` tangent ordering (e.g. from
        ``models/uncertainty.information_from_covariance`` — edges from
        well-constrained registrations then pull harder, axis by axis).
      iterations: fixed GN iteration count (static — one jit).
      anchor_weight: prior stiffness pinning pose 0 (gauge fix).
    """
    T = poses.shape[0]
    E = edges_i.shape[0]
    if weights is None:
        weights = jnp.ones((E,), jnp.float32)
    weights = jnp.asarray(weights, jnp.float32)
    full_info = weights.ndim == 3
    poses = poses.astype(jnp.float32)
    meas_inv = jax.vmap(se3_inv)(measurements.astype(jnp.float32))
    if full_info:
        # Λ = L·Lᵀ, constant across GN iterations — factor ONCE here, not
        # inside every fori_loop trip
        def _chol(w):
            floor = 1e-9 * (jnp.trace(w) / 6.0) + 1e-30
            return jnp.linalg.cholesky(w + floor * jnp.eye(6))

        whiten_L = jax.vmap(_chol)(weights)
    else:
        whiten_L = jnp.sqrt(weights)

    def gn_step(it, carry):
        X, rms_hist = carry

        def edge_terms(i, j, z_inv, w):
            A = jnp.matmul(se3_inv(X[i]), X[j], precision=_PREC)
            r = se3_log(jnp.matmul(z_inv, A, precision=_PREC))
            Jj = jnp.eye(6) + 0.5 * _ad_small(r)  # Jr⁻¹(r) to first order
            Ji = -jnp.matmul(Jj, se3_adjoint(se3_inv(A)), precision=_PREC)
            if full_info:
                # whiten: JᵀΛJ = (LᵀJ)ᵀ(LᵀJ)
                return (r, jnp.matmul(w.T, Ji, precision=_PREC),
                        jnp.matmul(w.T, Jj, precision=_PREC),
                        jnp.matmul(w.T, r, precision=_PREC))
            return r, Ji * w, Jj * w, r * w

        r_all, Ji_all, Jj_all, rw_all = jax.vmap(edge_terms)(
            edges_i, edges_j, meas_inv, whiten_L)

        # dense [T,6,T,6] normal matrix via four block scatter-adds
        H = jnp.zeros((T, 6, T, 6), jnp.float32)
        g = jnp.zeros((T, 6), jnp.float32)
        JiTJi = jnp.einsum("eab,eac->ebc", Ji_all, Ji_all, precision=_PREC)
        JiTJj = jnp.einsum("eab,eac->ebc", Ji_all, Jj_all, precision=_PREC)
        JjTJj = jnp.einsum("eab,eac->ebc", Jj_all, Jj_all, precision=_PREC)
        H = H.at[edges_i, :, edges_i, :].add(JiTJi)
        H = H.at[edges_i, :, edges_j, :].add(JiTJj)
        H = H.at[edges_j, :, edges_i, :].add(
            jnp.swapaxes(JiTJj, -1, -2))
        H = H.at[edges_j, :, edges_j, :].add(JjTJj)
        g = g.at[edges_i].add(
            jnp.einsum("eab,ea->eb", Ji_all, rw_all, precision=_PREC))
        g = g.at[edges_j].add(
            jnp.einsum("eab,ea->eb", Jj_all, rw_all, precision=_PREC))

        # gauge prior on pose 0 + Levenberg floor
        Hf = H.reshape(6 * T, 6 * T)
        diag = jnp.concatenate([
            jnp.full((6,), anchor_weight, jnp.float32),
            jnp.full((6 * (T - 1),), damping, jnp.float32),
        ])
        Hf = Hf + jnp.diag(diag) + 1e-8 * jnp.eye(6 * T)
        delta = -jax.scipy.linalg.cho_solve(
            jax.scipy.linalg.cho_factor(Hf), g.reshape(6 * T))
        # never-NaN solver contract (same guard as gicp_solve_update): the
        # anchor/damping spread puts Hf at >=1e12 condition in f32, and a
        # pose disconnected from every edge (or a NaN measurement) can make
        # the Cholesky non-finite — hold the trajectory instead of
        # poisoning it
        delta = jnp.where(jnp.isfinite(delta).all(), delta, 0.0)
        delta = delta.reshape(T, 6)

        X_new = jax.vmap(
            lambda Xi, d: jnp.matmul(Xi, se3_exp(d), precision=_PREC))(
                X, delta)
        rms = jnp.sqrt(jnp.mean(jnp.sum(r_all * r_all, axis=1)))
        return X_new, rms_hist.at[it].set(rms)

    X, rms_hist = lax.fori_loop(
        0, iterations, gn_step,
        (poses, jnp.full((iterations,), jnp.nan, jnp.float32)))
    return PoseGraphResult(poses=X, residual_rms=rms_hist,
                           num_iterations=jnp.int32(iterations))


def close_loops(
    odometry,
    loop_edges_i: jnp.ndarray,
    loop_edges_j: jnp.ndarray,
    loop_measurements: jnp.ndarray,
    loop_weights: Optional[jnp.ndarray] = None,
    *,
    iterations: int = 10,
    odometry_weight: float = 1.0,
) -> PoseGraphResult:
    """Fuse an ``OdometryResult`` with loop-closure edges.

    Builds the graph from the odometry's own T−1 consecutive relative
    measurements (weight ``odometry_weight``) plus the given closures,
    then optimizes. ``loop_measurements[e]`` maps frame ``j_e`` into
    frame ``i_e`` — exactly ``ICPResult.transform`` of registering
    ``frames[j]`` onto ``frames[i]``.
    """
    poses = odometry.poses
    T = poses.shape[0]
    rel = odometry.relative.transform  # frame t+1 -> frame t, batched [T-1]
    top = jnp.concatenate(
        [rel.rotation, rel.translation[:, :, None]], axis=2)  # [T-1, 3, 4]
    bottom = jnp.broadcast_to(
        jnp.array([[[0.0, 0.0, 0.0, 1.0]]]), (T - 1, 1, 4))
    odo_meas = jnp.concatenate([top, bottom], axis=1)  # [T-1, 4, 4]

    ei = jnp.concatenate([jnp.arange(T - 1, dtype=jnp.int32),
                          jnp.asarray(loop_edges_i, jnp.int32)])
    ej = jnp.concatenate([jnp.arange(1, T, dtype=jnp.int32),
                          jnp.asarray(loop_edges_j, jnp.int32)])
    meas = jnp.concatenate([odo_meas, loop_measurements.astype(jnp.float32)])
    E_loop = loop_measurements.shape[0]
    lw = (jnp.ones((E_loop,), jnp.float32) if loop_weights is None
          else jnp.asarray(loop_weights, jnp.float32))
    if lw.ndim == 3:
        # full information closures: lift the odometry scalars to w·I
        odo_w = jnp.broadcast_to(
            odometry_weight * jnp.eye(6, dtype=jnp.float32),
            (T - 1, 6, 6))
        w = jnp.concatenate([odo_w, lw])
    else:
        w = jnp.concatenate([
            jnp.full((T - 1,), odometry_weight, jnp.float32), lw])
    return optimize_pose_graph(poses, ei, ej, meas, w,
                               iterations=iterations)


def detect_loop_closures(
    frames: jnp.ndarray,
    odometry,
    *,
    radius: float = 0.5,
    min_separation: int = 3,
    max_pairs: int = 16,
    max_error: float = 1e-3,
    config=None,
):
    """Find and verify loop-closure candidates in a scan sequence.

    Candidate pairs are frames whose *odometry-estimated* positions lie
    within ``radius`` but are at least ``min_separation`` steps apart
    (tiny host-side O(T²) scan over the trajectory — T is trajectory
    scale). Candidates are ordered by loop value — LARGEST step
    separation first, then closest — before the ``max_pairs`` cap, so
    long-range revisits survive truncation over the trivially-near
    consecutive pairs.

    Verification is ONE vmapped registration over a STATIC batch of
    ``max_pairs`` pairs (short candidate lists are padded by repetition
    — one compiled program regardless of how many candidates a given
    trajectory produces): each pair is pre-transformed by the
    odometry-predicted relative pose ``A = X_i⁻¹X_j`` so the ICP only
    has to recover the DRIFT, not the full relative pose — closures
    where the sensor returns facing a different direction verify
    correctly instead of starting a large-rotation ICP from identity.
    Pairs whose final trimmed RMSE exceeds ``max_error`` are rejected.

    Returns ``(edges_i [K], edges_j [K], measurements [K,4,4],
    weights [K])`` ready for :func:`optimize_pose_graph` /
    :func:`close_loops` (weights = 1/final_rmse², normalized to mean 1 —
    relative confidence between closures). Empty arrays if nothing
    verifies.
    """
    import numpy as np

    from .batch import register_batch
    from .icp import ICPConfig

    def _empty():
        z = jnp.zeros((0,), jnp.int32)
        return z, z, jnp.zeros((0, 4, 4), jnp.float32), jnp.zeros((0,))

    config = config or ICPConfig(max_iterations=40, auto_trim=9.0)
    poses = np.asarray(odometry.poses)
    T = poses.shape[0]
    pos = poses[:, :3, 3]
    cand = []
    for i in range(T):
        for j in range(i + min_separation, T):
            d = float(np.linalg.norm(pos[i] - pos[j]))
            if d < radius:
                cand.append((i, j, d))
    if not cand:
        return _empty()
    # loop value: prefer the largest step separation, then proximity
    cand.sort(key=lambda c: (-(c[1] - c[0]), c[2]))
    n_real = min(len(cand), max_pairs)
    cand = cand[:max_pairs]
    # pad to the static batch size — one compiled program for any count
    while len(cand) < max_pairs:
        cand.append(cand[0])

    ii = np.array([c[0] for c in cand])
    jj = np.array([c[1] for c in cand])
    # odometry-predicted relative pose A_k = X_i^-1 X_j: start each
    # verification from the prediction, register only the residual drift
    A = np.stack([np.linalg.inv(poses[i]) @ poses[j]
                  for i, j in zip(ii, jj)]).astype(np.float32)
    fj = np.asarray(frames)[jj]
    fj_pred = np.einsum("kab,knb->kna", A[:, :3, :3], fj) + A[:, None, :3, 3]
    res = register_batch(jnp.asarray(fj_pred), frames[ii], config)
    errs = np.asarray(res.errors)
    ni = np.asarray(res.num_iterations)
    final = np.array([errs[k, max(int(ni[k]) - 1, 0)]
                      for k in range(len(cand))])
    keep = np.isfinite(final) & (final < max_error)
    keep[n_real:] = False  # padded repeats never emit edges
    if not keep.any():
        return _empty()

    # measured closure Z = dZ · A (dZ = the registered residual)
    R = np.asarray(res.transform.rotation)
    t = np.asarray(res.transform.translation)
    K_all = R.shape[0]
    dZ = np.tile(np.eye(4, dtype=np.float32), (K_all, 1, 1))
    dZ[:, :3, :3] = R
    dZ[:, :3, 3] = t
    Z = np.einsum("kab,kbc->kac", dZ, A)[keep]
    w = 1.0 / np.maximum(final[keep], 1e-12) ** 2
    w = w / w.mean()
    return (jnp.asarray(ii[keep], jnp.int32), jnp.asarray(jj[keep], jnp.int32),
            jnp.asarray(Z), jnp.asarray(w, jnp.float32))
