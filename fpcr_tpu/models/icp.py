"""The ICP registration loop — jit-compiled, device-resident, convergence-gated.

This is the on-device replacement for the reference's host-driven ``while``
loop (/root/reference/src/CUDA/ICP_point_to_point_clean.cu:324-461 for
point-to-point; /root/reference/src/CUDA/ICP_point_to_plane_clean.cu:579-695
for point-to-plane). The reference launches each kernel from the host,
synchronizes after every launch, and round-trips the error scalar (and for
point-to-plane the whole 6-DoF solve) through the host every iteration. Here
the entire loop — matching, moments, solve, transform, error, convergence
test — is a single ``lax.while_loop`` inside one jit: zero host↔device
traffic until the result is fetched.

Semantics parity with the reference:
  * iteration = match → minimize → transform → error, error measured between
    the *newly transformed* source and the correspondences found at the start
    of the iteration (:437-456);
  * stop when ``E < tol`` or ``|E - E_prev| < tol`` (:458-459), caps 40/50/100
    per workload (SURVEY.md §2.2); the error is always the *point* RMSE, even
    for the plane metric (reference quirk, ICP_point_to_plane_clean.cu:684-688);
  * the point-to-plane incremental rotation is the full Euler Rz·Ry·Rx
    rebuild (:648-657).

Extensions beyond the reference (all off by default or config-gated):
  * det(R) reflection correction (on by default, ``strict_reference`` mode
    reproduces the uncorrected reference math);
  * trimmed/robust ICP: correspondences beyond ``max_correspondence_dist`` are
    masked out of every reduction;
  * ``axis_name`` threads a mesh axis through all reductions so the identical
    loop runs sharded under shard_map (see fpcr_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.matching import gather_correspondences, nn_argmin
from ..ops.normals import estimate_normals
from ..ops.solve import kabsch_transform, point_to_plane_transform


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """Every compile-time ``#define`` of the reference becomes a field here
    (SURVEY.md §5 'Config / flag system')."""

    metric: str = "point"  # 'point' | 'plane' | 'symmetric' | 'gicp'
    max_iterations: int = 40  # reference caps: 40/50/100/200
    tolerance: float = 1e-6  # GPU f32 epsilon; CPU f64 used 1e-5
    k_neighbors: int = 4  # normals kNN (ICP_point_to_plane_clean.cu:436)
    # normals prepass switches from O(M²) streaming kNN to the Morton-banded
    # search above this cloud size (ops/normals.py)
    normals_banded_threshold: int = 100_000
    solver: str = "svd"  # 'svd' | 'polar' (point metric)
    det_correction: bool = True
    strict_reference: bool = False  # exact reference math (no det fix)
    damping: float = 0.0  # Levenberg damping for the 6x6 solve
    max_correspondence_dist: Optional[float] = None  # trimmed/robust ICP
    # robust auto-trim: gate matches with sqdist > factor x (iteratively
    # re-trimmed mean sqdist). None = off for exhaustive matchers, 9.0 for
    # 'morton' (whose rare window misses have unbounded distance and would
    # otherwise bias the solve).
    auto_trim: Optional[float] = None
    # IRLS robust reweighting of the solve: per-iteration weights from the
    # match residuals (scale = trimmed mean distance). None | 'huber' |
    # 'tukey'. Extends the reference's (absent) robustness story beyond the
    # hard trim gate.
    robust_loss: Optional[str] = None
    # Generalized-ICP surface-covariance regularization: per-point
    # C = I - (1-eps) n n^T (eigenvalues (eps,1,1); Segal et al. 2009).
    gicp_epsilon: float = 1e-3
    source_chunk: int = 2048
    target_tile: int = 2048
    matcher: str = "xla"  # 'xla' | 'pallas' | 'grid' | 'morton'
    exact_distances: bool = False
    # voxel-grid matcher (exact fixed-radius search; random-gather bound —
    # prefer 'morton' for speed at scale; see ops/grid.py)
    grid_cell_size: Optional[float] = None  # None = auto from target spacing
    grid_cap: int = 8
    grid_table_bits: int = 20
    # morton windowed matcher (the large-N fast path; see ops/morton.py)
    morton_chunk: int = 256
    morton_window: int = 256
    morton_unroll: int = 16
    # 2 = also query a half-cell-shifted second curve and keep the closer
    # match (covers Morton seam misses; ~2x matching cost)
    morton_shifts: int = 1
    # exact-rescue escalation for seam-heavy geometry: per iteration, the
    # `morton_rescue` source rows with the LARGEST banded match distance
    # are re-matched exactly against the full target (streaming XLA argmin,
    # cost ~ rescue/N of a brute match). 0 = off. Size it with
    # ``tune_morton`` (probe-driven) instead of guessing: on the
    # adversarial crossing-walls cloud, dual-shift + rescue of ~1.5x the
    # probed miss count removes ALL damaging misses.
    morton_rescue: int = 0

    def __post_init__(self):
        if self.metric not in ("point", "plane", "symmetric", "gicp"):
            raise ValueError(f"unknown metric {self.metric!r}")
        if self.solver not in ("svd", "polar"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.matcher not in ("xla", "pallas", "grid", "morton"):
            raise ValueError(f"unknown matcher {self.matcher!r}")
        if self.robust_loss not in (None, "huber", "tukey"):
            raise ValueError(f"unknown robust_loss {self.robust_loss!r}")
        if self.morton_rescue < 0:
            raise ValueError("morton_rescue must be >= 0")
        if not (0.0 < self.gicp_epsilon <= 1.0):
            # epsilon = 0 makes the summed covariance exactly singular for
            # parallel matched normals (the convergence regime) — the
            # Woodbury assembly would divide by zero
            raise ValueError("gicp_epsilon must be in (0, 1]")


class ICPResult(NamedTuple):
    transform: RigidTransform  # accumulated source→target estimate
    errors: jnp.ndarray  # [max_iterations] RMSE per executed iteration, NaN after stop
    num_iterations: jnp.ndarray  # int32 — iterations actually executed
    converged: jnp.ndarray  # bool
    points: jnp.ndarray  # final transformed source cloud
    # per-iteration observability (SURVEY.md §5 'Metrics / logging'; the
    # reference's printf dumps at ICP_point_to_point_clean.cu:334-398 are the
    # host-side analog). NaN after the stop iteration.
    matched_fraction: jnp.ndarray  # [max_iterations] post-trim inlier fraction
    delta_t: jnp.ndarray  # [max_iterations] ‖Δt‖ of the incremental transform
    delta_rot: jnp.ndarray  # [max_iterations] ∠ΔR (radians) of the increment


class IterationAux(NamedTuple):
    """Per-iteration diagnostics emitted by ``icp_iteration``."""

    matched_fraction: jnp.ndarray  # scalar — inliers entering the solve / N


def rotation_angle(rotation: jnp.ndarray) -> jnp.ndarray:
    """Rotation angle (radians) of a 3×3 rotation: θ = arccos((tr R − 1)/2)."""
    tr = jnp.trace(rotation)
    return jnp.arccos(jnp.clip(0.5 * (tr - 1.0), -1.0, 1.0))


class _LoopState(NamedTuple):
    points: jnp.ndarray
    source_normals: jnp.ndarray  # rotated to the current pose (symmetric /
    # gicp metrics only; a [1,3] dummy otherwise)
    transform: RigidTransform
    prev_error: jnp.ndarray
    errors: jnp.ndarray
    matched_fraction: jnp.ndarray
    delta_t: jnp.ndarray
    delta_rot: jnp.ndarray
    iteration: jnp.ndarray
    done: jnp.ndarray


def _match(points, target, target_mask, config: ICPConfig, matcher_state=None):
    """Dispatch to the configured matcher.

    Returns ``(idx, sqdist, found)`` — ``found`` is None for exhaustive
    matchers and a bool mask for the fixed-radius grid matcher.
    """
    if config.matcher == "pallas":
        from ..ops.matching_pallas import nn_argmin_pallas

        idx, d = nn_argmin_pallas(points, target, target_mask)
        return idx, d, None
    if config.matcher == "grid":
        from ..ops.grid import grid_nn

        idx, d, found = grid_nn(
            points, matcher_state, cap=config.grid_cap,
            chunk=config.source_chunk,
        )
        return idx, d, found
    idx, d = nn_argmin(
        points,
        target,
        target_mask,
        source_chunk=config.source_chunk,
        target_tile=config.target_tile,
        exact=config.exact_distances,
    )
    return idx, d, None


def resolve_matcher(config: ICPConfig, n_source: int) -> ICPConfig:
    """Degrade ``matcher='grid'`` to ``'morton'`` above the gather budget
    instead of erroring at trace time.

    The voxel-hash query gathers ``N x 27 x cap`` candidate rows; past
    ``ops.grid.MAX_CANDIDATE_GATHERS`` rows (~1.4 GB of gathered points per
    iteration) ``grid_nn`` refuses to trace it. Rather than surface that
    ValueError from deep inside a jit,
    the driver switches to the Morton banded matcher — the production
    large-N path with the same near-registered validity regime as a
    well-sized grid — and warns once at trace time. Callers who know their
    hardware tolerates more can call ``grid_nn`` directly with an explicit
    ``max_candidate_gathers``.
    """
    if config.matcher != "grid":
        return config
    from ..ops.grid import CANDIDATE_ROW_BYTES, MAX_CANDIDATE_GATHERS

    budget = n_source * 27 * config.grid_cap
    if budget <= MAX_CANDIDATE_GATHERS:
        return config
    warnings.warn(
        f"matcher='grid' candidate-gather budget {budget:,} rows "
        f"(N={n_source:,} x 27 x cap={config.grid_cap}, "
        f"{budget * CANDIDATE_ROW_BYTES / 1e9:.1f} GB of gathered points per "
        f"iteration) exceeds the limit {MAX_CANDIDATE_GATHERS:,}; falling "
        "back to matcher='morton', the production large-N path. Lower "
        "grid_cap or shard the source to stay on the grid matcher.",
        stacklevel=2,
    )
    return dataclasses.replace(config, matcher="morton")


def build_matcher_state(target, target_mask, config: ICPConfig,
                        target_normals=None):
    """Precompute per-target matcher structures (voxel hash table / Morton
    table); built once, reused every iteration."""
    if config.matcher == "grid":
        from ..ops.grid import build_voxel_table, suggest_cell_size

        cell = (jnp.float32(config.grid_cell_size)
                if config.grid_cell_size is not None
                else suggest_cell_size(target))
        return build_voxel_table(target, cell,
                                 table_bits=config.grid_table_bits,
                                 q_mask=target_mask)
    if config.matcher == "morton":
        from ..ops.morton import build_morton_table

        states = []
        for s_idx in range(max(1, config.morton_shifts)):
            table = build_morton_table(target, target_mask,
                                       shift=0.5 * s_idx)
            normals_sorted = (None if target_normals is None else
                              jnp.take(target_normals, table.orig_index,
                                       axis=0))
            states.append((table, normals_sorted))
        return tuple(states)
    return None


def _exact_rescue(points, target, target_mask, target_normals,
                  q_m, n_m, dmin, config: ICPConfig, source_mask):
    """Re-match the ``config.morton_rescue`` WORST rows (by banded match
    distance) exactly against the full target, and keep whichever match is
    closer. Seam misses on adversarial geometry (e.g. crossing walls whose
    intersection sits on the curve's top-bit boundary) have unbounded
    banded distance, so the damaging rows separate cleanly by dmin —
    measured on the crossing-walls cloud: dual-shift + rescue 1.5x the
    probed miss count leaves ZERO misses with excess > 1e-4. Static shapes throughout: one top_k, K-row streaming argmin,
    K-row scatter."""
    k = min(config.morton_rescue, points.shape[0])
    if k <= 0:
        return q_m, n_m, dmin
    score = dmin
    if source_mask is not None:
        # padded rows must not consume rescue slots
        score = jnp.where(source_mask, score, -jnp.inf)
    _, sel = lax.top_k(score, k)  # worst k rows
    p_sel = jnp.take(points, sel, axis=0)
    idx_e, d_e = nn_argmin(
        p_sel, target, target_mask,
        source_chunk=min(config.source_chunk, max(k, 8)),
        target_tile=config.target_tile,
        exact=config.exact_distances,
    )
    better = d_e < jnp.take(dmin, sel)
    q_e = gather_correspondences(target, idx_e)
    q_old = jnp.take(q_m, sel, axis=0)
    q_m = q_m.at[sel].set(jnp.where(better[:, None], q_e, q_old))
    dmin = dmin.at[sel].set(jnp.where(better, d_e, jnp.take(dmin, sel)))
    if n_m is not None and target_normals is not None:
        n_e = gather_correspondences(target_normals, idx_e)
        n_old = jnp.take(n_m, sel, axis=0)
        n_m = n_m.at[sel].set(jnp.where(better[:, None], n_e, n_old))
    return q_m, n_m, dmin


def _correspondences(points, target, target_mask, target_normals,
                     config: ICPConfig, matcher_state, source_mask=None):
    """Find correspondences: returns (q_matched, n_matched, dmin, found).

    For matcher='morton' the matched points/normals come straight from the
    dense target bands — no index gathers anywhere in the loop body.
    """
    if config.matcher == "morton":
        from ..ops.morton import morton_nn

        q_m = n_m = dmin = None
        for table, normals_sorted in matcher_state:
            q_c, d_c, _, n_c = morton_nn(
                points, table, normals_sorted,
                chunk=config.morton_chunk, window=config.morton_window,
                unroll=config.morton_unroll,
            )
            if dmin is None:
                q_m, dmin, n_m = q_c, d_c, n_c
            else:  # keep the closer match from the shifted curve
                better = (d_c < dmin)[:, None]
                q_m = jnp.where(better, q_c, q_m)
                if n_m is not None:
                    n_m = jnp.where(better, n_c, n_m)
                dmin = jnp.minimum(d_c, dmin)
        if config.morton_rescue > 0:
            q_m, n_m, dmin = _exact_rescue(
                points, target, target_mask, target_normals,
                q_m, n_m, dmin, config, source_mask)
        return q_m, n_m, dmin, None
    idx, dmin, found = _match(points, target, target_mask, config,
                              matcher_state)
    q_m = gather_correspondences(target, idx)
    n_m = (None if target_normals is None
           else gather_correspondences(target_normals, idx))
    return q_m, n_m, dmin, found


def _robust_weights(dmin, mask, loss, axis_name):
    """IRLS weights from squared match distances. Scale = sqrt of the
    trimmed mean squared distance (robust, branch-free). Huber: w = min(1,
    k·s/r); Tukey biweight: w = (1 - (r/(k·s))²)² inside, 0 outside."""
    def _ps(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    dmin = jnp.maximum(dmin, 0.0)
    finite = jnp.isfinite(dmin)
    base = finite if mask is None else (
        (mask > 0 if mask.dtype != jnp.bool_ else mask) & finite)
    w0 = base.astype(jnp.float32)
    t = _ps(jnp.sum(jnp.where(base, dmin, 0.0))) / jnp.maximum(
        _ps(jnp.sum(w0)), 1.0)
    keep = (dmin <= t) & base
    t = (_ps(jnp.sum(jnp.where(keep, dmin, 0.0)))
         / jnp.maximum(_ps(jnp.sum(keep.astype(jnp.float32))), 1.0))
    s = jnp.sqrt(jnp.maximum(t, 1e-30))
    r = jnp.sqrt(dmin)
    if loss == "huber":
        k = 1.345 * s
        w = jnp.minimum(1.0, k / jnp.maximum(r, 1e-30))
    else:  # tukey biweight
        k = 4.685 * s
        u = jnp.clip(r / k, 0.0, 1.0)
        w = (1.0 - u * u) ** 2
    return jnp.where(base, w, 0.0)


def _auto_trim_gate(dmin, mask, factor, axis_name):
    """Robust outlier gate: iteratively re-trimmed mean of the squared match
    distances (3 passes) scaled by ``factor``. Kills the unbounded miss tail
    of approximate matchers without a user-supplied threshold."""
    def _ps(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    finite = jnp.isfinite(dmin)
    base = finite if mask is None else (mask & finite)
    dmin = jnp.maximum(dmin, 0.0)  # guard f32 cancellation noise
    d_safe = jnp.where(base, dmin, 0.0)
    w = base.astype(dmin.dtype)
    t = _ps(jnp.sum(d_safe)) / jnp.maximum(_ps(jnp.sum(w)), 1.0)
    for _ in range(3):
        keep = (dmin <= t) & base
        kw = keep.astype(dmin.dtype)
        t = (_ps(jnp.sum(jnp.where(keep, dmin, 0.0)))
             / jnp.maximum(_ps(jnp.sum(kw)), 1.0))
    gate = dmin <= factor * t + 1e-12
    return gate if mask is None else (mask & gate)


def correspondence_weights(
    dmin: jnp.ndarray,
    found: Optional[jnp.ndarray],
    config: ICPConfig,
    source_mask: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
):
    """The trimming + robust-weight pipeline shared by ``icp_iteration`` and
    the AA-ICP safeguard: distance gate → auto-trim → IRLS weights.

    Returns the final solve mask (bool, float weights, or None)."""
    mask = source_mask
    if found is not None:  # grid matcher: unmatched rows leave the solve
        mask = found if mask is None else (mask & found)
    if config.max_correspondence_dist is not None:
        gate = dmin <= (config.max_correspondence_dist ** 2)
        mask = gate if mask is None else (mask & gate)

    auto_trim = config.auto_trim
    if auto_trim is None and config.matcher == "morton":
        auto_trim = 9.0
    if auto_trim:
        mask = _auto_trim_gate(dmin, mask, auto_trim, axis_name)

    if config.robust_loss is not None:
        # IRLS: weights from residual distances; every reduction downstream
        # already accepts float weights through the mask argument.
        weights = _robust_weights(dmin, mask, config.robust_loss, axis_name)
        mask = weights if mask is None else mask.astype(jnp.float32) * weights
    return mask


def _matched_fraction(mask, source_mask, n_rows, axis_name):
    """Fraction of (valid) source points entering the solve."""
    def _ps(x):
        return jax.lax.psum(x, axis_name) if axis_name is not None else x

    if source_mask is not None:
        denom = _ps(jnp.sum(source_mask.astype(jnp.float32)))
    else:
        denom = _ps(jnp.float32(n_rows))
    if mask is None:
        return jnp.float32(1.0)
    inliers = _ps(jnp.sum((mask > 0).astype(jnp.float32)))
    return inliers / jnp.maximum(denom, 1.0)


def icp_iteration(
    points: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig,
    source_mask: Optional[jnp.ndarray] = None,
    target_mask: Optional[jnp.ndarray] = None,
    target_normals: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    matcher_state=None,
    source_normals: Optional[jnp.ndarray] = None,
):
    """One ICP iteration: returns
    ``(new_points, incremental_transform, error, IterationAux)``.

    ``points``/``source_mask`` may be a shard; ``target`` is replicated.
    ``source_normals`` (already rotated to the current pose) are required
    for ``metric='symmetric'`` and ``metric='gicp'`` only.
    """
    q_matched, n_matched, dmin, found = _correspondences(
        points, target, target_mask, target_normals, config, matcher_state,
        source_mask=source_mask)

    mask = correspondence_weights(dmin, found, config, source_mask, axis_name)
    aux = IterationAux(matched_fraction=_matched_fraction(
        mask, source_mask, points.shape[0], axis_name))

    det_fix = config.det_correction and not config.strict_reference
    if config.metric == "point":
        inc = kabsch_transform(
            points, q_matched, mask,
            solver=config.solver, det_correction=det_fix, axis_name=axis_name,
        )
    elif config.metric == "symmetric":
        # Symmetric point-to-plane (Rusinkiewicz 2019): residual
        # (p−q)·(n_p + n_q) — same 6×6 linearization, symmetric normal.
        # Unoriented normals can cancel; sign-align n_q to n_p first.
        if source_normals is None:
            raise ValueError("metric='symmetric' needs source_normals")
        sgn = jnp.sign(jnp.sum(source_normals * n_matched, axis=1,
                               keepdims=True))
        sgn = jnp.where(sgn == 0, 1.0, sgn)
        inc = point_to_plane_transform(
            points, q_matched, source_normals + sgn * n_matched, mask,
            damping=config.damping, axis_name=axis_name,
        )
    elif config.metric == "gicp":
        # Generalized-ICP (Segal et al. 2009): anisotropic Mahalanobis
        # residual with surface covariances from both clouds' normals.
        if source_normals is None:
            raise ValueError("metric='gicp' needs source_normals")
        from ..ops.gicp import gicp_transform

        inc = gicp_transform(
            points, q_matched, source_normals, n_matched, mask,
            epsilon=config.gicp_epsilon, damping=config.damping,
            axis_name=axis_name,
        )
    else:
        inc = point_to_plane_transform(
            points, q_matched, n_matched, mask,
            damping=config.damping, axis_name=axis_name,
        )

    new_points = inc.apply(points)
    # Reference error semantics: new points vs this iteration's matches
    # (||p - q_idx|| / sqrt(N)). With an exhaustive matcher and no trimming,
    # `mask` equals `source_mask`, i.e. the reference's full-cloud RMSE;
    # otherwise the error is over the solve's inlier set.
    error = rmse(new_points, q_matched, mask, axis_name=axis_name)
    return new_points, inc, error, aux


def _run_icp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig,
    source_mask: Optional[jnp.ndarray],
    target_mask: Optional[jnp.ndarray],
    target_normals: Optional[jnp.ndarray],
    axis_name: Optional[str],
    source_normals: Optional[jnp.ndarray] = None,
    matcher_state=None,
) -> ICPResult:
    max_iter = config.max_iterations
    tol = jnp.float32(config.tolerance)

    # 'symmetric' and 'gicp' also carry source normals through the loop,
    # re-rotated by each increment.
    carries_src_normals = config.metric in ("symmetric", "gicp")
    if (config.metric in ("plane", "symmetric", "gicp")
            and target_normals is None):
        target_normals = estimate_normals(
            target, k=config.k_neighbors, mask=target_mask,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )
    if carries_src_normals and source_normals is None:
        source_normals = estimate_normals(
            source, k=config.k_neighbors, mask=source_mask,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )

    # grid -> morton auto-degrade above the safe gather budget, on BOTH
    # entry paths: a prebuilt grid table passed via matcher_state would
    # otherwise still hit the deep in-jit ValueError the degrade exists to
    # avoid (ADVICE r4). The distributed driver resolves per-shard before
    # building the table it passes in, so this is a no-op there.
    resolved = resolve_matcher(config, source.shape[0])
    if matcher_state is None:
        config = resolved
        # per-call default; the distributed driver builds this ONCE on the
        # replicated target outside shard_map and passes it in (otherwise
        # every shard would redo the O(M log M) table sort)
        matcher_state = build_matcher_state(target, target_mask, config,
                                            target_normals=target_normals)
    elif resolved.matcher != config.matcher:
        # the caller prebuilt a grid table above the budget: discard it and
        # rebuild for the degraded matcher (one O(M log M) sort)
        config = resolved
        matcher_state = build_matcher_state(target, target_mask, config,
                                            target_normals=target_normals)
    else:
        config = resolved

    source = source.astype(jnp.float32)
    unsort = None
    if config.matcher == "morton":
        # Pre-sort the source along the target's Morton frame ONCE: the
        # solve and error are permutation-invariant, rigid iterates keep
        # consecutive rows spatially coherent, and the loop body then runs
        # entirely gather-free (band reads only).
        from ..ops.morton import source_morton_order

        order = source_morton_order(source, matcher_state[0][0])
        source = jnp.take(source, order, axis=0)
        if source_mask is not None:
            source_mask = jnp.take(source_mask, order)
        if carries_src_normals:
            source_normals = jnp.take(source_normals, order, axis=0)
        unsort = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0], dtype=jnp.int32))

    def cond(state: _LoopState):
        return jnp.logical_and(state.iteration < max_iter, ~state.done)

    def body(state: _LoopState) -> _LoopState:
        new_points, inc, error, aux = icp_iteration(
            state.points, target, config,
            source_mask=source_mask, target_mask=target_mask,
            target_normals=target_normals, axis_name=axis_name,
            matcher_state=matcher_state,
            source_normals=(state.source_normals if carries_src_normals
                            else None),
        )
        it = state.iteration
        errors = state.errors.at[it].set(error)
        converged = jnp.logical_or(
            error < tol, jnp.abs(error - state.prev_error) < tol
        )
        # full-f32 rotation of the carried normals: default bf16 passes
        # drift ||n|| by ~5e-3/iter, which makes the GICP covariances
        # indefinite and NaNs the 6x6 Cholesky
        new_normals = (jnp.matmul(state.source_normals, inc.rotation.T,
                                  precision=jax.lax.Precision.HIGHEST)
                       if carries_src_normals else state.source_normals)
        return _LoopState(
            points=new_points,
            source_normals=new_normals,
            transform=inc.compose(state.transform),
            prev_error=error,
            errors=errors,
            matched_fraction=state.matched_fraction.at[it].set(
                aux.matched_fraction),
            delta_t=state.delta_t.at[it].set(
                jnp.linalg.norm(inc.translation)),
            delta_rot=state.delta_rot.at[it].set(
                rotation_angle(inc.rotation)),
            iteration=it + 1,
            done=converged,
        )

    nanvec = jnp.full((max_iter,), jnp.nan, dtype=jnp.float32)
    init = _LoopState(
        points=source.astype(jnp.float32),
        source_normals=(source_normals.astype(jnp.float32)
                        if carries_src_normals
                        else jnp.zeros((1, 3), jnp.float32)),
        transform=RigidTransform.identity(),
        prev_error=jnp.float32(jnp.inf),
        errors=nanvec,
        matched_fraction=nanvec,
        delta_t=nanvec,
        delta_rot=nanvec,
        iteration=jnp.int32(0),
        done=jnp.bool_(False),
    )
    final = lax.while_loop(cond, body, init)
    points_out = final.points
    if unsort is not None:
        points_out = jnp.take(points_out, unsort, axis=0)
    return ICPResult(
        transform=final.transform,
        errors=final.errors,
        num_iterations=final.iteration,
        converged=final.done,
        points=points_out,
        matched_fraction=final.matched_fraction,
        delta_t=final.delta_t,
        delta_rot=final.delta_rot,
    )


@functools.partial(jax.jit, static_argnames=("config", "axis_name"))
def run_icp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig = ICPConfig(),
    source_mask: Optional[jnp.ndarray] = None,
    target_mask: Optional[jnp.ndarray] = None,
    target_normals: Optional[jnp.ndarray] = None,
    axis_name: Optional[str] = None,
    source_normals: Optional[jnp.ndarray] = None,
    matcher_state=None,
) -> ICPResult:
    """Register ``source`` onto ``target``; the whole loop is one jit.

    ``matcher_state`` takes a prebuilt :func:`build_matcher_state` result
    (reuse the target's Morton/voxel tables across calls). An over-budget
    grid state degrades to the Morton matcher exactly like the default
    path (the table is rebuilt once).
    """
    return _run_icp(
        source, target, config, source_mask, target_mask, target_normals,
        axis_name, source_normals, matcher_state=matcher_state,
    )


def tune_morton(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: Optional[ICPConfig] = None,
    *,
    target_miss: float = 0.02,
    sample: int = 2048,
    target_mask: Optional[jnp.ndarray] = None,
) -> ICPConfig:
    """Probe-driven Morton quality tuning: returns a config whose banded
    matcher misses fewer than ``target_miss`` of true nearest neighbors on
    THIS cloud pair (measured, not guessed).

    Escalation ladder, each step validated by re-probing a strided sample
    against the exact streaming argmin:

    1. the config as given (most clouds already pass — uniform geometry
       probes ~0.2% at the default window);
    2. ``morton_shifts=2`` (half-cell-shifted second curve — covers
       fine-scale seams, ~2x matching cost);
    3. ``morton_rescue=K`` exact re-match of the K worst rows per
       iteration, K sized to cover every probed miss by its banded
       distance (damaging misses have unbounded distance, so they
       separate cleanly).

    Use before ``run_icp`` on seam-heavy geometry (thin crossing
    structures, wide displacement); the adversarial crossing-walls cloud
    lands at <2%/zero damaging misses with dual-shift + rescue where
    window widening alone plateaus at ~7.5% (the walls' intersection sits
    on the curve's top-bit boundary, which no window reaches across).
    """
    import math

    import numpy as np

    config = config or ICPConfig(matcher="morton")
    if config.matcher != "morton":
        config = dataclasses.replace(config, matcher="morton")
    src = source.astype(jnp.float32)
    tgt = target.astype(jnp.float32)

    def probe(cfg):
        state = build_matcher_state(tgt, target_mask, cfg)
        from ..ops.morton import source_morton_order

        order = source_morton_order(src, state[0][0])
        p = jnp.take(src, order, axis=0)
        _, _, dmin, _ = _correspondences(
            p, tgt, target_mask, None,
            dataclasses.replace(cfg, morton_rescue=0), state)
        # ceil stride so the sample spans the WHOLE sorted cloud — floor
        # would leave the highest-Morton-code tail (a whole curve corner,
        # where top-bit seam misses concentrate) unprobed
        stride = max(1, -(-p.shape[0] // sample))
        rows = jnp.arange(0, p.shape[0], stride)[:sample]
        _, d_e = nn_argmin(jnp.take(p, rows, axis=0), tgt, target_mask)
        d_b = jnp.take(dmin, rows)
        # a miss must beat both a relative and a scale-aware absolute
        # floor. Both distance paths compute in expansion form, so their
        # f32 disagreement scales with the COORDINATE magnitude |p|²
        # (global-frame clouds at |p|~1e3 carry ~0.1 of rounding noise);
        # what counts as *damaging* scales with the GEOMETRY extent
        # (origin-independent). Absolute constants here would misread
        # rounding noise as damaging misses far from the origin.
        excess = np.asarray(d_b - d_e)
        d_e_np = np.asarray(d_e)
        p_np = np.asarray(p, dtype=np.float64)
        abs2 = float(np.mean(np.sum(p_np ** 2, axis=1)))  # coord magnitude²
        extent2 = float(np.mean(np.sum(
            (p_np - p_np.mean(axis=0)) ** 2, axis=1)))    # geometry scale²
        noise = max(1e-6 * max(extent2, 1e-12), 4e-6 * abs2)
        miss = excess > np.maximum(noise, 1e-4 * d_e_np)
        damaging = excess > max(1e-4 * max(extent2, 1e-12), 4.0 * noise)
        miss_rate = float(miss.mean())
        # rescue K sizing: EVERY damaging miss must be covered by its
        # banded distance; mild misses only down to the residual target
        # (half of target_miss) — otherwise one near-tie mild miss with a
        # tiny distance collapses the threshold and K degenerates to N
        d_b_np = np.asarray(d_b)
        thresh = np.inf
        if damaging.any():
            thresh = float(d_b_np[damaging].min())
        mild = miss & ~damaging
        n_mild = int(mild.sum())
        allow = int(0.5 * target_miss * miss.shape[0])
        if n_mild > allow:
            # cover the (n_mild - allow) largest-distance mild misses
            md = np.sort(d_b_np[mild])[::-1]
            thresh = min(thresh, float(md[n_mild - allow - 1]))
        if np.isfinite(thresh):
            k_cover = int((np.asarray(dmin) >= thresh).sum())
        else:
            k_cover = 0
        return miss_rate, k_cover

    miss0, _ = probe(config)
    if miss0 <= target_miss:
        return config
    cfg2 = dataclasses.replace(config,
                               morton_shifts=max(config.morton_shifts, 2))
    miss2, k2 = probe(cfg2)
    if miss2 <= target_miss:
        return cfg2
    k = min(int(math.ceil(1.25 * max(k2, 1) / 256.0)) * 256, src.shape[0])
    return dataclasses.replace(cfg2, morton_rescue=k)


def _metric_wrapper(metric, source, target, kwargs) -> ICPResult:
    config = kwargs.pop("config", None)
    if config is None:
        fields = {
            k: kwargs.pop(k) for k in list(kwargs)
            if k in ICPConfig.__dataclass_fields__
        }
        if fields.pop("metric", metric) != metric:
            raise ValueError(
                f"metric is fixed to {metric!r} by this entry point; use "
                "run_icp(config=...) to pick the metric explicitly")
        config = ICPConfig(metric=metric, **fields)
    return run_icp(source, target, config, **kwargs)


def icp_point_to_point(source, target, **kwargs) -> ICPResult:
    return _metric_wrapper("point", source, target, kwargs)


def icp_point_to_plane(source, target, **kwargs) -> ICPResult:
    return _metric_wrapper("plane", source, target, kwargs)


def icp_generalized(source, target, **kwargs) -> ICPResult:
    """Generalized-ICP (plane-to-plane, Segal et al. 2009) registration."""
    return _metric_wrapper("gicp", source, target, kwargs)
