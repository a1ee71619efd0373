"""AA-ICP: Anderson-accelerated ICP.

ICP is a fixed-point iteration ``T <- g(T)`` on SE(3); its convergence is
linear and can stall on shallow error landscapes (the reference's synthetic
scene takes ~17-28 point-metric iterations). Anderson acceleration
extrapolates from the last ``m`` iterates to cut the iteration count —
the AA-ICP formulation of Pavlov et al. (arXiv:1709.05479, PAPERS.md).

Design: the transform is parametrized as the minimal 6-vector
``x = [log(R), t]`` (SO(3) log/exp in core/transforms.py); the history of
``m`` (iterate, residual) pairs lives in fixed-size buffers carried through
the ``lax.while_loop``; the mixing coefficients come from a tiny regularized
``m×m`` normal-equations solve — all static shapes, no host involvement.

Safeguard (the paper's): the accelerated candidate is *evaluated* (one extra
matching pass) and kept only if its RMSE does not regress versus the plain
ICP step; otherwise the plain step is used and the history restarts. This
keeps AA-ICP's per-iteration cost ≤ 2× plain while converging in fewer
iterations.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.metrics import rmse
from ..core.transforms import (
    RigidTransform,
    transform_to_vector,
    vector_to_transform,
)
from .icp import (
    ICPConfig,
    ICPResult,
    _correspondences,
    build_matcher_state,
    correspondence_weights,
    icp_iteration,
    rotation_angle,
)


class _AAState(NamedTuple):
    transform_vec: jnp.ndarray  # [6] current accumulated transform x_k
    hist_x: jnp.ndarray  # [m, 6] past iterates
    hist_f: jnp.ndarray  # [m, 6] past residuals f = g(x) - x
    hist_len: jnp.ndarray  # int32 valid history entries
    prev_error: jnp.ndarray
    errors: jnp.ndarray
    matched_fraction: jnp.ndarray
    delta_t: jnp.ndarray
    delta_rot: jnp.ndarray
    accepted: jnp.ndarray  # [max_iter] bool — AA candidate accepted
    iteration: jnp.ndarray
    done: jnp.ndarray


def _aa_mix(hist_x, hist_f, hist_len, x_new, f_new, reg: float):
    """Type-II Anderson mixing over the valid history rows."""
    m = hist_x.shape[0]
    # differences against the newest pair
    dF = f_new[None, :] - hist_f  # [m, 6]
    dX = x_new[None, :] - hist_x
    valid = (jnp.arange(m) < hist_len)[:, None].astype(dF.dtype)
    dFv = dF * valid
    G = dFv @ dFv.T + reg * jnp.eye(m, dtype=dF.dtype)
    b = dFv @ f_new
    gamma = jnp.linalg.solve(G, b)  # [m]
    gamma = gamma * valid[:, 0]
    # accelerated iterate: g(x) - sum gamma_j (dX_j + dF_j)
    x_acc = (x_new + f_new) - gamma @ (dX + dF)
    return x_acc


@functools.partial(
    jax.jit, static_argnames=("config", "history", "return_accepted"))
def run_aa_icp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig = ICPConfig(),
    history: int = 5,
    target_normals: Optional[jnp.ndarray] = None,
    target_mask: Optional[jnp.ndarray] = None,
    return_accepted: bool = False,
) -> ICPResult:
    """Anderson-accelerated registration; same contract as ``run_icp``.

    The returned ``points`` are the source transformed by the accumulated
    estimate. Works with every matcher/metric config (the inner step IS
    ``icp_iteration``). With ``return_accepted=True`` returns
    ``(result, accepted)`` where ``accepted[i]`` says whether iteration i
    kept the Anderson candidate (safeguard diagnostics).
    """
    from ..ops.normals import estimate_normals

    symmetric = config.metric in ("symmetric", "gicp")  # carries source normals
    if (config.metric in ("plane", "symmetric", "gicp")
            and target_normals is None):
        target_normals = estimate_normals(
            target, k=config.k_neighbors, mask=target_mask,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )
    source_normals0 = None
    if symmetric:
        source_normals0 = estimate_normals(
            source, k=config.k_neighbors,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )
    matcher_state = build_matcher_state(target, target_mask, config,
                                        target_normals=target_normals)

    source = source.astype(jnp.float32)
    unsort = None
    if config.matcher == "morton":
        from ..ops.morton import source_morton_order

        order = source_morton_order(source, matcher_state[0][0])
        source = jnp.take(source, order, axis=0)
        if symmetric:
            source_normals0 = jnp.take(source_normals0, order, axis=0)
        unsort = jnp.zeros_like(order).at[order].set(
            jnp.arange(order.shape[0], dtype=jnp.int32))

    tol = jnp.float32(config.tolerance)
    max_iter = config.max_iterations
    m = history

    def apply_vec(xvec):
        return vector_to_transform(xvec).apply(source)

    def eval_error(points):
        """RMSE of a candidate under the SAME trimming/robust weighting as
        ``icp_iteration``'s error — a like-for-like safeguard comparison."""
        q_m, _, dmin, found = _correspondences(
            points, target, target_mask, target_normals, config,
            matcher_state)
        mask = correspondence_weights(dmin, found, config)
        return rmse(points, q_m, mask)

    def plain_step(xvec):
        """One ICP iteration from accumulated transform x: returns g(x)."""
        points = apply_vec(xvec)
        normals = (jnp.matmul(source_normals0, vector_to_transform(xvec).rotation.T,
                              precision=jax.lax.Precision.HIGHEST)
                   if symmetric else None)
        _, inc, error, aux = icp_iteration(
            points, target, config, target_mask=target_mask,
            target_normals=target_normals, matcher_state=matcher_state,
            source_normals=normals,
        )
        total = inc.compose(vector_to_transform(xvec))
        return transform_to_vector(total), error, aux

    def cond(st: _AAState):
        return jnp.logical_and(st.iteration < max_iter, ~st.done)

    def body(st: _AAState) -> _AAState:
        x = st.transform_vec
        gx, _, aux = plain_step(x)
        f = gx - x

        x_acc = _aa_mix(st.hist_x, st.hist_f, st.hist_len, x, f, reg=1e-10)
        # Safeguard comparison MUST score both candidates with the same
        # operator (fresh matches at the candidate pose). icp_iteration's
        # error is the post-step RMSE against the PRE-step matches —
        # systematically higher than a fresh-match RMSE at an equally good
        # pose, which would bias acceptance toward the extrapolation
        # (review find r3; Pavlov et al. §III.B wants like-for-like).
        err_acc = eval_error(apply_vec(x_acc))
        err_plain = eval_error(apply_vec(gx))

        use_acc = jnp.logical_and(st.hist_len > 0, err_acc < err_plain)
        x_next = jnp.where(use_acc, x_acc, gx)
        err = jnp.where(use_acc, err_acc, err_plain)

        # push (x, f) into the history ring; on safeguard rejection the
        # history RESTARTS (Pavlov et al. §III.B) — only the just-pushed
        # plain-step pair stays valid, so stale rows cannot keep feeding
        # the mixer after a bad extrapolation.
        hist_x = jnp.roll(st.hist_x, 1, axis=0).at[0].set(x)
        hist_f = jnp.roll(st.hist_f, 1, axis=0).at[0].set(f)
        hist_len = jnp.where(use_acc,
                             jnp.minimum(st.hist_len + 1, m),
                             jnp.int32(1))

        it = st.iteration
        errors = st.errors.at[it].set(err)
        rel = vector_to_transform(x_next).compose(
            vector_to_transform(x).inverse())
        converged = jnp.logical_or(err < tol,
                                   jnp.abs(err - st.prev_error) < tol)
        return _AAState(
            transform_vec=x_next,
            hist_x=hist_x,
            hist_f=hist_f,
            hist_len=hist_len,
            prev_error=err,
            errors=errors,
            matched_fraction=st.matched_fraction.at[it].set(
                aux.matched_fraction),
            delta_t=st.delta_t.at[it].set(jnp.linalg.norm(rel.translation)),
            delta_rot=st.delta_rot.at[it].set(rotation_angle(rel.rotation)),
            accepted=st.accepted.at[it].set(use_acc),
            iteration=it + 1,
            done=converged,
        )

    nanvec = jnp.full((max_iter,), jnp.nan, jnp.float32)
    init = _AAState(
        transform_vec=jnp.zeros((6,), jnp.float32),
        hist_x=jnp.zeros((m, 6), jnp.float32),
        hist_f=jnp.zeros((m, 6), jnp.float32),
        hist_len=jnp.int32(0),
        prev_error=jnp.float32(jnp.inf),
        errors=nanvec,
        matched_fraction=nanvec,
        delta_t=nanvec,
        delta_rot=nanvec,
        accepted=jnp.zeros((max_iter,), bool),
        iteration=jnp.int32(0),
        done=jnp.bool_(False),
    )
    final = lax.while_loop(cond, body, init)

    transform = vector_to_transform(final.transform_vec)
    points_out = transform.apply(source)
    if unsort is not None:
        points_out = jnp.take(points_out, unsort, axis=0)
    result = ICPResult(
        transform=transform,
        errors=final.errors,
        num_iterations=final.iteration,
        converged=final.done,
        points=points_out,
        matched_fraction=final.matched_fraction,
        delta_t=final.delta_t,
        delta_rot=final.delta_rot,
    )
    if return_accepted:
        return result, final.accepted
    return result
