"""Scaled ICP: similarity registration (rotation + translation + uniform
scale) via per-iteration Umeyama solves.

Beyond-reference model family: the reference solves rigid-only Kabsch
(/root/reference/src/CUDA/ICP_point_to_point_clean.cu:386-429). Scaled
registration matters when clouds come from sensors with unknown metric
calibration (e.g. monocular-SfM reconstructions vs LiDAR scans). Same
Same loop design as ``models/icp.py``: matching + masked psum-able
moments + on-device 3x3 SVD inside one convergence-gated
``lax.while_loop`` — zero host round trips.

Uses the exhaustive matchers ('xla' | 'pallas'); the Morton matcher's
pre-sort/band machinery assumes rigid iterates and is not wired here.

Caveat (inherent to ICP-with-scale, not an implementation limit): on
densely sampled SURFACES, nearest-neighbor matching is nearly scale-blind
— a uniformly scaled copy of a surface attracts matches tangentially and
the per-iteration scale estimate collapses toward 1. Reliable scale
recovery needs the true counterparts to be the nearest neighbors, i.e.
initial displacement below the cloud's NN spacing (volumetric clouds, or
a coarse rigid pre-alignment first).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..core.metrics import rmse
from ..core.transforms import RigidTransform
from ..ops.solve import umeyama_transform
from .icp import ICPConfig, _correspondences, correspondence_weights


class ScaledICPResult(NamedTuple):
    scale: jnp.ndarray  # accumulated uniform scale estimate
    transform: RigidTransform  # rotation/translation of x -> s·R·x + t
    errors: jnp.ndarray  # [max_iterations] RMSE, NaN after stop
    num_iterations: jnp.ndarray
    converged: jnp.ndarray
    points: jnp.ndarray  # final transformed source cloud

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        """Apply the similarity ``x -> s·R·x + t``."""
        return (self.scale
                * jnp.matmul(points, self.transform.rotation.T,
                             precision=jax.lax.Precision.HIGHEST)
                + self.transform.translation)


class _State(NamedTuple):
    points: jnp.ndarray
    scale: jnp.ndarray
    rotation: jnp.ndarray
    translation: jnp.ndarray
    prev_error: jnp.ndarray
    errors: jnp.ndarray
    iteration: jnp.ndarray
    done: jnp.ndarray


@functools.partial(jax.jit, static_argnames=("config", "with_scale"))
def run_scaled_icp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig = ICPConfig(),
    source_mask: Optional[jnp.ndarray] = None,
    target_mask: Optional[jnp.ndarray] = None,
    with_scale: bool = True,
) -> ScaledICPResult:
    """Register ``source`` onto ``target`` with a similarity transform.

    ``with_scale=False`` degenerates to rigid ICP with Umeyama's
    determinant-consistent rotation solve.
    """
    if config.matcher not in ("xla", "pallas"):
        raise ValueError(
            "run_scaled_icp supports the exhaustive matchers 'xla'|'pallas' "
            f"(got {config.matcher!r})")
    max_iter = config.max_iterations
    tol = jnp.float32(config.tolerance)
    source = source.astype(jnp.float32)
    target = target.astype(jnp.float32)

    def cond(st: _State):
        return jnp.logical_and(st.iteration < max_iter, ~st.done)

    def body(st: _State) -> _State:
        q_m, _n_m, dmin, found = _correspondences(
            st.points, target, target_mask, None, config, None)
        mask = correspondence_weights(dmin, found, config, source_mask)
        s_inc, inc = umeyama_transform(st.points, q_m, mask,
                                       with_scale=with_scale)
        new_points = s_inc * jnp.matmul(
            st.points, inc.rotation.T,
            precision=jax.lax.Precision.HIGHEST) + inc.translation
        error = rmse(new_points, q_m, mask)
        it = st.iteration
        converged = jnp.logical_or(error < tol,
                                   jnp.abs(error - st.prev_error) < tol)
        # similarity composition: (s_i, R_i, t_i) ∘ (s, R, t)
        hi = jax.lax.Precision.HIGHEST
        return _State(
            points=new_points,
            scale=s_inc * st.scale,
            rotation=jnp.matmul(inc.rotation, st.rotation, precision=hi),
            translation=(s_inc * jnp.matmul(inc.rotation, st.translation,
                                            precision=hi)
                         + inc.translation),
            prev_error=error,
            errors=st.errors.at[it].set(error),
            iteration=it + 1,
            done=converged,
        )

    init = _State(
        points=source,
        scale=jnp.float32(1.0),
        rotation=jnp.eye(3, dtype=jnp.float32),
        translation=jnp.zeros((3,), jnp.float32),
        prev_error=jnp.float32(jnp.inf),
        errors=jnp.full((max_iter,), jnp.nan, jnp.float32),
        iteration=jnp.int32(0),
        done=jnp.bool_(False),
    )
    final = lax.while_loop(cond, body, init)
    return ScaledICPResult(
        scale=final.scale,
        transform=RigidTransform(final.rotation, final.translation),
        errors=final.errors,
        num_iterations=final.iteration,
        converged=final.done,
        points=final.points,
    )
