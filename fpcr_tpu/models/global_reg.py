"""Global registration: FPFH correspondences + batched RANSAC rigid
alignment — registers clouds from ARBITRARY initial pose, then hands off
to ICP for refinement.

Beyond-reference pipeline: every reference driver starts ICP from a small
known displacement (SURVEY.md §0); it has no answer for unknown initial
pose. This module is the standard feature-based global aligner (the
Open3D/PCL workflow), redesigned for an accelerator:

* FPFH descriptors and feature-space matching reuse the framework's
  streaming matmul machinery — ``ops.matching.nn_argmin`` is
  dimension-generic, so the 33-D feature NN search rides the MXU exactly
  like the 3-D point search;
* correspondence pruning by MUTUAL consistency (source->target and
  target->source matches must agree) — two feature searches, no host code;
* RANSAC evaluates ALL hypotheses in parallel: B minimal samples drawn
  with ``jax.random``, B Kabsch solves via a batched 3x3 SVD, and a
  [B, C] residual matrix scored in one einsum — hypothesis-parallelism is
  exactly what the hardware wants (the classic sequential-RANSAC loop
  would be latency-bound on an accelerator);
* everything static-shape, one jit end to end.

Caveat: global registration answers "which pose overlays the clouds", so
scenes with intrinsic symmetries have multiple correct answers. The
reference's own synthetic saddle z = x²−y² maps onto itself under the
proper rotation (x,y,z)->(y,x,-z) (180° about (1,1,0)/sqrt2): at large N
this pipeline may return GT∘S instead of GT — verified to be the exact
symmetric optimum (chamfer-equivalent), not an error. Asymmetric scenes
(Bunny, hall scan) have a unique answer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.transforms import RigidTransform
from ..ops.fpfh import fpfh_features
from ..ops.matching import gather_correspondences, nn_argmin
from ..ops.normals import estimate_normals, knn, orient_normals
from ..ops.solve import kabsch_transform


class GlobalRegResult(NamedTuple):
    transform: RigidTransform  # source -> target estimate
    num_inliers: jnp.ndarray  # int32 — inliers of the best hypothesis
    num_correspondences: jnp.ndarray  # int32 — mutual matches kept
    inlier_rmse: jnp.ndarray  # RMSE over the final inlier set
    tau: jnp.ndarray  # distance threshold actually used


def _estimate_spacing(cloud: jnp.ndarray, sample: int = 1024) -> jnp.ndarray:
    """Median nearest-neighbor distance of a subsample — the scale unit for
    the RANSAC inlier threshold. Delegates to the hardened
    ``ops.grid.suggest_cell_size`` (scale=1): a plain median collapses to
    ~0 on duplicate-heavy clouds, making tau ~ 0 so NO correspondence can
    ever be an inlier (review find r3 — same failure the NDT auto
    voxel-size had)."""
    from ..ops.grid import suggest_cell_size

    return jnp.maximum(suggest_cell_size(cloud, sample=sample, scale=1.0),
                       1e-12)


def _batched_kabsch(ps: jnp.ndarray, qs: jnp.ndarray):
    """Minimal-sample Kabsch for B hypotheses: ps, qs [B, s, 3] ->
    (R [B,3,3], t [B,3]). vmap of the shared ``kabsch_transform`` solver —
    the SVD/det-correction logic lives in exactly one place."""
    tr = jax.vmap(lambda a, b: kabsch_transform(a, b))(ps, qs)
    return tr.rotation, tr.translation


@functools.partial(
    jax.jit,
    static_argnames=("k_normals", "k_feature", "n_hypotheses", "sample_size",
                     "max_correspondences", "refine_rounds", "mutual"),
)
def global_registration(
    source: jnp.ndarray,
    target: jnp.ndarray,
    *,
    key: Optional[jnp.ndarray] = None,
    k_normals: int = 8,
    k_feature: int = 16,
    n_hypotheses: int = 1024,
    sample_size: int = 3,
    max_correspondences: int = 4096,
    tau: Optional[float] = None,
    refine_rounds: int = 3,
    mutual: bool = True,
) -> GlobalRegResult:
    """Estimate the source->target rigid transform with NO initial guess.

    Pipeline: oriented normals -> FPFH (33-D) on both clouds -> feature NN
    correspondences (mutually filtered) -> B-way parallel RANSAC on minimal
    samples -> masked Kabsch refinement over the inlier set.

    ``tau`` (inlier distance) defaults to 3x the SUBSAMPLED target's
    median NN spacing (correspondences live at subsample resolution).
    Refine the result with ``run_icp`` for the final 1e-6-grade pose (see
    ``register_global``).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    source = source.astype(jnp.float32)
    target = target.astype(jnp.float32)

    # Subsample FIRST, features after (the Open3D downsample-then-FPFH
    # recipe): computing descriptors for all N points and then keeping a
    # strided subset would waste ~N/C of the kNN+histogram work — the
    # dominant coarse-stage cost at large N. Both clouds are strided to
    # comparable budgets so their neighborhood densities (which shape the
    # histograms) stay comparable.
    n = source.shape[0]
    stride = max(1, -(-n // max_correspondences))  # ceil div
    src_sel = source[::stride]
    t_stride = max(1, -(-target.shape[0] // (2 * max_correspondences)))
    tgt_sel = target[::t_stride]
    c = src_sel.shape[0]

    spacing = _estimate_spacing(tgt_sel)
    tau_val = (jnp.float32(tau) if tau is not None else 3.0 * spacing)

    # features on consistently-oriented normals
    n_s = orient_normals(src_sel, estimate_normals(src_sel, k=k_normals))
    n_t = orient_normals(tgt_sel, estimate_normals(tgt_sel, k=k_normals))
    f_sel = fpfh_features(src_sel, n_s, k=k_feature)
    f_t = fpfh_features(tgt_sel, n_t, k=k_feature)

    fwd, _ = nn_argmin(f_sel, f_t)  # feature NN: [C] target-subset indices
    q_corr = gather_correspondences(tgt_sel, fwd)
    if mutual:
        # back-match the chosen target features into the SUBSAMPLED source
        # feature set: a mutual pair must be each other's nearest feature
        back, _ = nn_argmin(gather_correspondences(f_t, fwd), f_sel)
        good = back == jnp.arange(c, dtype=back.dtype)
    else:
        good = jnp.ones((c,), bool)

    # RANSAC: sample minimal sets from the good correspondences. Sampling
    # under a mask with static shapes: draw from a categorical over `good`.
    logits = jnp.where(good, 0.0, -1e30)
    samp = jax.random.categorical(
        key, logits, shape=(n_hypotheses, sample_size))
    ps = jnp.take(src_sel, samp, axis=0)  # [B, s, 3]
    qs = jnp.take(q_corr, samp, axis=0)
    R, t = _batched_kabsch(ps, qs)

    # score every hypothesis against every good correspondence
    hi = jax.lax.Precision.HIGHEST
    proj = jnp.einsum("bij,cj->bci", R, src_sel, precision=hi) + t[:, None, :]
    resid2 = jnp.sum((proj - q_corr[None, :, :]) ** 2, axis=-1)  # [B, C]
    ok = (resid2 < tau_val ** 2) & good[None, :]
    scores = jnp.sum(ok, axis=1)
    best = jnp.argmax(scores)
    R_b, t_b = R[best], t[best]

    # iterative masked-Kabsch refinement over the inlier set
    def refine(_, carry):
        R_c, t_c = carry
        pr = jnp.matmul(src_sel, R_c.T, precision=hi) + t_c
        r2 = jnp.sum((pr - q_corr) ** 2, axis=-1)
        inl = (r2 < tau_val ** 2) & good
        tr = kabsch_transform(src_sel, q_corr, inl)
        return tr.rotation, tr.translation

    R_f, t_f = jax.lax.fori_loop(0, refine_rounds, refine, (R_b, t_b))
    pr = jnp.matmul(src_sel, R_f.T, precision=hi) + t_f
    r2 = jnp.sum((pr - q_corr) ** 2, axis=-1)
    inl = (r2 < tau_val ** 2) & good
    n_inl = jnp.sum(inl)
    rmse = jnp.sqrt(jnp.sum(jnp.where(inl, r2, 0.0))
                    / jnp.maximum(n_inl, 1))
    return GlobalRegResult(
        transform=RigidTransform(R_f, t_f),
        num_inliers=n_inl.astype(jnp.int32),
        num_correspondences=jnp.sum(good).astype(jnp.int32),
        inlier_rmse=rmse,
        tau=tau_val,
    )


def register_global(source, target, config=None, **kwargs):
    """Global registration + ICP refinement: the full 'unknown initial
    pose' workflow. Returns the refined ``ICPResult`` whose transform is
    the composition (ICP increment ∘ RANSAC estimate)."""
    from .icp import ICPConfig, run_icp

    coarse = global_registration(source, target, **kwargs)
    if config is None:
        config = ICPConfig()
    init = coarse.transform.apply(source)
    res = run_icp(init, target, config)
    return res._replace(transform=res.transform.compose(coarse.transform))
