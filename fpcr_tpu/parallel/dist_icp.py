"""Multi-device ICP: source points sharded over a device mesh, moments
psum'd between the devices.

The reference is strictly single-GPU (SURVEY.md §2.4: no NCCL/MPI/multi-
process anywhere); this module is the scaling design this rebuild adds:

* the source cloud is sharded along a ``points`` mesh axis (pure data
  parallelism over points — the natural axis since every ICP reduction is a
  sum over source points);
* the target cloud (and its normals) are replicated, so each shard's
  brute-force argmin already produces *global* target indices;
* the tiny per-iteration moments — 3-vector centroids, 3x3 cross-covariance,
  6x6 C / 6-vector b, squared-error scalars — are ``lax.psum``'d across the
  axis (these few hundred bytes are the *only* per-iteration traffic
  between devices; on GPUs XLA hands the psum to NCCL);
* every shard then solves the identical 3x3 SVD / 6x6 Cholesky and applies
  the identical update, so the loop state stays replicated by construction.

The same ``fpcr_tpu.models.icp`` loop runs unmodified: all its reductions
take ``axis_name``. This file just wires it into ``shard_map``.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.cloud import round_up
from ..models.icp import ICPConfig, ICPResult, _run_icp

AXIS = "points"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` devices (all by default)."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def _pad_shardable(points: jnp.ndarray, shards: int):
    """Pad to a multiple of ``shards`` and return (padded, mask)."""
    n = points.shape[0]
    cap = round_up(n, shards)
    if cap != n:
        points = jnp.pad(points, ((0, cap - n), (0, 0)))
    mask = jnp.arange(cap) < n
    return points, mask


def distributed_icp(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config: ICPConfig = ICPConfig(),
    mesh: Optional[Mesh] = None,
    target_normals: Optional[jnp.ndarray] = None,
    target_mask: Optional[jnp.ndarray] = None,
) -> ICPResult:
    """Run the full convergence-gated ICP loop with the source sharded over
    the mesh. Returns a replicated ICPResult whose ``points`` output is the
    (unpadded) transformed source.

    Matches single-device ``run_icp`` numerically up to reduction order.
    """
    if mesh is None:
        mesh = make_mesh()
    shards = mesh.devices.size
    n = source.shape[0]
    source_p, source_mask = _pad_shardable(source.astype(jnp.float32), shards)
    # grid -> morton auto-degrade when the PER-SHARD candidate-gather budget
    # exceeds the limit (models.icp.resolve_matcher); resolved here so
    # the prebuilt matcher table below matches the matcher actually run.
    from ..models.icp import resolve_matcher

    config = resolve_matcher(config, source_p.shape[0] // shards)

    if (config.metric in ("plane", "symmetric", "gicp")
            and target_normals is None):
        # Normals prepass on the replicated target (each shard would compute
        # the same thing; do it once up front).
        from ..ops.normals import estimate_normals

        target_normals = estimate_normals(
            target, k=config.k_neighbors, mask=target_mask,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )
    source_normals = None
    if config.metric in ("symmetric", "gicp"):
        # Source normals need the FULL neighborhood — compute them before
        # sharding (a per-shard kNN would miss cross-shard neighbors), then
        # shard them alongside the points.
        from ..ops.normals import estimate_normals

        source_normals = estimate_normals(
            source.astype(jnp.float32), k=config.k_neighbors,
            chunk=config.source_chunk, tile=config.target_tile,
            banded_threshold=config.normals_banded_threshold,
        )
        source_normals, _ = _pad_shardable(source_normals, shards)

    has_normals = target_normals is not None
    has_tmask = target_mask is not None

    # Build the matcher tables (Morton sort / voxel hash) ONCE on the
    # replicated target and pass them into shard_map replicated — inside
    # shard_fn every shard would redo the identical O(M log M) sort.
    from ..models.icp import build_matcher_state

    matcher_state = (build_matcher_state(
        target.astype(jnp.float32), target_mask, config,
        target_normals=target_normals)
        if config.matcher in ("grid", "morton") else ())
    ms_specs = jax.tree_util.tree_map(lambda _: P(), matcher_state)

    def shard_fn(src, snorm, smask, tgt, tnorm, tmask, mstate):
        return _run_icp(
            src, tgt, config,
            source_mask=smask,
            target_mask=tmask if has_tmask else None,
            target_normals=tnorm if has_normals else None,
            axis_name=AXIS,
            source_normals=(snorm if config.metric in ("symmetric", "gicp")
                            else None),
            matcher_state=(mstate if config.matcher in ("grid", "morton")
                           else None),
        )

    in_specs = (
        P(AXIS, None),  # source shard
        P(AXIS, None),  # source normals shard (dummy when not symmetric)
        P(AXIS),        # source mask shard
        P(),            # target replicated
        P(),            # target normals (dummy [1,3] when absent)
        P(),            # target mask (dummy [1] when absent)
        ms_specs,       # matcher tables, replicated
    )
    from ..core.transforms import RigidTransform

    out_specs = ICPResult(
        transform=RigidTransform(rotation=P(), translation=P()),
        errors=P(),
        num_iterations=P(),
        converged=P(),
        points=P(AXIS, None),
        matched_fraction=P(),  # already psum-normalized — replicated
        delta_t=P(),
        delta_rot=P(),
    )

    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    # dummies keep the pytree structure static when optional inputs are absent
    tnorm_in = target_normals if has_normals else jnp.zeros((1, 3), jnp.float32)
    tmask_in = target_mask if has_tmask else jnp.zeros((1,), bool)
    snorm_in = (source_normals if source_normals is not None
                else jnp.zeros_like(source_p))
    result = jax.jit(fn)(source_p, snorm_in, source_mask,
                         target.astype(jnp.float32), tnorm_in, tmask_in,
                         matcher_state)
    return result._replace(points=result.points[:n])


def distributed_ndt(
    source: jnp.ndarray,
    target: jnp.ndarray,
    config=None,
    mesh: Optional[Mesh] = None,
    target_mask: Optional[jnp.ndarray] = None,
):
    """NDT registration with the source sharded over the mesh.

    Same decomposition as ``distributed_icp``: the voxel Gaussian grid is
    built once on the replicated target (every shard needs the whole
    field), source points are sharded along ``points``, and the per-
    iteration 6x6 H / 6-vector g / scalar counters are psum'd —
    the grid itself never moves after the one-time build. Returns a
    replicated ``NDTResult`` (``points`` unpadded).
    """
    from ..core.transforms import RigidTransform
    from ..models.ndt import (NDTConfig, NDTResult, _ndt_loop,
                              resolve_voxel_size)
    from ..ops.ndt import build_ndt_grid

    if mesh is None:
        mesh = make_mesh()
    config = resolve_voxel_size(config or NDTConfig(), target)
    shards = mesh.devices.size
    n = source.shape[0]
    src = source.astype(jnp.float32)
    grid = build_ndt_grid(target, config.voxel_size, target_mask,
                          min_points=config.min_points,
                          eig_ratio=config.eig_ratio)
    from ..models.ndt import _resolve_lookup

    config = _resolve_lookup(config, n)
    order = None
    if config.lookup == "banded":
        # global voxel-key sort BEFORE sharding: each shard then holds a
        # contiguous coherent block, exactly what the band reads need
        from ..ops.ndt import cell_key_order

        order = cell_key_order(src, grid)
        src = jnp.take(src, order, axis=0)
    source_p, source_mask = _pad_shardable(src, shards)

    def shard_fn(src, smask, g):
        R, t, it, errs, conv, frac = _ndt_loop(
            src, g, config, source_mask=smask, axis_name=AXIS)
        tf = RigidTransform(rotation=R, translation=t)
        return NDTResult(transform=tf, errors=errs, num_iterations=it,
                         converged=conv, points=tf.apply(src),
                         matched_fraction=frac)

    in_specs = (P(AXIS, None), P(AXIS), P())
    out_specs = NDTResult(
        transform=RigidTransform(rotation=P(), translation=P()),
        errors=P(), num_iterations=P(), converged=P(),
        points=P(AXIS, None), matched_fraction=P(),
    )
    fn = jax.shard_map(shard_fn, mesh=mesh, in_specs=in_specs,
                       out_specs=out_specs, check_vma=False)
    result = jax.jit(fn)(source_p, source_mask, grid)
    pts = result.points[:n]
    if order is not None:  # undo the coherence sort (original row order)
        pts = jnp.zeros_like(pts).at[order].set(pts)
    return result._replace(points=pts)
