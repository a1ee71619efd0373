"""Scan-sequence odometry: register a whole trajectory of clouds in one
device program.

Beyond-reference workflow (the reference registers exactly one pair per
executable): given T frames of a moving sensor, estimate every frame's
pose in frame-0 coordinates. Structure:

* the T-1 consecutive-pair registrations are INDEPENDENT, so they run as
  one vmapped program (``models/batch.py``) — not a Python loop of T-1
  dispatches;
* pose accumulation (the only sequential part) is a prefix product of
  4x4 homogeneous matrices, computed with ``lax.associative_scan`` —
  O(log T) matmul depth instead of a T-step scan.

Convention: ``relative[t]`` maps frame t+1 coordinates into frame t
(frame t+1's cloud is registered ONTO frame t's), so
``pose[t] = rel[0] @ rel[1] @ ... @ rel[t-1]`` maps frame t into frame 0.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.transforms import RigidTransform
from .batch import register_batch
from .icp import ICPConfig, ICPResult


class OdometryResult(NamedTuple):
    poses: jnp.ndarray  # [T, 4, 4] homogeneous frame->frame-0 transforms
    relative: ICPResult  # the T-1 pairwise registrations (batched fields)

    def pose(self, t: int) -> RigidTransform:
        m = self.poses[t]
        return RigidTransform(m[:3, :3], m[:3, 3])


@functools.partial(jax.jit, static_argnames=("config",))
def register_sequence(
    frames: jnp.ndarray,
    config: ICPConfig = ICPConfig(),
) -> OdometryResult:
    """Estimate the trajectory of a cloud sequence ``frames [T, N, 3]``.

    Frame t+1 is registered onto frame t (all pairs in parallel under
    vmap), then poses accumulate by an associative prefix product.
    ``poses[0]`` is the identity.
    """
    if frames.ndim != 3 or frames.shape[0] < 2:
        raise ValueError("frames must be [T>=2, N, 3]")
    rel = register_batch(frames[1:], frames[:-1], config)  # t+1 -> t

    # homogeneous 4x4 prefix product, frame t -> frame 0
    t_minus_1 = frames.shape[0] - 1
    top = jnp.concatenate(
        [rel.transform.rotation, rel.transform.translation[:, :, None]],
        axis=2)  # [T-1, 3, 4]
    bottom = jnp.broadcast_to(
        jnp.array([[[0.0, 0.0, 0.0, 1.0]]], top.dtype), (t_minus_1, 1, 4))
    mats = jnp.concatenate([top, bottom], axis=1)  # [T-1, 4, 4]

    hi = jax.lax.Precision.HIGHEST

    def compose(a, b):  # a then... prefix product in application order
        return jnp.einsum("...ij,...jk->...ik", a, b, precision=hi)

    prefixes = jax.lax.associative_scan(compose, mats)  # [T-1, 4, 4]
    eye = jnp.eye(4, dtype=mats.dtype)[None]
    poses = jnp.concatenate([eye, prefixes], axis=0)  # [T, 4, 4]
    return OdometryResult(poses=poses, relative=rel)


def build_map(
    frames: jnp.ndarray,
    poses: jnp.ndarray,
    voxel_size,
    masks: "jnp.ndarray | None" = None,
) -> "tuple[jnp.ndarray, jnp.ndarray]":
    """Fuse a registered scan sequence into one downsampled map.

    Transforms every frame into frame-0 coordinates by its pose (one
    batched einsum), concatenates, and voxel-downsamples — the standard
    map-building epilogue of the odometry → loop-closure → pose-graph
    pipeline. Returns ``(points [T*N, 3], valid [T*N] bool)`` in the
    framework's static-shape padded-cloud convention
    (``ops/grid.py::voxel_downsample``).

    Args:
      frames: ``[T, N, 3]`` scan sequence (the odometry input).
      poses: ``[T, 4, 4]`` frame→frame-0 poses (``OdometryResult.poses``
        or the pose-graph-optimized ``PoseGraphResult.poses``).
      voxel_size: map resolution.
      masks: optional ``[T, N]`` validity masks for padded frames —
        pad rows must not fuse into the map as phantom geometry.
    """
    if frames.ndim != 3 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be [T, N, 3], got {frames.shape}")
    if poses.ndim != 3 or poses.shape[1:] != (4, 4) or \
            poses.shape[0] != frames.shape[0]:
        raise ValueError(
            f"poses must be [T={frames.shape[0]}, 4, 4], got {poses.shape}")
    return _build_map(frames, poses, jnp.float32(voxel_size), masks)


@jax.jit
def _build_map(frames, poses, voxel_size, masks):
    from ..ops.grid import voxel_downsample

    R = poses[:, :3, :3].astype(jnp.float32)
    t = poses[:, :3, 3].astype(jnp.float32)
    world = jnp.einsum("tab,tnb->tna", R, frames.astype(jnp.float32),
                       precision=jax.lax.Precision.HIGHEST) + t[:, None, :]
    flat = world.reshape(-1, 3)
    flat_mask = None if masks is None else masks.reshape(-1)
    return voxel_downsample(flat, voxel_size, flat_mask)
