"""Rigid transforms and rotation conventions.

JAX rebuild of the reference's host-side transform handling
(column-major 3x3 R + 3-vector T, e.g. /root/reference/src/ICP_point_to_point.cu:167-190
and /root/reference/src/CUDA/ICP_point_to_plane_clean.cu:648-657). Here clouds
are row-major ``[N, 3]`` jnp arrays and transforms are a small pytree, so the
whole pipeline stays jit/vmap/shard_map friendly.

Two Euler conventions exist in the reference and both are reproduced exactly:

* ``rotation_gt`` — the ground-truth scene construction matrix used by every
  driver to synthesize the target cloud ``M = R·D + t``
  (/root/reference/src/ICP_point_to_point.cu:167-172,
  /root/reference/src/CUDA/GPU_point_to_point_bunny.cu:146-152,
  /root/reference/src/CUDA/GPU_point_to_plane_real.cu:836-841).
* ``rotation_zyx`` — the standard ``Rz·Ry·Rx`` matrix used to rebuild the
  incremental rotation from the point-to-plane 6-DoF solution
  (/root/reference/src/CUDA/ICP_point_to_plane_clean.cu:649-657).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class RigidTransform(NamedTuple):
    """SE(3) transform ``x -> R @ x + t`` acting on row-major ``[N, 3]`` clouds.

    Being a NamedTuple it is automatically a JAX pytree: it can be carried
    through ``lax.scan`` / ``lax.while_loop`` and returned from jitted code.
    """

    rotation: jnp.ndarray  # [3, 3]
    translation: jnp.ndarray  # [3]

    def apply(self, points: jnp.ndarray) -> jnp.ndarray:
        """Apply to ``[..., 3]`` points (the reference's ``RyT`` kernel,
        /root/reference/src/CUDA/ICP_point_to_point_clean.cu:103-113).

        Uses full-f32 matmul precision — a reduced-precision (bf16/TF32)
        matmul would perturb every coordinate by ~1e-3 relative, wrecking the 1e-6
        convergence semantics.
        """
        return (
            jnp.matmul(points, self.rotation.T, precision=jax.lax.Precision.HIGHEST)
            + self.translation
        )

    def compose(self, other: "RigidTransform") -> "RigidTransform":
        """Return ``self ∘ other`` (first ``other``, then ``self``)."""
        hi = jax.lax.Precision.HIGHEST
        return RigidTransform(
            rotation=jnp.matmul(self.rotation, other.rotation, precision=hi),
            translation=jnp.matmul(self.rotation, other.translation, precision=hi)
            + self.translation,
        )

    def inverse(self) -> "RigidTransform":
        rt = self.rotation.T
        return RigidTransform(
            rotation=rt,
            translation=-jnp.matmul(rt, self.translation,
                                    precision=jax.lax.Precision.HIGHEST),
        )

    @staticmethod
    def identity(dtype=jnp.float32) -> "RigidTransform":
        return RigidTransform(jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype))

    def as_matrix(self) -> jnp.ndarray:
        """Return the 4x4 homogeneous matrix."""
        top = jnp.concatenate([self.rotation, self.translation[:, None]], axis=1)
        bottom = jnp.array([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype)
        return jnp.concatenate([top, bottom], axis=0)


def rotation_x(a) -> jnp.ndarray:
    c, s = jnp.cos(a), jnp.sin(a)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([one, zero, zero]),
            jnp.stack([zero, c, -s]),
            jnp.stack([zero, s, c]),
        ]
    )


def rotation_y(a) -> jnp.ndarray:
    c, s = jnp.cos(a), jnp.sin(a)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([c, zero, s]),
            jnp.stack([zero, one, zero]),
            jnp.stack([-s, zero, c]),
        ]
    )


def rotation_z(a) -> jnp.ndarray:
    c, s = jnp.cos(a), jnp.sin(a)
    one, zero = jnp.ones_like(c), jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero]),
            jnp.stack([s, c, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )


def rotation_zyx(rx, ry, rz) -> jnp.ndarray:
    """``Rz(rz) @ Ry(ry) @ Rx(rx)`` — the point-to-plane update convention.

    Written in closed form (identical entries to
    /root/reference/src/CUDA/ICP_point_to_plane_clean.cu:649-653, which stores
    column-major; this is the row-major equivalent).
    """
    cx, cy, cz = jnp.cos(rx), jnp.cos(ry), jnp.cos(rz)
    sx, sy, sz = jnp.sin(rx), jnp.sin(ry), jnp.sin(rz)
    return jnp.stack(
        [
            jnp.stack([cy * cz, cz * sx * sy - cx * sz, cx * cz * sy + sx * sz]),
            jnp.stack([cy * sz, cx * cz + sx * sy * sz, cx * sy * sz - cz * sx]),
            jnp.stack([-sy, cy * sx, cx * cy]),
        ]
    )


def rotation_gt(rx, ry, rz) -> jnp.ndarray:
    """The reference's ground-truth scene rotation.

    Exact row-major transcription of the column-major ``h_r`` construction at
    /root/reference/src/ICP_point_to_point.cu:167-172 (same formula in the
    bunny and hall-scan drivers). Row-major element (r, c) equals the
    reference's ``h_r[r + 3*c]``.
    """
    cx, cy, cz = jnp.cos(rx), jnp.cos(ry), jnp.cos(rz)
    sx, sy, sz = jnp.sin(rx), jnp.sin(ry), jnp.sin(rz)
    return jnp.stack(
        [
            jnp.stack([cy * cz, -cy * sz, sy]),
            jnp.stack([cz * sx * sy + cx * sz, cx * cz - sx * sy * sz, -cy * sx]),
            jnp.stack([-cx * cz * sy + sx * sz, cx * sy * sz + cz * sx, cx * cy]),
        ]
    )


def gt_transform(translation, rotation_rad, dtype=jnp.float32) -> RigidTransform:
    """Build the ground-truth ``RigidTransform`` the reference drivers use to
    synthesize target clouds (``M = R·D + t``)."""
    t = jnp.asarray(translation, dtype=dtype)
    rx, ry, rz = [jnp.asarray(a, dtype=dtype) for a in rotation_rad]
    return RigidTransform(rotation_gt(rx, ry, rz).astype(dtype), t)


def rotation_exp(w: jnp.ndarray) -> jnp.ndarray:
    """SO(3) exponential map (Rodrigues): rotation vector [3] → matrix.

    Branch-free small-angle handling via Taylor-safe coefficients."""
    theta2 = jnp.sum(w * w)
    theta = jnp.sqrt(theta2)
    # sin(θ)/θ and (1-cos(θ))/θ² with stable small-angle limits
    a = jnp.where(theta < 1e-6, 1.0 - theta2 / 6.0, jnp.sin(theta) / jnp.where(theta > 0, theta, 1.0))
    b = jnp.where(theta < 1e-6, 0.5 - theta2 / 24.0,
                  (1.0 - jnp.cos(theta)) / jnp.where(theta2 > 0, theta2, 1.0))
    wx = jnp.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ])
    return jnp.eye(3) + a * wx + b * jnp.matmul(wx, wx, precision=jax.lax.Precision.HIGHEST)


def rotation_log(R: jnp.ndarray) -> jnp.ndarray:
    """SO(3) logarithm: rotation matrix → rotation vector [3].

    Stable for small angles (the ICP increment regime); not intended for
    θ → π edge cases."""
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    v = 0.5 * jnp.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    # v = sin(θ)·axis ; scale by θ/sin(θ) with small-angle limit
    s = jnp.where(theta < 1e-6, 1.0 + theta * theta / 6.0,
                  theta / jnp.where(jnp.sin(theta) != 0, jnp.sin(theta), 1.0))
    return v * s


def transform_to_vector(t: "RigidTransform") -> jnp.ndarray:
    """Minimal 6-vector [rotation-vector, translation] parametrization."""
    return jnp.concatenate([rotation_log(t.rotation), t.translation])


def vector_to_transform(x: jnp.ndarray) -> "RigidTransform":
    return RigidTransform(rotation_exp(x[:3]).astype(x.dtype), x[3:6])
