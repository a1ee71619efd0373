"""Synthetic benchmark scenes with known ground truth.

Reproduces the reference's oracle-by-construction setup: a ``z = x² - y²``
surface grid on ``[XY_min, XY_max]²`` (/root/reference/src/ICP_point_to_point.cu:103-152)
and a target cloud synthesized as ``M = R_gt·D + t_gt``
(:182-190), so registration correctness = recovering ``(R_gt, t_gt)`` and the
RMSE sequence decaying to ~0.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax.numpy as jnp
import numpy as np

from ..core.transforms import RigidTransform, gt_transform

# Reference defaults (/root/reference/src/ICP_point_to_point.cu:20-24,158-165)
DEFAULT_XY_MIN = -2.0
DEFAULT_XY_MAX = 2.0
DEFAULT_TRANSLATION = (0.8, -0.3, 0.2)
DEFAULT_ROTATION = (0.2, -0.2, 0.05)


def surface_grid(
    width: int,
    xy_min: float = DEFAULT_XY_MIN,
    xy_max: float = DEFAULT_XY_MAX,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """``width² x 3`` cloud sampling ``z = x² - y²`` on a regular grid —
    the reference's lin_space + meshgrid generator."""
    axis = np.linspace(xy_min, xy_max, width, dtype=np.float64)
    xs, ys = np.meshgrid(axis, axis, indexing="ij")
    zs = xs * xs - ys * ys
    pts = np.stack([xs.ravel(), ys.ravel(), zs.ravel()], axis=1)
    return jnp.asarray(pts, dtype=dtype)


class RegistrationScene(NamedTuple):
    source: jnp.ndarray  # D — the data cloud to be registered
    target: jnp.ndarray  # M = R_gt·D + t_gt — the model cloud
    ground_truth: RigidTransform


def synthetic_scene(
    width: int = 128,
    translation: Sequence[float] = DEFAULT_TRANSLATION,
    rotation_rad: Sequence[float] = DEFAULT_ROTATION,
    xy_min: float = DEFAULT_XY_MIN,
    xy_max: float = DEFAULT_XY_MAX,
    dtype=jnp.float32,
) -> RegistrationScene:
    """The reference's standard benchmark scene at a given grid width
    (width=32 → 1,024 pts; 100 → 10,000; 128 → 16,384)."""
    source = surface_grid(width, xy_min, xy_max, dtype)
    gt = gt_transform(translation, rotation_rad, dtype)
    target = gt.apply(source)
    return RegistrationScene(source=source, target=target, ground_truth=gt)


def transformed_scene(
    points: jnp.ndarray,
    translation: Sequence[float],
    rotation_rad: Sequence[float],
) -> RegistrationScene:
    """Build a GT-transformed scene from an arbitrary cloud (used for Bunny:
    t=(0.01,-0.04,0.02), r=(0.15,-0.1,0.05),
    /root/reference/src/CUDA/GPU_point_to_point_bunny.cu:136-152)."""
    gt = gt_transform(translation, rotation_rad, points.dtype)
    return RegistrationScene(points, gt.apply(points), gt)


def wide_plane_cloud(
    sheets: int = 18,
    grid: int = 120,
    extent: float = 5.0,
    sheet_spacing: float = 0.25,
    noise: float = 0.01,
    seed: int = 7,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Plane-dominant adversarial cloud: ``sheets`` dense (y, z) sheets of
    ``grid x grid`` points at x stations ``sheet_spacing`` apart
    (defaults: 18 x 120 x 120 = 259,200 points).

    Each x-plane of the resulting voxel table holds ~(extent/voxel)² rows,
    so a voxel's ±x face neighbour sits that many rows away in key order:
    the scene that stresses the banded NDT lookup's window."""
    rng = np.random.default_rng(seed)
    ys, zs = np.meshgrid(np.linspace(0, extent, grid, dtype=np.float32),
                         np.linspace(0, extent, grid, dtype=np.float32),
                         indexing="ij")
    out = []
    for xi in range(sheets):
        sheet = np.stack([np.full(ys.size, sheet_spacing * xi, np.float32),
                          ys.ravel(), zs.ravel()], axis=1)
        out.append(sheet + rng.normal(0, noise, sheet.shape
                                      ).astype(np.float32))
    return jnp.asarray(np.concatenate(out), dtype=dtype)


def random_cloud(
    n: int,
    seed: int = 0,
    scale: float = 1.0,
    dtype=jnp.float32,
) -> jnp.ndarray:
    """Uniform random test cloud (for property tests and large-N
    benchmarks). Seeded by ``seed`` only (a silently-ignored PRNG ``key``
    parameter was removed — review find r3: two "different" keys returned
    byte-identical clouds)."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.uniform(-scale, scale, size=(n, 3)), dtype=dtype)
