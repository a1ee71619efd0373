"""Batched closed-form symmetric 3x3 eigendecomposition — fully on device.

The reference *started* exactly this approach in its ``Normals`` CUDA kernel
(trigonometric eigenvalue formula,
/root/reference/src/CUDA/ICP_point_to_plane_clean.cu:126-147) but abandoned
the eigenvector path (dead code, constant (1,1,1)/sqrt(3) output, :149-181)
and fell back to a *host* loop of LAPACKE_ssyev calls with a D2H/H2D round
trip of all 9N covariance entries (:487-497). That host loop is the
anti-pattern an accelerator can least afford; here the whole thing is a vectorized
jnp computation over ``[..., 3, 3]`` batches: trigonometric eigenvalues
(Smith's algorithm) + cross-product eigenvectors, all VPU element-wise ops —
no LAPACK, no host, vmap/shard_map friendly.

Degenerate guards:
  * isotropic A ≈ qI (p2 → 0): eigenvalues collapse to q; eigenvector falls
    back to (1,1,1)/sqrt(3) — the same fallback direction the reference's
    device kernel ships (:163-166).
  * rank-deficient cross products: the largest-norm cross of rows of
    (A - λI) is selected; below threshold the fallback direction is used.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

# numpy (not jnp) constant: a module-level jnp op would run inside whatever
# trace first imports this module and leak a tracer into later traces.
_FALLBACK = np.array([1.0, 1.0, 1.0], dtype=np.float32) / np.sqrt(3.0)


def eigvals3(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues of symmetric ``[..., 3, 3]`` matrices, ascending
    ``[..., 3]``. Trigonometric closed form (no iteration, no LAPACK)."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]

    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2, 0.0) / 6.0)

    safe_p = jnp.where(p > 0.0, p, 1.0)
    b00, b11, b22 = (a00 - q) / safe_p, (a11 - q) / safe_p, (a22 - q) / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    # det(B) / 2 for B = (A - qI)/p
    det_b = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = jnp.clip(det_b / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0

    two_p = 2.0 * p
    lam_max = q + two_p * jnp.cos(phi)
    lam_min = q + two_p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min
    return jnp.stack([lam_min, lam_mid, lam_max], axis=-1)


def _unit_eigenvector(A: jnp.ndarray, lam: jnp.ndarray, eps: float) -> jnp.ndarray:
    """Null direction of (A - lam I) via the largest-norm cross product of its
    rows — branch-free, batched."""
    M = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    cands = jnp.stack(
        [jnp.cross(r0, r1), jnp.cross(r0, r2), jnp.cross(r1, r2)], axis=-2
    )  # [..., 3 candidates, 3]
    norms = jnp.sum(cands * cands, axis=-1)  # [..., 3]
    best = jnp.argmax(norms, axis=-1)
    v = jnp.take_along_axis(cands, best[..., None, None], axis=-2)[..., 0, :]
    n = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
    good = n[..., 0] > eps
    v_unit = v / jnp.where(n > 0, n, 1.0)
    fb = jnp.asarray(_FALLBACK, dtype=A.dtype)
    return jnp.where(good[..., None], v_unit, fb)


def smallest_eigenvector(
    A: jnp.ndarray, eps: float = 1e-20
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(eigenvector, eigenvalue) for the smallest eigenvalue of symmetric
    ``[..., 3, 3]`` batches — the PCA surface-normal direction."""
    lams = eigvals3(A)
    lam_min = lams[..., 0]
    v = _unit_eigenvector(A, lam_min, eps)
    return v, lam_min


def eigh3(A: jnp.ndarray, eps: float = 1e-20) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full decomposition: (eigvals ascending [..., 3], eigvecs [..., 3, 3]
    with ``eigvecs[..., :, k]`` the k-th eigenvector) — mirrors
    ``jnp.linalg.eigh``'s layout but closed-form and batched on the VPU."""
    lams = eigvals3(A)
    v_min = _unit_eigenvector(A, lams[..., 0], eps)
    v_max = _unit_eigenvector(A, lams[..., 2], eps)
    # Orthogonalize: v_mid completes the right-handed frame. Guard the
    # degenerate case where v_min ≈ ±v_max (isotropic A): the fallback must
    # itself be orthonormal to v_max — a fixed axis is NOT (review find r3:
    # both _unit_eigenvector fallbacks return (1,1,1)/√3, and a (0,1,0)
    # v_mid then yields a non-orthonormal frame whose V diag(1/λ) Vᵀ
    # reconstruction is O(1) wrong for isotropic voxels). Gram-Schmidt the
    # world axis least aligned with v_max instead.
    v_mid = jnp.cross(v_max, v_min)
    n = jnp.sqrt(jnp.sum(v_mid * v_mid, axis=-1, keepdims=True))
    # both inputs are unit vectors, so n = sin(angle between them): an
    # absolute ~1e-20 guard lets f32 rounding junk (n ~ 1e-8 for v_min ==
    # v_max) through and the "normalized" junk need not be orthogonal to
    # anything — require a genuinely non-degenerate angle instead
    good = n[..., 0] > 1e-4
    axis = jnp.argmin(jnp.abs(v_max), axis=-1)
    e = jnp.eye(3, dtype=A.dtype)[axis]  # [..., 3] one-hot
    t = e - v_max * jnp.sum(e * v_max, axis=-1, keepdims=True)
    t = t / jnp.sqrt(jnp.maximum(jnp.sum(t * t, axis=-1, keepdims=True),
                                 jnp.asarray(eps, A.dtype)))
    v_mid = jnp.where(
        good[..., None],
        v_mid / jnp.where(n > 0, n, 1.0),
        t,
    )
    # Re-derive v_min to guarantee an orthonormal frame even in near-repeated
    # eigenvalue cases (normalized: v_mid ⊥ v_max holds only to ~sin(angle)
    # accuracy near the degeneracy threshold).
    v_min_o = jnp.cross(v_mid, v_max)
    nmo = jnp.sqrt(jnp.sum(v_min_o * v_min_o, axis=-1, keepdims=True))
    v_min_o = v_min_o / jnp.where(nmo > 0, nmo, 1.0)
    vecs = jnp.stack([v_min_o, v_mid, v_max], axis=-1)
    return lams, vecs
