"""Pure-numpy float64 ICP — the golden cross-check baseline.

Plays the role of the reference's CPU programs: the double-precision serial
baseline (/root/reference/src/ICP_CPU.c — MAX_ITER 200, epsilon 1e-5, f64)
and the float MKL mirror (/root/reference/src/CUDA/CPU_ICP_point_to_point.cpp)
that were used to validate the GPU math (SURVEY.md §4 'algorithmic
cross-checks'). Tests compare the JAX pipeline against this implementation;
it is deliberately simple, sequential, and dependency-free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

# reference CPU baseline defaults (ICP_CPU.c:17,267)
CPU_MAX_ITER = 200
CPU_TOLERANCE = 1e-5


@dataclass
class NumpyICPResult:
    rotation: np.ndarray
    translation: np.ndarray
    errors: List[float] = field(default_factory=list)
    iterations: int = 0
    converged: bool = False
    points: Optional[np.ndarray] = None


def nn_match(p: np.ndarray, q: np.ndarray, chunk: int = 2048) -> np.ndarray:
    """Exact brute-force NN via the BLAS matmul form
    (|p|² − 2 p·q + |q|²), row-chunked so the [N, M] block stays bounded
    (the broadcast difference form peaks at ~15 GB f64 AND runs ~100×
    slower than dgemm at the 16,384-pt flagship size). In f64 the matmul-
    form rounding is ~1e-13 relative — far below every parity tolerance."""
    q_sq = (q * q).sum(1)
    out = np.empty(p.shape[0], np.int64)
    for lo in range(0, p.shape[0], chunk):
        pc = p[lo:lo + chunk]
        d = (pc * pc).sum(1)[:, None] - 2.0 * (pc @ q.T) + q_sq[None, :]
        out[lo:lo + chunk] = d.argmin(axis=1)
    return out


def kabsch(p: np.ndarray, q: np.ndarray, det_correction: bool = True):
    p_bar, q_bar = p.mean(0), q.mean(0)
    W = (q - q_bar).T @ (p - p_bar)
    U, _, Vt = np.linalg.svd(W)
    R = U @ Vt
    if det_correction and np.linalg.det(R) < 0:
        U2 = U.copy()
        U2[:, 2] *= -1
        R = U2 @ Vt
    t = q_bar - R @ p_bar
    return R, t


def plane_solve(p: np.ndarray, q: np.ndarray, n: np.ndarray):
    c = np.cross(p, n)
    J = np.concatenate([c, n], axis=1)
    r = ((p - q) * n).sum(1)
    C = J.T @ J
    b = -(J * r[:, None]).sum(0)
    x = np.linalg.solve(C, b)
    rx, ry, rz = x[:3]

    def rot(ax, ay, az):
        cx, cy, cz = np.cos([ax, ay, az])
        sx, sy, sz = np.sin([ax, ay, az])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        return Rz @ Ry @ Rx

    return rot(rx, ry, rz), x[3:6]


def estimate_normals_np(q: np.ndarray, k: int = 4,
                        chunk: int = 1024) -> np.ndarray:
    """PCA normals from the k nearest (non-self) neighbors; row-chunked
    stable argsort (same tie-break semantics as the one-shot form, bounded
    memory at flagship sizes)."""
    m = q.shape[0]
    q_sq = (q * q).sum(1)
    nbr_idx = np.empty((m, k), np.int64)
    for lo in range(0, m, chunk):
        qc = q[lo:lo + chunk]
        d = (qc * qc).sum(1)[:, None] - 2.0 * (qc @ q.T) + q_sq[None, :]
        order = np.argsort(d, axis=1, kind="stable")
        nbr_idx[lo:lo + chunk] = order[:, 1:k + 1]  # skip self
    nbr = q[nbr_idx]
    dev = nbr - nbr.mean(1, keepdims=True)
    cov = np.einsum("mki,mkj->mij", dev, dev)
    w, v = np.linalg.eigh(cov)
    return v[:, :, 0]


def icp_numpy(
    source: np.ndarray,
    target: np.ndarray,
    metric: str = "point",
    max_iterations: int = CPU_MAX_ITER,
    tolerance: float = CPU_TOLERANCE,
    k_neighbors: int = 4,
    det_correction: bool = True,
    dtype=np.float64,
) -> NumpyICPResult:
    """Sequential double-precision ICP with the reference's loop semantics
    (match → minimize → transform → error; stop on E<tol or |ΔE|<tol)."""
    p = np.asarray(source, dtype=dtype).copy()
    q = np.asarray(target, dtype=dtype)
    R_acc = np.eye(3, dtype=dtype)
    t_acc = np.zeros(3, dtype=dtype)
    normals = estimate_normals_np(q, k_neighbors) if metric == "plane" else None

    errors: List[float] = []
    prev_e = np.inf
    converged = False
    it = 0
    for it in range(1, max_iterations + 1):
        idx = nn_match(p, q)
        q_m = q[idx]
        if metric == "point":
            R, t = kabsch(p, q_m, det_correction)
        else:
            R, t = plane_solve(p, q_m, normals[idx])
        p = p @ R.T + t
        R_acc = R @ R_acc
        t_acc = R @ t_acc + t
        e = float(np.linalg.norm(p - q_m) / np.sqrt(len(p)))
        errors.append(e)
        if e < tolerance or abs(e - prev_e) < tolerance:
            converged = True
            break
        prev_e = e

    return NumpyICPResult(
        rotation=R_acc, translation=t_acc, errors=errors,
        iterations=it, converged=converged, points=p,
    )
