"""Failure detection & numerical diagnostics.

The reference's failure handling is ``cudaGetLastError`` after every launch
plus status-code early exits (/root/reference/src/CUDA/ICP_point_to_point_clean.cu:329-330,
352-356) and an SVD failure message (/root/reference/src/ICP_CPU.c:241-245).
JAX is race-free by construction (SURVEY.md §5), so the on-device
equivalents are numerical: non-finite detection on results, convergence
failure reporting, and an opt-in global NaN debugger.
"""

from __future__ import annotations

import contextlib
from typing import List

import jax
import numpy as np


class RegistrationError(RuntimeError):
    """Raised when a registration result fails validation."""


def validate_result(result, *, require_converged: bool = False,
                    context: str = "icp") -> List[str]:
    """Check an ICPResult/ICPHistory for failures. Returns a list of issue
    strings; raises RegistrationError if any are fatal."""
    issues: List[str] = []
    rot = np.asarray(result.transform.rotation)
    tra = np.asarray(result.transform.translation)
    if not np.isfinite(rot).all() or not np.isfinite(tra).all():
        issues.append("non-finite transform")
    else:
        ortho = np.abs(rot @ rot.T - np.eye(3)).max()
        if ortho > 1e-3:
            issues.append(f"rotation not orthogonal (|RRᵀ-I|={ortho:.2e})")
        det = float(np.linalg.det(rot))
        if det < 0:
            issues.append(f"reflection (det={det:.3f})")
    errors = np.asarray(result.errors)
    ni = int(result.num_iterations)
    if ni and not np.isfinite(errors[:ni]).all():
        issues.append("non-finite error sequence")
    if require_converged and not bool(result.converged):
        issues.append(f"did not converge in {ni} iterations")

    fatal = [i for i in issues if "non-finite" in i or "reflection" in i]
    if fatal:
        raise RegistrationError(f"{context}: " + "; ".join(issues))
    return issues


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped ``jax_debug_nans`` — the on-device replacement for running
    under cuda-memcheck: any NaN-producing op raises at the op that made it."""
    if not enable:
        yield
        return
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)
