"""Timing & profiling utilities.

Mirrors the reference's two instrumentation styles (SURVEY.md §5):
* per-phase wall-clock accumulators with a %-of-total report
  (/root/reference/src/CUDA/ICP_point_to_point_clean.cu:319-333,464-481 —
  MKL ``dsecnd()`` around matching / minimization / transformation / error);
* min-of-k microbenchmark policy
  (/root/reference/src/CUDA/Matching_opt.cu:213-226 keeps the min of 10).

Plus ``block_until_ready``-correct timing for async dispatch, and a
``jax.profiler`` trace context for XLA-level traces.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import jax


def timed(fn: Callable, *args, repeats: int = 3):
    """``(result, first_call_s, median_s)`` of ``fn(*args)``: the first
    call includes compilation (report it as set-up); the median is over
    ``repeats`` warm calls, each ending in ``block_until_ready``."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, first, statistics.median(times)


def benchmark(
    fn: Callable,
    *args,
    repeats: int = 10,
    warmup: int = 1,
    **kwargs,
) -> Dict[str, float]:
    """Time ``fn(*args)`` with device-synchronous semantics.

    Returns dict with min/mean/max seconds over ``repeats`` (min is the
    headline, matching the reference's min-of-10 policy).
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args, **kwargs))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args, **kwargs))
        times.append(time.perf_counter() - t0)
    return {
        "min": min(times),
        "mean": sum(times) / len(times),
        "max": max(times),
        "repeats": repeats,
    }


class PhaseTimer:
    """Accumulate wall time per named phase; report like the reference's
    per-step %-of-total breakdown."""

    def __init__(self) -> None:
        self.totals: "OrderedDict[str, float]" = OrderedDict()
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [f"{'phase':<16}{'total ms':>12}{'calls':>8}{'%':>8}"]
        for name, t in self.totals.items():
            lines.append(
                f"{name:<16}{t * 1e3:>12.3f}{self.counts[name]:>8}"
                f"{100.0 * t / total:>7.1f}%"
            )
        lines.append(f"{'TOTAL':<16}{total * 1e3:>12.3f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {k: v * 1e3 for k, v in self.totals.items()}  # ms


def profile_icp(
    source,
    target,
    config,
    iterations: int = 5,
    target_normals=None,
) -> PhaseTimer:
    """Stepwise (unfused) ICP with per-phase blocking timers — the
    diagnostic twin of the production single-jit loop, reproducing the
    reference's matching/minimization/transformation/error breakdown.

    Supports the reference's two metrics (point / plane) with the brute
    streaming matcher ONLY — silently profiling a DIFFERENT algorithm than
    the one configured would mislead (review find r3), so anything else is
    rejected with a clear error.
    """
    if config.metric not in ("point", "plane"):
        raise ValueError(
            f"profile_icp breaks down the point/plane pipelines; "
            f"metric={config.metric!r} has a different solve structure — "
            "time it end-to-end with utils.timing.benchmark / bench.py "
            "instead")
    if config.matcher not in ("xla",):
        raise ValueError(
            f"profile_icp times the brute streaming matcher; "
            f"matcher={config.matcher!r} is not represented in this "
            "breakdown — use cli match-bench for kernel-level numbers")
    from ..core.metrics import rmse
    from ..ops.matching import gather_correspondences, nn_argmin
    from ..ops.normals import estimate_normals
    from ..ops.solve import kabsch_transform, point_to_plane_transform

    timer = PhaseTimer()
    match_fn = jax.jit(lambda p, q: nn_argmin(
        p, q, source_chunk=config.source_chunk, target_tile=config.target_tile))
    gather_fn = jax.jit(gather_correspondences)
    if config.metric == "plane":
        if target_normals is None:
            with timer.phase("normals"):
                target_normals = jax.block_until_ready(
                    estimate_normals(target, k=config.k_neighbors))
        solve_fn = jax.jit(point_to_plane_transform)
    else:
        solve_fn = jax.jit(lambda p, q: kabsch_transform(
            p, q, solver=config.solver,
            det_correction=config.det_correction and not config.strict_reference))
    apply_fn = jax.jit(lambda tr, p: tr.apply(p))
    err_fn = jax.jit(rmse)

    p = source
    for _ in range(iterations):
        with timer.phase("matching"):
            idx, _ = jax.block_until_ready(match_fn(p, target))
        with timer.phase("gather"):
            q_m = jax.block_until_ready(gather_fn(target, idx))
        with timer.phase("minimization"):
            if config.metric == "plane":
                n_m = gather_fn(target_normals, idx)
                inc = jax.block_until_ready(solve_fn(p, q_m, n_m))
            else:
                inc = jax.block_until_ready(solve_fn(p, q_m))
        with timer.phase("transformation"):
            p = jax.block_until_ready(apply_fn(inc, p))
        with timer.phase("error"):
            jax.block_until_ready(err_fn(p, q_m))
    return timer


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str] = None):
    """jax.profiler trace context (view with TensorBoard / xprof)."""
    if log_dir is None:
        yield
        return
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
