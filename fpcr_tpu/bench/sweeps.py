"""Benchmark sweeps reproducing the reference's performance studies.

* ``time_complexity_sweep`` — one ICP iteration per cloud size over a width
  range, the reference's L5 harness
  (/root/reference/src/CUDA/GPU_time_complexity_point.cu:103-460: WIDTH
  3..128, MAX_ITER 1, "N,ms" CSV; plane variant GPU_time_complexity_plane.cu).
* ``matching_benchmark`` — the matching-kernel microbenchmark ladder
  (/root/reference/src/CUDA/Matching_opt.cu:58-243, min-of-10 policy), with
  this framework's variants: XLA matmul-form, XLA exact-form, Pallas kernel.

Both return rows and optionally emit reference-format CSVs via
``fpcr_tpu.utils.csvout``.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from ..data.synthetic import synthetic_scene
from ..models.icp import ICPConfig, run_icp
from ..utils.csvout import write_rows
from ..utils.timing import benchmark

# Reference sweep bounds (GPU_time_complexity_point.cu:110 — WIDTH 3..128)
DEFAULT_WIDTHS = tuple(range(3, 129))


def time_complexity_sweep(
    metric: str = "point",
    widths: Sequence[int] = DEFAULT_WIDTHS,
    iterations: int = 1,
    repeats: int = 3,
    matcher: str = "xla",
    csv_path: Optional[str] = None,
) -> List[Tuple[int, float]]:
    """Time ``iterations`` ICP iterations at each width; returns
    ``[(n_points, ms_per_iter), ...]``, the min over ``repeats`` warm runs
    (the reference's "N,ms" rows)."""
    rows: List[Tuple[int, float]] = []
    for width in widths:
        scene = synthetic_scene(width=width)
        config = ICPConfig(metric=metric, max_iterations=iterations,
                           tolerance=0.0, matcher=matcher)
        t = benchmark(run_icp, scene.source, scene.target, config,
                      repeats=repeats)
        rows.append((width * width, t["min"] * 1e3 / iterations))
    if csv_path:
        write_rows(csv_path, rows, header=("n", "ms"))
    return rows


def matching_benchmark(
    n: int = 16384,
    repeats: int = 10,
    variants: Optional[Iterable[str]] = None,
    csv_path: Optional[str] = None,
) -> dict:
    """Min-of-``repeats`` matching-kernel times (ms) at N=M=``n`` for each
    implementation variant. The default is every variant the backend runs
    ('pallas', the fused kernel, needs a GPU). Reference ladder results in
    BASELINE.md §matching (best CUDA variant: 2.297 ms @ 16,384 on an
    RTX 2060)."""
    import math

    import jax

    if variants is None:
        variants = ("xla", "xla_exact", "morton")
        if jax.default_backend() == "gpu":
            variants += ("pallas",)

    from ..ops.matching import nn_argmin
    from ..ops.matching_pallas import nn_argmin_pallas

    width = int(math.isqrt(n))
    scene = synthetic_scene(width=width)
    p, q = scene.source, scene.target
    actual_n = p.shape[0]

    from ..ops.morton import build_morton_table, morton_nn, source_morton_order

    table = build_morton_table(q)
    p_sorted = p[source_morton_order(p, table)]

    impls = {
        "xla": (lambda x: nn_argmin(x, q)[0], p),
        "xla_exact": (lambda x: nn_argmin(x, q, exact=True)[0], p),
        "pallas": (lambda x: nn_argmin_pallas(x, q)[0], p),
        "morton": (lambda x: morton_nn(x, table)[2], p_sorted),
    }
    unknown = [v for v in variants if v not in impls]
    if unknown:
        # fail BEFORE timing anything — a mid-run KeyError after minutes of
        # measurement would lose the completed results
        raise ValueError(f"unknown matching variants {unknown}; "
                         f"valid: {sorted(impls)}")
    results = {"n": actual_n}
    for name in variants:
        run, arg = impls[name]
        results[name] = benchmark(run, arg, repeats=repeats)["min"] * 1e3
    if csv_path:
        write_rows(csv_path,
                   [(v, actual_n, results[v]) for v in variants if v in results],
                   header=["variant", "n", "ms"])
    return results
