"""Headline benchmark: ICP ms/iteration at N=16,384 on one GPU.

Reference baseline (BASELINE.md): 6.4944 ms per point-to-point ICP iteration
(7.1085 ms point-to-plane) at N=16,384 on an RTX 2060
(src/CUDA/csv_files/GPU_ICP_point_to_point_TimeComp.csv), the reference's
own headline. This times the same workload — full ICP iterations (matching
+ solve + transform + error) on the synthetic 128x128 z=x²-y² scene — with a
fixed iteration count (no early exit), after a warm-up call whose time,
compilation included, is reported as set-up. It prints ONE JSON line:

    {"metric": ..., "value": <ms/iter>, "unit": "ms",
     "vs_baseline": <value / baseline>, "device": {...},
     "card": "<nvidia-smi name, power limit>"}

and a details record (plane, Morton near-registered and NDT ms/iter) on
stderr. With no GPU it exits 2 and prints no value. ``--cpu`` is an
explicit rehearsal on the CPU: its record is labelled ``"rehearsal":
"cpu"`` and its metric name ends in ``_cpu_rehearsal``. A phase that raises
fails the run.
"""

from __future__ import annotations

import argparse
import json
import sys

BASELINE_MS_PER_ITER_16384 = 6.4944  # RTX 2060, point metric, reference CSV
BASELINE_PLANE_MS_PER_ITER_16384 = 7.1085  # RTX 2060, plane metric


def _parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cpu", action="store_true",
                        help="rehearse on the CPU (labelled; not a device "
                             "measurement)")
    parser.add_argument("--width", type=int, default=128,
                        help="grid width (N=width²)")
    parser.add_argument("--metric", default="point",
                        choices=["point", "plane"])
    parser.add_argument("--iters", type=int, default=30,
                        help="ICP iterations per timed run")
    parser.add_argument("--repeats", type=int, default=10,
                        help="timed runs (the median is reported)")
    parser.add_argument("--matcher", default=None, choices=["xla", "pallas"],
                        help="brute matcher: default 'pallas' (the fused "
                             "GPU kernel), 'xla' with --cpu")
    args = parser.parse_args(argv)
    if args.width < 2 or args.repeats < 1 or args.iters < 1:
        parser.error("need width>=2, repeats>=1, iters>=1")
    return args


def measure(args) -> dict:
    import jax

    import fpcr_tpu as f
    from fpcr_tpu.models.ndt import NDTConfig, run_ndt
    from fpcr_tpu.utils.timing import timed

    scene = f.synthetic_scene(width=args.width)
    source = jax.device_put(scene.source)
    target = jax.device_put(scene.target)
    near = f.gt_transform((0.004, -0.002, 0.003), (0.002, -0.003, 0.002))
    target_near = jax.device_put(near.apply(scene.source))

    def icp(metric, matcher, tgt):
        def run(iters):
            # tolerance=0 → no early exit → exactly `iters` iterations
            cfg = f.ICPConfig(metric=metric, max_iterations=iters,
                              tolerance=0.0, matcher=matcher)
            return f.run_icp(source, tgt, cfg).errors
        return run

    grid = f.build_ndt_grid(target_near, 0.12)

    def ndt(iters):
        cfg = NDTConfig(voxel_size=0.12, max_iterations=iters,
                        tolerance=0.0, lookup="banded")
        return run_ndt(source, target_near, cfg, grid=grid).errors

    results = {}
    for name, run in (
            ("point", icp("point", args.matcher, target)),
            ("plane", icp("plane", args.matcher, target)),
            ("morton_near_registered", icp("point", "morton", target_near)),
            ("ndt_near_registered", ndt)):
        _, setup, wall = timed(run, args.iters, repeats=args.repeats)
        results[name] = {"ms_per_iter": wall * 1e3 / args.iters,
                         "setup_s": setup}
    return results


def main(argv=None) -> int:
    args = _parse_args(argv)
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    devices = jax.devices()
    platform = devices[0].platform
    if not args.cpu and platform != "gpu":
        print(f"bench: no GPU (JAX found '{platform}'); use --cpu for a "
              "labelled CPU rehearsal", file=sys.stderr)
        return 2
    if args.matcher is None:
        args.matcher = "xla" if args.cpu else "pallas"

    from fpcr_tpu.utils.platform import (card_name_and_power,
                                         enable_compile_cache)

    enable_compile_cache()
    results = measure(args)
    device = {"platform": platform, "kind": devices[0].device_kind,
              "count": len(devices)}
    card = None if args.cpu else card_name_and_power()
    details = {"n_points": args.width * args.width, "matcher": args.matcher,
               "iters": args.iters, "repeats": args.repeats,
               "device": device, "card": card, "results": results,
               "baseline": {"point_ms_per_iter": BASELINE_MS_PER_ITER_16384,
                            "plane_ms_per_iter":
                                BASELINE_PLANE_MS_PER_ITER_16384,
                            "hardware": "RTX 2060 (the reference's card)"}}
    print(json.dumps(details), file=sys.stderr)

    plane = args.metric == "plane"
    baseline = (BASELINE_PLANE_MS_PER_ITER_16384 if plane
                else BASELINE_MS_PER_ITER_16384)
    name = "icp_point_to_plane" if plane else "icp_point_to_point"
    metric = f"{name}_ms_per_iter_n{args.width * args.width}"
    record = {"metric": metric + ("_cpu_rehearsal" if args.cpu else ""),
              "value": results[args.metric]["ms_per_iter"], "unit": "ms",
              "vs_baseline": results[args.metric]["ms_per_iter"] / baseline,
              "device": device, "card": card}
    if args.cpu:
        record["rehearsal"] = "cpu"
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
