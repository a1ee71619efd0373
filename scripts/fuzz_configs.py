"""Randomized robustness fuzz: random clouds (uniform/surface/line/duplicate/
global-frame-offset) × random ICPConfig combos + random NDT configs; any
non-finite transform / reflection / crash is a failure.

Catches so far:
  * round 2 — rank-deficient line clouds NaN-poisoned the polar and 6x6
    solvers (fixed with identity-fallback guards, see ops/solve.py);
  * round 3 — auto NDT voxel_size collapsed to 0 on duplicate-heavy clouds
    and was noise-swamped at global-frame coordinates (fixed in
    ops/grid.py::suggest_cell_size: centered 2-NN pass, positive-spacing
    median, extent fallback).

Run: python scripts/fuzz_configs.py [seed]
"""
import jax; jax.config.update("jax_platforms", "cpu")
import os, sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax.numpy as jnp
import fpcr_tpu as f
from fpcr_tpu.utils.diagnostics import validate_result, RegistrationError

rng = np.random.default_rng(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
fails = 0
for trial in range(60):
    n = int(rng.integers(4, 3000))
    metric = rng.choice(["point", "plane", "symmetric", "gicp"])
    # the CPU matchers ('pallas' is the GPU-only fused brute kernel)
    matcher = rng.choice(["xla", "morton", "grid"])
    solver = rng.choice(["svd", "polar"])
    robust = rng.choice([None, "huber", "tukey"])
    trim = rng.choice([None, float(rng.uniform(0.05, 2.0))])
    shape = rng.choice(["uniform", "surface", "line", "dup"])
    if shape == "uniform":
        src = rng.uniform(-2, 2, (n, 3))
    elif shape == "surface":
        w = max(2, int(np.sqrt(n))); src = np.asarray(f.surface_grid(width=w))[:n]
        n = src.shape[0]
    elif shape == "line":
        ts = rng.uniform(-1, 1, n); src = np.stack([ts, 2*ts, -ts], 1)
        src += rng.normal(scale=1e-4, size=src.shape)
    else:
        base = rng.uniform(-1, 1, (max(n // 4, 1), 3))
        src = base[rng.integers(0, base.shape[0], n)]
    src = jnp.asarray(src.astype(np.float32))
    gt = f.gt_transform(tuple(0.02*rng.standard_normal(3)),
                        tuple(0.03*rng.standard_normal(3)))
    tgt = gt.apply(src)
    cfg = dict(metric=metric, matcher=matcher, solver=solver,
               robust_loss=robust, max_correspondence_dist=trim,
               max_iterations=int(rng.integers(1, 15)),
               k_neighbors=int(rng.integers(3, 8)))
    try:
        res = f.run_icp(src, tgt, f.ICPConfig(**cfg))
        validate_result(res)  # raises on non-finite/reflection
    except RegistrationError as e:
        print(f"FAIL trial {trial}: n={n} shape={shape} cfg={cfg}: {e}", flush=True)
        fails += 1
    except Exception as e:
        print(f"CRASH trial {trial}: n={n} shape={shape} cfg={cfg}: {type(e).__name__} {str(e)[:120]}", flush=True)
        fails += 1
# NDT trials: random resolutions/lookup strategies on random geometry —
# the never-NaN contract extends to the voxel-field solver
from fpcr_tpu.models.ndt import NDTConfig, run_ndt

for trial in range(20):
    n = int(rng.integers(64, 4000))
    shape = rng.choice(["uniform", "surface", "dup", "offset"])
    if shape == "uniform":
        src = rng.uniform(-2, 2, (n, 3))
    elif shape == "surface":
        w = max(4, int(np.sqrt(n))); src = np.asarray(f.surface_grid(width=w))[:n]
        n = src.shape[0]
    elif shape == "dup":
        base = rng.uniform(-1, 1, (max(n // 4, 1), 3))
        src = base[rng.integers(0, base.shape[0], n)]
    else:  # global-frame coordinates (the ADVICE r2 failure regime)
        src = rng.uniform(-1, 1, (n, 3)) + np.array([300.0, -450.0, 250.0])
    src = jnp.asarray(src.astype(np.float32))
    gt = f.gt_transform(tuple(0.02 * rng.standard_normal(3)),
                        tuple(0.02 * rng.standard_normal(3)))
    tgt = gt.apply(src)
    cfg = NDTConfig(
        voxel_size=rng.choice([None, float(rng.uniform(0.1, 1.0))]),
        max_iterations=int(rng.integers(1, 20)),
        lookup=rng.choice(["auto", "gather", "banded"]),
        min_points=int(rng.integers(3, 7)))
    try:
        res = run_ndt(src, tgt, cfg)
        r = np.asarray(res.transform.rotation)
        t = np.asarray(res.transform.translation)
        if not (np.isfinite(r).all() and np.isfinite(t).all()):
            raise RegistrationError("non-finite NDT transform")
        if abs(np.linalg.det(r) - 1.0) > 1e-2:
            raise RegistrationError(f"det(R)={np.linalg.det(r)}")
    except RegistrationError as e:
        print(f"NDT FAIL trial {trial}: n={n} shape={shape} cfg={cfg}: {e}",
              flush=True)
        fails += 1
    except Exception as e:
        print(f"NDT CRASH trial {trial}: n={n} shape={shape} cfg={cfg}: "
              f"{type(e).__name__} {str(e)[:120]}", flush=True)
        fails += 1

print(f"done: {fails} failures / 80 trials", flush=True)
sys.exit(1 if fails else 0)  # guard scripts must gate
