"""2-process ``jax.distributed`` CPU dryrun for the multi-host (DCN) path.

The reference is strictly single-GPU; SURVEY.md §2.4 names multi-host as a
required design axis of this rebuild. This script proves
``parallel/multihost.py`` + ``parallel/dist_icp.py`` actually run
multi-controller: it spawns TWO OS processes, each initializing
``jax.distributed`` against a localhost coordinator with 4 virtual CPU
devices (8 global devices across the 2 processes), builds the global mesh,
and runs the full sharded ICP loop to ground-truth recovery.

Usage:  python scripts/multihost_dryrun.py            # parent: spawn + check
        python scripts/multihost_dryrun.py --child ... # internal
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCESSES = 2
DEVICES_PER_PROCESS = 4


def child(pid: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)

    from fpcr_tpu.parallel.multihost import (
        initialize_multihost,
        is_multihost,
        local_shard_bounds,
    )

    ok = initialize_multihost(f"localhost:{port}", N_PROCESSES, pid)
    assert ok, "initialize_multihost returned False with explicit args"
    assert is_multihost(), jax.process_count()
    n_global = len(jax.devices())
    assert n_global == N_PROCESSES * DEVICES_PER_PROCESS, n_global

    import jax.numpy as jnp
    import numpy as np

    import fpcr_tpu as f
    from fpcr_tpu.parallel.dist_icp import distributed_icp, make_mesh

    mesh = make_mesh()  # all GLOBAL devices
    rng = np.random.default_rng(0)  # same data on every process
    src = rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32)
    gt = f.gt_transform((0.02, -0.01, 0.03), (0.03, -0.02, 0.01))
    tgt = np.asarray(gt.apply(jnp.asarray(src)))

    lo, hi = local_shard_bounds(src.shape[0])
    print(f"[proc {pid}] {jax.process_count()} processes, "
          f"{n_global} global devices, local rows [{lo}:{hi})", flush=True)

    res = distributed_icp(jnp.asarray(src), jnp.asarray(tgt),
                          f.ICPConfig(max_iterations=20), mesh=mesh)
    err = float(f.transform_rmse(res.transform, gt, jnp.asarray(src)))
    print(f"[proc {pid}] converged={bool(res.converged)} GT err {err:.2e}",
          flush=True)
    assert err < 1e-4, err
    print(f"[proc {pid}] MULTIHOST OK", flush=True)


def parent() -> int:
    # NOTE: probe-then-bind is inherently TOCTOU (another process can take
    # the port between the probe closing and the coordinator binding); an
    # intermittent 'address already in use' here is that race, not a bug
    # in the distributed path — just rerun. Ephemeral-port collisions are
    # rare enough in this single-purpose container to not warrant a
    # coordinator-side port handshake.
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    env = dict(os.environ)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") +
                        f" --xla_force_host_platform_device_count="
                        f"{DEVICES_PER_PROCESS}").strip()
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--child", "--pid", str(i), "--port", str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(N_PROCESSES)
    ]
    ok = True
    try:
        for i, p in enumerate(procs):
            out, _ = p.communicate(timeout=600)
            sys.stdout.write(out)
            if p.returncode != 0 or "MULTIHOST OK" not in out:
                ok = False
                print(f"[parent] process {i} FAILED (rc={p.returncode})")
    finally:
        # a hung child (coordinator deadlock, port clash) must not orphan
        # the OTHER coordinator-connected process holding the port — kill
        # both explicitly on any exit path (these are our own Popen
        # handles, never pattern-matched process kills)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print("[parent] multihost dryrun", "PASSED" if ok else "FAILED")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--port", type=int, default=0)
    args = ap.parse_args()
    if args.child:
        child(args.pid, args.port)
        return 0
    return parent()


if __name__ == "__main__":
    sys.exit(main())
