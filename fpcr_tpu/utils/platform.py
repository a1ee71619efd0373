"""Platform selection and compile-cache helpers."""

from __future__ import annotations

import os
import subprocess

import jax

# The checkout's own compile-cache directory (listed in .gitignore). A fixed
# path: JAX keys cache entries by it, so a directory that moves never hits.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def force_cpu(host_device_count: int | None = None) -> None:
    """Pin this process to the CPU backend (optionally with N virtual
    devices for sharding tests). Must run before first backend use."""
    if host_device_count is not None:
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={host_device_count}"
            ).strip()
    jax.config.update("jax_platforms", "cpu")


def backend_name() -> str:
    return jax.devices()[0].platform


def card_name_and_power() -> str:
    """``nvidia-smi``'s name and power limit of every card, one per line
    (a card below its 700 W maximum runs slower under load)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for an entry point and
    return its directory. ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's
    own setting and is left alone; otherwise the cache lives in
    ``CACHE_DIR``. Call before the first compilation."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
