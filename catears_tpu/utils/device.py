"""Accelerator facts and the persistent compile cache, in one place.

Every entry point (CLI, bench, scripts, the on-card smoke test) calls
`enable_compile_cache()` before its first compile, and every measurement
path calls `require_gpu()` so that a run without a card fails instead of
quietly timing XLA's CPU backend.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
# Fixed, checkout-relative default: the path is part of the cache key, so a
# directory that moves between runs would never hit (listed in .gitignore).
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache; returns the directory used.

    If JAX_COMPILATION_CACHE_DIR is set, JAX already reads it and no other
    path is set.  Otherwise the cache lives at DEFAULT_CACHE_DIR.
    """
    import jax

    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


def require_gpu():
    """The first JAX device, which must be a GPU; raises otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's first device is {dev.platform!r} "
            f"({dev.device_kind}); this path measures the card only")
    return dev


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of the cards as nvidia-smi reports them.

    Read by a child process that does not import JAX, so it never competes
    for the card's memory.
    """
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_record() -> Dict[str, object]:
    """What every benchmark result carries: the device it ran on."""
    import jax

    dev = require_gpu()
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices()),
            "gpu": gpu_name_and_power_limit()}
