"""Process-level device set-up shared by the experiments, the benchmark and
the chip smoke test: the persistent compile cache, the GPU requirement of
full runs, and the card's name and power limit for every reported number.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path

# <repo>/.jax_cache: a fixed path, because the directory is part of the
# cache's key and a moving directory never hits
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Enable JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already takes the
    directory from it and no directory is set here; otherwise the cache
    lives in ``<repo>/.jax_cache``.  Every program is cached, however short
    its compile (a full experiment dispatches ~100 tiny programs).
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return jax.config.jax_compilation_cache_dir


def keep_cpu_platform() -> None:
    """Keep the CPU backend beside the accelerator when ``JAX_PLATFORMS``
    names only the accelerator, so the plain CPU reference can run in the
    same process.  Call before JAX initialises its backends."""
    import jax

    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")


def require_gpu() -> None:
    """Raise unless JAX's default device is a GPU: a measurement or a full
    run never carries on on the CPU."""
    import jax

    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise RuntimeError(
            f"no GPU found (JAX's default device is {platform!r}); full runs "
            "need a GPU — pass --cpu (or --smoke) to run on the CPU")


def describe_devices() -> dict:
    """``platform``, ``kind`` and ``count`` of the devices as JAX reports
    them."""
    import jax

    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (one
    line per card), or a note saying why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"
    return out.strip()
