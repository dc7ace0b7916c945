"""Process set-up shared by the entry scripts (``chip_smoke.py``, the
benchmarks): the persistent compile cache, the device description every
result line carries, and the card's name and power limit."""

from __future__ import annotations

import os
import subprocess

import jax

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def use_compile_cache() -> None:
    """Keep JAX's persistent compile cache where ``JAX_COMPILATION_CACHE_DIR``
    says (JAX reads that variable itself), or else under ``<repo>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    jax.config.update(
        "jax_compilation_cache_dir", os.path.join(REPO_ROOT, ".jax_cache")
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def device_info() -> dict:
    """The default device as JAX reports it."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def require_gpu(count: int = 1) -> dict:
    """:func:`device_info`, or SystemExit unless ``count`` GPUs are visible."""
    info = device_info()
    if info["platform"] != "gpu" or info["count"] < count:
        raise SystemExit(f"needs {count} GPU(s); JAX reports {info}")
    return info


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of each card, read by a child
    process that does not import JAX."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    )
    return out.stdout.strip()
