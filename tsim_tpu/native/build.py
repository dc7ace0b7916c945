"""Lazy build + load of the native C++ kernels via ctypes.

No packaging dependencies (pybind11 is unavailable): the shared object is
compiled with g++ on first use and cached under ``_build/`` keyed by a hash
of the source, the flags and the host CPU, so repeat imports are instant,
source edits rebuild, and a library built with ``-march=native`` on one
machine is never loaded on another.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "_build")
_LOCK = threading.Lock()
_CACHE: dict[str, ctypes.CDLL] = {}


def _host_cpu() -> bytes:
    """Identity of this host's CPU for the build key: the model name and
    feature flags of ``/proc/cpuinfo``, or the platform's machine string
    where that file does not exist."""
    try:
        with open("/proc/cpuinfo", "rb") as fh:
            lines = fh.read().splitlines()
    except OSError:
        import platform

        return platform.machine().encode()
    keep = (b"model name", b"flags", b"Features", b"CPU part")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


class NativeBuildError(RuntimeError):
    pass


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and dlopen ``src/<name>.cpp``."""
    with _LOCK:
        lib = _CACHE.get(name)
        if lib is not None:
            return lib
        src = os.path.join(_SRC_DIR, f"{name}.cpp")
        flags = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC"]
        with open(src, "rb") as fh:
            digest = hashlib.sha256(
                fh.read() + " ".join(flags).encode() + _host_cpu()
            ).hexdigest()[:16]
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so_path = os.path.join(_BUILD_DIR, f"{name}-{digest}.so")
        if not os.path.exists(so_path):
            tmp = so_path + f".tmp{os.getpid()}"
            cmd = ["g++", *flags, src, "-o", tmp]
            try:
                subprocess.run(cmd, check=True, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise NativeBuildError(f"g++ not available: {e}") from e
            except subprocess.CalledProcessError as e:
                raise NativeBuildError(
                    f"native build failed:\n{e.stderr}"
                ) from e
            os.replace(tmp, so_path)
        lib = ctypes.CDLL(so_path)
        _CACHE[name] = lib
        return lib
