"""Native (C++) host components, loaded via ctypes.

The sources are this package's own copies of the JAX package's native
code (`native/reader.cpp`, `native/spgemm.cpp`), compiled with g++ into
this package's `_build/` directory on first use. Every entry point has a
NumPy fallback, so the port works without a toolchain.
"""

from __future__ import annotations

import os
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_PKG, "_build")
_LOCK = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def _compile(src: str, out: str) -> str:
    src_path = os.path.join(SRC_DIR, src)
    out_path = os.path.join(BUILD_DIR, out)
    if not os.path.exists(src_path):
        raise NativeUnavailable(f"native source {src_path} not found")
    if (os.path.exists(out_path)
            and os.path.getmtime(out_path) >= os.path.getmtime(src_path)):
        return out_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build to a private name, then rename: concurrent processes (test
    # workers) must never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, src_path]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out_path)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"failed to build {src}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out_path


def load_library(src: str, out: str):
    import ctypes
    with _LOCK:
        path = _compile(src, out)
    try:
        return ctypes.CDLL(path)
    except OSError as e:
        raise NativeUnavailable(str(e)) from e
