"""Build and load the port's CUDA kernels (`csrc/bsr_spmv.cu`).

nvcc compiles the source into a shared library with a plain C interface in
`lsbench_tpu_torch/_build/`, at first use and again whenever the source is
newer than the library; ctypes loads it. This takes seconds, where a
PyTorch C++ extension that includes torch's headers takes minutes. Nothing
here runs at import: the CPU-only test environment has no nvcc.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "bsr_spmv.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
LIBRARY = os.path.join(BUILD_DIR, "libbsr_spmv.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Entry points: (name, number of pointer arguments, number of int arguments);
# every entry takes the stream last and returns a cudaError_t as int.
_ENTRIES = (("lsb_spmv_bsr_f32", 4, 2),
            ("lsb_spmv_bsr_classed_f32", 5, 2),
            ("lsb_spmv_bsr_f64acc", 5, 2))

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): cannot build the CUDA kernels")
    return nvcc


def build() -> str:
    """Compile the kernels if the library is missing or stale. Returns
    nvcc's output (ptxas register and spill report), or "" when the library
    was current. Raises if the build fails."""
    if (os.path.exists(LIBRARY)
            and os.path.getmtime(LIBRARY) >= os.path.getmtime(SOURCE)):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Private name, then rename: another process must never load a
    # half-written library.
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return proc.stdout + proc.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIBRARY)
            for name, n_ptr, n_int in _ENTRIES:
                fn = getattr(lib, name)
                # c_void_p for every pointer and the stream: without
                # argtypes ctypes passes Python ints as 32-bit C ints.
                fn.argtypes = ([ctypes.c_void_p] * n_ptr
                               + [ctypes.c_int] * n_int + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
