"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles each source into its own shared library with a plain C
interface in `lsbench_tpu_torch/_build/`, at first use and again whenever
the source or a shared header (`csrc/*.cuh`) is newer than its library;
ctypes loads it. This takes seconds,
where a PyTorch C++ extension that includes torch's headers takes minutes.
`build()` starts one nvcc per stale source, all at once. Nothing here runs
at import: the CPU-only test environment has no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import tempfile
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

# Source stem → its entry points: (name, number of pointer arguments,
# number of int arguments); every entry takes the stream last and returns a
# cudaError_t as int.
SOURCES = {
    "bsr_spmv": (("lsb_spmv_bsr_f32", 4, 2),
                 ("lsb_spmv_bsr_classed_f32", 5, 2),
                 ("lsb_spmv_bsr_f64acc", 5, 2),
                 ("lsb_spmm_bsr_f32", 4, 3)),
    "well_spmv": (("lsb_spmv_well_f32", 5, 2),),
    "bsr_variants": (("lsb_spmv_bsr_compact_f32", 5, 1),
                     ("lsb_spmv_bsr_selector_f32", 4, 3),
                     ("lsb_spmv_bsr_onehot_f32", 4, 3)),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(stem: str) -> str:
    return os.path.join(CSRC, stem + ".cu")


def library_path(stem: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{stem}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): cannot build the CUDA kernels")
    return nvcc


def _stale(stem: str) -> bool:
    lib = library_path(stem)
    inputs = [source_path(stem), *glob.glob(os.path.join(CSRC, "*.cuh"))]
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < max(map(os.path.getmtime, inputs)))


def build(stems=None) -> str:
    """Compile the named sources (default: all) whose library is missing or
    stale, one nvcc each, run in parallel. Returns nvcc's output (ptxas
    register and spill report), "" when every library was current. Raises if
    a build fails."""
    todo = [s for s in (stems or SOURCES) if _stale(s)]
    if not todo:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for stem in todo:
            # Private name, then rename: another process must never load a
            # half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(stem)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((stem, tmp, proc))
        logs, failed = [], []
        for stem, tmp, proc in jobs:
            out, _ = proc.communicate(timeout=600)
            logs.append(f"[{stem}.cu]\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, library_path(stem))
        if failed:
            raise RuntimeError("\n".join(failed))
        return "".join(logs)
    finally:
        for _, tmp, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<stem>.cu`, built on first use."""
    with _lock:
        if stem not in _libs:
            build([stem])
            lib = ctypes.CDLL(library_path(stem))
            for name, n_ptr, n_int in SOURCES[stem]:
                fn = getattr(lib, name)
                # c_void_p for every pointer and the stream: without
                # argtypes ctypes passes Python ints as 32-bit C ints.
                fn.argtypes = ([ctypes.c_void_p] * n_ptr
                               + [ctypes.c_int] * n_int + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
            _libs[stem] = lib
    return _libs[stem]


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
