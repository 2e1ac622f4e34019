"""Build and load the port's CUDA kernels (`csrc/*.cu`).

nvcc compiles each source into its own shared library with a plain C
interface in `lsbench_tpu_torch/_build/`, named by a hash of what it is
built from (the source, the shared headers `csrc/*.cuh` and the nvcc
flags), at first use; ctypes loads it. A library built from other source
is never loaded under this source's `argtypes`, however new it is on
disk. This takes seconds,
where a PyTorch C++ extension that includes torch's headers takes minutes.
`build()` starts one nvcc per missing library, all at once. Nothing here runs
at import: the CPU-only test environment has no nvcc.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

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
    "well_spmv": (("lsb_spmv_well_f32", 5, 3),),
    "sell_spmv": (("lsb_spmv_sell_f32", 5, 1),
                  ("lsb_spmv_sell_f64", 5, 1)),
    "sell_spmm": (("lsb_spmm_sell_f32", 5, 2),),
    "tri_sweep": (("lsb_tri_sweep_f32", 16, 3),
                  ("lsb_tri_sweep_f64", 16, 3)),
    "graph_if": (("lsb_graph_if_load", 0, 0),
                 ("lsb_graph_if_f32", 5, 0),
                 ("lsb_graph_if_f64", 5, 0),
                 ("lsb_graph_if_end", 0, 0)),
}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_path(stem: str) -> str:
    return os.path.join(CSRC, stem + ".cu")


def library_path(stem: str) -> str:
    """`_build/lib<stem>-<hash8>.so`, the hash over the source, every
    shared header (by name and content) and NVCC_FLAGS."""
    h = hashlib.sha256("\0".join(NVCC_FLAGS).encode())
    for path in [source_path(stem),
                 *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        h.update(os.path.basename(path).encode() + b"\0")
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{stem}-{h.hexdigest()[:8]}.so")


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found (PATH, CUDA_HOME or "
                           "/usr/local/cuda): cannot build the CUDA kernels")
    return nvcc


def build(stems=None) -> str:
    """Compile the named sources (default: all) whose library is missing,
    one nvcc each, run in parallel. Returns nvcc's output (ptxas register
    and spill report), "" when every library was there. Raises if a build
    fails."""
    todo = [(s, lib) for s in (stems or SOURCES)
            if not os.path.exists(lib := library_path(s))]
    if not todo:
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    try:
        for stem, lib in todo:
            # Private name, then rename: another process must never load a
            # half-written library.
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(stem)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((stem, lib, tmp, proc))
        logs, failed = [], []
        for stem, lib, tmp, proc in jobs:
            out, _ = proc.communicate(timeout=600)
            logs.append(f"[{stem}.cu]\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)
        if failed:
            raise RuntimeError("\n".join(failed))
        return "".join(logs)
    finally:
        for _, _, tmp, proc in jobs:
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


_entries: dict = {}


def entry(stem: str, name: str):
    """The entry point `lsb_<name>` of `csrc/<stem>.cu`, built and loaded
    on first use, then looked up from a dict."""
    fn = _entries.get(name)
    if fn is None:
        fn = _entries[name] = getattr(library(stem), "lsb_" + name)
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def launch(fn, name: str, device: torch.device, *args) -> None:
    """Call the entry point `fn` with `args` and the current stream of
    `device` (a CUDA device with its index), inside that device's context
    where it is not the current one; raise on a CUDA error. The stream is
    taken as a raw handle, the accessor PyTorch's own generated launchers
    use: it builds no Stream object, so a call costs little host time."""
    idx = device.index
    stream = torch._C._cuda_getCurrentRawStream(idx)
    if idx == torch._C._cuda_getDevice():
        rc = fn(*args, stream)
    else:
        with torch.cuda.device(idx):
            rc = fn(*args, stream)
    check(rc, name)
