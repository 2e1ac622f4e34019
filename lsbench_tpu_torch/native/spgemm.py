"""ctypes binding for the native Gustavson SpGEMM (`native/spgemm.cpp`)."""

from __future__ import annotations

import ctypes

import numpy as np

from lsbench_tpu_torch.native import load_library

_lib = None

_I64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_library("spgemm.cpp", "libspgemm.so")
        lib.lsb_spgemm_count.argtypes = [
            ctypes.c_longlong, _I64, _I32, _I64, _I32,
            ctypes.c_longlong, _I64]
        lib.lsb_spgemm_count.restype = ctypes.c_longlong
        lib.lsb_spgemm_fill.argtypes = [
            ctypes.c_longlong, _I64, _I32, _F64, _I64, _I32, _F64,
            ctypes.c_longlong, _I64, _I32, _F64]
        lib.lsb_spgemm_fill.restype = ctypes.c_int
        _lib = lib
    return _lib


def spgemm_native(m: int, a_offs, a_cols, a_vals, b_offs, b_cols, b_vals,
                  b_ncols: int):
    """C = A @ B. Returns (c_offs, c_cols, c_vals); cols sorted per row.
    Raises NativeUnavailable if the library cannot be built or loaded, and
    RuntimeError if the product itself fails."""
    lib = _get_lib()
    a_offs = np.ascontiguousarray(a_offs, dtype=np.int64)
    a_cols = np.ascontiguousarray(a_cols, dtype=np.int32)
    a_vals = np.ascontiguousarray(a_vals, dtype=np.float64)
    b_offs = np.ascontiguousarray(b_offs, dtype=np.int64)
    b_cols = np.ascontiguousarray(b_cols, dtype=np.int32)
    b_vals = np.ascontiguousarray(b_vals, dtype=np.float64)
    c_offs = np.empty(m + 1, dtype=np.int64)
    total = lib.lsb_spgemm_count(m, a_offs, a_cols, b_offs, b_cols,
                                 b_ncols, c_offs)
    if total < 0:
        raise RuntimeError("native spgemm count failed")
    c_cols = np.empty(total, dtype=np.int32)
    c_vals = np.empty(total, dtype=np.float64)
    rc = lib.lsb_spgemm_fill(m, a_offs, a_cols, a_vals, b_offs, b_cols,
                             b_vals, b_ncols, c_offs, c_cols, c_vals)
    if rc != 0:
        raise RuntimeError(f"native spgemm fill failed (rc={rc})")
    return c_offs, c_cols, c_vals
