"""ctypes binding for the native sparse-Cholesky numeric factor and host
triangular solve (`native/spchol.cpp`: `lsb_chol_numeric`, `lsb_tri_solve`)."""

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
        lib = load_library("spchol.cpp", "libspchol.so")
        lib.lsb_chol_numeric.argtypes = [ctypes.c_longlong, _I64, _I32, _F64,
                                         _I64, _I64, _I64, _I64, _F64]
        lib.lsb_chol_numeric.restype = ctypes.c_longlong
        lib.lsb_tri_solve.argtypes = [ctypes.c_longlong, ctypes.c_longlong,
                                      _I64, _I64, _F64, _F64, _F64]
        lib.lsb_tri_solve.restype = None
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _get_lib()
        return True
    except Exception:
        return False


def tri_solve(cp, ci, cx, b) -> np.ndarray:
    """Host CSC triangular solves x = (L Lᵀ)⁻¹ b; b (n,) or (n, k). The CPU
    solve the reference's default CHOLMOD backend times
    (cholmod-impl.h:44-63, useGPU=0)."""
    lib = _get_lib()
    b = np.asarray(b, dtype=np.float64)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    n, k = b2.shape
    x = np.empty((k, n), dtype=np.float64)
    lib.lsb_tri_solve(int(n), int(k),
                      np.ascontiguousarray(cp, np.int64),
                      np.ascontiguousarray(ci, np.int64),
                      np.ascontiguousarray(cx, np.float64),
                      np.ascontiguousarray(b2.T), x)
    return x[0] if squeeze else x.T


def chol_numeric(n, a_offs, a_cols, a_vals, cp, ci, lrow_offs, lrow_cols
                 ) -> np.ndarray:
    """Native numeric factor over the symbolic pattern: the algorithm of
    `solvers/sparse_cholesky.py::numeric_factor`. Raises LinAlgError on a
    non-positive pivot."""
    lib = _get_lib()
    cx = np.zeros(int(cp[-1]), dtype=np.float64)
    rc = lib.lsb_chol_numeric(
        int(n),
        np.ascontiguousarray(a_offs, np.int64),
        np.ascontiguousarray(a_cols, np.int32),
        np.ascontiguousarray(a_vals, np.float64),
        np.ascontiguousarray(cp, np.int64),
        np.ascontiguousarray(ci, np.int64),
        np.ascontiguousarray(lrow_offs, np.int64),
        np.ascontiguousarray(lrow_cols, np.int64),
        cx)
    if rc != 0:
        raise np.linalg.LinAlgError(
            f"matrix not positive definite at column {rc - 1}")
    return cx
