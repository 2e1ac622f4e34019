"""ctypes binding for the native COO reader (`native/reader.cpp`)."""

from __future__ import annotations

import ctypes

import numpy as np

from lsbench_tpu_torch.native import load_library

_lib = None
_ERRORS = {
    1: "unable to open file",
    2: "unable to read meta information about the matrix",
    3: "base should be either 0 or 1",
    4: "number of nnz values in the file are zero",
    5: "unable to read matrix entries",
    6: "allocation failure",
}


class _LsbCoo(ctypes.Structure):
    _fields_ = [
        ("nnz", ctypes.c_longlong),
        ("base", ctypes.c_int),
        ("rows", ctypes.POINTER(ctypes.c_longlong)),
        ("cols", ctypes.POINTER(ctypes.c_longlong)),
        ("vals", ctypes.POINTER(ctypes.c_double)),
    ]


def _get_lib():
    global _lib
    if _lib is None:
        lib = load_library("reader.cpp", "libreader.so")
        lib.lsb_read_coo.argtypes = [ctypes.c_char_p, ctypes.POINTER(_LsbCoo)]
        lib.lsb_read_coo.restype = ctypes.c_int
        lib.lsb_free_coo.argtypes = [ctypes.POINTER(_LsbCoo)]
        lib.lsb_free_coo.restype = None
        _lib = lib
    return _lib


def read_coo(fname: str):
    """Returns (rows, cols, vals, base) as numpy arrays / int.

    Raises FileNotFoundError / MatrixFormatError consistently with the
    numpy fallback, or NativeUnavailable if the library can't be built.
    """
    from lsbench_tpu_torch.matrix.io import MatrixFormatError

    lib = _get_lib()
    out = _LsbCoo()
    rc = lib.lsb_read_coo(str(fname).encode(), ctypes.byref(out))
    if rc == 1:
        raise FileNotFoundError(2, f"Unable to open file '{fname}'")
    if rc != 0:
        raise MatrixFormatError(f"{fname}: {_ERRORS.get(rc, 'parse error')}.")
    try:
        n = out.nnz
        rows = np.ctypeslib.as_array(out.rows, shape=(n,)).copy()
        cols = np.ctypeslib.as_array(out.cols, shape=(n,)).copy()
        vals = np.ctypeslib.as_array(out.vals, shape=(n,)).copy()
        base = int(out.base)
    finally:
        lib.lsb_free_coo(ctypes.byref(out))
    return rows, cols, vals, base
