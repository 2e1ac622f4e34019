"""Matrix text I/O with reference-identical semantics.

Counterpart of `lsbench_tpu/matrix/io.py`. File format (lsbench-csr.c:34-53):
first line ``nnz base``, then exactly ``nnz`` lines of ``row col val``; base
must be 0 or 1 and nnz positive. Entries are sorted by (row, col) and
duplicates summed. MatrixMarket coordinate files are auto-detected too.

The native C++ parser (`native/reader.py`) is used when a toolchain is
present; the NumPy fallback below parses the same grammar.
"""

from __future__ import annotations

import os

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix


class MatrixFormatError(ValueError):
    pass


def _read_header(line: str, fname: str) -> tuple[int, int]:
    parts = line.split()
    if len(parts) != 2:
        raise MatrixFormatError(
            f"{fname}: unable to read meta information about the matrix.")
    try:
        nnz, base = int(parts[0]), int(parts[1])
    except ValueError as e:
        raise MatrixFormatError(
            f"{fname}: unable to read meta information about the matrix.") from e
    if base not in (0, 1):
        raise MatrixFormatError(
            f"{fname}: base should be either 0 or 1, got: {base}.")
    if nnz <= 0:
        raise MatrixFormatError(
            f"{fname}: number of nnz values in the file are zero.")
    return nnz, base


def read_matrix(fname: str | os.PathLike) -> CsrMatrix:
    """Read a sparse matrix file (reference COO text or MatrixMarket
    coordinate) into a 0-based `CsrMatrix`."""
    fname = os.fspath(fname)
    with open(fname, "r") as fp:
        first = fp.readline()
    if first.startswith("%%MatrixMarket"):
        return _read_matrix_market(fname, first)
    coo = _read_coo_native(fname)
    if coo is None:
        coo = _read_coo_numpy(fname)
    rows, cols, vals, base = coo
    n = int(max(rows.max(), cols.max())) - base + 1
    return CsrMatrix.from_coo(rows - base, cols - base, vals, nrows=n, ncols=n)


def _read_matrix_market(fname: str, banner: str) -> CsrMatrix:
    parts = banner.split()
    if (len(parts) < 5 or parts[1].lower() != "matrix"
            or parts[2].lower() != "coordinate"):
        raise MatrixFormatError(
            f"{fname}: unsupported MatrixMarket banner: {banner.strip()!r} "
            "(only 'matrix coordinate' is supported)")
    field = parts[3].lower()
    symmetry = parts[4].lower()
    if field not in ("real", "integer", "pattern"):
        raise MatrixFormatError(
            f"{fname}: unsupported MatrixMarket field '{field}'")
    if symmetry not in ("general", "symmetric"):
        raise MatrixFormatError(
            f"{fname}: unsupported MatrixMarket symmetry '{symmetry}'")
    with open(fname, "r") as fp:
        fp.readline()  # banner
        line = fp.readline()
        while line.startswith("%"):
            line = fp.readline()
        try:
            nrows, ncols, nnz = (int(t) for t in line.split())
        except ValueError as e:
            raise MatrixFormatError(
                f"{fname}: bad MatrixMarket size line: {line.strip()!r}") from e
        data = np.loadtxt(fp, ndmin=2, max_rows=nnz)
    if data.shape[0] != nnz:
        raise MatrixFormatError(
            f"{fname}: expected {nnz} entries, found {data.shape[0]}")
    rows = data[:, 0].astype(np.int64) - 1
    cols = data[:, 1].astype(np.int64) - 1
    vals = data[:, 2] if data.shape[1] > 2 else np.ones(nnz)
    if symmetry == "symmetric":
        off = rows != cols
        rows = np.concatenate([rows, cols[off]])
        cols = np.concatenate([cols, data[:, 0].astype(np.int64)[off] - 1])
        vals = np.concatenate([vals, vals[off]])
    return CsrMatrix.from_coo(rows, cols, vals, nrows=nrows, ncols=ncols,
                              sum_duplicates=True)


def _read_coo_numpy(fname: str):
    with open(fname, "r") as fp:
        header = fp.readline()
        nnz, base = _read_header(header, fname)
        try:
            data = np.loadtxt(fp, dtype=np.float64, max_rows=nnz, ndmin=2)
        except ValueError as e:
            raise MatrixFormatError(f"{fname}: unable to read matrix entries.") from e
    if data.shape != (nnz, 3):
        raise MatrixFormatError(f"{fname}: unable to read matrix entries.")
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    if not (np.all(data[:, 0] == rows) and np.all(data[:, 1] == cols)):
        raise MatrixFormatError(f"{fname}: non-integer row/col indices.")
    if rows.min() < base or cols.min() < base:
        raise MatrixFormatError(f"{fname}: index below declared base {base}.")
    return rows, cols, data[:, 2].copy(), base


def _read_coo_native(fname: str):
    """Fast path via the C++ parser; None when no toolchain can build it
    (host parsing only: the fallback hides no device)."""
    from lsbench_tpu_torch.native import NativeUnavailable
    from lsbench_tpu_torch.native import reader as native_reader
    try:
        return native_reader.read_coo(fname)
    except NativeUnavailable:
        return None


def write_matrix(A: CsrMatrix, fname: str | os.PathLike, base: int = 0) -> None:
    """Write the `nnz base` + triplets format (round-trip of read_matrix)."""
    if base not in (0, 1):
        raise ValueError("base must be 0 or 1")
    rows, cols, vals = A.to_coo()
    with open(os.fspath(fname), "w") as fp:
        fp.write(f"{A.nnz} {base}\n")
        for r, c, v in zip(rows + base, cols + base, vals):
            fp.write(f"{r} {c} {v:.17g}\n")
