"""y = A·x with A in CSR form: the least work any kernel of it needs.

Bytes: each nonzero's value and int32 column index read once, the int32
row offsets (nrows + 1) read once, x read once and y written once, in the
value type. Operations: one multiply and one add per nonzero. This counts
the function, whatever layout or kernel computes it, so a change of layout
is judged on the same count; padding a layout stores is not counted.
"""

from __future__ import annotations


def bytes_moved(nrows: int, ncols: int, nnz: int, value_bytes: int) -> int:
    return nnz * (value_bytes + 4) + (nrows + 1) * 4 + (ncols + nrows) * value_bytes


def flops(nrows: int, ncols: int, nnz: int, value_bytes: int) -> int:
    del nrows, ncols, value_bytes
    return 2 * nnz
