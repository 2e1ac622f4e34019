"""The HPCG problem's matrix: the 27-point stencil of the reference
`GenerateProblem` on an nx × ny × nz grid.

Row i = ix + nx·(iy + ny·iz) (HPCG's lexicographic order). Its entries
are the grid points (ix+sx, iy+sy, iz+sz), sz, sy, sx ∈ {−1, 0, 1}, that
lie inside the grid, taken in the reference's loop order (sz outer, sx
inner), which is ascending column order: 26 on the diagonal, −1 off it.
The matrix is SPD and the same for every seed.
"""

from __future__ import annotations

import numpy as np


def shape(nx: int, ny: int, nz: int) -> tuple[int, int]:
    """(n, nnz) of the grid's matrix: each axis of length m gives 3m − 2
    (point, neighbour) pairs."""
    return nx * ny * nz, (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def generate(nx: int, ny: int, nz: int):
    """(offs int64 (n+1,), cols int32 (nnz,), vals float64 (nnz,)): the
    matrix in CSR form, columns ascending within each row."""
    n, nnz = shape(nx, ny, nz)
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx),
                             indexing="ij")
    ix, iy, iz = ix.ravel(), iy.ravel(), iz.ravel()
    row = np.arange(n, dtype=np.int64)
    offsets = [(sz, sy, sx) for sz in (-1, 0, 1) for sy in (-1, 0, 1)
               for sx in (-1, 0, 1)]
    # (n, 27) tables in the reference's loop order; a row's valid slots are
    # ascending in column, so the row-major compress is CSR order.
    cols = np.empty((n, 27), dtype=np.int64)
    valid = np.empty((n, 27), dtype=bool)
    for k, (sz, sy, sx) in enumerate(offsets):
        cols[:, k] = row + sx + nx * (sy + ny * sz)
        valid[:, k] = ((0 <= ix + sx) & (ix + sx < nx) & (0 <= iy + sy)
                       & (iy + sy < ny) & (0 <= iz + sz) & (iz + sz < nz))
    del ix, iy, iz
    counts = valid.sum(axis=1)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offs[1:])
    out_cols = cols[valid].astype(np.int32)
    del cols
    diag = np.zeros((n, 27), dtype=bool)
    diag[:, 13] = True
    vals = np.where(diag[valid], 26.0, -1.0)
    if out_cols.size != nnz:
        raise AssertionError(f"hpcg27: {out_cols.size} entries, expected {nnz}")
    return offs, out_cols, vals
