"""Synthetic SPD test matrices (counterpart of `lsbench_tpu/matrix/generate.py`).

They stand in for the reference's pressure-Poisson SPD matrices
(tests/tj7a_*, tests/xn3b_*), so tests and the chip smoke run need no data
files. Same generators, same outputs for the same arguments.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix


def poisson_2d(nx: int, ny: int | None = None) -> CsrMatrix:
    """5-point Laplacian on an nx × ny grid (SPD, 0-based)."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r.ravel())
        cols.append(c.ravel())
        vals.append(np.full(r.size, v))

    add(idx, idx, 4.0)
    add(idx[1:, :], idx[:-1, :], -1.0)
    add(idx[:-1, :], idx[1:, :], -1.0)
    add(idx[:, 1:], idx[:, :-1], -1.0)
    add(idx[:, :-1], idx[:, 1:], -1.0)
    return CsrMatrix.from_coo(np.concatenate(rows), np.concatenate(cols),
                              np.concatenate(vals), nrows=n, ncols=n)


def sem_2d(ne: int, p: int = 2, shift: float = 1e-3) -> CsrMatrix:
    """SEM-type SPD matrix: ne × ne spectral elements of order p on a 2-D
    quad mesh; every element's (p+1)² nodes form a clique (the assembled
    pressure-Poisson pattern: ~23 nnz/row at p=2 with strong row-width
    skew). Values: sum of element clique Laplacians (m·I − J per element)
    + `shift`·I."""
    nn = ne * p + 1
    n = nn * nn
    idx = np.arange(n).reshape(nn, nn)
    m = (p + 1) ** 2
    ex = np.arange(ne) * p
    wins = idx[ex[:, None, None, None] + np.arange(p + 1)[None, None, :, None],
               ex[None, :, None, None] + np.arange(p + 1)[None, None, None, :]]
    nodes = wins.reshape(ne * ne, m)
    r = np.repeat(nodes, m, axis=1).ravel()
    c = np.tile(nodes, (1, m)).ravel()
    v = np.where(r == c, float(m - 1), -1.0)
    dr = np.arange(n)
    return CsrMatrix.from_coo(
        np.concatenate([r, dr]), np.concatenate([c, dr]),
        np.concatenate([v, np.full(n, shift)]), nrows=n, ncols=n)


def random_spd(n: int, nnz_per_row: int = 23, seed: int = 0) -> CsrMatrix:
    """Random diagonally-dominant SPD matrix with ~nnz_per_row entries/row
    (the reference workload's 22–25 nnz/row)."""
    rng = np.random.default_rng(seed)
    k = max(1, (nnz_per_row - 1) // 2)
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, size=rows.size)
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    vals = -rng.random(rows.size)
    r = np.concatenate([rows, cols])
    c = np.concatenate([cols, rows])
    v = np.concatenate([vals, vals]) * 0.5
    off = CsrMatrix.from_coo(r, c, v, nrows=n, ncols=n)
    rowsum = np.zeros(n)
    np.add.at(rowsum, off.row_indices(), np.abs(off.vals))
    dr = np.arange(n)
    return CsrMatrix.from_coo(
        np.concatenate([off.row_indices(), dr]),
        np.concatenate([off.cols, dr]),
        np.concatenate([off.vals, 1.0 + rowsum]),
        nrows=n, ncols=n)
