"""Nested-dissection ordering in the METIS role (counterpart of
`lsbench_tpu/ordering/nd.py`).

The reference's `--ordering METIS` maps to `cusolverSpXcsrmetisndHost`
(cusparse.c:75-79): a fill-reducing nested-dissection permutation applied
symmetrically before Cholesky. Here: recursive two-way bisection by BFS
level structures (a level set is a vertex separator: BFS edges never skip a
level), separators numbered last, minimum degree on the leaves. The
permutations are the JAX package's for the same CSR.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ordering.amd import min_degree_graph
from lsbench_tpu_torch.ordering.rcm import (_bfs_levels, _pseudo_peripheral,
                                            _symmetrized_graph)


def _subgraph(offs, cols, verts):
    """Restrict (offs, cols) to `verts`; returns local (offs, cols)."""
    n_sub = verts.size
    local = np.full(int(offs.size - 1), -1, dtype=np.int64)
    local[verts] = np.arange(n_sub)
    soffs = np.zeros(n_sub + 1, dtype=np.int64)
    chunks = []
    for li, v in enumerate(verts):
        nb = local[cols[offs[v]:offs[v + 1]]]
        nb = nb[nb >= 0]
        chunks.append(nb)
        soffs[li + 1] = soffs[li] + nb.size
    scols = (np.concatenate(chunks).astype(np.int32) if chunks
             else np.zeros(0, dtype=np.int32))
    return soffs, scols


def _bisect(offs, cols, n):
    """Split vertices 0..n-1 into (part_a, part_b, separator) local ids.

    BFS level structure from a pseudo-peripheral vertex; the separator is
    the thinnest level whose cumulative split lies within [1/4, 3/4].
    Unreached vertices join part A (no edges to either side).
    """
    deg = np.diff(offs)
    seeds = np.flatnonzero(deg > 0)
    if seeds.size == 0:  # edgeless: any split works, no separator needed
        half = n // 2
        ids = np.arange(n)
        return ids[:half], ids[half:], ids[:0]
    start = _pseudo_peripheral(offs, cols, int(seeds[0]), n)
    level, reached = _bfs_levels(offs, cols, start, n)
    nlev = int(level[reached].max()) + 1
    if nlev < 3:
        # Too tight to bisect by levels (near-clique): a balanced split
        # with B's vertices adjacent to A as the separator.
        half = max(1, n // 2)
        in_a = np.zeros(n, dtype=bool)
        in_a[reached[:half]] = True
        sep_mask = np.zeros(n, dtype=bool)
        for v in np.flatnonzero(~in_a):
            if in_a[cols[offs[v]:offs[v + 1]]].any():
                sep_mask[v] = True
        part_a = np.flatnonzero(in_a)
        part_b = np.flatnonzero(~in_a & ~sep_mask)
        return part_a, part_b, np.flatnonzero(sep_mask)
    counts = np.bincount(level[reached], minlength=nlev)
    frac = np.cumsum(counts) / reached.size
    ok = np.flatnonzero((frac >= 0.25) & (frac <= 0.75))
    if ok.size == 0:
        ok = np.array([np.argmin(np.abs(frac - 0.5))])
    m = int(ok[np.argmin(counts[ok])])
    part_a = np.flatnonzero((level >= 0) & (level < m))
    sep = np.flatnonzero(level == m)
    part_b = np.flatnonzero(level > m)
    unreached = np.flatnonzero(level < 0)
    if unreached.size:
        part_a = np.concatenate([part_a, unreached])
    return part_a, part_b, sep


def nd_ordering(A: CsrMatrix, leaf_size: int = 64) -> np.ndarray:
    """Nested-dissection permutation p: row i of the reordered matrix is
    old row p[i]. Separators are numbered last at every level."""
    offs, cols = _symmetrized_graph(A)

    def rec(offs, cols, verts):
        if verts.size <= leaf_size:
            return verts[min_degree_graph(offs, cols, verts.size)]
        la, lb, ls = _bisect(offs, cols, verts.size)
        if la.size == 0 or lb.size == 0:
            # Bisection did not split (a dense blob): minimum degree on all.
            return verts[min_degree_graph(offs, cols, verts.size)]
        pieces = []
        for part in (la, lb):
            so, sc = _subgraph(offs, cols, part)
            pieces.append(rec(so, sc, verts[part]))
        pieces.append(verts[ls])  # separator last
        return np.concatenate(pieces)

    perm = rec(offs, cols, np.arange(A.nrows, dtype=np.int64))
    assert perm.size == A.nrows and np.unique(perm).size == A.nrows
    return perm
