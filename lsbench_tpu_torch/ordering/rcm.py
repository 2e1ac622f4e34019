"""Reverse Cuthill–McKee ordering (counterpart of `lsbench_tpu/ordering/rcm.py`).

Role equivalent to the reference's `cusolverSpXcsrsymrcmHost` call
(cusparse.c:69-71). BFS from a pseudo-peripheral start node, visiting
neighbors in increasing-degree order, then reverse.

Beyond direct-solver fill reduction, RCM concentrates nonzeros near the
diagonal, which densifies the block-sparse (BSR) layout the SpMV kernels
stream. The permutation is identical to the JAX package's for the same CSR.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix


def _symmetrized_graph(A: CsrMatrix):
    """Adjacency of A + A^T without self loops, as (offs, cols).

    scipy's C-level CSR transpose/add/sorted-merge: the numpy COO round
    trip it replaces cost ~8 s at n=262k (half the whole RCM time)."""
    import scipy.sparse as sp
    n = A.nrows
    S = sp.csr_matrix(
        (np.ones(A.nnz, dtype=np.int8), np.asarray(A.cols, dtype=np.int64),
         np.asarray(A.offs, dtype=np.int64)), shape=(n, n))
    G = S + S.T
    G.setdiag(0)
    G.eliminate_zeros()
    G.sort_indices()
    return G.indptr.astype(np.int64), G.indices


def _gather_neighbors(offs, cols, frontier):
    """All neighbors of `frontier` plus the rank (position in `frontier`)
    of the touching parent — one vectorized gather, no per-node loop."""
    counts = (offs[frontier + 1] - offs[frontier]).astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, dtype=cols.dtype),
                np.zeros(0, dtype=np.int64))
    starts = offs[frontier]
    # flat index construction: for each parent i, starts[i] + [0..counts[i])
    reps = np.repeat(np.arange(frontier.size), counts)
    base = np.repeat(starts, counts)
    within = np.arange(total) - np.repeat(
        np.concatenate(([0], np.cumsum(counts)[:-1])), counts)
    return cols[base + within], reps


def _bfs_levels(offs, cols, start, n):
    """Level-synchronous BFS; returns (levels, order) with -1 unreached.
    Vectorized per level (the per-node queue loop cost ~7 s at n=262k)."""
    level = np.full(n, -1, dtype=np.int64)
    level[start] = 0
    order = [np.array([start], dtype=np.int64)]
    frontier = order[0]
    depth = 0
    reached = 1
    while frontier.size:
        nb, _ = _gather_neighbors(offs, cols, frontier)
        nb = nb[level[nb] < 0]
        if nb.size == 0:
            break
        new = np.unique(nb).astype(np.int64)
        depth += 1
        level[new] = depth
        order.append(new)
        reached += new.size
        frontier = new
    return level, np.concatenate(order)[:reached]


def _pseudo_peripheral(offs, cols, component_seed, n):
    """George–Liu style: repeat BFS from a farthest min-degree node."""
    deg = np.diff(offs)
    u = component_seed
    last_ecc = -1
    for _ in range(8):  # converges in a few sweeps
        level, reached = _bfs_levels(offs, cols, u, n)
        ecc = int(level[reached].max())
        if ecc <= last_ecc:
            break
        last_ecc = ecc
        far = reached[level[reached] == ecc]
        u = far[np.argmin(deg[far])]
    return u


def rcm_ordering(A: CsrMatrix) -> np.ndarray:
    """Permutation p: new index i holds old row p[i]."""
    n = A.nrows
    offs, cols = _symmetrized_graph(A)
    deg = np.diff(offs)

    visited = np.zeros(n, dtype=bool)
    out = np.empty(n, dtype=np.int64)
    pos = 0
    # Handle disconnected graphs: loop over components.
    for seed in np.argsort(deg, kind="stable"):
        if visited[seed]:
            continue
        start = _pseudo_peripheral(offs, cols, int(seed), n)
        # Cuthill–McKee, level-synchronous and vectorized: within a BFS
        # level, nodes are ordered by (rank of first-reaching parent,
        # degree, node id) — exactly the sequence the classic per-node
        # queue produces (each node is claimed by the first parent that
        # reaches it; a parent's new neighbors are appended in increasing
        # degree, ties by node id via np.unique's sort).
        visited[start] = True
        frontier = np.array([start], dtype=np.int64)
        while frontier.size:
            out[pos:pos + frontier.size] = frontier
            pos += frontier.size
            nb, parent_rank = _gather_neighbors(offs, cols, frontier)
            keep = ~visited[nb]
            nb, parent_rank = nb[keep].astype(np.int64), parent_rank[keep]
            if nb.size == 0:
                break
            # First-parent attribution: per unique node, min parent rank.
            o = np.lexsort((parent_rank, nb))
            nb_s, pr_s = nb[o], parent_rank[o]
            first = np.empty(nb_s.size, dtype=bool)
            first[0] = True
            first[1:] = nb_s[1:] != nb_s[:-1]
            uniq, pr_min = nb_s[first], pr_s[first]   # uniq is id-sorted
            order2 = np.lexsort((deg[uniq], pr_min))  # stable: id ties kept
            new = uniq[order2]
            visited[new] = True
            frontier = new
    assert pos == n
    return out[::-1].copy()  # reverse CM


def bandwidth(A: CsrMatrix) -> int:
    """max |i − j| over the stored entries (0 for an empty matrix): how far
    a row's couplings reach, the width RCM minimizes."""
    r, c, _ = A.to_coo()
    return int(np.abs(r - c).max()) if A.nnz else 0
