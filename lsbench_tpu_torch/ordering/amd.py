"""Minimum-degree ordering, fill reduction for the direct solvers
(counterpart of `lsbench_tpu/ordering/amd.py`).

Role equivalent to `cusolverSpXcsrsymamdHost` (cusparse.c:72-74) and to the
ordering CHOLMOD runs inside `analyze` (cholmod-impl.h:25). The
permutations are the JAX package's for the same CSR.
"""

from __future__ import annotations

import heapq

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ordering.rcm import _symmetrized_graph


def amd_ordering(A: CsrMatrix) -> np.ndarray:
    """Permutation p (new index i holds old row p[i]) by minimum degree.

    Prefers the native approximate minimum degree (`native/mindeg.cpp::
    lsb_amd`: supervariables, w-pass degrees, element absorption — the
    SuiteSparse-AMD algorithm class CHOLMOD's analyze runs). Only when the
    native library cannot be built or loaded does it take the pure-Python
    exact scheme `min_degree_graph` (the native exact scheme lives in the
    same library, so it cannot stand in). The JAX package measured 9.06M
    fill for the approximate scheme on the 512² Poisson, against 12.25M
    for the exact one."""
    from lsbench_tpu_torch.native import NativeUnavailable, mindeg
    offs, cols = _symmetrized_graph(A)
    try:
        return mindeg.amd_approx(offs, cols, A.nrows)
    except NativeUnavailable:
        return min_degree_graph(offs, cols, A.nrows)


def min_degree_graph(offs: np.ndarray, cols: np.ndarray, n: int) -> np.ndarray:
    """Exact minimum-degree ordering of an adjacency graph (no self loops):
    greedy elimination with clique updates, lazily invalidated heap
    entries, (degree, node) tie-break."""
    adj: list[set[int]] = [set(cols[offs[i]:offs[i + 1]].tolist())
                           for i in range(n)]
    heap = [(len(adj[i]), i) for i in range(n)]
    heapq.heapify(heap)
    eliminated = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    while heap:
        d, u = heapq.heappop(heap)
        if eliminated[u] or d != len(adj[u]):
            continue  # stale entry
        eliminated[u] = True
        order[pos] = u
        pos += 1
        nbrs = adj[u]
        # Eliminating u connects its neighbors into a clique.
        for v in nbrs:
            av = adj[v]
            av.discard(u)
            av |= nbrs
            av.discard(v)
            heapq.heappush(heap, (len(av), v))
        adj[u] = set()
    assert pos == n
    return order
