"""Bandwidth- and fill-reducing orderings (counterpart of
`lsbench_tpu/ordering/__init__.py`).

The slice ports `none` and `rcm`. AMD and nested dissection (`amd`,
`metis`, `nd`) are ROADMAP Queue 1 items: they raise NotImplementedError,
and no other ordering is substituted for them.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ordering.rcm import rcm_ordering

NOT_PORTED = ("amd", "metis", "nd")


def get_ordering(name: str, A: CsrMatrix) -> np.ndarray:
    """Return a permutation `perm` such that B = A[perm, perm] is the
    reordered matrix (identity for 'none')."""
    name = name.lower()
    if name == "none":
        return np.arange(A.nrows)
    if name == "rcm":
        return rcm_ordering(A)
    if name in NOT_PORTED:
        raise NotImplementedError(
            f"ordering '{name}' is not yet ported to lsbench_tpu_torch "
            "(ROADMAP.md Queue 1: amd/nd orderings)")
    raise KeyError(f"unknown ordering '{name}'")


__all__ = ["get_ordering", "rcm_ordering"]
