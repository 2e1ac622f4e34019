"""Bandwidth- and fill-reducing orderings (counterpart of
`lsbench_tpu/ordering/__init__.py`).

The reference exposes `--ordering RCM|AMD|METIS` and applies the symmetric
permutation on the host before factorization (cusparse.c:66-96). Here:
RCM (bandwidth reduction, which also densifies the block layouts), AMD
(fill reduction for the direct solvers) and nested dissection (`nd.py`),
which fills the METIS role: `--ordering metis` dispatches to it. The JAX
package's setup cache (`--cache`) is not ported.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ordering.amd import amd_ordering
from lsbench_tpu_torch.ordering.nd import nd_ordering
from lsbench_tpu_torch.ordering.rcm import rcm_ordering


def get_ordering(name: str, A: CsrMatrix) -> np.ndarray:
    """Return a permutation `perm` such that B = A[perm, perm] is the
    reordered matrix (identity for 'none')."""
    name = name.lower()
    if name == "none":
        return np.arange(A.nrows)
    if name == "rcm":
        return rcm_ordering(A)
    if name == "amd":
        return amd_ordering(A)
    if name in ("metis", "nd"):
        # Native nested dissection fills the METIS role (cusparse.c:75-79).
        return nd_ordering(A)
    raise KeyError(f"unknown ordering '{name}'")


__all__ = ["get_ordering", "rcm_ordering", "amd_ordering", "nd_ordering"]
