"""Bandwidth- and fill-reducing orderings (counterpart of
`lsbench_tpu/ordering/__init__.py`).

The reference exposes `--ordering RCM|AMD|METIS` and applies the symmetric
permutation on the host before factorization (cusparse.c:66-96). Here:
RCM (bandwidth reduction, which also densifies the block layouts), AMD
(fill reduction for the direct solvers) and nested dissection (`nd.py`),
which fills the METIS role: `--ordering metis` dispatches to it.
"""

from __future__ import annotations

import numpy as np

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ordering.amd import amd_ordering
from lsbench_tpu_torch.ordering.nd import nd_ordering
from lsbench_tpu_torch.ordering.rcm import rcm_ordering


def get_ordering(name: str, A: CsrMatrix) -> np.ndarray:
    """Return a permutation `perm` such that B = A[perm, perm] is the
    reordered matrix (identity for 'none'). Cached by the matrix's content
    hash when the setup cache is on (`harness/cache.py`)."""
    name = name.lower()
    if name == "none":
        return np.arange(A.nrows)
    if name not in ("rcm", "amd", "metis", "nd"):
        raise KeyError(f"unknown ordering '{name}'")

    from lsbench_tpu_torch.harness import cache
    key = None
    if cache.is_enabled():
        key = cache.key_of(cache.fingerprint_csr(A), name)
        hit = cache.load_arrays("ordering", key)
        if hit is not None:
            return hit["perm"]

    if name == "rcm":
        perm = rcm_ordering(A)
    elif name == "amd":
        perm = amd_ordering(A)
    else:
        # Native nested dissection fills the METIS role (cusparse.c:75-79).
        perm = nd_ordering(A)
    if key is not None:
        cache.store_arrays("ordering", key, {"perm": perm})
    return perm


__all__ = ["get_ordering", "rcm_ordering", "amd_ordering", "nd_ordering"]
