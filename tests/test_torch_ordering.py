"""Port parity: the fill-reducing orderings (`ordering/amd.py`,
`ordering/nd.py`, `native/mindeg.cpp`) against the JAX package's.

Bar: every permutation bitwise equal to the JAX package's on the same CSR
(all of them are deterministic integer algorithms). The CLI's fallback for
an invalid ordering, AMD, now runs."""

import json

import numpy as np
import pytest

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.matrix.generate import sem_2d as j_sem_2d
from lsbench_tpu.native import mindeg as j_mindeg
from lsbench_tpu.ordering import get_ordering as j_get_ordering
from lsbench_tpu.ordering.amd import amd_ordering as j_amd
from lsbench_tpu.ordering.amd import min_degree_graph as j_min_degree_graph
from lsbench_tpu.ordering.nd import nd_ordering as j_nd
from lsbench_tpu.ordering.rcm import _symmetrized_graph as j_graph
from lsbench_tpu.ordering.rcm import bandwidth as j_bandwidth

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.native import mindeg
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.ordering.amd import amd_ordering, min_degree_graph
from lsbench_tpu_torch.ordering.nd import nd_ordering
from lsbench_tpu_torch.ordering.rcm import _symmetrized_graph, bandwidth

MATRICES = {
    "poisson_2d(24)": lambda: j_poisson_2d(24),
    "sem_2d(4)": lambda: j_sem_2d(4),
    "random_spd(300,9)": lambda: j_random_spd(300, 9),
}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _graphs(JA):
    A = _port_csr(JA)
    return A, _symmetrized_graph(A), j_graph(JA)


def _is_perm(p, n):
    return p.shape == (n,) and np.array_equal(np.sort(p), np.arange(n))


# method → (port function of (A, graph), JAX function of (JA, graph))
METHODS = {
    "amd (native approximate)": (
        lambda A, g: amd_ordering(A), lambda JA, g: j_amd(JA)),
    "native exact minimum degree": (
        lambda A, g: mindeg.min_degree(*g, A.nrows),
        lambda JA, g: j_mindeg.min_degree(*g, JA.nrows)),
    "python minimum degree": (
        lambda A, g: min_degree_graph(*g, A.nrows),
        lambda JA, g: j_min_degree_graph(*g, JA.nrows)),
    "nd": (lambda A, g: nd_ordering(A), lambda JA, g: j_nd(JA)),
}


@pytest.mark.parametrize("method", sorted(METHODS))
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ordering_bitwise_equals_jax(name, method):
    JA = MATRICES[name]()
    A, g, jg = _graphs(JA)
    for mine, theirs in zip(g, jg, strict=True):
        np.testing.assert_array_equal(mine, theirs)
    port_fn, jax_fn = METHODS[method]
    p = port_fn(A, g)
    assert _is_perm(p, A.nrows)
    np.testing.assert_array_equal(p, jax_fn(JA, jg))


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_bandwidth_equals_jax(name):
    """`rcm.bandwidth` is the JAX function's max |i − j|, before and after
    RCM (which narrows the random matrix's), and 0 for a matrix with no
    entries."""
    JA = MATRICES[name]()
    A = _port_csr(JA)
    p = get_ordering("rcm", A)
    for mine, theirs in ((A, JA), (A.permuted(p), JA.permuted(p))):
        assert bandwidth(mine) == j_bandwidth(theirs)
    if name.startswith("random"):
        assert bandwidth(A.permuted(p)) < bandwidth(A)
    empty = CsrMatrix(3, 3, np.zeros(4, np.int64), np.zeros(0, np.int32),
                      np.zeros(0))
    assert bandwidth(empty) == 0


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_get_ordering_dispatch_matches_jax(name):
    """`amd`, `metis` and `nd` dispatch as the JAX package's `get_ordering`
    does (metis is the nested dissection); an unknown name raises."""
    JA = MATRICES[name]()
    A = _port_csr(JA)
    for key in ("amd", "metis", "nd", "rcm", "none"):
        np.testing.assert_array_equal(get_ordering(key, A),
                                      j_get_ordering(key, JA))
    np.testing.assert_array_equal(get_ordering("METIS", A), nd_ordering(A))
    with pytest.raises(KeyError):
        get_ordering("colamd", A)


def test_amd_falls_back_to_python_only_without_native(monkeypatch):
    """Without the native library `amd_ordering` takes the Python scheme,
    the JAX package's exact minimum-degree permutation; any other error of
    the native ordering propagates."""
    from lsbench_tpu_torch.native import NativeUnavailable
    JA = j_poisson_2d(12)
    A, _, jg = _graphs(JA)
    exact = j_min_degree_graph(*jg, JA.nrows)

    def unavailable(*_):
        raise NativeUnavailable("no toolchain")

    def broken(*_):
        raise RuntimeError("native ordering failed")

    monkeypatch.setattr(mindeg, "amd_approx", unavailable)
    np.testing.assert_array_equal(amd_ordering(A), exact)
    monkeypatch.setattr(mindeg, "amd_approx", broken)
    with pytest.raises(RuntimeError, match="native ordering failed"):
        amd_ordering(A)


def test_amd_reduces_fill_against_the_natural_order():
    """The fill of L (symbolic, `sparse_cholesky.symbolic_rows`) under AMD
    and ND lies below the natural order's on a 2-D grid."""
    from lsbench_tpu_torch.solvers.sparse_cholesky import (elimination_tree,
                                                           symbolic_rows,
                                                           symmetrize)
    A = _port_csr(j_poisson_2d(24))

    def fill(perm):
        As = symmetrize(A.permuted(perm))
        return int(symbolic_rows(As, elimination_tree(As))[0][-1])

    natural = fill(np.arange(A.nrows))
    assert fill(amd_ordering(A)) < 0.7 * natural
    assert fill(nd_ordering(A)) < natural


@pytest.mark.parametrize("ordering", ["zzz", "amd", "metis"])
def test_cli_orderings_run(tmp_path, capsys, ordering):
    """`--ordering amd|metis` run, and an invalid ordering warns and runs
    AMD (lsbench.c:47-49), as in the JAX CLI."""
    from lsbench_tpu_torch.harness.cli import main
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix
    f = tmp_path / "p12.txt"
    write_matrix(poisson_2d(12), str(f))
    rc = main(["--matrix", str(f), "--ordering", ordering, "--trials", "1",
               "--json", "--platform", "cpu"])
    cap = capsys.readouterr()
    assert rc == 0, cap.err
    out = cap.out.strip().splitlines()
    rec = json.loads(out[2])
    expect = "amd" if ordering == "zzz" else ordering
    assert out[1].split(",")[4:6] == ["cholmod", expect]
    assert rec["ordering"] == expect and rec["true_relres"] <= 1e-10
    assert ("Defaulting to AMD" in cap.err) == (ordering == "zzz")
