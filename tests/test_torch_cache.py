"""Port parity: the setup cache (harness/cache.py) and the same-pattern AMG
re-setup (solvers/amg.py::HierarchyRefresher) against the JAX package.

- The JAX package's `tests/test_cache.py` cases, on the port.
- The port's `.npz` entries (`ordering`, `spchol`, `amg_hier`,
  `amg_hier_pat`) have the JAX package's file names and equal its arrays,
  array for array, each package writing into its own directory.
- The port hits entries the JAX package wrote.
- A pattern hit re-forms the coarse operators of the frozen hierarchy (the
  host Galerkin product within 1e-12) and recomputes the smoother
  scalings; a stale pattern entry and a corrupt entry fall back to a
  rebuild; cached solves give the uncached x.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from lsbench_tpu.harness import cache as jcache
from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.ordering import get_ordering as j_get_ordering
from lsbench_tpu.solvers import amg as jamg
from lsbench_tpu.solvers.base import get_solver as j_get_solver

from lsbench_tpu_torch import ordering as tordering
from lsbench_tpu_torch.harness import cache
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
from lsbench_tpu_torch.ops.spgemm import rap
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers import amg as tamg
from lsbench_tpu_torch.solvers import get_solver

from conftest import make_rhs

CPU = torch.device("cpu")
PRESET = dict(coarsening="classical", theta=0.5, interp="jacobi",
              interp_passes=3, interp_omega=0.5, pmax=8, coarse_n=16)


@pytest.fixture
def cache_on(tmp_path, monkeypatch):
    """The port's cache on, in a fresh directory, with an empty refresher
    memo; restored after the test."""
    monkeypatch.setattr(cache, "_enabled", True)
    monkeypatch.setattr(cache, "_root", tmp_path / "port")
    monkeypatch.setattr(tamg, "_REFRESHERS", {})
    return tmp_path / "port"


@pytest.fixture
def jax_cache(tmp_path, monkeypatch):
    """The JAX package's cache on, in its own fresh directory."""
    monkeypatch.setattr(jcache, "_enabled", True)
    monkeypatch.setattr(jcache, "_root", tmp_path / "jax")
    monkeypatch.setattr(jamg, "_REFRESHERS", {})
    return tmp_path / "jax"


def _revalued(A, seed=0):
    """Same pattern, values scaled by 1.5 and perturbed by 1% (SPD)."""
    rng = np.random.default_rng(seed)
    r = A.row_indices()
    s = 1.5 + 0.01 * rng.random(A.nrows)
    return type(A)(A.nrows, A.ncols, A.offs, A.cols,
                   A.vals * np.sqrt(s[r] * s[A.cols]))


def _entries(d: Path) -> dict:
    out = {}
    for f in sorted(d.glob("*.npz")):
        with np.load(f) as z:
            out[f.name] = {k: z[k] for k in z.files}
    return out


def _assert_entries_equal(port: dict, jax: dict):
    assert sorted(port) == sorted(jax)
    for name in port:
        assert sorted(port[name]) == sorted(jax[name]), name
        for k, v in port[name].items():
            w = jax[name][k]
            assert v.dtype == w.dtype, (name, k, v.dtype, w.dtype)
            np.testing.assert_array_equal(v, w, err_msg=f"{name}:{k}")


# --------------------------------------- the JAX package's test_cache cases

def test_cache_off_loads_nothing(monkeypatch):
    monkeypatch.setattr(cache, "_enabled", False)
    assert cache.load_arrays("ordering", "deadbeef") is None


def test_default_dir_is_the_ports_own(monkeypatch, tmp_path):
    monkeypatch.delenv("LSBENCH_CACHE_DIR", raising=False)
    monkeypatch.setattr(cache, "_root", None)
    monkeypatch.setattr(jcache, "_root", None)
    assert cache.cache_dir().name == "lsbench_tpu_torch"
    assert cache.cache_dir() != jcache.cache_dir()
    monkeypatch.setenv("LSBENCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache, "_root", None)
    assert cache.cache_dir() == tmp_path


def test_fingerprint_distinguishes_values():
    A, B = poisson_2d(6), poisson_2d(6)
    assert cache.fingerprint_csr(A) == cache.fingerprint_csr(B)
    assert cache.fingerprint_csr(A) != cache.fingerprint_csr(
        random_spd(36, seed=0))
    A2 = _revalued(A)
    assert cache.fingerprint_csr(A) != cache.fingerprint_csr(A2)
    assert cache.fingerprint_pattern(A) == cache.fingerprint_pattern(A2)


@pytest.mark.parametrize("name", ["rcm", "amd", "metis"])
def test_ordering_cache_roundtrip(cache_on, name, monkeypatch):
    A = poisson_2d(10)
    p1 = get_ordering(name, A)
    assert any(cache_on.glob("ordering-*.npz"))
    for fn in ("rcm_ordering", "amd_ordering", "nd_ordering"):
        monkeypatch.setattr(tordering, fn, None)  # a hit computes nothing
    np.testing.assert_array_equal(get_ordering(name, A), p1)


@pytest.mark.parametrize("schedule", ["host", "block", "level"])
def test_sparse_cholesky_cache_hit_same_answer(cache_on, schedule):
    A = poisson_2d(10)
    b = make_rhs(A.nrows)
    cls, params = get_solver("sparse_cholesky")
    params.update(schedule=schedule, device=CPU)
    s1 = cls(A, **params)
    x1 = s1.solve(b).x.numpy()
    assert "factor_s" in s1.setup_breakdown
    assert any(cache_on.glob("spchol-*.npz"))
    s2 = cls(A, **params)  # the second build hits the cache
    assert "factor_s" not in s2.setup_breakdown
    assert s2.fill_nnz == s1.fill_nnz
    np.testing.assert_array_equal(s2.solve(b).x.numpy(), x1)


def test_amg_hierarchy_cache_hit_same_answer(cache_on):
    A = poisson_2d(12)
    b = make_rhs(A.nrows)
    cls, params = get_solver("amg")
    params.update(rtol=1e-8, maxiter=50, coarse_n=16, device=CPU)
    s1 = cls(A, **params)
    r1 = s1.solve(b)
    assert s1.setup_breakdown["hier_cache"] == "miss"
    assert any(cache_on.glob("amg_hier-*.npz"))
    s2 = cls(A, **params)
    assert s2.setup_breakdown["hier_cache"] == "exact_hit"
    r2 = s2.solve(b)
    assert r1.iters == r2.iters
    np.testing.assert_array_equal(r1.x.numpy(), r2.x.numpy())


@pytest.mark.parametrize("kind", ["ordering", "spchol", "amg_hier"])
def test_corrupt_cache_entry_is_rebuilt(cache_on, kind):
    A = poisson_2d(8)

    def run():
        if kind == "ordering":
            return get_ordering("rcm", A)
        if kind == "spchol":
            cls, params = get_solver("sparse_cholesky")
            return cls(A, **params, device=CPU).solve(make_rhs(A.nrows)).x
        bd = {}
        mats, _ = tamg.build_matrix_hierarchy(A, tamg.AmgOptions(**PRESET),
                                              breakdown=bd, device=CPU)
        assert bd["hier_cache"] == "miss"
        return mats[0]["P"].vals

    first = run()
    for f in cache_on.glob(f"{kind}*.npz"):  # amg_hier: the pattern copy too
        f.write_bytes(b"not an npz")
    np.testing.assert_array_equal(run(), first)  # rebuilt, no crash
    with np.load(next(cache_on.glob(f"{kind}-*.npz"))) as z:
        assert z.files  # and stored again


def test_clear(cache_on):
    get_ordering("rcm", poisson_2d(8))
    assert cache.clear() >= 1
    assert not any(cache_on.glob("*.npz"))


# ------------------------------------------------ entries equal the JAX ones

def test_entries_equal_the_jax_packages(cache_on, jax_cache):
    """Each package writes into its own directory: the same file names and,
    array for array, the same contents (dtype included)."""
    JA = j_poisson_2d(12)
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    for name in ("rcm", "amd", "metis"):
        j_get_ordering(name, JA)
        get_ordering(name, A)
    jcls, jparams = j_get_solver("sparse_cholesky")
    jcls(JA, **jparams)
    cls, params = get_solver("sparse_cholesky")
    cls(A, **params, device=CPU)
    jamg.build_matrix_hierarchy(JA, jamg.AmgOptions(**PRESET))
    tamg.build_matrix_hierarchy(A, tamg.AmgOptions(**PRESET), device=CPU)
    port, jax = _entries(cache_on), _entries(jax_cache)
    kinds = sorted({n.split("-")[0] for n in port})
    assert kinds == ["amg_hier", "amg_hier_pat", "ordering", "spchol"]
    _assert_entries_equal(port, jax)


def test_port_hits_entries_the_jax_package_wrote(cache_on, jax_cache,
                                                monkeypatch):
    monkeypatch.setattr(cache, "_root", jax_cache)
    JA = j_poisson_2d(12)
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    perm = j_get_ordering("amd", JA)
    jcls, jparams = j_get_solver("sparse_cholesky")
    jcls(JA, **jparams)
    j_mats, _ = jamg.build_matrix_hierarchy(JA, jamg.AmgOptions(**PRESET))
    before = _entries(jax_cache)

    monkeypatch.setattr(tordering, "amd_ordering", None)
    np.testing.assert_array_equal(get_ordering("amd", A), perm)
    cls, params = get_solver("sparse_cholesky")
    s = cls(A, **params, device=CPU)
    assert "factor_s" not in s.setup_breakdown
    b = make_rhs(A.nrows)
    assert np.linalg.norm(b - A.matvec(s.solve(b).x.numpy())) \
        <= 1e-10 * np.linalg.norm(b)
    bd = {}
    mats, _ = tamg.build_matrix_hierarchy(A, tamg.AmgOptions(**PRESET),
                                          breakdown=bd, device=CPU)
    assert bd["hier_cache"] == "exact_hit"
    for m, jm in zip(mats, j_mats):
        for f in ("offs", "cols", "vals"):
            np.testing.assert_array_equal(getattr(m["P"], f),
                                          getattr(jm["P"], f))
    bd = {}
    tamg.build_matrix_hierarchy(_revalued(A), tamg.AmgOptions(**PRESET),
                                breakdown=bd, device=CPU)
    assert bd["hier_cache"] == "pattern_hit_device_rap"
    assert _entries(jax_cache).keys() == before.keys()  # nothing new stored


# ------------------------------------------------------------- pattern hits

def test_amg_pattern_hit_device_rap(cache_on):
    """A value change with the same sparsity hits the pattern-keyed entry:
    every coarse operator is re-formed from the frozen P and the new fine
    values (the host Galerkin product within 1e-12), the smoother scalings
    are recomputed, and the refreshed hierarchy is not stored under the
    exact key (a re-run pattern-hits again, through the memo)."""
    A = poisson_2d(24)
    opts = tamg.AmgOptions(**{**PRESET, "max_levels": 3})
    bd = {}
    mats0, _ = tamg.build_matrix_hierarchy(A, opts, breakdown=bd, device=CPU)
    assert bd["hier_cache"] == "miss" and len(mats0) >= 2

    A2 = _revalued(A, seed=1)
    bd2 = {}
    mats2, Ac2 = tamg.build_matrix_hierarchy(A2, opts, breakdown=bd2,
                                             device=CPU)
    assert bd2["hier_cache"] == "pattern_hit_device_rap"
    assert bd2["rap_device_s"] >= 0.0 and bd2["rap_symbolic_s"] > 0.0
    P0 = mats0[0]["P"]
    ref = rap(P0.transpose(), A2, P0)
    got = mats2[1]["A"]
    scale = np.abs(ref.to_dense()).max()
    assert np.abs(got.to_dense() - ref.to_dense()).max() <= 1e-12 * scale
    np.testing.assert_allclose(mats2[0]["dinv"], 1.0 / A2.diagonal(),
                               rtol=1e-13)
    np.testing.assert_array_equal(mats2[0]["P"].vals, P0.vals)
    assert mats2[1]["rho"] != mats0[1]["rho"]
    n_files = len(list(cache_on.glob("*.npz")))
    bd3 = {}
    mats3, _ = tamg.build_matrix_hierarchy(A2, opts, breakdown=bd3,
                                           device=CPU)
    assert bd3["hier_cache"] == "pattern_hit_device_rap"
    assert "rap_symbolic_s" not in bd3  # the memoized plans
    assert len(list(cache_on.glob("*.npz"))) == n_files
    for m2, m3 in zip(mats2, mats3):  # the memoized refresher is repeatable
        np.testing.assert_array_equal(m2["A"].vals, m3["A"].vals)


def test_refreshed_levels_match_the_jax_refresher(cache_on, jax_cache):
    """Both packages' pattern hits on the same new values: the same
    re-formed operators (within 1e-12) and the same scalings."""
    JA = j_poisson_2d(24)
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    jamg.build_matrix_hierarchy(JA, jamg.AmgOptions(**PRESET))
    tamg.build_matrix_hierarchy(A, tamg.AmgOptions(**PRESET), device=CPU)
    A2 = _revalued(A, seed=2)
    JA2 = type(JA)(A2.nrows, A2.ncols, A2.offs, A2.cols, A2.vals)
    jbd, bd = {}, {}
    jm, jc = jamg.build_matrix_hierarchy(JA2, jamg.AmgOptions(**PRESET),
                                         breakdown=jbd)
    tm, tc = tamg.build_matrix_hierarchy(A2, tamg.AmgOptions(**PRESET),
                                         breakdown=bd, device=CPU)
    assert jbd["hier_cache"] == bd["hier_cache"] == "pattern_hit_device_rap"
    for m, j in zip(tm + [dict(A=tc)], jm + [dict(A=jc)]):
        np.testing.assert_array_equal(m["A"].offs, j["A"].offs)
        np.testing.assert_array_equal(m["A"].cols, j["A"].cols)
        scale = np.abs(j["A"].vals).max()
        assert np.abs(m["A"].vals - j["A"].vals).max() <= 1e-12 * scale
        if "dinv" in m:
            np.testing.assert_allclose(m["dinv"], j["dinv"], rtol=1e-12)
            np.testing.assert_allclose(m["rho"], j["rho"], rtol=1e-9)


def test_stale_pattern_entry_falls_back_to_rebuild(cache_on):
    """A pattern entry whose coarse pattern is not the RAP plan's (an older
    code version's) is not used: the hierarchy is rebuilt."""
    A = poisson_2d(16)
    opts = tamg.AmgOptions(**PRESET)
    mats0, _ = tamg.build_matrix_hierarchy(A, opts, device=CPU)
    f = next(cache_on.glob("amg_hier_pat-*.npz"))
    with np.load(f) as z:
        arrays = {k: z[k] for k in z.files}
    # Level 1's stored operator loses its last stored entry.
    k = "l1_A" if int(arrays["n_levels"][0]) > 1 else "coarse"
    arrays[k + "_offs"] = arrays[k + "_offs"].copy()
    arrays[k + "_offs"][-1] -= 1
    arrays[k + "_cols"] = arrays[k + "_cols"][:-1]
    arrays[k + "_vals"] = arrays[k + "_vals"][:-1]
    np.savez(f, **arrays)
    bd = {}
    mats, _ = tamg.build_matrix_hierarchy(_revalued(A), opts, breakdown=bd,
                                          device=CPU)
    assert bd["hier_cache"] == "miss"
    assert not tamg._REFRESHERS
    assert len(mats) == len(mats0)


# ----------------------------------------------- cached solves, same answer

@pytest.mark.parametrize("solver,kw", [
    ("cg_ir", dict(precond="amg_classical", ordering="rcm", rtol=1e-10)),
    ("sparse_cholesky", dict(ordering="amd")),
], ids=["cg_ir amg_classical", "sparse_cholesky"])
def test_cached_solve_gives_uncached_x(cache_on, monkeypatch, solver, kw):
    A = poisson_2d(16)
    b = make_rhs(A.nrows)
    cls, params = get_solver(solver)
    params.update(kw, device=CPU)
    monkeypatch.setattr(cache, "_enabled", False)
    x0 = cls(A, **params).solve(b).x.numpy()
    monkeypatch.setattr(cache, "_enabled", True)
    xs = [cls(A, **params).solve(b).x.numpy() for _ in range(2)]
    assert any(cache_on.glob("*.npz"))
    for x in xs:  # the miss, then the hit
        np.testing.assert_array_equal(x, x0)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_amg_pattern_hit_on_card(cache_on, cuda_device):
    """The refresher's numeric RAP on the card: the CPU refresh within
    1e-12 and bitwise repeatable."""
    A = poisson_2d(24)
    opts = tamg.AmgOptions(**PRESET)
    tamg.build_matrix_hierarchy(A, opts, device=CPU)
    A2 = _revalued(A, seed=3)
    out = {}
    for dev in (CPU, cuda_device, cuda_device):
        bd = {}
        mats, _ = tamg.build_matrix_hierarchy(A2, opts, breakdown=bd,
                                              device=dev)
        assert bd["hier_cache"] == "pattern_hit_device_rap"
        out.setdefault(str(dev), []).append(mats)
    cpu, (card1, card2) = out["cpu"][0], out[str(cuda_device)]
    for c, g1, g2 in zip(cpu, card1, card2):
        np.testing.assert_array_equal(g1["A"].vals, g2["A"].vals)
        scale = np.abs(c["A"].vals).max()
        assert np.abs(g1["A"].vals - c["A"].vals).max() <= 1e-12 * scale
