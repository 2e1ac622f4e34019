"""The port's scaling sweep (`lsbench_tpu_torch/harness/scale.py`,
`python -m lsbench_tpu_torch.scale`) against the JAX package's
(`lsbench_tpu/harness/scale.py`) on the CPU: gloo ranks here, the 8
simulated devices there.

Inputs: poisson_2d(16) (n=256), RCM inside the solvers, b[i] = i; a
diagonal system that CG solves exactly in one iteration. Bars:
- `main([... "--devices", "1,2", "--iters", "5", "--reps", "1", "--json",
  "--platform", "cpu"])` returns 0 and prints the table header's
  efficiency column, a `1x1` row and one JSON record per count with the
  JAX tool's keys (`tests/test_cli.py:61` for the JAX tool);
- `run_sweep` at D ∈ {1, 2, 4} with `mesh2d`: the same meshes (`2x2` at
  D = 4), devices and strategies as the JAX `run_sweep`, every JAX record
  key, and `launches`, the port's one addition (zeros on the CPU);
- the 2-rank fixed-iteration x (`rtol=0`, `maxiter=5`) within 1e-12
  relative of the JAX `DistributedCg`'s on 2 devices, after 5 iterations
  in both; on the diagonal system both stop after 1 iteration (‖r‖² = 0:
  the JAX loop's stop rule, which the port keeps);
- `--platform cuda` with no card exits 1, printing no record.
"""

import json

import numpy as np
import pytest
import torch

from lsbench_tpu_torch.harness import scale
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel.launch import run_ranks

JAX_KEYS = {"mesh", "devices", "elapsed_s", "nnz_per_s", "speedup",
            "efficiency", "strategy"}


def _port_csr(A) -> CsrMatrix:
    return CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals)


def _jax_poisson():
    from lsbench_tpu.matrix.generate import poisson_2d
    return poisson_2d(16)


def _diagonal(n=64):
    """diag(2^(i mod 4)): with Jacobi, z = D⁻¹b and D·z = b exactly, so
    α = 1 and the first step leaves r = 0 exactly."""
    from lsbench_tpu.matrix.csr import CsrMatrix as JCsr
    i = np.arange(n)
    return JCsr.from_coo(i, i, 2.0 ** (i % 4), nrows=n, ncols=n)


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    from lsbench_tpu_torch.matrix.io import write_matrix
    f = tmp_path_factory.mktemp("scale") / "p16.txt"
    write_matrix(_port_csr(_jax_poisson()), str(f))
    return str(f)


def test_main_prints_the_table_and_records(matrix_file, capsys):
    rc = scale.main(["--matrix", matrix_file, "--devices", "1,2", "--iters",
                     "5", "--reps", "1", "--json", "--platform", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "eff" in out.splitlines()[0] and "1x1" in out
    recs = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert [r["mesh"] for r in recs] == ["1x1", "2x1"]
    for r in recs:
        assert JAX_KEYS | {"matrix", "iters", "n", "nnz"} <= set(r)
        assert (r["iters"], r["n"], r["nnz"]) == (5, 256, 1216)
        assert "efficiency" in r and r["elapsed_s"] > 0
    assert recs[0]["speedup"] == recs[0]["efficiency"] == 1.0


def test_records_match_the_jax_sweep():
    from lsbench_tpu.harness.scale import run_sweep as j_run_sweep
    JA = _jax_poisson()
    kw = dict(iters=5, reps=1, ordering="rcm", mesh2d=True)
    want = j_run_sweep(JA, [1, 2, 4], **kw)
    got = scale.run_sweep(_port_csr(JA), [1, 2, 4], platform="cpu", **kw)
    assert [(r["mesh"], r["devices"], r["strategy"]) for r in got] == [
        (r["mesh"], r["devices"], r["strategy"]) for r in want] == [
        ("1x1", 1, "halo"), ("2x1", 2, "halo"), ("4x1", 4, "halo"),
        ("2x2", 4, "2d")]
    for g, w in zip(got, want):
        assert set(g) == set(w) | {"launches"}
        assert not any(g["launches"].values())  # plain versions on the CPU
        assert g["elapsed_s"] > 0 and g["nnz_per_s"] > 0
    assert got[0]["speedup"] == got[0]["efficiency"] == 1.0


def _rank_fixed_iterations(mesh, jobs):
    """Each job's gathered x and iterations at rtol=0."""
    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
    from lsbench_tpu_torch.solvers.base import to_numpy
    out = {}
    for name, (A, kw) in jobs.items():
        res = DistributedCg(A, mesh, rtol=0.0, **kw).solve(
            np.arange(A.nrows, dtype=np.float64))
        out[name] = (to_numpy(res.x), res.iters)
    return out


def test_fixed_iteration_x_matches_jax():
    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    cases = {"p16": (_jax_poisson(), dict(maxiter=5, ordering="rcm")),
             "diagonal": (_diagonal(), dict(maxiter=5))}
    jobs = {k: (_port_csr(JA), kw) for k, (JA, kw) in cases.items()}
    ranks = run_ranks(2, _rank_fixed_iterations, jobs, timeout=110)
    for name, (JA, kw) in cases.items():
        b = np.arange(JA.nrows, dtype=np.float64)
        j = DistributedCg(JA, make_row_mesh(2), rtol=0.0, **kw).solve(b)
        jx = np.asarray(j.x, np.float64)
        for x, iters in (r[name] for r in ranks):
            assert iters == j.iters == (5 if name == "p16" else 1), name
            assert np.linalg.norm(x - jx) <= 1e-12 * np.linalg.norm(jx), name


def test_cuda_without_a_card_exits_1(matrix_file, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: --platform cuda would run")
    rc = scale.main(["--matrix", matrix_file, "--devices", "1", "--iters",
                     "5", "--reps", "1", "--json"])
    cap = capsys.readouterr()
    assert rc == 1 and not cap.out
    assert "--platform cuda: no CUDA device is available" in cap.err
