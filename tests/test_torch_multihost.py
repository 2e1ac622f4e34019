"""The port's multi-process seam (`parallel/mesh.py init_distributed`, the
TCPStore rendezvous, the CLI's `--coordinator --num-processes
--process-id`), the counterpart of `tests/test_multihost.py`: processes
started apart on this host, with gloo ranks, meeting at a coordinator on
127.0.0.1.

Inputs: poisson_2d(24) (n=576), b[i] = i. Bars:
- two CLI processes, `--coordinator 127.0.0.1:<port> --num-processes 2
  --process-id {0,1} --devices 4 --platform cpu --solver cg --ordering
  rcm --json`: both exit 0 and print records with the same iterations and
  relres (x is gathered on every rank), equal to the single-process
  `--devices 4` run's and to the JAX `DistributedCg`'s iterations on a
  4-device mesh; with `--verbose 1` each prints the JAX CLI's
  `distributed: process i/2, 4 global devices`;
- the solver API: 2 processes × 2 ranks (`init_distributed`, then
  `run_ranks(4, ..., coordinator=..., first=2i, local=2)`): every rank's x
  within 1e-9 relative of the single-device CG's, and the same on all
  ranks;
- refusals, exit 1 with the JAX messages: `--coordinator nohost`,
  `--num-processes 2` without `--process-id`, `--process-id 2` of 2, and
  the port's own: `--devices 3` over 2 processes; `init_distributed`
  without ids reads WORLD_SIZE and RANK, and raises without them.

A test skips only if binding a socket on 127.0.0.1 fails before anything
starts; every process it starts has a 120 s limit and is killed after.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from lsbench_tpu_torch.harness.cli import main
from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.parallel import mesh as tmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120

WORKER = r"""
import sys

import numpy as np


def solve_rank(mesh, A):
    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
    from lsbench_tpu_torch.solvers.base import to_numpy
    res = DistributedCg(A, mesh, rtol=1e-10, ordering="rcm").solve(
        np.arange(A.nrows, dtype=np.float64))
    return mesh.rank, mesh.local_rank, res.iters, to_numpy(res.x)


if __name__ == "__main__":
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.parallel.launch import run_ranks
    from lsbench_tpu_torch.parallel.mesh import (distributed_process,
                                                 init_distributed)
    coordinator, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    assert init_distributed(coordinator, 2, pid) == pid
    info = distributed_process()
    local = 4 // info.num_processes
    res = run_ranks(4, solve_rank, poisson_2d(24), coordinator=coordinator,
                    first=info.process_id * local, local=local, timeout=100)
    np.savez(out, ranks=[r[:3] for r in res], x=np.stack([r[3] for r in res]))
"""


@pytest.fixture
def port():
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    try:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            return s.getsockname()[1]
    except OSError as e:
        pytest.skip(f"cannot bind a socket on 127.0.0.1: {e}")


@pytest.fixture(scope="module")
def matrix():
    from lsbench_tpu.matrix.generate import poisson_2d
    return poisson_2d(24)


@pytest.fixture(scope="module")
def matrix_file(matrix, tmp_path_factory):
    from lsbench_tpu_torch.matrix.io import write_matrix
    f = tmp_path_factory.mktemp("multihost") / "p24.txt"
    write_matrix(CsrMatrix(matrix.nrows, matrix.ncols, matrix.offs,
                           matrix.cols, matrix.vals), str(f))
    return str(f)


def _run_together(argvs):
    """Start one process per argv (from the repo root), wait for all within
    LIMIT_S, kill what remains; [(returncode, stdout, stderr)]."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO, *filter(None, [os.environ.get("PYTHONPATH")])]))
    procs = [subprocess.Popen([sys.executable, *argv], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=LIMIT_S)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


CG = ["--solver", "cg", "--ordering", "rcm", "--json", "--trials", "1",
      "--warmups", "0", "--platform", "cpu"]


def test_two_cli_processes_match_one_process_and_jax(matrix, matrix_file,
                                                     port, capsys):
    outs = _run_together([
        ["-m", "lsbench_tpu_torch", "--matrix", matrix_file, *CG,
         "--devices", "4", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "2", "--process-id", str(i), "--verbose", "1"]
        for i in range(2)])
    recs = []
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, err[-3000:]
        assert f"distributed: process {i}/2, 4 global devices" in err
        recs.append(json.loads(out.splitlines()[-1]))
    assert recs[0]["iters"] == recs[1]["iters"]
    assert recs[0]["relres"] == recs[1]["relres"]
    assert recs[0]["true_relres"] == recs[1]["true_relres"] <= 1e-8

    assert main(["--matrix", matrix_file, *CG, "--devices", "4"]) == 0
    one = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert (one["iters"], one["relres"]) == (recs[0]["iters"],
                                             recs[0]["relres"])

    from lsbench_tpu.parallel.dist_cg import DistributedCg
    from lsbench_tpu.parallel.mesh import make_row_mesh
    j = DistributedCg(matrix, make_row_mesh(4), rtol=1e-8,
                      ordering="rcm").solve(
        np.arange(matrix.nrows, dtype=np.float64))
    assert recs[0]["iters"] == j.iters


def test_solver_api_two_processes_of_two_ranks(tmp_path, port):
    import torch

    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.solvers.cg import CgSolver
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER)
    outs = _run_together([[str(worker), f"127.0.0.1:{port}", str(i),
                           str(tmp_path / f"x{i}.npz")] for i in range(2)])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    A = poisson_2d(24)
    ref = CgSolver(A, dtype=torch.float64, rtol=1e-10, ordering="rcm",
                   device="cpu").solve(np.arange(A.nrows, dtype=np.float64))
    xs = ref.x.numpy()
    seen = []
    for i in range(2):
        got = np.load(tmp_path / f"x{i}.npz")
        # Process i ran global ranks 2i, 2i+1 on its local ranks 0, 1.
        assert [tuple(r[:2]) for r in got["ranks"]] == [(2 * i, 0),
                                                         (2 * i + 1, 1)]
        for x in got["x"]:
            assert np.linalg.norm(x - xs) <= 1e-9 * np.linalg.norm(xs)
        seen += list(got["x"])
    for x in seen[1:]:
        np.testing.assert_array_equal(x, seen[0])


@pytest.mark.parametrize("flags,message", [
    (["--coordinator", "nohost"], "coordinator must be 'host:port', got"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2"],
     "pass both num_processes and process_id, or neither"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "process_id 2 out of range [0, 2)"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0", "--devices", "3"],
     "--devices 3 is not a multiple of the 2 processes"),
])
def test_refusals_exit_1(matrix_file, capsys, monkeypatch, flags, message):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    rc = main(["--matrix", matrix_file, *CG, *flags])
    cap = capsys.readouterr()
    assert rc == 1 and not cap.out and message in cap.err


def test_init_distributed_reads_the_launchers_environment(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("RANK", "2")
    assert tmesh.init_distributed("127.0.0.1:1") == 2
    assert tmesh.distributed_process() == tmesh.ProcessInfo(
        "127.0.0.1:1", 3, 2)
    monkeypatch.setenv("RANK", "3")
    with pytest.raises(ValueError, match=r"process_id 3 out of range"):
        tmesh.init_distributed("127.0.0.1:1")
    monkeypatch.delenv("RANK")
    with pytest.raises(ValueError, match="pass both num_processes and "
                                         "process_id, or neither"):
        tmesh.init_distributed("127.0.0.1:1")
    assert tmesh.init_distributed("h:2", 2, 1) == 1


def test_group_of_one_and_no_devices(matrix_file, port, capsys):
    """`--coordinator` with one process: `--devices 1` meets at a TCPStore
    it serves itself and takes the FileStore group's iterations; without
    `--devices` it runs the single-device solve, as the JAX CLI does."""
    coord = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
             "--process-id", "0"]
    recs = []
    for extra in (["--devices", "1", *coord], ["--devices", "1"], coord,
                  []):
        assert main(["--matrix", matrix_file, *CG, *extra]) == 0
        recs.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert recs[0]["iters"] == recs[1]["iters"]
    assert recs[0]["strategy"] == recs[1]["strategy"] == "halo"
    assert recs[2]["iters"] == recs[3]["iters"]
    assert "strategy" not in recs[2]  # the single-device solver's record
