"""The port's distributed dry run (`lsbench_tpu_torch/parallel/dryrun.py`,
the counterpart of `lsbench_tpu/parallel/dryrun.py` and of
`__graft_entry__.dryrun_multichip`) on gloo ranks.

Bars: `run_dryrun(4, platform="cpu")` passes every solve's assert (the JAX
dry run's bars, the IR classes at their rtol 1e-8) with the 2 × 2 grid's
four solves; `python -m lsbench_tpu_torch.parallel.dryrun 2 --platform
cpu` exits 0 and prints "ok"; on `cuda` without a card
`dryrun_multichip(2)` raises "requested 2 devices, have 0" before any rank
starts, and the module and a script calling it exit 1: no fall-back to
the CPU, where the JAX hook falls back to a virtual CPU mesh.
"""

import os
import subprocess
import sys

import pytest
import torch

from lsbench_tpu_torch.parallel import dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ONE_D = {"cg", "amg_cg", "cg bsr", "gmres", "bicgstab", "amg v fixed",
         "amg k fixed", "cg_ir", "bicgstab_ir", "gmres_ir", "block_cg k=3"}
TWO_D = {"cg 2d", "amg_cg 2d", "cg_ir 2d", "block_cg 2d k=2"}


def _python(*argv, timeout=120):
    return subprocess.run([sys.executable, *argv], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_dryrun_on_four_ranks_runs_the_grid_too():
    out = dryrun.run_dryrun(4, platform="cpu", timeout=110)
    assert set(out["solves"]) == ONE_D | TWO_D
    for name, (iters, rel) in out["solves"].items():
        assert iters >= 1 and rel < 0.3, name
    assert out["solves"]["cg_ir"][1] < 1e-8
    assert out["solves"]["cg_ir 2d"][1] < 1e-8
    assert out["solves"]["amg v fixed"][0] == 2
    assert not any(out["launches"].values())  # plain versions on the CPU


def test_module_on_two_cpu_ranks_exits_0():
    p = _python("-m", "lsbench_tpu_torch.parallel.dryrun", "2",
                "--platform", "cpu")
    assert p.returncode == 0, p.stderr[-3000:]
    lines = p.stdout.splitlines()
    assert lines[-1] == "ok"
    assert {ln.split(":")[0] for ln in lines[:-1]} == ONE_D


def test_cuda_without_cards_refuses_and_does_not_fall_back(monkeypatch):
    if torch.cuda.device_count() >= 2:
        pytest.skip("two cards present: the cuda dry run would run")
    have = torch.cuda.device_count()
    msg = f"requested 2 devices, have {have}"

    def no_ranks(*a, **k):
        raise AssertionError("ranks started")
    monkeypatch.setattr(dryrun, "run_ranks", no_ranks)
    with pytest.raises(ValueError, match=msg):
        dryrun.dryrun_multichip(2)
    p = _python("-c", "from lsbench_tpu_torch.parallel.dryrun import "
                      "dryrun_multichip; dryrun_multichip(2)")
    assert p.returncode == 1 and msg in p.stderr and not p.stdout
    p = _python("-m", "lsbench_tpu_torch.parallel.dryrun", "2")
    assert p.returncode == 1 and msg in p.stderr and not p.stdout
