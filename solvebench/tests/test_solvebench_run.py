"""Whole runs at a tiny grid: on the CPU past the harness's look for a
card (the program's plain kernels), with faults planted under the timed
path, the control, the import check; and on a card where there is one."""

import argparse
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from solvebench import control
from solvebench import run as bench_run

CELLS = ["hpcg104-jacobi.rhs1", "hpcg104-amg.rhs1"]
TINY = {"nx": 7, "ny": 6, "nz": 5}
SEED = 2**31 + 4321


def one_run(cell, tmp_path, device="cpu", trace=0, hook=None, seconds=0.3):
    args = argparse.Namespace(workload=cell, seed=SEED, seconds=seconds,
                              trace=trace)
    return bench_run.run(args, torch.device(device), time.perf_counter(),
                         matrix_overrides=TINY, cache_dir=tmp_path / "cache",
                         solver_hook=hook)


class Planted:
    """The solver the window drives, with `fault(x, b)` applied to each
    solution where the solve produces it."""

    def __init__(self, solver, fault):
        self._solver, self._fault = solver, fault
        self.setup_breakdown = solver.setup_breakdown

    def solve(self, b):
        res = self._solver.solve(b)
        res.x = self._fault(res.x, b)
        return res


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tmp_path):
    result, checks = one_run(cell, tmp_path)
    assert result["correct"] is True
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"rhs_per_s", "solve_p95_ms",
                                      "setup_s"}  # no card: no peak memory
    assert result["attempted"] >= 1 and result["failed"] == 0
    [(name, value, limit)] = checks
    assert name == "worst_relres" and value <= limit == 1e-10


FAULTS = {
    # the solve returns its state unchanged: x still the zero start
    "state_unchanged": lambda x, b: torch.zeros_like(x),
    # one entry of the answer altered where the solve produces it
    "answer_altered": lambda x, b: x + torch.nn.functional.one_hot(
        torch.tensor(3), x.numel()).to(x.dtype) * 1e-6 * x.abs().max(),
    # the right-hand side handed back as the answer
    "returns_b": lambda x, b: b.clone(),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, tmp_path):
    result, checks = one_run(
        cell, tmp_path, hook=lambda s: Planted(s, FAULTS[fault]))
    assert result["correct"] is False
    assert not checks[0][1] <= checks[0][2]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, tmp_path):
    out = control.readings(cell, [SEED, SEED + 1], 3, torch.device("cpu"), 1,
                           matrix_overrides=TINY, cache_dir=tmp_path)
    assert out["lower"] <= 1e-10 < out["upper"]


def test_traced_run_reports_per_layer_metrics(tmp_path):
    result, _ = one_run("hpcg104-jacobi.rhs1", tmp_path, trace=1)
    m = result["metrics"]
    assert {"refine_passes_per_solve", "inner_iters_per_solve",
            "layout_s"} <= set(m)
    assert "spmv_f32_roofline" not in m  # no device events on the CPU
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_trace_that_lost_events_is_taken_again(tmp_path, monkeypatch):
    calls = []
    real = bench_run.profile_readings

    def losing(*args):
        summary = real(*args)
        calls.append(summary)
        return dict(summary, events_complete=False)

    monkeypatch.setattr(bench_run, "EVENT_CAP", 1)  # one solve a trace
    monkeypatch.setattr(bench_run, "profile_readings", losing)
    result, _ = one_run("hpcg104-jacobi.rhs1", tmp_path, trace=1,
                        seconds=1.0)
    assert len(calls) == bench_run.TRACE_TRIES
    assert result["correct"] is True
    assert "inner_iters_per_solve" in result["metrics"]


def test_banned_modules_compare_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lsbench_tpu_torch_x", sys)
    assert "lsbench_tpu" not in bench_run.banned_modules()
    monkeypatch.setitem(sys.modules, "lsbench_tpu.solvers", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"lsbench_tpu", "jaxlib"} <= set(bench_run.banned_modules())


REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

IMPORT_CHECK = """
import argparse, sys, time, tempfile
from pathlib import Path
import torch
from solvebench import run, spec, control
bench = spec.load_benchmark(run.ROOT)
for w in bench["workloads"]:
    args = argparse.Namespace(workload=w["name"], seed=7, seconds=0.2,
                              trace=0)
    run.run(args, torch.device("cpu"), time.perf_counter(),
            matrix_overrides=dict(nx=4, ny=4, nz=4),
            cache_dir=Path(tempfile.mkdtemp()))
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_no_jax_in_any_module_the_command_loads():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-c", IMPORT_CHECK], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "lsbench_tpu_torch" in top and "solvebench" in top
    assert not top & set(bench_run.BANNED)


def test_command_without_a_card_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "solvebench", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_on_the_card(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = one_run(cell, tmp_path, device="cuda", trace=1)
    assert result["correct"] is True
    assert result["device"]["busy_s"] > 0
