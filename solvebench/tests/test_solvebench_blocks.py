"""`syncs_per_inner_iter` and `cg_slot_use_share`: each reader on made-up
readings, their entries in `BENCHMARK.json`, traced runs on the CPU (the
eager loop: a read an iteration, no block to count) and on a card, where
the CG loop runs in blocks of guarded iterations."""

import pytest
import torch

from solvebench import run as bench_run
from solvebench import spec
from solvebench.tests.test_solvebench_run import CELLS, one_run

NAMES = ["syncs_per_inner_iter", "cg_slot_use_share"]
SLOTS = "graph_slots:lsbench.cg.block"


def readings(counters, iters=700):
    profiled = (None if counters is None
                else {"launches": counters, "iters": iters})
    return bench_run.Readings(
        solves=[], rhs_per_solve=1, window_s=1.0, setup_s=1.0,
        memory_peak_bytes=0, setup_breakdown={}, n=1, nnz=1, peaks=None,
        profiled=profiled)


def read(name, counters, iters=700):
    return spec.load_module(bench_run.BASE, "metrics", name).read(
        readings(counters, iters))


@pytest.mark.parametrize("syncs,iters,want", [
    (720, 700, 720 / 700), (59, 700, 59 / 700), (28, 14, 2.0)])
def test_syncs_per_inner_iter_divides_reads_by_iterations(syncs, iters,
                                                           want):
    got = read("syncs_per_inner_iter",
               {"sell_f32": iters, "host_syncs": syncs}, iters)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("slots,iters,want", [
    (768, 705, 100.0 * 705 / 768), (224, 14, 6.25), (16, 16, 100.0)])
def test_slot_use_share_divides_iterations_by_slots(slots, iters, want):
    got = read("cg_slot_use_share", {"sell_f32": iters, SLOTS: slots}, iters)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_their_keys(name):
    assert read(name, None) is None
    assert read(name, {"sell_f32": 700}) is None
    key = "host_syncs" if name == "syncs_per_inner_iter" else SLOTS
    assert read(name, {key: 0}) is None
    if name == "syncs_per_inner_iter":
        assert read(name, {key: 720}, iters=0) is None
    else:   # the parent's keys: no block
        assert read(name, {"host_syncs": 720,
                           "span_n:lsbench.cg.iter": 700}) is None


def test_entries_follow_the_readers():
    bench = spec.load_benchmark(bench_run.ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name, unit, better in [("syncs_per_inner_iter", "reads", "lower"),
                               ("cg_slot_use_share", "%", "higher")]:
        m = entries[name]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            unit, better, "program_counter", "rhs_per_s")
        assert m["layer"] == "Krylov inner loop (solvers/cg.py::cg_loop)"
        assert m["workloads"] == CELLS
        assert [e["name"] for e in bench["per_layer"]].count(name) == 1


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_traced_run_reads_a_sync_an_iteration(cell, tmp_path):
    result, _ = one_run(cell, tmp_path, trace=1)
    assert result["correct"] is True
    m = result["metrics"]
    # One read an iteration, and a few more a pass and a solve.
    assert 1.0 < m["syncs_per_inner_iter"]["value"] < 4.0
    assert "cg_slot_use_share" not in m


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_traced_run_reads_once_a_block(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = one_run(cell, tmp_path, device="cuda", trace=1)
    assert result["correct"] is True
    m = result["metrics"]
    assert 0.0 < m["cg_slot_use_share"]["value"] <= 100.0
    assert m["syncs_per_inner_iter"]["value"] > 0.0
    assert "host_syncs_per_iter" not in m
