"""`graph_iter_share`: the reader on made-up readings, its entry in
`BENCHMARK.json`, a traced run on the CPU (no graphs there, so nothing to
read) and one on a card, where every iteration body is a replay."""

import pytest
import torch

from solvebench import run as bench_run
from solvebench import spec
from solvebench.tests.test_solvebench_run import CELLS, one_run

NAME = "graph_iter_share"
REPLAYS, SPANS = "graph_replays:lsbench.cg.iter", "span_n:lsbench.cg.iter"


def readings(counters):
    profiled = None if counters is None else {"launches": counters}
    return bench_run.Readings(
        solves=[], rhs_per_solve=1, window_s=1.0, setup_s=1.0,
        memory_peak_bytes=0, setup_breakdown={}, n=1, nnz=1, peaks=None,
        profiled=profiled)


def read(counters):
    return spec.load_module(bench_run.BASE, "metrics", NAME).read(
        readings(counters))


@pytest.mark.parametrize("replays,spans,want", [
    (700, 700, 100.0), (693, 700, 99.0), (0, 700, 0.0)])
def test_reader_divides_replays_by_iterations(replays, spans, want):
    got = read({"sell_f32": 700, REPLAYS: replays, SPANS: spans,
                "graph_replays:lsbench.cg.start": 6})
    assert got == pytest.approx(want)


def test_reader_reads_nothing_without_its_keys():
    assert read(None) is None
    assert read({"sell_f32": 700}) is None
    assert read({"sell_f32": 700, SPANS: 700}) is None   # the parent's keys
    assert read({REPLAYS: 700}) is None
    assert read({REPLAYS: 700, SPANS: 0}) is None


def test_entry_follows_the_reader():
    bench = spec.load_benchmark(bench_run.ROOT)
    [m] = [m for m in bench["per_layer"] if m["name"] == NAME]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "higher", "program_counter", "rhs_per_s")
    assert m["layer"] == "Krylov inner loop (solvers/cg.py::cg_loop)"
    assert m["workloads"] == CELLS
    assert bench["per_layer"][-1] is m


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_traced_run_leaves_the_share_out(cell, tmp_path):
    result, _ = one_run(cell, tmp_path, trace=1)
    assert result["correct"] is True
    assert NAME not in result["metrics"]
    assert "dispatch_us_per_iter" in result["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_traced_run_replays_every_iteration(cell, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    result, _ = one_run(cell, tmp_path, device="cuda", trace=1)
    assert result["correct"] is True
    assert result["metrics"][NAME]["value"] == 100.0
