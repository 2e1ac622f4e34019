"""The per-layer metrics that read the program's spans and host-sync
counters (`host_syncs_per_iter`, `sync_wait_us_per_iter`,
`dispatch_us_per_iter`, `vcycle_host_us`): each reader on made-up
readings, and traced runs at a tiny grid on the CPU."""

import pytest

from solvebench import run as bench_run
from solvebench import spec
from solvebench import trace as tr
from solvebench.tests.test_solvebench_run import CELLS, one_run

NAMES = ["host_syncs_per_iter", "sync_wait_us_per_iter",
         "dispatch_us_per_iter", "vcycle_host_us"]
COUNTERS = {"sell_f32": 700, "host_syncs": 720, "sync_wait_ns": 7_000_000,
            "span_n:lsbench.cg.iter": 700,
            "span_ns:lsbench.cg.iter": 140_000_000,
            "span_n:lsbench.amg.vcycle": 9,
            "span_ns:lsbench.amg.vcycle": 18_000_000}
WANT = {"host_syncs_per_iter": 720 / 700, "sync_wait_us_per_iter": 10.0,
        "dispatch_us_per_iter": 200.0, "vcycle_host_us": 2000.0}
NEEDS = {"host_syncs_per_iter": ("host_syncs", "span_n:lsbench.cg.iter"),
         "sync_wait_us_per_iter": ("sync_wait_ns", "span_n:lsbench.cg.iter"),
         "dispatch_us_per_iter": ("span_ns:lsbench.cg.iter",
                                  "span_n:lsbench.cg.iter"),
         "vcycle_host_us": ("span_ns:lsbench.amg.vcycle",
                            "span_n:lsbench.amg.vcycle")}


def readings(counters):
    profiled = None if counters is None else {"launches": counters}
    return bench_run.Readings(
        solves=[], rhs_per_solve=1, window_s=1.0, setup_s=1.0,
        memory_peak_bytes=0, setup_breakdown={}, n=1, nnz=1, peaks=None,
        profiled=profiled)


def reader(name):
    return spec.load_module(bench_run.BASE, "metrics", name).read


@pytest.mark.parametrize("name", NAMES)
def test_reader_divides_its_counters(name):
    assert reader(name)(readings(dict(COUNTERS))) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NAMES)
def test_reader_reads_nothing_without_its_keys(name):
    read = reader(name)
    assert read(readings(None)) is None
    assert read(readings({"sell_f32": 700})) is None  # the parent's keys
    for key in NEEDS[name]:
        missing = {k: v for k, v in COUNTERS.items() if k != key}
        assert read(readings(missing)) is None
        assert read(readings(dict(COUNTERS, **{key: 0}))) is None


def test_entries_follow_the_readers():
    bench = spec.load_benchmark(bench_run.ROOT)
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NAMES:
        m = entries[name]
        assert m["moves"] == "rhs_per_s" and m["better"] == "lower"
        want = CELLS if name != "vcycle_host_us" else ["hpcg104-amg.rhs1"]
        assert m["workloads"] == want


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reports_the_span_metrics(cell, tmp_path):
    result, _ = one_run(cell, tmp_path, trace=1)
    assert result["correct"] is True
    m = result["metrics"]
    for name in NAMES[:3]:
        assert m[name]["value"] > 0
    # One read an iteration, and a few more a pass and a solve.
    assert 1.0 < m["host_syncs_per_iter"]["value"] < 4.0
    assert ("vcycle_host_us" in m) == (cell == "hpcg104-amg.rhs1")


def test_idle_gaps_are_named_by_the_program_spans(tmp_path, monkeypatch):
    """With the CPU's ATen ops standing in for the card's kernels, the
    host's time between them is named by the innermost open span."""
    monkeypatch.setattr(tr, "DEVICE_CATEGORIES", ("cpu_op",))
    result, _ = one_run("hpcg104-jacobi.rhs1", tmp_path, trace=1)
    labels = [name for name, _ in result["breakdown"]["idle_gaps"]]
    assert any(name.startswith("lsbench.") for name in labels), labels
