"""The benchmark's parts on the CPU: the HPCG generator, the cost
functions, the trace arithmetic, finding parts by name, the reference and
the traffic's exactness."""

import json

import numpy as np
import pytest
import torch

from solvebench import spec
from solvebench import trace as tr
from solvebench.matrices import hpcg27
from solvebench.reference import CsrReference, relres
from solvebench.rhs import RhsStream

TRAFFIC = {"rhs_per_solve": 1, "pool": 4, "pair_shift": 3, "eps_scale": 0.5,
           "check_every": 2, "max_checks": 8}


def hpcg_loops(nx, ny, nz):
    """The reference GenerateProblem's loops, one entry at a time."""
    rows, cols, vals = [], [], []
    for iz in range(nz):
        for iy in range(ny):
            for ix in range(nx):
                i = ix + nx * (iy + ny * iz)
                for sz in (-1, 0, 1):
                    for sy in (-1, 0, 1):
                        for sx in (-1, 0, 1):
                            x, y, z = ix + sx, iy + sy, iz + sz
                            if 0 <= x < nx and 0 <= y < ny and 0 <= z < nz:
                                rows.append(i)
                                cols.append(x + nx * (y + ny * z))
                                vals.append(26.0 if (sx, sy, sz) == (0, 0, 0)
                                            else -1.0)
    return np.array(rows), np.array(cols), np.array(vals)


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 3, 4), (5, 4, 3), (6, 6, 6)])
def test_hpcg_matches_reference_loops(grid):
    offs, cols, vals = hpcg27.generate(*grid)
    rows, want_cols, want_vals = hpcg_loops(*grid)
    n, nnz = hpcg27.shape(*grid)
    assert offs.size == n + 1 and offs[-1] == nnz == rows.size
    np.testing.assert_array_equal(np.repeat(np.arange(n), np.diff(offs)), rows)
    np.testing.assert_array_equal(cols, want_cols)
    np.testing.assert_array_equal(vals, want_vals)
    assert cols.dtype == np.int32 and vals.dtype == np.float64


def test_hpcg_published_size():
    assert hpcg27.shape(104, 104, 104) == (1_124_864, 29_791_000)


def test_hpcg_spd_and_symmetric():
    offs, cols, vals = hpcg27.generate(3, 4, 5)
    n = offs.size - 1
    A = np.zeros((n, n))
    A[np.repeat(np.arange(n), np.diff(offs)), cols] = vals
    np.testing.assert_array_equal(A, A.T)
    assert np.linalg.eigvalsh(A).min() > 0


def test_spmv_cost():
    cost = spec.load_module(spec.HERE, "costs", "spmv_csr")
    # 3 x 3, 7 nonzeros, f32: 7·(4+4) + 4·4 + (3+3)·4
    assert cost.bytes_moved(3, 3, 7, 4) == 56 + 16 + 24
    assert cost.bytes_moved(3, 3, 7, 8) == 7 * 12 + 16 + 48
    assert cost.flops(3, 3, 7, 4) == 14
    n, nnz = hpcg27.shape(104, 104, 104)
    assert cost.bytes_moved(n, n, nnz, 4) == (238_328_000 + 4_499_460
                                             + 8_998_912)


def test_union_and_gaps():
    busy = tr.union([(5, 7), (0, 2), (1, 3), (6, 9), (9, 10)])
    assert busy == [(0, 3), (5, 10)]
    assert tr.clip(busy, 1, 6) == [(1, 3), (5, 6)]
    assert tr.gaps(busy, -1, 12) == [(-1, 0), (3, 5), (10, 12)]
    assert tr.gaps([], 0, 4) == [(0, 4)]


def _ev(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid}


def test_summarize_busy_idle_and_labels(tmp_path):
    events = [
        _ev(tr.SPAN, "user_annotation", 0, 100),
        _ev(tr.SPAN, "gpu_user_annotation", 0, 100, tid=7),
        _ev("aten::mul", "cpu_op", 2, 6),
        _ev("cudaLaunchKernel", "cuda_runtime", 4, 2),
        _ev("aten::item", "cpu_op", 40, 30),
        _ev("cudaStreamSynchronize", "cuda_runtime", 42, 20),
        _ev("other thread", "cpu_op", 10, 80, tid=2),
        _ev("spmv_sell_f32_kernel(float const*)", "kernel", 5, 20, tid=7),
        _ev("elementwise", "kernel", 20, 15, tid=7),
        _ev("Memcpy DtoH", "gpu_memcpy", 60, 5, tid=7),
        _ev("outside the span", "kernel", 150, 5, tid=7),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = tr.summarize(tr.load_events(str(path)))
    # busy: [5, 35) and [60, 65) → 35 µs of a 100 µs span
    assert s["span_us"] == 100 and s["busy_us"] == 35
    idle = s["idle_by_host_us"]
    assert sum(idle.values()) == 65
    # gap [0, 5) mid 2.5: aten::mul; [35, 60) mid 47.5: the sync inside
    # aten::item; [65, 100) mid 82.5: nothing open
    assert idle == {"aten::mul": 5, "cudaStreamSynchronize": 25,
                    "host: python, no op recorded": 35}
    assert s["device_by_name_us"]["elementwise"] == 15
    assert len(s["device_events"]) == 4  # the whole trace's
    assert s["outside_span"] == ["outside the span"]
    assert tr.top(idle, 2, scale=1.0) == [
        ["host: python, no op recorded", 35], ["cudaStreamSynchronize", 25]]


def test_summarize_without_span():
    assert tr.summarize([_ev("k", "kernel", 0, 1)]) is None


def test_innermost_timeline_nesting():
    host = [_ev("outer", "cpu_op", 0, 10), _ev("inner", "cpu_op", 2, 3),
            _ev("next", "cpu_op", 12, 2)]
    tl = tr.innermost_timeline(host)
    assert [tr.label_at(tl, t) for t in (1, 3, 6, 11, 13, 20)] == [
        "outer", "inner", "outer", "host: python, no op recorded", "next",
        "host: python, no op recorded"]


def test_parts_found_by_name_without_edit(tmp_path):
    """A new config, traffic mix, matrix, cost and metric are new files."""
    base = tmp_path / "bench"
    for kind in ("configs", "traffic", "matrices", "costs", "metrics"):
        (base / kind).mkdir(parents=True)
    (base / "matrices" / "diag-2.py").write_text(
        "import numpy as np\n"
        "def generate(n):\n"
        "    return (np.arange(n + 1), np.arange(n, dtype=np.int32),"
        " np.full(n, 2.0))\n")
    (base / "costs" / "dot.v1.py").write_text(
        "def bytes_moved(n):\n    return 8 * n\n")
    (base / "metrics" / "twice_setup.s.py").write_text(
        "def read(ctx):\n    return 2 * ctx['setup_s']\n")
    cfg = {"matrix": {"generator": "diag-2", "n": 3}}
    (base / "configs" / "new-cfg.json").write_text(json.dumps(cfg))
    (base / "traffic" / "new-mix.json").write_text(json.dumps(TRAFFIC))
    bench = {"configs": [{"name": "new-cfg",
                          "file": "bench/configs/new-cfg.json"}],
             "workloads": [{"name": "new-cfg.mix", "config": "new-cfg",
                            "traffic": "new-mix", "chips": 1}],
             "end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "twice_setup.s",
                            "workloads": ["new-cfg.mix"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    loaded = spec.load_benchmark(tmp_path)
    w = spec.cell(loaded, "new-cfg.mix")
    got = spec.load_config(tmp_path, loaded, w["config"])
    assert got == cfg
    assert spec.load_traffic(base, w["traffic"]) == TRAFFIC
    gen = spec.load_module(base, "matrices", got["matrix"]["generator"])
    offs, cols, vals = gen.generate(n=3)
    assert list(vals) == [2.0, 2.0, 2.0]
    assert spec.load_module(base, "costs", "dot.v1").bytes_moved(4) == 32
    [m] = spec.metrics_of(loaded, "new-cfg.mix", "per_layer")
    assert spec.load_module(base, "metrics", m["name"]).read(
        {"setup_s": 1.5}) == 3.0
    assert [m["name"] for m in spec.metrics_of(loaded, "new-cfg.mix",
                                               "end_to_end")] == ["a"]
    with pytest.raises(KeyError):
        spec.cell(loaded, "absent")
    with pytest.raises(FileNotFoundError):
        spec.load_module(base, "metrics", "absent")


def test_the_benchmark_finds_every_part_it_names():
    bench = spec.load_benchmark(spec.HERE.parent)
    for w in bench["workloads"]:
        cfg = spec.load_config(spec.HERE.parent, bench, w["config"])
        spec.load_module(spec.HERE, "matrices", cfg["matrix"]["generator"])
        spec.load_traffic(spec.HERE, w["traffic"])
        for kind in ("end_to_end", "per_layer"):
            for m in spec.metrics_of(bench, w["name"], kind):
                assert hasattr(spec.load_module(spec.HERE, "metrics",
                                                m["name"]), "read")


def test_reference_residual_against_dense_solve():
    offs, cols, vals = hpcg27.generate(3, 3, 4)
    n = offs.size - 1
    dense = np.zeros((n, n))
    dense[np.repeat(np.arange(n), np.diff(offs)), cols] = vals
    ref = CsrReference(offs, cols, vals)
    rng = np.random.default_rng(0)
    X = rng.standard_normal((n, 3))
    np.testing.assert_allclose(ref.matvec(torch.from_numpy(X)).numpy(),
                               dense @ X, rtol=0, atol=1e-12)
    B = dense @ X
    x = np.linalg.solve(dense, B)
    assert relres(ref, torch.from_numpy(x), torch.from_numpy(B)).max() < 1e-14
    bad = x + 1e-6 * rng.standard_normal(x.shape)
    want = (np.linalg.norm(B - dense @ bad, axis=0)
            / np.linalg.norm(B, axis=0))
    np.testing.assert_allclose(
        relres(ref, torch.from_numpy(bad), torch.from_numpy(B)), want,
        rtol=1e-9)


def exact_x(stream, U, s):
    """x of solve s from the pool U: column c is u_i + ε·u_j of
    t = s·k + c."""
    cols = []
    for c in range(stream.k):
        i, j, e = stream.pair(s * stream.k + c)
        cols.append(U[:, i] + e * U[:, j])
    return cols[0] if stream.k == 1 else torch.stack(cols, dim=1)


@pytest.mark.parametrize("k", [1, 3])
def test_rhs_is_a_times_known_x(k):
    offs, cols, vals = hpcg27.generate(4, 3, 5)
    ref = CsrReference(offs, cols, vals)
    seed = 2**31 + 77
    stream = RhsStream(dict(TRAFFIC, rhs_per_solve=k), ref, seed, "cpu")
    gen = torch.Generator(device="cpu")
    gen.manual_seed(seed)
    U = torch.randn((ref.n, stream.pool), generator=gen, dtype=torch.float64)
    seen = set()
    for s in range(12):
        b = stream.rhs(s)
        x = exact_x(stream, U, s)
        assert b.shape == x.shape and b.dtype == torch.float64
        r = relres(ref, x, b)
        assert r.max() < 1e-15
        seen.add(tuple(b.reshape(-1)[:4].tolist()))
    assert len(seen) == 12  # no two solves share a b
    again = RhsStream(dict(TRAFFIC, rhs_per_solve=k), ref, seed, "cpu")
    assert torch.equal(again.rhs(5), stream.rhs(5))
    other = RhsStream(dict(TRAFFIC, rhs_per_solve=k), ref, seed + 1, "cpu")
    assert not torch.equal(other.rhs(5), stream.rhs(5))


def test_checked_sample_is_seeded():
    offs, cols, vals = hpcg27.generate(2, 2, 2)
    ref = CsrReference(offs, cols, vals)
    a = RhsStream(TRAFFIC, ref, 123, "cpu")
    b = RhsStream(TRAFFIC, ref, 123, "cpu")
    picks = [s for s in range(20) if a.checked(s)]
    assert picks == [s for s in range(20) if b.checked(s)]
    assert len(picks) == 10 and picks[1] - picks[0] == 2


def _readings(profiled, **kw):
    from solvebench.run import Readings, SolveRecord
    base = dict(solves=[SolveRecord(0.05, 300, 3, True),
                        SolveRecord(0.07, 310, 3, True),
                        SolveRecord(0.06, 320, 3, False)],
                rhs_per_solve=1, window_s=0.2, setup_s=12.0,
                memory_peak_bytes=2**30, setup_breakdown={"layout_s": 2.5},
                n=1000, nnz=27000,
                peaks={"hbm_bytes_per_s": 1e9, "f32_flops_per_s": 1e12},
                profiled=profiled)
    base.update(kw)
    return Readings(**base)


def _metric(name, ctx):
    return spec.load_module(spec.HERE, "metrics", name).read(ctx)


def test_metric_readers_on_synthetic_readings():
    events = [("spmv_sell_f32_kernel(x)", 100.0)] * 4 + [("dot", 5.0)]
    prof = {"span_us": 1000.0, "busy_us": 600.0, "iters": 4,
            "launches": {"sell_f32": 4}, "events_complete": True,
            "device_events": events}
    ctx = _readings(prof)
    assert _metric("rhs_per_s", ctx) == 2 / 0.2  # the unconverged one left out
    assert _metric("peak_mem_gib", ctx) == 1.0
    assert _metric("inner_iters_per_solve", ctx) == 310
    assert _metric("refine_passes_per_solve", ctx) == 3
    assert _metric("host_gap_us_per_iter", ctx) == 100.0
    assert _metric("amg_device_us_per_iter", ctx) == 150.0
    assert abs(_metric("device_idle_share", ctx) - 40.0) < 1e-12
    assert _metric("layout_s", ctx) == 2.5
    assert _metric("precond_setup_s", ctx) is None
    cost = spec.load_module(spec.HERE, "costs", "spmv_csr")
    bound_s = cost.bytes_moved(1000, 1000, 27000, 4) / 1e9  # bytes bound it
    assert abs(_metric("spmv_f32_roofline", ctx)
               - 100 * bound_s / 100e-6) < 1e-9
    # events lost, or f32 products that are not all A's: no reading
    assert _metric("spmv_f32_roofline",
                   _readings(dict(prof, events_complete=False))) is None
    assert _metric("spmv_f32_roofline",
                   _readings(dict(prof, iters=3))) is None
    assert _metric("device_idle_share", _readings(None)) is None
