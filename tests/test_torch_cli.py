"""The port's CLI against the JAX package's: the same reference CSV record,
the same error behaviour, flags whose machinery is not ported yet refused
with rc=1, and the harness flags (`--cache`, `--cache-dir`, `--roofline`,
`--profile-dir`, `--debug-nans`) run on the CPU. Also: the port never
imports jax."""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from lsbench_tpu.harness.cli import main as j_main

from lsbench_tpu_torch.harness.bench import BenchRecord
from lsbench_tpu_torch.harness.cli import main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(fn, argv, capsys):
    rc = fn(argv)
    cap = capsys.readouterr()
    return rc, cap.out.strip().splitlines(), cap.err


@pytest.mark.parametrize("extra", [[], ["--ordering", "rcm",
                                        "--precision", "fp32_ir",
                                        "--rtol", "1e-10"]])
def test_csv_and_json_match_jax_cli(tiny_matrix_file, capsys, extra):
    argv = ["--matrix", str(tiny_matrix_file), "--solver", "cg",
            "--trials", "3", "--json", *extra]
    rc, out, _ = _run(main, argv + ["--platform", "cpu"], capsys)
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    assert rc == j_rc == 0
    assert out[0] == j_out[0] == BenchRecord.CSV_HEADER
    fields, j_fields = out[1].split(","), j_out[1].split(",")
    assert fields[:6] == j_fields[:6]
    assert re.fullmatch(r"\d\.\d{6}e[+-]\d\d", fields[6])
    rec, j_rec = json.loads(out[2]), json.loads(j_out[2])
    assert set(j_rec) <= set(rec)
    for k in ("matrix", "n", "nnz", "trials", "solver", "ordering",
              "precision", "converged"):
        assert rec[k] == j_rec[k], k
    assert rec["converged"] is True and rec["true_relres"] < 1e-8
    assert rec["device"] == "cpu"


@pytest.fixture
def poisson_file(tmp_path):
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix
    f = tmp_path / "p20.txt"
    write_matrix(poisson_2d(20), str(f))
    return f


@pytest.mark.parametrize("solver,mode", [("hypre", "fp32_cycles_auto"),
                                         ("amg", "fp32_ir_auto")])
def test_amg_backend_through_the_cli(poisson_file, capsys, solver, mode):
    """`--solver hypre` resolves to the AMG solver with the hypre preset;
    the record names the precision substitution, as the JAX CLI's does."""
    argv = ["--matrix", str(poisson_file), "--solver", solver, "--trials",
            "2", "--warmups", "1", "--json", "--rtol", "1e-10"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    assert out[0] == BenchRecord.CSV_HEADER
    fields = out[1].split(",")
    assert fields[1:6] == ["400", "1920", "2", solver, "none"]
    rec = json.loads(out[2])
    assert rec["precision"] == f"fp64({mode})" and mode in err
    assert rec["levels"] >= 2 and rec["device"] == "cpu"
    if solver == "hypre":
        assert rec["iters"] == 2 and rec["mode"] == "fixed_2_cycles"
        assert 0 < rec["true_relres"] < 1e-2
    else:
        assert rec["converged"] and rec["true_relres"] <= 1e-10
    # fp32_ir on an AMG solver is refused, as by the JAX CLI.
    rc, out, err = _run(main, argv + ["--platform", "cpu", "--precision",
                                      "fp32_ir"], capsys)
    assert rc == 1 and not out and "fp32_ir" in err


def test_cg_ir_with_amg_classical_through_the_cli(poisson_file, capsys):
    argv = ["--matrix", str(poisson_file), "--solver", "cg_ir", "--precond",
            "amg_classical", "--ordering", "rcm", "--rtol", "1e-10",
            "--trials", "1", "--json", "--platform", "cpu"]
    rc, out, _ = _run(main, argv, capsys)
    assert rc == 0
    rec = json.loads(out[2])
    assert rec["converged"] and rec["true_relres"] <= 1e-10
    assert rec["iters"] < 20 and rec["precision"] == "fp64"


@pytest.mark.parametrize("solver,nrhs,routed,precision", [
    ("cg", 3, "block_cg", "fp64(fp32_ir)"),
    ("ginkgo", 2, "batched_bicgstab", "fp64(fp32_ir)"),
    ("ginkgo", 1, "ginkgo", "fp64(fp32_ir_auto)"),
])
def test_nrhs_and_ginkgo_match_jax_cli(poisson_file, capsys, solver, nrhs,
                                       routed, precision):
    """`--nrhs k` routes cg to block_cg and bicgstab/ginkgo to
    batched_bicgstab, and one-RHS ginkgo runs as bicgstab_ir, with the JAX
    CLI's record fields; nnz_per_s counts every right-hand side."""
    argv = ["--matrix", str(poisson_file), "--solver", solver, "--nrhs",
            str(nrhs), "--ordering", "rcm", "--trials", "2", "--warmups",
            "1", "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    assert out[1].split(",")[4] == rec["solver"] == routed
    assert rec["precision"] == precision and rec["converged"] is True
    assert rec.get("nrhs", 1) == nrhs and rec["device"] == "cpu"
    assert rec["true_relres"] <= (1e-10 if solver == "cg" else 1e-4)
    assert rec["nnz_per_s"] == pytest.approx(
        rec["nnz"] * rec["iters"] * nrhs / rec["solve_s"])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0 and j_rec["solver"] == routed
    assert j_rec.get("nrhs", 1) == nrhs and j_rec["converged"] is True


@pytest.mark.parametrize("extra,solver,precision", [
    ([], "cholmod", "fp64(fp32_ir_auto)"),
    (["--solver", "cusolver"], "cusolver", "fp64(fp32_ir_auto)"),
    (["--solver", "cholmod", "--precision", "fp32_ir"], "cholmod",
     "fp32_ir"),
    (["--solver", "cholmod", "--nrhs", "2"], "cholmod", "fp64(fp32_ir_auto)"),
    (["--solver", "cholesky_ir", "--nrhs", "2"], "cholesky_ir", "fp64"),
    (["--solver", "sparse_cholesky", "--ordering", "amd"], "sparse_cholesky",
     "fp64"),
])
def test_direct_solvers_match_jax_cli(poisson_file, capsys, extra, solver,
                                      precision):
    """No --solver runs the reference's default, cholmod; cusolver and
    cholesky_ir run Cholesky; fp32_ir maps cholesky onto cholesky_ir (no
    fp32_ir_auto delegation); --nrhs k passes for the Cholesky family. The
    records carry the JAX CLI's solver, precision and nrhs."""
    argv = ["--matrix", str(poisson_file), "--trials", "2", "--warmups", "1",
            "--json", "--rtol", "1e-10", *extra]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0
    assert out[1].split(",")[4] == rec["solver"] == j_rec["solver"] == solver
    assert rec["precision"] == precision
    assert rec.get("nrhs", 1) == j_rec.get("nrhs", 1)
    assert rec["converged"] is True and rec["true_relres"] <= 1e-10
    assert ("fp32_ir_auto" in err) == ("fp32_ir_auto" in precision)
    if solver != "sparse_cholesky":
        assert rec["refine_passes"] >= 1
    else:
        assert rec["schedule"] == "host" and rec["fill_nnz"] > 1920


@pytest.mark.parametrize("extra,solver,precision,j_precision", [
    ([], "gmres", "fp64(fp32_ir_auto)", "fp64"),
    (["--precision", "fp32_ir"], "gmres_ir", "fp32_ir", "fp32_ir"),
    (["--precision", "fp32", "--rtol", "1e-5"], "gmres", "fp32", "fp32"),
])
def test_gmres_through_the_cli(poisson_file, capsys, extra, solver,
                               precision, j_precision):
    """`--solver gmres` runs GMRES, not the default solver: at fp64 as
    gmres_ir (the JAX package's TPU branch, on every device), at fp32_ir
    mapped onto gmres_ir, at fp32 on the f32 kernel. The JAX CLI on the
    CPU takes its non-TPU branch at fp64 (native f64 GMRES)."""
    argv = ["--matrix", str(poisson_file), "--solver", "gmres", "--ordering",
            "rcm", "--rtol", "1e-10", "--trials", "2", "--warmups", "1",
            "--json", *extra]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    assert "Invalid solver" not in err
    assert ("fp32_ir_auto" in err) == ("fp32_ir_auto" in precision)
    rec = json.loads(out[2])
    assert out[1].split(",")[4] == rec["solver"] == solver
    assert rec["precision"] == precision and rec["converged"] is True
    bar = 1e-5 if "fp32" in extra else 1e-10
    assert rec["true_relres"] <= bar and rec["iters"] % 30 == 0
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0 and j_rec["solver"] == solver
    assert j_rec["precision"] == j_precision and j_rec["converged"] is True


@pytest.mark.parametrize("precond", ["block_jacobi", "chebyshev"])
def test_new_preconds_through_the_cli(poisson_file, capsys, precond):
    argv = ["--matrix", str(poisson_file), "--solver", "cg_ir", "--precond",
            precond, "--ordering", "rcm", "--rtol", "1e-10", "--trials", "2",
            "--warmups", "1", "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0 and rec["solver"] == j_rec["solver"] == "cg_ir"
    assert rec["converged"] is True and rec["true_relres"] <= 1e-10
    assert rec["precision"] == j_rec["precision"] == "fp64"


def test_gmres_nrhs_exits_1_as_in_the_jax_cli(poisson_file, capsys):
    argv = ["--matrix", str(poisson_file), "--solver", "gmres", "--nrhs",
            "2", "--trials", "1"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    j_rc, j_out, j_err = _run(j_main, argv, capsys)
    assert rc == j_rc == 1 and not out and not j_out
    for e in (err, j_err):
        assert "got 'gmres' (for gmres run one RHS per solve)" in e


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    ["--solver", "bicgstab", "--precision", "fp32_ir"],
    ["--solver", "bicgstab", "--precision", "fp32"],
    ["--solver", "block_cg", "--nrhs", "3", "--precision", "fp32_ir"],
    ["--solver", "batched_bicgstab", "--nrhs", "3"],
    ["--solver", "ginkgo", "--nrhs", "3", "--precision", "fp32_ir"],
    [], ["--solver", "cusolver"], ["--solver", "cholmod", "--nrhs", "3"],
    ["--solver", "sparse_cholesky", "--opt", "schedule=block"],
    ["--solver", "gmres"],
    ["--solver", "gmres", "--precision", "fp32", "--rtol", "1e-5"],
    ["--solver", "gmres", "--precond", "amg_classical"],
    ["--solver", "cg_ir", "--precond", "chebyshev"],
    ["--solver", "cg_ir", "--precond", "block_jacobi"],
])
def test_krylov_cli_on_card(poisson_file, capsys, extra):
    """The BiCGSTAB, GMRES, multi-RHS and direct solver spellings and the
    block-Jacobi and Chebyshev preconditioners through the CLI on the card:
    each converges and launches kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lsbench_tpu_torch.ops import spmv_bsr, spmv_sell
    spmv_bsr.reset_launches()
    spmv_sell.reset_launches()
    rc, out, err = _run(main, ["--matrix", str(poisson_file), "--ordering",
                               "rcm", "--trials", "1", "--warmups", "1",
                               "--json", *extra], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    assert rec["converged"] is True and rec["device"] != "cpu"
    assert (sum(spmv_bsr.LAUNCHES.values())
            + sum(spmv_sell.LAUNCHES.values())) > 0


def test_rejects_fp16(tiny_matrix_file, capsys):
    rc, out, err = _run(main, ["--matrix", str(tiny_matrix_file),
                               "--precision", "fp16", "--platform", "cpu"],
                        capsys)
    assert rc == 1 and "fp16" in err and not out


def test_invalid_solver_warns_and_defaults(tiny_matrix_file, capsys):
    rc, out, err = _run(main, ["--matrix", str(tiny_matrix_file), "--solver",
                               "nope", "--trials", "1", "--platform", "cpu"],
                        capsys)
    assert rc == 0
    assert "Invalid solver" in err and "Defaulting to cholmod" in err
    assert out[0] == BenchRecord.CSV_HEADER and ",cholmod," in out[1]


@pytest.mark.parametrize("content", [None, "abc def\n"])
def test_missing_or_malformed_file(tmp_path, capsys, content):
    f = tmp_path / "m.txt"
    if content is not None:
        f.write_text(content)
    rc, out, err = _run(main, ["--matrix", str(f), "--platform", "cpu"],
                        capsys)
    assert rc == 1 and not out and err


@pytest.mark.parametrize("flags", [
    ["--solver", "hypre", "--devices", "2", "--mesh", "1x2"],
    ["--mesh", "2x4", "--devices", "4", "--solver", "cg"],
    ["--solver", "hypre", "--nrhs", "2"],
    ["--coordinator", "localhost:1234"],
    ["--platform", "tpu"],
])
def test_unported_flags_exit_1(tiny_matrix_file, capsys, flags):
    argv = ["--matrix", str(tiny_matrix_file), "--trials", "1",
            "--platform", "cpu", *flags]
    rc, out, err = _run(main, argv, capsys)
    assert rc == 1 and not out
    # --nrhs > 1 with a solver of neither the cg nor the bicgstab family is
    # refused as by the JAX CLI (test_block_cg.py::test_cli_nrhs_rejects_non_cg);
    # so are a --mesh solver outside the 2-D family and a grid whose size
    # is not --devices (the JAX CLI's messages).
    assert ("not yet ported" in err or "Unsupported platform" in err
            or "--nrhs > 1 is implemented for" in err
            or "--mesh RxC supports" in err
            or "--mesh 2x4 needs 8 devices but --devices=4" in err)


@pytest.mark.parametrize("solver,extra,precision", [
    ("cg", [], "fp64"),
    ("cg_ir", [], "fp64"),
    ("gmres", [], "fp64(fp32_ir_auto)"),
    ("cg", ["--precision", "fp32", "--rtol", "1e-5"], "fp32"),
])
def test_ic0_precond_through_the_cli(poisson_file, capsys, solver, extra,
                                     precision):
    """`--precond ic0`, refused before slice 10, runs with the JAX CLI's
    record: fewer iterations than Jacobi, to the requested tolerance."""
    argv = ["--matrix", str(poisson_file), "--solver", solver, "--ordering",
            "rcm", "--rtol", "1e-10", "--trials", "1", "--warmups", "1",
            "--json", *extra]
    rc, out, err = _run(main, argv + ["--precond", "ic0", "--platform",
                                      "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    assert out[1].split(",")[4:6] == [solver, "rcm"]
    assert rec["precision"] == precision and rec["converged"] is True
    if precision == "fp32":
        # The f32 recurrence's residual meets rtol; the host f64 residual of
        # the f32 x lies within 10x of it.
        assert rec["relres"] <= 1e-5 and rec["true_relres"] <= 1e-4
    else:
        assert rec["true_relres"] <= 1e-10
    _, j_out, _ = _run(main, argv + ["--precond", "jacobi", "--platform",
                                     "cpu"], capsys)
    assert rec["iters"] < json.loads(j_out[2])["iters"]
    # The JAX CLI on the CPU runs fp64 gmres natively (its non-TPU branch),
    # so only the solver and the outcome are compared.
    j_rc, j_out, _ = _run(j_main, argv + ["--precond", "ic0"], capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0 and j_rec["solver"] == rec["solver"]
    assert j_rec["converged"] is True


@pytest.mark.parametrize("ordering", ["amd", "rcm"])
def test_level_schedule_through_the_cli(poisson_file, capsys, ordering):
    """`--solver sparse_cholesky --opt schedule=level`, refused before
    slice 10: f32 level sweeps refined to 1e-10, recorded as
    fp64(fp32_ir_auto) with the levels of both sweeps and the padding of
    the plain version's segments. (`--nrhs` stays refused for
    sparse_cholesky, as in the JAX CLI; the solver's own multi-RHS is
    tests/test_torch_direct.py's.)"""
    argv = ["--matrix", str(poisson_file), "--solver", "sparse_cholesky",
            "--opt", "schedule=level", "--ordering", ordering, "--rtol",
            "1e-10", "--trials", "1", "--warmups", "1", "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0
    assert rec["schedule"] == j_rec["schedule"] == "level"
    assert rec["precision"] == "fp64(fp32_ir_auto)"
    assert rec["levels"] == j_rec["levels"] and rec["levels"][0] > 1
    assert rec["fill_nnz"] == j_rec["fill_nnz"] and rec["pad_waste"] > 0
    assert rec["converged"] is True and rec["true_relres"] <= 1e-10
    assert rec["setup_breakdown"]["level_build_s"] > 0


@pytest.mark.parametrize("ordering", ["rcm", "none"])
def test_cholesky_band_through_the_cli(poisson_file, capsys, ordering):
    """`--solver cholesky_band`, refused before slice 10: the f32 band
    factor refined to 1e-10, with the JAX CLI's solver name, bandwidth,
    passes and precision label."""
    argv = ["--matrix", str(poisson_file), "--solver", "cholesky_band",
            "--ordering", ordering, "--trials", "1", "--warmups", "1",
            "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    j_rec = json.loads(j_out[2])
    assert j_rc == 0 and out[1].split(",")[4:6] == ["cholesky_band", ordering]
    for k in ("solver", "precision", "bandwidth", "refine_passes",
              "converged"):
        assert rec[k] == j_rec[k], k
    assert rec["precision"] == "fp64(fp32_ir_auto)"
    assert rec["true_relres"] <= 1e-10
    # One right-hand side only, as in the JAX CLI.
    rc, out, err = _run(main, argv + ["--nrhs", "2", "--platform", "cpu"],
                        capsys)
    assert rc == 1 and not out and "--nrhs > 1 is implemented for" in err


def test_invalid_ordering_defaults_to_amd(tiny_matrix_file, capsys):
    """An invalid ordering warns and defaults to AMD (lsbench.c:47-49),
    which then runs, as in the JAX CLI."""
    argv = ["--matrix", str(tiny_matrix_file), "--ordering", "zzz",
            "--trials", "1"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    assert rc == j_rc == 0
    assert "Defaulting to AMD" in err and "not yet ported" not in err
    assert out[1].split(",")[4:6] == j_out[1].split(",")[4:6] \
        == ["cholmod", "amd"]


def test_cuda_platform_without_cuda_exits_1(tiny_matrix_file, capsys,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = _run(main, ["--matrix", str(tiny_matrix_file)], capsys)
    assert rc == 1 and not out and "no CUDA device" in err


def test_port_never_imports_jax():
    """Every module of the port imports without jax or lsbench_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lsbench_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'lsbench_tpu_torch.') if not m.name.endswith('__main__')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'lsbench_tpu' or m.startswith('lsbench_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout) >= 20


def test_profile_device_busy_is_union_of_intervals(tmp_path, monkeypatch):
    """The solve profiler's busy time merges overlapping device events and
    ignores host events; without a card it exits 1."""
    from lsbench_tpu_torch.harness import profile_solve as ps

    trace = {"traceEvents": [
        {"cat": "kernel", "name": "k", "ts": 0.0, "dur": 10.0},
        {"cat": "kernel", "name": "k", "ts": 5.0, "dur": 10.0},     # overlaps
        {"cat": "gpu_memcpy", "name": "c", "ts": 20.0, "dur": 2.0},
        {"cat": "gpu_memset", "name": "s", "ts": 21.0, "dur": 0.5},  # inside
        {"cat": "cpu_op", "name": "aten::dot", "ts": 0.0, "dur": 100.0},
        {"cat": "kernel", "name": "instant", "ts": 30.0},           # no dur
    ]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(trace))
    events = ps._device_events(str(path))
    assert [e["cat"] for e in events] == ["kernel", "kernel", "gpu_memcpy",
                                          "gpu_memset"]
    assert ps._union_us(events) == 17.0
    assert ps._union_us([]) == 0.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert ps.main([]) == 1


# ------------------------------------------------ the harness flags (slice 11)

@pytest.fixture
def harness_state(tmp_path, monkeypatch):
    """The cache and the NaN switch as the CLI leaves them are restored
    after the test; the default cache directory is a temporary one."""
    from lsbench_tpu_torch.harness import cache
    from lsbench_tpu_torch.solvers import amg
    from lsbench_tpu_torch.utils import debug
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.setattr(cache, "_root", tmp_path / "default_cache")
    monkeypatch.setattr(amg, "_REFRESHERS", {})
    monkeypatch.setattr(debug, "_debug_nans", False)
    return tmp_path


def _rec(argv, capsys):
    rc, out, err = _run(main, argv + ["--platform", "cpu", "--json"], capsys)
    assert rc == 0, err
    return json.loads(out[2]), err


AMG_CG_IR = ["--solver", "cg_ir", "--precond", "amg_classical", "--ordering",
             "rcm", "--rtol", "1e-10", "--trials", "1", "--warmups", "0"]


@pytest.mark.parametrize("flags", [["--cache"], ["--cache-dir", "DIR"]])
def test_cache_miss_then_exact_hit(poisson_file, harness_state, capsys,
                                   flags):
    d = harness_state / ("default_cache" if flags == ["--cache"] else "c")
    flags = [str(d) if f == "DIR" else f for f in flags]
    argv = ["--matrix", str(poisson_file), *AMG_CG_IR, *flags]
    miss, _ = _rec(argv, capsys)
    hit, _ = _rec(argv, capsys)
    assert miss["setup_breakdown"]["hier_cache"] == "miss"
    assert hit["setup_breakdown"]["hier_cache"] == "exact_hit"
    assert hit["iters"] == miss["iters"]
    assert hit["true_relres"] == miss["true_relres"] <= 1e-10
    kinds = sorted({f.name.split("-")[0] for f in d.glob("*.npz")})
    assert kinds == ["amg_hier", "amg_hier_pat", "ordering"]


def test_cache_pattern_hit_through_the_cli(poisson_file, harness_state,
                                           capsys):
    """A same-pattern re-assembly, D·A·D with D smooth over the grid, hits
    the pattern entry and converges on the re-formed hierarchy."""
    import numpy as np

    from lsbench_tpu_torch.matrix.csr import CsrMatrix
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix
    A = poisson_2d(20)
    d = 1 + 0.5 * (np.arange(A.nrows) // 20) / 19
    A2 = CsrMatrix(A.nrows, A.ncols, A.offs, A.cols,
                   d[A.row_indices()] * A.vals * d[A.cols])
    f2 = harness_state / "p20_dad.txt"
    write_matrix(A2, str(f2))
    c = ["--cache-dir", str(harness_state / "c")]
    _rec(["--matrix", str(poisson_file), *AMG_CG_IR, *c], capsys)
    rec, _ = _rec(["--matrix", str(f2), *AMG_CG_IR, *c], capsys)
    bd = rec["setup_breakdown"]
    assert bd["hier_cache"] == "pattern_hit_device_rap"
    assert bd["rap_device_s"] >= 0
    assert rec["converged"] is True and rec["true_relres"] <= 1e-10


def test_cache_sparse_cholesky_factor(poisson_file, harness_state, capsys):
    argv = ["--matrix", str(poisson_file), "--solver", "sparse_cholesky",
            "--ordering", "amd", "--trials", "1", "--warmups", "0",
            "--cache-dir", str(harness_state / "c")]
    miss, _ = _rec(argv, capsys)
    hit, _ = _rec(argv, capsys)
    assert "factor_s" in miss["setup_breakdown"]
    assert "factor_s" not in hit["setup_breakdown"]
    assert hit["fill_nnz"] == miss["fill_nnz"]
    assert hit["true_relres"] == miss["true_relres"] <= 1e-10


def test_roofline_record(poisson_file, harness_state, capsys):
    """`--roofline` adds the JAX CLI's roofline fields (and the function's
    bytes); on the CPU the peak and the shares are null. (fp64 cg: the JAX
    CLI's roofline of an f32 SpMV fails on the CPU, where x0 is f64.)"""
    argv = ["--matrix", str(poisson_file), "--solver", "cg", "--trials",
            "1", "--warmups", "0", "--roofline"]
    rec, _ = _rec(argv, capsys)
    j_rc, j_out, _ = _run(j_main, argv + ["--platform", "cpu", "--json"],
                          capsys)
    assert j_rc == 0
    r, j_r = rec["roofline"], json.loads(j_out[2])["roofline"]
    assert set(j_r) <= set(r)
    assert r["stream_bytes"] > 0 and r["spmv_s"] > 0
    assert r["peak_gbps"] is None and r["hbm_utilization"] is None


def test_roofline_without_a_streaming_spmv(poisson_file, harness_state,
                                           capsys):
    rec, err = _rec(["--matrix", str(poisson_file), "--solver", "cholmod",
                     "--trials", "1", "--warmups", "0", "--roofline"], capsys)
    assert "roofline: solver has no streaming SpMV" in err
    assert "roofline" not in rec


def test_profile_dir_writes_a_trace(poisson_file, harness_state, capsys):
    from lsbench_tpu_torch.harness.profile_solve import _device_events
    d = harness_state / "prof"
    _rec(["--matrix", str(poisson_file), "--solver", "cg_ir", "--trials",
          "1", "--warmups", "0", "--profile-dir", str(d)], capsys)
    traces = list(d.glob("*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        assert json.load(f)["traceEvents"]
    assert _device_events(str(traces[0])) == []  # the CPU has no device


def test_debug_nans_same_solve(poisson_file, harness_state, capsys):
    from lsbench_tpu_torch.utils import debug
    argv = ["--matrix", str(poisson_file), "--solver", "cg_ir", "--ordering",
            "rcm", "--rtol", "1e-10", "--trials", "1", "--warmups", "0"]
    plain, _ = _rec(argv, capsys)
    assert not debug.debug_nans_enabled()
    checked, _ = _rec(argv + ["--debug-nans"], capsys)
    assert debug.debug_nans_enabled()
    assert checked["iters"] == plain["iters"]
    assert checked["true_relres"] == plain["true_relres"]
