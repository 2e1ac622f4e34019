"""`--devices N` and `--mesh RxC` through the port's CLI against the JAX
CLI at the same mesh size: `--devices 1` (a group of one, in this process)
and `--devices 4 --platform cpu` (this process is rank 0, ranks 1–3 are
spawned gloo processes) for `cg_ir`, `cg`, `ginkgo`, `gmres_ir` and `cg
--nrhs 4` print the reference CSV line and a JSON record whose keys
include the JAX record's, with the same solver, precision, strategy, halo
and refinement passes; rank 0 alone prints. Each route of the AMG family
(`hypre`, `amgx`, `amg`, `paralmond` and `cg_ir --precond amg_classical`
with `--devices 2`) and of the grid (`--mesh 2x2 --devices 4` with
`cg_ir`, `bicgstab`, `ginkgo`, `cg --nrhs 4` and `cg --precond amg`) picks
the JAX CLI's class with its settings (tolerance, cycles, coarsening
preset, ordering); `hypre`, `paralmond` and `cg_ir --precond
amg_classical` at `--devices 2`, and `cg_ir`, `cg --nrhs 4` and `cg
--precond amg` at `--devices 4 --mesh 2x2`, run end to end on gloo ranks
and print the JAX CLI's CSV fields, iterations, levels and passes (the IR
routes to true_relres ≤ 1e-10). The refusals exit 1: `--coordinator`, the
three `--mesh` refusals with the JAX CLI's messages (a solver outside the
2-D family, a grid whose size is not `--devices`, fp64 `gmres`), a solver
with no distributed form, a shard that cannot be built, and `--devices 2`
on `--platform cuda` without two cards (the JAX message). On a card
(`pytest -m cuda`): the `--devices 1` NCCL path through the SELL kernels,
and the D = 4 per-rank operators checked kernel against plain version and
against the global product."""

import json

import numpy as np
import pytest
import torch

from lsbench_tpu.harness.cli import main as j_main

from lsbench_tpu_torch.harness.bench import BenchRecord
from lsbench_tpu_torch.harness.cli import main


def _run(fn, argv, capsys):
    rc = fn(argv)
    cap = capsys.readouterr()
    return rc, cap.out.strip().splitlines(), cap.err


@pytest.fixture(scope="module")
def matrix_files(tmp_path_factory):
    from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
    from lsbench_tpu_torch.matrix.io import write_matrix
    d = tmp_path_factory.mktemp("dist_cli")
    files = {}
    for name, A in (("p20", poisson_2d(20)),
                    ("rspd", random_spd(128, nnz_per_row=23, seed=0))):
        files[name] = str(d / f"{name}.txt")
        write_matrix(A, files[name])
    return files


CASES = {
    "cg_ir": ("p20", ["--solver", "cg_ir", "--rtol", "1e-10"]),
    "cg": ("p20", ["--solver", "cg", "--rtol", "1e-10"]),
    "ginkgo": ("p20", ["--solver", "ginkgo"]),
    "gmres_ir": ("p20", ["--solver", "gmres_ir"]),
    "cg --nrhs 4": ("p20", ["--solver", "cg", "--nrhs", "4"]),
}


@pytest.mark.parametrize("D", [1, 4])
@pytest.mark.parametrize("case", sorted(CASES))
def test_devices_cli_matches_jax_cli(matrix_files, capsys, case, D):
    name, flags = CASES[case]
    argv = ["--matrix", matrix_files[name], *flags, "--ordering", "rcm",
            "--devices", str(D), "--trials", "1", "--warmups", "0",
            "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    # Rank 0 alone prints: one header, one CSV line, one record.
    assert len(out) == 3 and out[0] == BenchRecord.CSV_HEADER
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv, capsys)
    assert j_rc == 0
    j_rec = json.loads(j_out[2])
    assert out[1].split(",")[:6] == j_out[1].split(",")[:6]
    assert set(j_rec) <= set(rec)
    for k in ("solver", "precision", "strategy", "halo", "converged",
              "refine_passes", "nrhs"):
        assert rec.get(k) == j_rec.get(k), k
    assert rec["local_spmv"] == "bsr" and rec["device"] == "cpu"
    assert rec["true_relres"] <= (1e-4 if case == "ginkgo" else 1e-10)
    if case == "cg_ir":
        assert (rec["strategy"], rec["precision"]) == (
            "halo", "fp64(fp32_ir_auto)")
        assert rec["precision_mode"] == "fp32_ir_auto"


@pytest.mark.parametrize("flags,message", [
    (["--mesh", "2x2", "--devices", "4", "--solver", "hypre"],
     "--mesh RxC supports cg/gmres/bicgstab/ginkgo"),
    (["--coordinator", "localhost:1234"], "not yet ported"),
    (["--mesh", "2x2", "--devices", "2", "--solver", "cg"],
     "--mesh 2x2 needs 4 devices but --devices=2"),
    (["--mesh", "2x2", "--devices", "4", "--solver", "gmres"],
     "--mesh RxC gmres runs as fp32_ir"),
    (["--solver", "cholmod", "--devices", "2"],
     "has no distributed implementation"),
])
def test_refusals_exit_1(matrix_files, capsys, flags, message):
    argv = ["--matrix", matrix_files["p20"], *flags]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 1 and not out and message in err
    if "--mesh" in flags:  # the JAX CLI's own message
        j_rc, _, j_err = _run(j_main, argv, capsys)
        assert j_rc == 1 and message in j_err


# (port route, JAX route): the JAX CLI's `_make_distributed` branches.
ROUTES = {
    "hypre": ["--solver", "hypre", "--devices", "2"],
    "amgx": ["--solver", "amgx", "--devices", "2"],
    "amg": ["--solver", "amg", "--devices", "2"],
    "paralmond": ["--solver", "paralmond", "--devices", "2"],
    "cg_ir amg_classical": ["--solver", "cg_ir", "--precond",
                            "amg_classical", "--devices", "2"],
    "mesh cg_ir": ["--solver", "cg_ir", "--devices", "4", "--mesh", "2x2"],
    "mesh bicgstab": ["--solver", "bicgstab", "--devices", "4", "--mesh",
                      "2x2"],
    "mesh ginkgo": ["--solver", "ginkgo", "--devices", "4", "--mesh", "2x2"],
    "mesh cg --nrhs 4": ["--solver", "cg", "--nrhs", "4", "--devices", "4",
                         "--mesh", "2x2"],
    "mesh cg amg": ["--solver", "cg", "--precond", "amg", "--devices", "4",
                    "--mesh", "2x2"],
}
# The settings each class takes that the route decides.
SETTINGS = ("rtol", "cycles", "nrhs", "inner_rtol", "max_refine")
AMG_SETTINGS = ("coarsening", "theta", "interp", "interp_passes",
                "interp_omega", "pmax", "cycle", "coarse_n", "smoother",
                "degree")


class _Built(Exception):
    pass


def _effective(cls, kw, key):
    """The value the port's class takes for `key`: the route's, or the
    class's default (AMG options: through its AmgOptions)."""
    import inspect
    if key in kw:
        return kw[key]
    for klass in cls.__mro__:
        init = klass.__dict__.get("__init__")
        if init is not None:
            p = inspect.signature(init).parameters.get(key)
            if p is not None and p.default is not inspect.Parameter.empty:
                return p.default
    if key in AMG_SETTINGS:  # not a parameter: the hierarchy's default
        from lsbench_tpu_torch.solvers.amg import AmgOptions
        return getattr(AmgOptions(), key)
    return None


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_routes_pick_the_jax_class(matrix_files, capsys, monkeypatch,
                                   route):
    """The class and settings of each AMG and grid route are the JAX
    CLI's (its solver is built, then the run is stopped before the
    bench)."""
    import lsbench_tpu.harness.cli as jcli
    from lsbench_tpu_torch.harness.cli import _prepare, build_parser
    argv = ["--matrix", matrix_files["p20"], *ROUTES[route], "--trials",
            "1", "--warmups", "0"]
    prep = _prepare(build_parser().parse_args(argv + ["--platform", "cpu"]))
    cls, kw, grid = prep.dist
    built = {}

    def stop(solver, b, **_):
        built["solver"] = solver
        raise _Built

    monkeypatch.setattr(jcli, "run_bench", stop)
    with pytest.raises(_Built):
        j_main(argv)
    capsys.readouterr()
    j = built["solver"]
    assert cls.__name__ == type(j).__name__
    if "--mesh" in argv:
        assert grid == (2, 2)
        assert _effective(cls, kw, "ordering") == "none"
    else:
        assert grid is None
    for key in SETTINGS:
        if hasattr(j, key):
            assert _effective(cls, kw, key) == getattr(j, key), key
    if hasattr(j, "opts"):
        for key in AMG_SETTINGS:
            want = getattr(j.opts, key)
            got = _effective(cls, kw, key)
            assert got == want, (key, got, want)


# The acceptance runs: (argv, the JAX record's keys compared).
END_TO_END = {
    "hypre": (["--solver", "hypre", "--devices", "2"], 1.0),
    "paralmond": (["--solver", "paralmond", "--devices", "2"], 1.0),
    "cg_ir amg_classical": (["--solver", "cg_ir", "--precond",
                             "amg_classical", "--devices", "2"], 1e-10),
    "mesh cg_ir": (["--solver", "cg_ir", "--devices", "4", "--mesh", "2x2"],
                   1e-10),
    "mesh cg --nrhs 4": (["--solver", "cg", "--nrhs", "4", "--devices", "4",
                          "--mesh", "2x2"], 1e-10),
    "mesh cg amg": (["--solver", "cg", "--precond", "amg", "--devices", "4",
                     "--mesh", "2x2", "--rtol", "1e-8"], 1e-8),
}


@pytest.mark.parametrize("case", sorted(END_TO_END))
def test_amg_and_mesh_routes_end_to_end(matrix_files, capsys, case):
    flags, bar = END_TO_END[case]
    argv = ["--matrix", matrix_files["p20"], *flags, "--trials", "1",
            "--warmups", "0", "--json"]
    rc, out, err = _run(main, argv + ["--platform", "cpu"], capsys)
    assert rc == 0, err
    assert len(out) == 3 and out[0] == BenchRecord.CSV_HEADER
    rec = json.loads(out[2])
    j_rc, j_out, _ = _run(j_main, argv + ["--platform", "cpu"], capsys)
    assert j_rc == 0
    j_rec = json.loads(j_out[2])
    assert out[1].split(",")[:6] == j_out[1].split(",")[:6]
    assert set(j_rec) <= set(rec)
    for k in ("solver", "precision", "converged", "nrhs", "levels",
              "n_devices", "mesh"):
        assert rec.get(k) == j_rec.get(k), k
    # The SELL kernels' plain versions (JAX on the CPU runs ELL), but the
    # 2-D hierarchy's gather ELL.
    assert rec["local_spmv"] == ("ell" if case == "mesh cg amg" else "bsr")
    assert rec["device"] == "cpu" and rec["true_relres"] <= bar
    passes, j_passes = rec.get("refine_passes"), j_rec.get("refine_passes")
    if passes is None:
        assert j_passes is None and abs(rec["iters"] - j_rec["iters"]) <= 1
    else:
        # The f32 inner solves' stop points move with the last bits of the
        # sums, and a pass can end on either side of 1e-10 (`cg_ir --mesh
        # 2x2` on poisson_2d(20): the port's second pass ends at 8.7e-11,
        # the JAX class takes a third): one pass more or less, 10% more
        # iterations per pass.
        assert abs(passes - j_passes) <= 1
        assert rec["iters"] <= 1.1 * j_rec["iters"] * max(
            1.0, passes / j_passes)


def test_a_shard_that_cannot_be_built_exits_1(matrix_files, capsys):
    """random_spd's couplings reach past one block at D = 4: the halo
    strategy is refused on every rank, and the run exits 1."""
    rc, out, err = _run(main, ["--matrix", matrix_files["rspd"], "--solver",
                               "cg", "--devices", "4", "--platform", "cpu",
                               "--opt", "strategy=halo", "--trials", "1"],
                        capsys)
    assert rc == 1 and not out and "halo strategy impossible" in err


def test_more_devices_than_cards_exits_1_with_the_jax_message(
        matrix_files, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    rc, out, err = _run(main, ["--matrix", matrix_files["p20"], "--solver",
                               "cg_ir", "--devices", "2"], capsys)
    assert rc == 1 and not out
    assert "requested 2 devices, have 1" in err


@pytest.mark.cuda
def test_devices_1_nccl_path_and_per_rank_kernels_on_card(matrix_files,
                                                           capsys):
    """On a card: `cg_ir --devices 1` is an NCCL group of one through the
    SELL f32 and f64 kernels; then each D = 4 rank's operator of RCM
    poisson_2d(40), fed an x_ext assembled by hand, runs the SELL f32, f64
    and k = 8 SpMM kernels, each held to its plain version, and the ranks'
    rows concatenated to the global product."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.ops import spmv_sell
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.parallel.dist_spmv import build_halo_sell_plan
    spmv_sell.reset_launches()
    rc, out, err = _run(main, ["--matrix", matrix_files["p20"], "--solver",
                               "cg_ir", "--ordering", "rcm", "--devices",
                               "1", "--trials", "1", "--json"], capsys)
    assert rc == 0, err
    rec = json.loads(out[2])
    assert rec["true_relres"] <= 1e-10 and rec["local_spmv"] == "bsr"
    assert spmv_sell.LAUNCHES["sell_f32"] > 0
    assert spmv_sell.LAUNCHES["sell_f64"] > 0

    A = poisson_2d(40)
    A = A.permuted(get_ordering("rcm", A))
    D, dev = 4, torch.device("cuda")
    rng = np.random.default_rng(3)
    x = rng.standard_normal(A.nrows)
    X = rng.standard_normal((A.nrows, 8))
    ys, Ys = [], []
    for r in range(D):
        p = build_halo_sell_plan(A, D, r, (torch.float32, torch.float64),
                                 device=dev)
        lo, H = r * p.nloc, p.halo

        def ext(v):
            pad = np.zeros((p.n_pad + 2 * H, *v.shape[1:]))
            pad[H: H + A.nrows] = v
            return pad[lo: lo + p.n_ext]
        x64 = torch.as_tensor(ext(x), device=dev)
        X32 = torch.as_tensor(ext(X), dtype=torch.float32, device=dev)
        y32 = spmv_sell.spmv_sell(p.sell, x64.float())
        y64 = spmv_sell.spmv_sell_f64(p.sell, x64)
        Y32 = spmv_sell.spmm_sell(p.sell, X32.contiguous())
        torch.cuda.synchronize()
        scale = float(y64.abs().max())
        assert float((y32 - spmv_sell.spmv_sell_plain(
            p.sell, x64.float())).abs().max()) <= 1e-5 * scale
        assert float((y64 - spmv_sell.spmv_sell_f64_plain(
            p.sell, x64)).abs().max()) <= 1e-13 * scale
        assert float((Y32 - spmv_sell.spmm_sell_plain(
            p.sell, X32.contiguous())).abs().max()) <= 1e-5 * float(
                Y32.abs().max())
        ys.append(y64.cpu().numpy())
        Ys.append(Y32.double().cpu().numpy())
    y = np.concatenate(ys)[: A.nrows]
    Y = np.concatenate(Ys)[: A.nrows]
    host = A.matvec(x)
    assert np.abs(y - host).max() <= 1e-13 * np.abs(host).max()
    host_X = np.stack([A.matvec(X[:, j]) for j in range(8)], axis=1)
    assert np.abs(Y - host_X).max() <= 2e-5 * np.abs(host_X).max()


def test_port_sources_import_neither_jax_nor_lsbench_tpu():
    """No module of the port imports jax or the JAX package, at the top or
    inside a function (the ranks import only torch and the port)."""
    import pathlib
    import re
    root = pathlib.Path(__file__).resolve().parent.parent / "lsbench_tpu_torch"
    pattern = re.compile(r"^\s*(from|import)\s+(jax|lsbench_tpu)(\.|\s|$)",
                         re.MULTILINE)
    files = sorted(root.rglob("*.py"))
    assert len(files) > 40
    bad = [str(f) for f in files if pattern.search(f.read_text())]
    assert not bad, bad
