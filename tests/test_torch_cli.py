"""The port's CLI against the JAX package's: the same reference CSV record,
the same error behaviour, and flags whose machinery is not ported yet
refused with rc=1. Also: the port never imports jax."""

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
    assert "Invalid solver" in err and "Defaulting to cg" in err
    assert out[0] == BenchRecord.CSV_HEADER and ",cg," in out[1]


@pytest.mark.parametrize("content", [None, "abc def\n"])
def test_missing_or_malformed_file(tmp_path, capsys, content):
    f = tmp_path / "m.txt"
    if content is not None:
        f.write_text(content)
    rc, out, err = _run(main, ["--matrix", str(f), "--platform", "cpu"],
                        capsys)
    assert rc == 1 and not out and err


@pytest.mark.parametrize("flags", [
    ["--devices", "2"], ["--mesh", "2x4"], ["--nrhs", "2"], ["--roofline"],
    ["--profile-dir", "prof"], ["--cache"], ["--cache-dir", "c"],
    ["--coordinator", "localhost:1234"], ["--debug-nans"],
    ["--ordering", "amd"], ["--ordering", "metis"], ["--precond", "amg"],
    ["--platform", "tpu"],
])
def test_unported_flags_exit_1(tiny_matrix_file, capsys, flags):
    argv = ["--matrix", str(tiny_matrix_file), "--trials", "1",
            "--platform", "cpu", *flags]
    rc, out, err = _run(main, argv, capsys)
    assert rc == 1 and not out
    assert "not yet ported" in err or "Unsupported platform" in err


def test_invalid_ordering_defaults_to_amd_which_is_refused(tiny_matrix_file,
                                                           capsys):
    rc, out, err = _run(main, ["--matrix", str(tiny_matrix_file),
                               "--ordering", "zzz", "--platform", "cpu"],
                        capsys)
    assert rc == 1 and not out
    assert "Defaulting to AMD" in err and "not yet ported" in err


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
