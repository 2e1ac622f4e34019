"""The port's native host code is its own: `native/reader.cpp` and
`native/spgemm.cpp` live in `lsbench_tpu_torch/native/` and build from
there, and no code of the port reads, builds or imports anything of the JAX
package."""

import ast
import os

import numpy as np

import lsbench_tpu_torch
from lsbench_tpu_torch import native
from lsbench_tpu_torch.matrix.generate import poisson_2d

PKG = os.path.dirname(os.path.abspath(lsbench_tpu_torch.__file__))


def test_native_sources_are_the_ports_own():
    assert os.path.commonpath([native.SRC_DIR, PKG]) == PKG
    for src in ("reader.cpp", "spgemm.cpp"):
        assert os.path.isfile(os.path.join(native.SRC_DIR, src))


def test_native_libraries_build_from_the_port(tmp_path, monkeypatch):
    """Both libraries build from the port's sources into a fresh build
    directory and compute what the NumPy paths compute."""
    from lsbench_tpu_torch.matrix.io import read_matrix, write_matrix
    from lsbench_tpu_torch.native import reader, spgemm
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(reader, "_lib", None)
    monkeypatch.setattr(spgemm, "_lib", None)
    A = poisson_2d(7)
    f = tmp_path / "p7.txt"
    write_matrix(A, str(f))
    rows, cols, vals, base = reader.read_coo(str(f))
    assert base in (0, 1) and rows.size == A.nnz
    B = read_matrix(str(f))
    np.testing.assert_array_equal(B.to_dense(), A.to_dense())
    c_offs, c_cols, c_vals = spgemm.spgemm_native(
        A.nrows, A.offs, A.cols, A.vals, A.offs, A.cols, A.vals, A.ncols)
    C = np.zeros((A.nrows, A.ncols))
    C[np.repeat(np.arange(A.nrows), np.diff(c_offs)), c_cols] = c_vals
    np.testing.assert_allclose(C, A.to_dense() @ A.to_dense())
    built = sorted(os.listdir(tmp_path / "build"))
    assert built == ["libreader.so", "libspgemm.so"]


def _code_strings(tree):
    """String constants of a module that are not docstrings."""
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_port_code_names_no_jax_package_path():
    offenders = []
    for dirpath, _, files in os.walk(PKG):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    names = [node.module or ""]
                else:
                    continue
                offenders += [f"{path}: import {n}" for n in names
                              if n.split(".")[0] in ("jax", "lsbench_tpu")]
            offenders += [f"{path}: {s!r}" for s in _code_strings(tree)
                          if "lsbench_tpu/" in s or s == "lsbench_tpu"]
    assert not offenders, offenders
