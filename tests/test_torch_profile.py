"""The port's observability (harness/profile.py) and `--debug-nans`
(utils/debug.py).

- `spmv_roofline` returns the JAX package's fields plus the function's
  CSR bytes; on the CPU the peak and the shares are None (no device
  figure stands in).
- `device_hbm_gbps` knows the H100 parts by name and nothing else.
- `trace` writes a chrome trace that `harness/profile_solve.py` reads.
- With `--debug-nans` on, every kernel wrapper raises FloatingPointError
  naming its op on a NaN in its output; off, the NaN passes through.
- The `cuda` twins: the L2-cold roofline of the SELL f32 kernel on the
  card, and the wrapper raising on the card.
"""

import json

import numpy as np
import pytest
import torch

from lsbench_tpu.harness import profile as jprofile

from lsbench_tpu_torch.harness import profile
from lsbench_tpu_torch.harness.profile_solve import _device_events
from lsbench_tpu_torch.matrix.bsr import (BsrClassed, BsrCompact, BsrDf64,
                                          BsrMatrix)
from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops import spmv_bsr as bsr
from lsbench_tpu_torch.ops import spmv_sell as sell
from lsbench_tpu_torch.ops import tri_sweep as ts
from lsbench_tpu_torch.ops.interp_well import WindowEll, spmv_well
from lsbench_tpu_torch.solvers import get_solver
from lsbench_tpu_torch.solvers.ic0 import ic0_factor
from lsbench_tpu_torch.solvers.sparse_cholesky import pack_tri
from lsbench_tpu_torch.utils import debug

CPU = torch.device("cpu")
F32, F64 = torch.float32, torch.float64


def _csr_bytes(A, value_bytes):
    """`chip_smoke.py::function_bound`'s bytes of y = A·x."""
    return (A.nnz * (value_bytes + 4) + (A.nrows + 1) * 4
            + (A.ncols + A.nrows) * value_bytes)


# ------------------------------------------------------------- roofline

@pytest.mark.parametrize("dtype", [F32, F64])
def test_roofline_fields_on_cpu(dtype):
    A = random_spd(400, 9)
    S = SellMatrix.from_csr(A, dtypes=(dtype,), device=CPU)
    mv = sell.spmv_sell if dtype == F32 else sell.spmv_sell_f64
    x = torch.as_tensor(np.random.default_rng(0).random(A.ncols), dtype=dtype)
    r = profile.spmv_roofline(lambda v: mv(S, v), x, A.nnz,
                              S.bytes_streamed, reps=3)
    jkeys = {"spmv_s", "gnnz_per_s", "achieved_gbps", "peak_gbps",
             "hbm_utilization", "stream_bytes"}
    assert set(r) == jkeys | {"function_bytes", "function_utilization"}
    assert r["spmv_s"] > 0 and r["stream_bytes"] == S.bytes_streamed
    assert r["function_bytes"] == _csr_bytes(A, x.element_size())
    assert r["gnnz_per_s"] == pytest.approx(A.nnz / r["spmv_s"] / 1e9)
    assert r["achieved_gbps"] == pytest.approx(
        S.bytes_streamed / r["spmv_s"] / 1e9)
    assert r["peak_gbps"] is None
    assert r["hbm_utilization"] is None and r["function_utilization"] is None


@pytest.mark.parametrize("kind,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2039.0),
    ("NVIDIA H100 NVL", 3938.0), ("NVIDIA A100-SXM4-80GB", None),
    ("TPU v5 lite", None)])
def test_device_hbm_gbps_by_name(kind, gbps):
    assert profile.device_hbm_gbps(kind=kind) == gbps


def test_device_hbm_gbps_is_none_on_the_cpu():
    assert profile.device_hbm_gbps(CPU) is None
    # The JAX table's fallback is a v5e figure; the port has none.
    assert jprofile.device_hbm_gbps() == jprofile.DEFAULT_HBM_GBPS


@pytest.mark.parametrize("solver,stream", [
    ("cg_ir", True), ("cg", True), ("gmres", True), ("bicgstab", True),
    ("cholmod", False), ("amg", False)])
def test_matvec_op_where_the_jax_package_has_one(solver, stream):
    A = poisson_2d(12)
    cls, params = get_solver(solver)
    s = cls(A, **params, device=CPU)
    op = s.matvec_op()
    assert (op is not None) == stream
    if stream:
        mv, nnz, nbytes, x_dtype = op
        assert nnz == A.nnz and nbytes > 0
        y = mv(torch.ones(A.ncols, dtype=x_dtype))
        np.testing.assert_allclose(y.double().numpy(),
                                   A.matvec(np.ones(A.ncols)), rtol=1e-6)


# ---------------------------------------------------------------- trace

def test_trace_is_readable_by_profile_solve(tmp_path):
    A = poisson_2d(12)
    cls, params = get_solver("cg_ir")
    s = cls(A, **params, device=CPU)
    with profile.trace(str(tmp_path), CPU) as path:
        s.solve(np.arange(A.nrows, dtype=np.float64))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert _device_events(path) == []  # no device activity on the CPU


# ----------------------------------------------------------- debug-nans

def _wrappers():
    """(op name, call(nan) -> output) for every kernel wrapper on the CPU;
    `nan` puts a NaN into x (or b)."""
    A = poisson_2d(16)
    n = A.ncols

    def x(dtype, nan, k=None):
        v = torch.ones(n if k is None else (n, k), dtype=dtype)
        if nan:
            v[0] = float("nan")
        return v

    S = SellMatrix.from_csr(A, dtypes=(F32, F64), device=CPU)
    B = BsrMatrix.from_csr(A, device=CPU)
    D = BsrDf64.from_csr(A, device=CPU)
    C = BsrClassed.from_csr(A, device=CPU)
    K = BsrCompact.from_csr(A, device=CPU)
    W = WindowEll.from_csr(A, dtype=F32, max_k=24, max_j=16, device=CPU)
    cp, ci, cx = ic0_factor(A)
    T32, _ = pack_tri(cp, ci, cx, n, F32, CPU)
    T64, _ = pack_tri(cp, ci, cx, n, F64, CPU)
    return {
        "spmv_sell_f32": lambda nan: sell.spmv_sell(S, x(F32, nan)),
        "spmv_sell_f64": lambda nan: sell.spmv_sell_f64(S, x(F64, nan)),
        "spmm_sell_f32": lambda nan: sell.spmm_sell(S, x(F32, nan, 3)),
        "spmv_bsr_f32": lambda nan: bsr.spmv_bsr(B, x(F32, nan)),
        "spmv_bsr_selector_f32":
            lambda nan: bsr.spmv_bsr(B, x(F32, nan), variant="selector"),
        "spmv_bsr_onehot_f32":
            lambda nan: bsr.spmv_bsr(B, x(F32, nan), variant="onehot"),
        "spmv_bsr_compact_f32": lambda nan: bsr.spmv_bsr_compact(
            K, x(F32, nan)),
        "spmm_bsr_f32": lambda nan: bsr.spmm_bsr(B, x(F32, nan, 3)),
        "spmv_bsr_classed_f32": lambda nan: bsr.spmv_bsr_classed(
            C, x(F32, nan)),
        "spmv_bsr_f64acc": lambda nan: bsr.spmv_bsr_df64(D, x(F64, nan)),
        "spmv_bsr_f64acc (lo)": lambda nan: bsr.spmv_bsr_df64_lo(
            B, D.blocks_lo, x(F64, nan)),
        "spmv_well_f32": lambda nan: spmv_well(W, x(F32, nan)),
        "tri_sweep_f32": lambda nan: ts.tri_sweep(T32.f, x(F32, nan)),
        "tri_sweep_f64": lambda nan: ts.tri_sweep(T64.b, x(F64, nan)),
    }


WRAPPERS = _wrappers()


@pytest.fixture
def nans_on(monkeypatch):
    monkeypatch.setattr(debug, "_debug_nans", True)


@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_debug_nans_raises_naming_the_op(op, nans_on):
    call = WRAPPERS[op]
    assert not torch.isnan(call(False)).any()  # a clean call passes
    with pytest.raises(FloatingPointError, match=op.split()[0]):
        call(True)


@pytest.mark.parametrize("op", sorted(WRAPPERS))
def test_debug_nans_off_lets_the_nan_through(op):
    assert not debug.debug_nans_enabled()
    assert torch.isnan(WRAPPERS[op](True)).any()


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cold_roofline_on_card(cuda_device):
    """The SELL f32 kernel on poisson_2d(24), timed L2-cold: a positive
    time, and shares of the card's peak in (0, 1.05]."""
    A = poisson_2d(24)
    S = SellMatrix.from_csr(A, dtypes=(F32,), device=cuda_device)
    x = torch.rand(A.ncols, device=cuda_device)
    r = profile.spmv_roofline(lambda v: sell.spmv_sell(S, v), x, A.nnz,
                              S.bytes_streamed)
    assert r["spmv_s"] > 1e-9
    assert r["function_bytes"] == _csr_bytes(A, 4)
    assert r["peak_gbps"] == profile.device_hbm_gbps(cuda_device)
    if r["peak_gbps"] is not None:
        assert 0 < r["hbm_utilization"] <= 1.05
        assert 0 < r["function_utilization"] <= 1.05


@pytest.mark.cuda
def test_debug_nans_on_card(cuda_device, monkeypatch):
    A = poisson_2d(16)
    S = SellMatrix.from_csr(A, dtypes=(F32,), device=cuda_device)
    x = torch.ones(A.ncols, device=cuda_device)
    x[0] = float("nan")
    assert torch.isnan(sell.spmv_sell(S, x)).any()  # off: passes through
    monkeypatch.setattr(debug, "_debug_nans", True)
    with pytest.raises(FloatingPointError, match="spmv_sell_f32"):
        sell.spmv_sell(S, x)
