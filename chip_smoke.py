#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lsbench_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Print the card's name and power limit (nvidia-smi), build the kernels
   from `lsbench_tpu_torch/csrc/*.cu` (one nvcc per source, all started
   together) and print the build time.
2. Kernels: on the main path's layouts (RCM-ordered poisson_2d(512),
   n=262,144, class-padded and uniform; RCM-ordered random_spd(6408, 23),
   uniform) compare each kernel with its plain PyTorch version on the same
   CUDA tensors — f32 kernels within 1e-5·max|y|, the f64-accurate kernel
   within 1e-13·max|y| and within 5e-13·max|y| of the host f64 CSR matvec —
   and print the median CUDA-event time of both with the bytes streamed.
3. Main path: write each matrix to a file and run the port's CLI on it
   (`cg_ir`, RCM, rtol 1e-10, 2 trials, 1 warmup); check the reference CSV,
   convergence, the independent host f64 residual, and that the launch
   counters show each kernel of that path ran.
4. AMG kernel: build the `amg_classical` hierarchy of RCM-ordered
   poisson_2d(512) once and compare the window-ELL kernel (K4) with its
   plain version (within 1e-5·max|y|) and with the host f64 CSR matvec
   (within 2e-5·max|y|) on every operator laid out as window-ELL, with the
   median CUDA-event times of the wrapper and the plain version, and the
   device time of the kernel alone over back-to-back launches.
5. AMG-CG-IR path: the CLI with `cg_ir --precond amg_classical --ordering
   rcm --rtol 1e-10` on poisson_2d(512); it must converge to true relres
   ≤ 1e-10 through K5, K1, K4 and K2.
6. Fixed-cycle backend path: the CLI with `--solver hypre` (2 V-cycles) on
   poisson_2d(512): the record must say `fp64(fp32_cycles_auto)`, K4 and K1
   must run, the true relres must be finite and below 1. Then the same
   solve of poisson_2d(128) on the card and with `--platform cpu` (the
   plain versions): the two true relres agree to 1e-3 relative.
7. Multi-RHS kernel (K3, in phase 2): `spmm_bsr` on the uniform layouts of
   RCM poisson_2d(512) and random_spd(6408, 23) for k in {1, 3, 8, 16},
   each column within 1e-5·max|Y_j| of the plain version and 2e-5·max|Y_j|
   of the host f64 CSR product, with median CUDA-event times and GB/s.
8. Multi-RHS paths through the CLI: `--solver cg --nrhs 8` (block CG, rtol
   1e-10, RCM) on both matrices, `--solver ginkgo --nrhs 8` (batched
   BiCGSTAB) on poisson_2d(512), one-RHS `--solver ginkgo` (bicgstab_ir,
   `fp64(fp32_ir_auto)`) on random_spd(6408, 23), each through its kernels;
   then `--solver cg --nrhs 4` on poisson_2d(128) on the card and with
   `--platform cpu`: both reach 1e-10 within max(3, 10%) block iterations
   of each other, and the CPU run launches nothing.
9. Alternate SpMV kernels K6 (exact-block `spmv_bsr_compact`), K7
   (`spmv_bsr(variant="selector")`) and K8 (`variant="onehot"`), which no
   solver path runs: first their API path (each public entry called once
   on RCM poisson_2d(512) and random_spd(6408, 23), each result within
   2e-5·max|y| of the host f64 CSR matvec), then each kernel against its
   plain version (within 1e-5·max|y|) with the median CUDA-event times,
   bounds and cuSPARSE's time. The 1.34 GB selector is freed after it.
10. The XLA-only layouts through the CLI: `cg_ir --opt layout=ell` on
   poisson_2d(512) (true relres ≤ 1e-10 through K2, with no K1 or K5
   launch) and fp64 `cg --opt layout=bsr_xla` on random_spd(6408, 23)
   (≤ 1e-10).

Each path's launch counts are read from counters set to 0 just before it.
Beside each kernel's times the record carries its bound (`bound_ms`: the
larger of the bytes it must move over 3.35 TB/s and its operations over
the card's peak for their type) and the time of the cuSPARSE product
`torch.sparse_csr_tensor(...) @ x` on the same operator (`library_ms`,
timed here only; the port never calls it). The log also prints the bytes
bound of the operator's CSR form beside each bound. The last two lines are the
per-kernel JSON record (launches summed over the paths; `launches_by_path`
in the order of `PATHS`) and `{"ok": true, "device": {...}}`. Without a
CUDA device it prints no result and exits 1. Nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

BSR_SOURCE = "lsbench_tpu_torch/csrc/bsr_spmv.cu"
WELL_SOURCE = "lsbench_tpu_torch/csrc/well_spmv.cu"
VARIANTS_SOURCE = "lsbench_tpu_torch/csrc/bsr_variants.cu"
# Kernel name → (launch counter, source, TPU kernel it replaces).
KERNELS = {
    "spmv_bsr_f32": ("bsr_f32", BSR_SOURCE,
                     "lsbench_tpu/ops/spmv_pallas.py:47"),
    "spmv_bsr_classed_f32": ("bsr_classed_f32", BSR_SOURCE,
                             "lsbench_tpu/ops/spmv_pallas.py:187"),
    "spmv_bsr_f64acc": ("bsr_f64acc", BSR_SOURCE,
                        "lsbench_tpu/ops/spmv_pallas.py:396"),
    "spmv_well_f32": ("well_f32", WELL_SOURCE,
                      "lsbench_tpu/ops/interp_pallas.py:139"),
    "spmm_bsr_f32": ("bsr_mm_f32", BSR_SOURCE,
                     "lsbench_tpu/ops/spmv_pallas.py:255"),
    "spmv_bsr_compact_f32": ("bsr_compact_f32", VARIANTS_SOURCE,
                             "lsbench_tpu/ops/spmv_pallas.py:543"),
    "spmv_bsr_selector_f32": ("bsr_selector_f32", VARIANTS_SOURCE,
                              "lsbench_tpu/ops/spmv_pallas.py:135"),
    "spmv_bsr_onehot_f32": ("bsr_onehot_f32", VARIANTS_SOURCE,
                            "lsbench_tpu/ops/spmv_pallas.py:27"),
}
# The main-path runs whose launch counts the record lists, in order.
PATHS = ("cg_ir poisson_2d(512) + random_spd(6408,23)",
         "cg_ir amg_classical poisson_2d(512)", "hypre poisson_2d(512)",
         "hypre poisson_2d(128)", "cg --nrhs 8 poisson_2d(512)",
         "cg --nrhs 8 random_spd(6408,23)", "ginkgo --nrhs 8 poisson_2d(512)",
         "ginkgo random_spd(6408,23)", "cg --nrhs 4 poisson_2d(128)",
         "spmv variants API poisson_2d(512) + random_spd(6408,23)",
         "cg_ir --opt layout=ell poisson_2d(512)",
         "cg --opt layout=bsr_xla random_spd(6408,23)")
# H100 SXM data sheet: HBM3 rate, and peak rates outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "f64": 34e12}
# Iterations and passes of the same solves by the JAX package on the CPU
# (cg_ir, rtol 1e-10, RCM, b[i] = i, its CPU default ELL layout), for
# comparison only. At n=262k it needs more inner iterations than the port
# because XLA's f32 dot products on the CPU round more; with the CG dots
# accumulated in f64 it takes the port's count (PERF.md, section 7).
JAX_CPU_ITERS = {"poisson_2d(512)": (5209, 4), "random_spd(6408,23)": (19, 2)}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip()


def build_kernels() -> float:
    from lsbench_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    log = _cuda.build()  # one nvcc per source, run in parallel
    for stem in _cuda.SOURCES:
        _cuda.library(stem)
    seconds = time.perf_counter() - t0
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling" in line
                or line.startswith("[")):
            print("  ptxas:", line.strip())
    return seconds


def median_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after a warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(nbytes: int, flops: int, kind: str) -> tuple[float, str]:
    """Least time (ms) the card could take: bytes over the HBM rate or
    operations over the peak rate for `kind`, whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def csr_bound_ms(A, value_bytes: int, k: int = 1) -> float:
    """The bytes bound of the same product on the CSR form of A: values and
    int32 column indices of the nonzeros, int32 row offsets, x and y."""
    nbytes = (A.nnz * (value_bytes + 4) + (A.nrows + 1) * 4
              + (A.ncols + A.nrows) * value_bytes * k)
    return nbytes / HBM_BYTES_PER_S * 1e3


def library_ms(A, dtype, X) -> float:
    """Median time of cuSPARSE's product (torch.sparse_csr_tensor @ X) on
    A, the library call computing the kernel's function; timed only."""
    import warnings

    import torch
    with warnings.catch_warnings():  # "sparse CSR support is in beta"
        warnings.simplefilter("ignore")
        M = torch.sparse_csr_tensor(
            torch.as_tensor(A.offs, dtype=torch.int64),
            torch.as_tensor(A.cols, dtype=torch.int64),
            torch.as_tensor(A.vals, dtype=dtype), size=(A.nrows, A.ncols),
            device=X.device)
        return median_ms(lambda: M @ X)


def main_path_matrices():
    from lsbench_tpu_torch.matrix.generate import poisson_2d, random_spd
    return {"poisson_2d(512)": poisson_2d(512),
            "random_spd(6408,23)": random_spd(6408, 23)}


def kernel_phase(matrices) -> dict:
    """Compare every kernel with its plain version at the main path's
    shapes. Returns {kernel name: {max_abs_err, ms, plain_ms, shape}} at the
    shape the main path runs it on (max_abs_err over all shapes)."""
    import torch

    from lsbench_tpu_torch.matrix.bsr import (BsrClassed, BsrDf64, BsrMatrix,
                                              classed_layout_wins)
    from lsbench_tpu_torch.ops import spmv_bsr as ops
    from lsbench_tpu_torch.ordering import rcm_ordering

    dev = torch.device("cuda")
    P, R = (A.permuted(rcm_ordering(A)) for A in matrices.values())
    check(classed_layout_wins(P), "poisson_2d(512) should take the classed layout")
    check(not classed_layout_wins(R), "random_spd(6408,23) should stay uniform")

    p_cls = BsrClassed.from_csr(P, device=dev)
    p_uni = BsrMatrix.from_csr(P, device=dev)
    p_64 = BsrDf64.from_csr(P, device=dev)
    r_uni = BsrMatrix.from_csr(R, device=dev)
    r_lo = BsrDf64.from_csr(R, device="cpu").blocks_lo.to(dev)

    # (kernel, shape label, matrix, wrapper, plain, bytes streamed, f64?)
    cases = [
        ("spmv_bsr_classed_f32", "poisson_2d(512) RCM classed", P,
         lambda x: ops.spmv_bsr_classed(p_cls, x),
         lambda x: ops.spmv_bsr_classed_plain(p_cls, x),
         p_cls.bytes_streamed, False),
        ("spmv_bsr_f32", "poisson_2d(512) RCM uniform", P,
         lambda x: ops.spmv_bsr(p_uni, x),
         lambda x: ops.spmv_bsr_plain(p_uni, x), p_uni.bytes_streamed, False),
        ("spmv_bsr_f32", "random_spd(6408,23) RCM uniform", R,
         lambda x: ops.spmv_bsr(r_uni, x),
         lambda x: ops.spmv_bsr_plain(r_uni, x), r_uni.bytes_streamed, False),
        ("spmv_bsr_f64acc", "poisson_2d(512) RCM df64", P,
         lambda x: ops.spmv_bsr_df64(p_64, x),
         lambda x: ops.spmv_bsr_df64_plain(p_64, x),
         p_64.bytes_streamed, True),
        ("spmv_bsr_f64acc", "random_spd(6408,23) RCM df64_lo", R,
         lambda x: ops.spmv_bsr_df64_lo(r_uni, r_lo, x),
         lambda x: ops.spmv_bsr_df64_lo_plain(r_uni, r_lo, x),
         2 * r_uni.bytes_streamed, True),
    ]
    # The shape each kernel runs at on the main path (reported in the JSON),
    # and the bytes of its layout's index arrays there.
    main_shape = {"spmv_bsr_classed_f32": "poisson_2d(512) RCM classed",
                  "spmv_bsr_f32": "random_spd(6408,23) RCM uniform",
                  "spmv_bsr_f64acc": "poisson_2d(512) RCM df64"}
    layout_index_bytes = {
        "spmv_bsr_classed_f32": 4 * sum(t.numel() for t in
                                        (*p_cls.bcols, *p_cls.oidx)),
        "spmv_bsr_f32": 4 * r_uni.block_cols.numel(),
        "spmv_bsr_f64acc": 4 * p_64.block_cols.numel()}

    results = {}
    rng = np.random.default_rng(0)
    lib_dtype = {False: torch.float32, True: torch.float64}
    for name, shape, A, kern, plain, nbytes, f64 in cases:
        x_np = rng.standard_normal(A.ncols)
        x = torch.as_tensor(x_np, dtype=torch.float64 if f64 else torch.float32,
                            device=dev)
        y_k = kern(x)
        y_p = plain(x)
        torch.cuda.synchronize()
        check(y_k.shape == (A.nrows,) and bool(torch.isfinite(y_k).all()),
              f"{name} [{shape}]: bad output")
        scale = float(y_p.abs().max())
        err = float((y_k - y_p).abs().max())
        tol = (1e-13 if f64 else 1e-5) * scale
        check(err <= tol, f"{name} [{shape}]: max|kernel - plain| = {err:.3e}"
                          f" > {tol:.3e}")
        msg = ""
        if f64:
            y_host = A.matvec(x_np)
            host_err = float(np.abs(y_k.cpu().numpy() - y_host).max())
            host_tol = 5e-13 * float(np.abs(y_host).max())
            check(host_err <= host_tol,
                  f"{name} [{shape}]: max|kernel - host f64| = {host_err:.3e}"
                  f" > {host_tol:.3e}")
            msg = f" host_err={host_err:.3e}"
        ms, plain_ms = median_ms(lambda: kern(x)), median_ms(lambda: plain(x))
        print(f"kernel {name} [{shape}]: max_abs_err={err:.3e} "
              f"(tol {tol:.3e}){msg} kernel {ms:.4f} ms "
              f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes} B) "
              f"plain {plain_ms:.4f} ms")
        entry = results.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if shape == main_shape[name]:
            vb = 8 if f64 else 4
            # The function's bytes: every array of the layout once, x read
            # and y written once. K2 does 3 FP64 operations per stored
            # element (hi + lo, multiply, add); the f32 kernels 2.
            elems = nbytes // (8 if f64 else 4)
            b_ms, b_by = bound(nbytes + layout_index_bytes[name]
                               + (A.ncols + A.nrows) * vb,
                               (3 if f64 else 2) * elems,
                               "f64" if f64 else "f32")
            lib = library_ms(A, lib_dtype[f64], x)
            entry.update(ms=ms, plain_ms=plain_ms, shape=shape,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            print(f"  bound {b_ms:.4f} ms ({b_by}), CSR bound "
                  f"{csr_bound_ms(A, vb):.4f} ms, cuSPARSE {lib:.4f} ms")
    results["spmm_bsr_f32"] = spmm_cases(
        {"poisson_2d(512) RCM uniform": (P, p_uni),
         "random_spd(6408,23) RCM uniform": (R, r_uni)}, rng)
    del p_cls, p_uni, p_64, r_uni, r_lo
    torch.cuda.empty_cache()
    return results


def spmm_cases(layouts, rng) -> dict:
    """K3 against its plain version and the host f64 CSR product, column by
    column, for k in {1, 3, 8, 16} on each uniform layout; returns the
    record entry with k=8 on poisson_2d(512)."""
    import scipy.sparse as sp
    import torch

    from lsbench_tpu_torch.ops import spmv_bsr as ops

    result = {"max_abs_err": 0.0}
    for shape, (A, op) in layouts.items():
        dev = op.blocks.device
        host = sp.csr_matrix((A.vals, A.cols, A.offs), shape=A.shape)
        for k in (1, 3, 8, 16):
            X_np = rng.standard_normal((A.ncols, k))
            X = torch.as_tensor(X_np, dtype=torch.float32, device=dev)
            Y_k = ops.spmm_bsr(op, X)
            Y_p = ops.spmm_bsr_plain(op, X)
            torch.cuda.synchronize()
            label = f"spmm_bsr_f32 [{shape}, k={k}]"
            check(Y_k.shape == (A.nrows, k)
                  and bool(torch.isfinite(Y_k).all()), f"{label}: bad output")
            Y_host = host @ X_np
            err = (Y_k - Y_p).abs().amax(dim=0).cpu().numpy()
            tol = 1e-5 * Y_p.abs().amax(dim=0).cpu().numpy()
            check(bool(np.all(err <= tol)), f"{label}: max|kernel - plain| "
                  f"per column {err} > {tol}")
            host_err = np.abs(Y_k.double().cpu().numpy() - Y_host).max(axis=0)
            host_tol = 2e-5 * np.abs(Y_host).max(axis=0)
            check(bool(np.all(host_err <= host_tol)),
                  f"{label}: max|kernel - host f64| per column {host_err} > "
                  f"{host_tol}")
            ms = median_ms(lambda: ops.spmm_bsr(op, X))
            plain_ms = median_ms(lambda: ops.spmm_bsr_plain(op, X))
            nbytes = op.bytes_streamed
            print(f"kernel {label}: max_abs_err={err.max():.3e} (tol "
                  f"{tol.min():.3e}..{tol.max():.3e}) host_err="
                  f"{host_err.max():.3e} kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes} B) plain "
                  f"{plain_ms:.4f} ms")
            result["max_abs_err"] = max(result["max_abs_err"],
                                        float(err.max()))
            if k == 8 and shape.startswith("poisson_2d(512)"):
                b_ms, b_by = bound(
                    nbytes + op.block_cols.numel() * 4
                    + (A.ncols + A.nrows) * 4 * k,
                    2 * k * op.blocks.numel(), "f32")
                lib = library_ms(A, torch.float32, X)
                result.update(ms=ms, plain_ms=plain_ms,
                              shape=f"{shape}, k=8", bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
                print(f"  bound {b_ms:.4f} ms ({b_by}), CSR bound "
                      f"{csr_bound_ms(A, 4, k):.4f} ms, cuSPARSE SpMM "
                      f"{lib:.4f} ms")
    return result


def main_path_phase(matrices) -> dict:
    """Run cg_ir through the port's CLI on each matrix; return the launch
    counts of the whole phase."""
    from lsbench_tpu_torch.harness.bench import BenchRecord
    from lsbench_tpu_torch.harness.cli import main as cli_main
    from lsbench_tpu_torch.matrix.io import write_matrix
    from lsbench_tpu_torch.ops.spmv_bsr import LAUNCHES, reset_launches

    expect = {"poisson_2d(512)": ("bsr_classed_f32", "bsr_f64acc"),
              "random_spd(6408,23)": ("bsr_f32", "bsr_f64acc")}
    reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        for label, A in matrices.items():
            fname = os.path.join(tmp, label.split("(")[0] + ".txt")
            t0 = time.perf_counter()
            write_matrix(A, fname)
            write_s = time.perf_counter() - t0
            before = dict(LAUNCHES)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["--matrix", fname, "--solver", "cg_ir",
                               "--ordering", "rcm", "--rtol", "1e-10",
                               "--trials", "2", "--warmups", "1", "--json"])
            wall_s = time.perf_counter() - t0
            out = buf.getvalue().splitlines()
            check(rc == 0, f"{label}: CLI exited {rc}")
            check(len(out) == 3 and out[0] == BenchRecord.CSV_HEADER,
                  f"{label}: unexpected CLI output {out[:2]}")
            fields = out[1].split(",")
            check(len(fields) == 7 and fields[0] == fname
                  and fields[1:5] == [str(A.nrows), str(A.nnz), "2", "cg_ir"]
                  and fields[5] == "rcm",
                  f"{label}: bad CSV line {out[1]}")
            rec = json.loads(out[2])
            check(rec["converged"] is True, f"{label}: not converged")
            check(rec["true_relres"] <= 1e-10,
                  f"{label}: true_relres {rec['true_relres']:.3e} > 1e-10")
            ran = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
            for k in expect[label]:
                check(ran[k] > 0, f"{label}: kernel {k} never launched")
            jax_it, jax_passes = JAX_CPU_ITERS[label]
            print(f"main path {label}: n={rec['n']} nnz={rec['nnz']} "
                  f"iters={rec['iters']} passes={rec['refine_passes']} "
                  f"(JAX on CPU, ELL layout: {jax_it}/{jax_passes}) "
                  f"true_relres={rec['true_relres']:.3e} "
                  f"setup_s={rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
                  f"first_call_s={rec['first_call_s']:.3f} "
                  f"write_s={write_s:.2f} cli_wall_s={wall_s:.2f} "
                  f"launches={ran}")
            print(f"  csv: {out[1]}")
    return dict(LAUNCHES)


def reset_counts() -> None:
    from lsbench_tpu_torch.ops import interp_well, spmv_bsr
    spmv_bsr.reset_launches()
    interp_well.reset_launches()


def read_counts() -> dict:
    from lsbench_tpu_torch.ops import interp_well, spmv_bsr
    return {**spmv_bsr.LAUNCHES, **interp_well.LAUNCHES}


def _op_summary(op) -> str:
    import torch
    if isinstance(op, torch.Tensor):
        return f"dense {op.numel() * op.element_size()} B"
    kind = type(op).__name__
    extra = (f" k8={op.k8} k_real={op.k_real} J={op.j_blocks}"
             if kind == "WindowEll" else "")
    return f"{kind}{extra} {op.bytes_streamed} B"


def well_launch_ms(op, x, launches: int = 200) -> float:
    """Device time of one K4 launch: CUDA events around `launches`
    back-to-back launches of the kernel alone (no x-table fill, no wrapper
    checks), so the host's per-call cost does not show as card idle."""
    import torch

    from lsbench_tpu_torch.ops import _cuda, interp_well
    lib = _cuda.library("well_spmv")
    xt = interp_well._x_table(op, x)
    y = torch.empty(op.n_pad, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    args = (op.vals.data_ptr(), op.lcols.data_ptr(), op.w0.data_ptr(),
            xt.data_ptr(), y.data_ptr(), op.n_pad, op.k_real, stream)
    _cuda.check(lib.lsb_spmv_well_f32(*args), "spmv_well_f32")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        lib.lsb_spmv_well_f32(*args)
    end.record()
    end.synchronize()
    _cuda.check(lib.lsb_spmv_well_f32(*args), "spmv_well_f32")
    return start.elapsed_time(end) / launches


def amg_kernel_phase(A) -> dict:
    """K4 against its plain version and the host f64 matvec on every
    window-ELL operator of the amg_classical hierarchy of RCM-ordered
    poisson_2d(512). Returns {max_abs_err, ms, plain_ms, shape} with the
    times of the level-0 P."""
    import torch

    from lsbench_tpu_torch.ops.interp_well import (WindowEll, spmv_well,
                                                   spmv_well_plain)
    from lsbench_tpu_torch.ordering import rcm_ordering
    from lsbench_tpu_torch.solvers import amg
    from lsbench_tpu_torch.solvers.preconditioners import AMG_CLASSICAL

    dev = torch.device("cuda")
    P = A.permuted(rcm_ordering(A))
    opts = amg.AmgOptions(**AMG_CLASSICAL)
    t0 = time.perf_counter()
    mats, coarse = amg.build_matrix_hierarchy(P, opts)
    host_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params, _, _ = amg.device_hierarchy(mats, coarse, opts, torch.float32,
                                        "bsr", dev)
    torch.cuda.synchronize()
    print(f"amg hierarchy poisson_2d(512) RCM amg_classical: {len(mats) + 1} "
          f"levels, host {host_s:.2f} s, device layouts "
          f"{time.perf_counter() - t0:.2f} s, coarse n={coarse.nrows}")

    result = {"max_abs_err": 0.0}
    rng = np.random.default_rng(1)
    n_well = 0
    for lvl, (m, lp) in enumerate(zip(mats, params)):
        print(f"  level {lvl}: n={m['A'].nrows} nnz(A)={m['A'].nnz} "
              + " ".join(f"{k.upper()}=[{_op_summary(lp[k])}]"
                         for k in ("a", "p", "r")))
        for key in ("a", "p", "r"):
            op = lp[key]
            if not isinstance(op, WindowEll):
                continue
            M = m[key.upper()]
            x_np = rng.standard_normal(M.ncols)
            x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
            y_k = spmv_well(op, x)
            y_p = spmv_well_plain(op, x)
            torch.cuda.synchronize()
            label = f"level {lvl} {key.upper()} ({M.nrows}x{M.ncols})"
            check(y_k.shape == (M.nrows,) and bool(torch.isfinite(y_k).all()),
                  f"spmv_well_f32 [{label}]: bad output")
            err = float((y_k - y_p).abs().max())
            tol = 1e-5 * float(y_p.abs().max())
            check(err <= tol, f"spmv_well_f32 [{label}]: max|kernel - plain| "
                              f"= {err:.3e} > {tol:.3e}")
            y_host = M.matvec(x_np)
            host_err = float(np.abs(y_k.double().cpu().numpy() - y_host).max())
            host_tol = 2e-5 * float(np.abs(y_host).max())
            check(host_err <= host_tol,
                  f"spmv_well_f32 [{label}]: max|kernel - host f64| = "
                  f"{host_err:.3e} > {host_tol:.3e}")
            ms = median_ms(lambda: spmv_well(op, x))
            plain_ms = median_ms(lambda: spmv_well_plain(op, x))
            launch_ms = well_launch_ms(op, x)
            nbytes = op.bytes_streamed
            print(f"kernel spmv_well_f32 [{label}]: max_abs_err={err:.3e} "
                  f"(tol {tol:.3e}) host_err={host_err:.3e} wrapper "
                  f"{ms:.4f} ms, kernel alone {launch_ms:.4f} ms "
                  f"({nbytes / launch_ms / 1e6:.1f} GB/s of {nbytes} B), "
                  f"plain {plain_ms:.4f} ms")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            n_well += 1
            if lvl == 0 and key == "p":
                b_ms, b_by = bound(
                    4 * (op.vals.numel() + op.lcols.numel() + op.w0.numel()
                         + M.ncols + M.nrows), 2 * op.vals.numel(), "f32")
                lib = library_ms(M, torch.float32, x)
                result.update(ms=ms, plain_ms=plain_ms, launch_ms=launch_ms,
                              shape=f"poisson_2d(512) RCM amg_classical "
                                    f"{label}, k8={op.k8} "
                                    f"k_real={op.k_real} J={op.j_blocks}",
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib)
                print(f"  bound {b_ms:.4f} ms ({b_by}), CSR bound "
                      f"{csr_bound_ms(M, 4):.4f} ms, cuSPARSE "
                      f"{lib:.4f} ms")
    check("ms" in result, "level-0 P is not window-ELL")
    print(f"  {n_well} window-ELL operators checked")
    del params
    torch.cuda.empty_cache()
    return result


def cli_path(label: str, fname: str, argv: list[str]):
    """Run the CLI once; return (record, launch counts of this run, wall s).
    Counters are set to 0 just before the run and read just after."""
    from lsbench_tpu_torch.harness.bench import BenchRecord
    from lsbench_tpu_torch.harness.cli import main as cli_main

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["--matrix", fname, *argv])
    wall_s = time.perf_counter() - t0
    ran = read_counts()
    out = buf.getvalue().splitlines()
    check(rc == 0, f"{label}: CLI exited {rc}")
    check(len(out) == 3 and out[0] == BenchRecord.CSV_HEADER
          and out[1].startswith(fname + ","),
          f"{label}: unexpected CLI output {out[:2]}")
    print(f"  csv: {out[1]}")
    return json.loads(out[2]), ran, wall_s


def amg_paths_phase(tmp: str, A512, A128) -> list[dict]:
    """The AMG-CG-IR path and the hypre path through the CLI; returns each
    path's launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    f512 = os.path.join(tmp, "poisson_512.txt")
    f128 = os.path.join(tmp, "poisson_128.txt")
    write_matrix(A512, f512)
    write_matrix(A128, f128)
    counts = []

    t0 = time.perf_counter()
    rec, ran, wall = cli_path(
        "amg-cg-ir", f512, ["--solver", "cg_ir", "--precond", "amg_classical",
                            "--ordering", "rcm", "--rtol", "1e-10",
                            "--trials", "2", "--warmups", "1", "--json"])
    check(rec["converged"] is True, "amg-cg-ir: not converged")
    check(rec["true_relres"] <= 1e-10,
          f"amg-cg-ir: true_relres {rec['true_relres']:.3e} > 1e-10")
    for k in ("bsr_classed_f32", "bsr_f32", "well_f32", "bsr_f64acc"):
        check(ran[k] > 0, f"amg-cg-ir: kernel {k} never launched")
    bd = rec["setup_breakdown"]
    print(f"amg-cg-ir path poisson_2d(512): iters={rec['iters']} "
          f"passes={rec['refine_passes']} "
          f"true_relres={rec['true_relres']:.3e} setup_s={rec['setup_s']:.3f}"
          f" (hierarchy as precond_s={bd['precond_s']:.3f}, ordering_s="
          f"{bd['ordering_s']:.3f}, layout_s={bd['layout_s']:.3f}) "
          f"solve_s={rec['solve_s']:.4f} first_call_s="
          f"{rec['first_call_s']:.3f} cli_wall_s={wall:.2f} launches={ran} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    t0 = time.perf_counter()
    hypre = ["--solver", "hypre", "--trials", "2", "--warmups", "1", "--json"]
    rec, ran, wall = cli_path("hypre", f512, hypre)
    check(rec["precision"] == "fp64(fp32_cycles_auto)",
          f"hypre: precision {rec['precision']}")
    check(bool(np.isfinite(rec["true_relres"])) and rec["true_relres"] < 1,
          f"hypre: true_relres {rec['true_relres']}")
    for k in ("well_f32", "bsr_f32"):
        check(ran[k] > 0, f"hypre: kernel {k} never launched")
    print(f"hypre path poisson_2d(512): cycles={rec['iters']} "
          f"levels={rec['levels']} relres={rec['relres']:.4e} "
          f"true_relres={rec['true_relres']:.4e} "
          f"setup_s={rec['setup_s']:.3f} (hierarchy_s="
          f"{rec['setup_breakdown']['hierarchy_s']:.3f}) "
          f"solve_s={rec['solve_s']:.4f} first_call_s="
          f"{rec['first_call_s']:.3f} cli_wall_s={wall:.2f} launches={ran} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    t0 = time.perf_counter()
    small = ["--solver", "hypre", "--trials", "1", "--warmups", "1", "--json"]
    rec_dev, ran, _ = cli_path("hypre 128 cuda", f128, small)
    counts.append(ran)
    rec_cpu, ran_cpu, _ = cli_path("hypre 128 cpu", f128,
                                   small + ["--platform", "cpu"])
    check(sum(ran_cpu.values()) == 0, f"--platform cpu launched {ran_cpu}")
    a, b = rec_dev["true_relres"], rec_cpu["true_relres"]
    check(abs(a - b) <= 1e-3 * abs(b),
          f"hypre poisson_2d(128): card {a:.6e} vs plain {b:.6e}")
    print(f"hypre poisson_2d(128): true_relres card {a:.6e} plain (cpu) "
          f"{b:.6e} rel diff {abs(a - b) / abs(b):.2e} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    return counts


def multi_rhs_paths_phase(tmp: str, matrices, A128) -> list[dict]:
    """Block CG and batched BiCGSTAB (`--nrhs 8`), one-RHS ginkgo, and
    block CG on the card against `--platform cpu`; returns each path's
    launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix
    from lsbench_tpu_torch.solvers.batched_bicgstab import (
        BatchedBicgstabSolver)

    files = {}
    for label, A in (*matrices.items(), ("poisson_2d(128)", A128)):
        files[label] = os.path.join(tmp, label.split("(")[0]
                                    + f"_{A.nrows}.txt")
        write_matrix(A, files[label])
    counts = []
    block = ["--solver", "cg", "--nrhs", "8", "--ordering", "rcm", "--rtol",
             "1e-10", "--trials", "1", "--warmups", "1", "--json"]
    for label in matrices:
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(f"block-cg {label}", files[label], block)
        check(rec["solver"] == "block_cg" and rec["nrhs"] == 8,
              f"block-cg {label}: solver {rec['solver']} nrhs "
              f"{rec.get('nrhs')}")
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"block-cg {label}: converged {rec['converged']} true_relres "
              f"{rec['true_relres']:.3e}")
        for k in ("bsr_mm_f32", "bsr_f64acc"):
            check(ran[k] > 0, f"block-cg {label}: kernel {k} never launched")
        print(f"block-cg path {label} (--nrhs 8): block iters={rec['iters']}"
              f" passes={rec['refine_passes']} method={rec['method']} "
              f"precision={rec['precision']} "
              f"true_relres={rec['true_relres']:.3e} "
              f"setup_s={rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
              f"per-RHS ms={rec['solve_s'] / 8 * 1e3:.3f} "
              f"first_call_s={rec['first_call_s']:.3f} cli_wall_s={wall:.2f} "
              f"launches={ran} phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)

    t0 = time.perf_counter()
    label = "poisson_2d(512)"
    rec, ran, wall = cli_path(
        "ginkgo --nrhs 8", files[label],
        ["--solver", "ginkgo", "--nrhs", "8", "--ordering", "rcm",
         "--trials", "1", "--warmups", "1", "--json"])
    check(rec["solver"] == "batched_bicgstab" and rec["nrhs"] == 8,
          f"ginkgo --nrhs 8: solver {rec['solver']}")
    check(rec["converged"] is True and rec["true_relres"] <= 1e-4,
          f"ginkgo --nrhs 8: true_relres {rec['true_relres']:.3e}")
    check(ran["bsr_mm_f32"] > 0, "ginkgo --nrhs 8: K3 never launched")
    max_refine = inspect.signature(BatchedBicgstabSolver).parameters[
        "max_refine"].default
    print(f"ginkgo path {label} (--nrhs 8, batched BiCGSTAB): "
          f"iters={rec['iters']} passes={rec['refine_passes']} of "
          f"max_refine={max_refine} "
          f"true_relres={rec['true_relres']:.3e} setup_s={rec['setup_s']:.3f}"
          f" solve_s={rec['solve_s']:.4f} per-RHS ms="
          f"{rec['solve_s'] / 8 * 1e3:.3f} cli_wall_s={wall:.2f} "
          f"launches={ran} phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    t0 = time.perf_counter()
    label = "random_spd(6408,23)"
    rec, ran, wall = cli_path(
        "ginkgo", files[label], ["--solver", "ginkgo", "--ordering", "rcm",
                                 "--trials", "2", "--warmups", "1", "--json"])
    check(rec["precision"] == "fp64(fp32_ir_auto)",
          f"ginkgo: precision {rec['precision']}")
    check(rec["converged"] is True and rec["true_relres"] <= 1e-4,
          f"ginkgo: true_relres {rec['true_relres']:.3e}")
    check(ran["bsr_f32"] + ran["bsr_classed_f32"] > 0 and ran["bsr_f64acc"] > 0,
          f"ginkgo: kernels {ran}")
    print(f"ginkgo path {label} (one RHS, bicgstab_ir): iters={rec['iters']}"
          f" passes={rec['refine_passes']} precision={rec['precision']} "
          f"true_relres={rec['true_relres']:.3e} solve_s={rec['solve_s']:.5f}"
          f" launches={ran} phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    t0 = time.perf_counter()
    small = ["--solver", "cg", "--nrhs", "4", "--ordering", "rcm", "--rtol",
             "1e-10", "--trials", "1", "--warmups", "1", "--json"]
    f128 = files["poisson_2d(128)"]
    rec_dev, ran, _ = cli_path("block-cg 128 cuda", f128, small)
    counts.append(ran)
    rec_cpu, ran_cpu, _ = cli_path("block-cg 128 cpu", f128,
                                   small + ["--platform", "cpu"])
    check(sum(ran_cpu.values()) == 0, f"--platform cpu launched {ran_cpu}")
    for where, rec in (("card", rec_dev), ("cpu", rec_cpu)):
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"block-cg poisson_2d(128) {where}: true_relres "
              f"{rec['true_relres']:.3e}")
    a, b = rec_dev["iters"], rec_cpu["iters"]
    check(abs(a - b) <= max(3, 0.1 * b),
          f"block-cg poisson_2d(128): {a} block iterations on the card, "
          f"{b} with the plain versions")
    print(f"block-cg poisson_2d(128) --nrhs 4: card {a} block iters / "
          f"{rec_dev['refine_passes']} passes, true_relres "
          f"{rec_dev['true_relres']:.3e}; plain (cpu) {b} / "
          f"{rec_cpu['refine_passes']}, {rec_cpu['true_relres']:.3e} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    return counts


def variant_kernels_phase(matrices) -> tuple[dict, dict]:
    """K6, K7 and K8 on the RCM layouts of both matrices. Returns the record
    entries (times at poisson_2d(512)) and the launch counts of the API
    path: one call of each public entry per matrix, counters set to 0 just
    before and read just after."""
    import torch

    from lsbench_tpu_torch.matrix.bsr import BsrCompact, BsrMatrix
    from lsbench_tpu_torch.ops import spmv_bsr as ops
    from lsbench_tpu_torch.ordering import rcm_ordering

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    layouts = {}
    for label, A in matrices.items():
        P = A.permuted(rcm_ordering(A))
        t0 = time.perf_counter()
        B = BsrMatrix.from_csr(P, device=dev, with_sel=True)
        C = BsrCompact.from_csr(P, device=dev)
        torch.cuda.synchronize()
        x_np = rng.standard_normal(P.ncols)
        layouts[label] = (P, B, C, x_np, torch.as_tensor(
            x_np, dtype=torch.float32, device=dev))
        print(f"variant layouts {label} RCM: uniform G={B.n_groups} "
              f"S={B.slots} C={B.n_col_blocks} ({B.bytes_streamed} B blocks,"
              f" {B.sel.numel() * 4} B selector), exact T={C.n_blocks} "
              f"({C.bytes_streamed} B) built in "
              f"{time.perf_counter() - t0:.2f} s")

    entries = {  # kernel → (public entry, plain version, layout index)
        "spmv_bsr_compact_f32": (ops.spmv_bsr_compact,
                                 ops.spmv_bsr_compact_plain, 2),
        "spmv_bsr_selector_f32": (
            lambda B, x: ops.spmv_bsr(B, x, variant="selector"),
            ops.spmv_bsr_selector_plain, 1),
        "spmv_bsr_onehot_f32": (
            lambda B, x: ops.spmv_bsr(B, x, variant="onehot"),
            ops.spmv_bsr_onehot_plain, 1),
    }
    reset_counts()
    api_out = {(label, name): fn(lay[idx], lay[4])
               for label, lay in layouts.items()
               for name, (fn, _, idx) in entries.items()}
    torch.cuda.synchronize()
    api_counts = read_counts()
    for name in entries:
        check(api_counts[KERNELS[name][0]] == len(layouts),
              f"{name}: API path launches {api_counts}")
    host_errs = {}
    for (label, name), y in api_out.items():
        P, x_np = layouts[label][0], layouts[label][3]
        y_host = P.matvec(x_np)
        check(y.shape == (P.nrows,) and bool(torch.isfinite(y).all()),
              f"{name} [{label}]: bad output")
        host_err = float(np.abs(y.double().cpu().numpy() - y_host).max())
        host_tol = 2e-5 * float(np.abs(y_host).max())
        check(host_err <= host_tol, f"{name} [{label}]: max|kernel - host "
                                    f"f64| = {host_err:.3e} > {host_tol:.3e}")
        host_errs[label, name] = host_err
    del api_out
    print(f"spmv variants API path: launches={api_counts}")

    results = {}
    for label, (P, B, C, x_np, x) in layouts.items():
        lib = library_ms(P, torch.float32, x)
        sel_bytes = B.sel.numel() * 4
        io_bytes = (P.ncols + P.nrows) * 4
        # Each function's bytes: the arrays its kernel reads, x read and y
        # written once; 2 flops per stored block element (the gathers are
        # exact selections, not products).
        work = {
            "spmv_bsr_compact_f32": (
                C.bytes_streamed + 4 * (C.bcols.numel() + C.goff.numel()),
                C.blocks.numel(), "compact"),
            "spmv_bsr_selector_f32": (B.bytes_streamed + sel_bytes,
                                      B.blocks.numel(), "uniform + selector"),
            "spmv_bsr_onehot_f32": (B.bytes_streamed
                                    + 4 * B.block_cols.numel(),
                                    B.blocks.numel(), "uniform"),
        }
        for name, (fn, plain, idx) in entries.items():
            op = (P, B, C)[idx]
            y_k, y_p = fn(op, x), plain(op, x)
            torch.cuda.synchronize()
            scale = float(y_p.abs().max())
            err = float((y_k - y_p).abs().max())
            tol = 1e-5 * scale
            check(err <= tol, f"{name} [{label}]: max|kernel - plain| = "
                              f"{err:.3e} > {tol:.3e}")
            nbytes, elems, kind = work[name]
            ms = median_ms(lambda: fn(op, x))
            plain_ms = median_ms(lambda: plain(op, x))
            b_ms, b_by = bound(nbytes + io_bytes, 2 * elems, "f32")
            print(f"kernel {name} [{label} RCM {kind}]: max_abs_err="
                  f"{err:.3e} (tol {tol:.3e}) host_err="
                  f"{host_errs[label, name]:.3e} kernel {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes} B) plain "
                  f"{plain_ms:.4f} ms")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            print(f"  bound {b_ms:.4f} ms ({b_by}), CSR bound "
                  f"{csr_bound_ms(P, 4):.4f} ms, cuSPARSE {lib:.4f} ms")
            if label == "poisson_2d(512)":
                entry.update(ms=ms, plain_ms=plain_ms,
                             shape=f"{label} RCM {kind}", bound_ms=b_ms,
                             bound_by=b_by, library_ms=lib)
    del layouts
    torch.cuda.empty_cache()
    return results, api_counts


def layout_paths_phase(tmp: str, matrices) -> list[dict]:
    """The XLA-only layouts through the CLI: `cg_ir --opt layout=ell` on
    poisson_2d(512) and fp64 `cg --opt layout=bsr_xla` on
    random_spd(6408, 23); returns each path's launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    counts = []
    runs = (("poisson_2d(512)", ["--solver", "cg_ir", "--ordering", "rcm",
                                 "--opt", "layout=ell"]),
            ("random_spd(6408,23)", ["--solver", "cg", "--opt",
                                     "layout=bsr_xla"]))
    for label, argv in runs:
        t0 = time.perf_counter()
        fname = os.path.join(tmp, label.split("(")[0] + "_layout.txt")
        write_matrix(matrices[label], fname)
        rec, ran, wall = cli_path(
            f"{argv[1]} {argv[-1]} {label}", fname,
            [*argv, "--rtol", "1e-10", "--trials", "1", "--warmups", "1",
             "--json"])
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"{argv[-1]} {label}: converged {rec['converged']} "
              f"true_relres {rec['true_relres']:.3e}")
        if argv[-1] == "layout=ell":
            check(ran["bsr_f64acc"] > 0, f"{label}: K2 never launched")
            check(ran["bsr_f32"] == ran["bsr_classed_f32"] == 0,
                  f"{label}: K1/K5 launched with the ELL layout: {ran}")
        print(f"{argv[1]} --opt {argv[-1]} path {label}: "
              f"iters={rec['iters']} passes={rec.get('refine_passes')} "
              f"precision={rec['precision']} "
              f"true_relres={rec['true_relres']:.3e} "
              f"setup_s={rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
              f"cli_wall_s={wall:.2f} launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import lsbench_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    card = card_line()
    print(f"card: {card}  torch {torch.__version__} cuda {torch.version.cuda}")
    print(f"build: {build_kernels():.2f} s")

    matrices = main_path_matrices()
    t0 = time.perf_counter()
    measured = kernel_phase(matrices)
    print(f"phase kernels: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    path_counts = [main_path_phase(matrices)]
    print(f"phase cg_ir paths: {time.perf_counter() - t0:.2f} s")

    from lsbench_tpu_torch.matrix.generate import poisson_2d
    t0 = time.perf_counter()
    measured["spmv_well_f32"] = amg_kernel_phase(matrices["poisson_2d(512)"])
    print(f"phase amg kernel: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += amg_paths_phase(tmp, matrices["poisson_2d(512)"],
                                       poisson_2d(128))
    print(f"phase amg paths: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += multi_rhs_paths_phase(tmp, matrices, poisson_2d(128))
    print(f"phase multi-rhs paths: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    variants, api_counts = variant_kernels_phase(matrices)
    measured.update(variants)
    path_counts.append(api_counts)
    print(f"phase spmv variants: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += layout_paths_phase(tmp, matrices)
    print(f"phase layout paths: {time.perf_counter() - t0:.2f} s")
    check(len(path_counts) == len(PATHS), "one launch count per path")

    kernels = []
    for name, (counter, source, replaces) in KERNELS.items():
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces,
                        "launches": sum(c.get(counter, 0) for c in path_counts),
                        "launches_by_path": [c.get(counter, 0)
                                             for c in path_counts],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
                        "bound_by": m["bound_by"],
                        "library_ms": m["library_ms"], "shape": m["shape"],
                        **({"kernel_alone_ms": m["launch_ms"]}
                           if "launch_ms" in m else {})})
    print("paths: " + json.dumps(PATHS))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
