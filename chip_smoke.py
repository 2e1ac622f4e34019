#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lsbench_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Print the card's name and power limit (nvidia-smi), build the BSR SpMV
   kernels from `lsbench_tpu_torch/csrc/` with nvcc and print the build time.
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

The last two lines are the per-kernel JSON record and
`{"ok": true, "device": {...}}`. Without a CUDA device it prints no result
and exits 1. Nothing here imports JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SOURCE = "lsbench_tpu_torch/csrc/bsr_spmv.cu"
# Kernel name → (launch counter, TPU kernel it replaces).
KERNELS = {
    "spmv_bsr_f32": ("bsr_f32", "lsbench_tpu/ops/spmv_pallas.py:47"),
    "spmv_bsr_classed_f32": ("bsr_classed_f32",
                             "lsbench_tpu/ops/spmv_pallas.py:187"),
    "spmv_bsr_f64acc": ("bsr_f64acc", "lsbench_tpu/ops/spmv_pallas.py:396"),
}
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
    log = _cuda.build()
    _cuda.library()
    seconds = time.perf_counter() - t0
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
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
    # The shape each kernel runs at on the main path (reported in the JSON).
    main_shape = {"spmv_bsr_classed_f32": "poisson_2d(512) RCM classed",
                  "spmv_bsr_f32": "random_spd(6408,23) RCM uniform",
                  "spmv_bsr_f64acc": "poisson_2d(512) RCM df64"}

    results = {}
    rng = np.random.default_rng(0)
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
            entry.update(ms=ms, plain_ms=plain_ms, shape=shape)
    del p_cls, p_uni, p_64, r_uni, r_lo
    torch.cuda.empty_cache()
    return results


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
    measured = kernel_phase(matrices)
    launches = main_path_phase(matrices)

    kernels = []
    for name, (counter, replaces) in KERNELS.items():
        m = measured[name]
        kernels.append({"name": name, "route": "cuda", "source": SOURCE,
                        "replaces": replaces, "launches": launches[counter],
                        "max_abs_err": m["max_abs_err"], "ms": m["ms"],
                        "plain_ms": m["plain_ms"], "shape": m["shape"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
