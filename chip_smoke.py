#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`lsbench_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code 1) on failure:

1. Print the card's name, power limit and driver version (nvidia-smi),
   build the kernels from `lsbench_tpu_torch/csrc/*.cu` (one nvcc per
   source, all started together) and print the build time.
2. Kernels: on the main path's layouts (RCM-ordered poisson_2d(512),
   n=262,144, class-padded and uniform; RCM-ordered random_spd(6408, 23),
   uniform) compare each kernel with its plain PyTorch version on the same
   CUDA tensors — f32 kernels within 1e-5·max|y|, the f64-accurate kernel
   within 1e-13·max|y| and within 5e-13·max|y| of the host f64 CSR matvec —
   and print the median CUDA-event time of both with the bytes streamed.
3. Main path: write each matrix to a file and run the port's CLI on it
   (`cg_ir`, RCM, rtol 1e-10, 2 trials, 1 warmup, `--roofline`, which
   phase 18 checks); check the reference CSV,
   convergence, the independent host f64 residual, and that the launch
   counters show each kernel of that path ran (on both matrices the SELL
   f32 and f64 kernels) and the BSR K1, K5 and K2 did not; print the peak
   device memory.
4. AMG kernels: build the `amg_classical` hierarchy of RCM-ordered
   poisson_2d(512) once and compare the window-ELL kernel (K4) with its
   plain version (within 1e-5·max|y|) and with the host f64 CSR matvec
   (within 2e-5·max|y|) on every operator laid out as window-ELL, with the
   median CUDA-event times of the wrapper and the plain version, and the
   device time of the kernel alone over back-to-back launches, each beside
   the SELL f32 kernel's wrapper and kernel-alone times on the same
   operator and x; likewise
   the SELL f32 kernel (the redesigned K1) on every operator laid out as
   SELL, rectangular transfers included, with its times, bound and
   cuSPARSE's on the level-1 A.
5. AMG-CG-IR path: the CLI with `cg_ir --precond amg_classical --ordering
   rcm --rtol 1e-10 --cache-dir` on poisson_2d(512), the setup cache's
   miss (`hier_cache` "miss"); it must converge to true relres ≤ 1e-10
   through the SELL f32 kernel, K4 and the SELL f64 kernel, with no K1
   launch.
6. Fixed-cycle backend path: the CLI with `--solver hypre` (2 V-cycles) on
   poisson_2d(512): the record must say `fp64(fp32_cycles_auto)`, K4 and
   the SELL f32 kernel must run (K1 not), the true relres must be finite
   and below 1. Then the same
   solve of poisson_2d(128) on the card and with `--platform cpu` (the
   plain versions): the two true relres agree to 1e-3 relative.
7. Multi-RHS kernels (in phase 2): the SELL SpMM `spmm_sell` (the
   redesigned K3, the solver paths' SpMM) on the RCM SELL layouts and the
   BSR `spmm_bsr` (K3's port, ops API) on the uniform layouts of RCM
   poisson_2d(512) and random_spd(6408, 23) for k in {1, 3, 8, 16}, each
   column within 1e-5·max|Y_j| of the plain version and 2e-5·max|Y_j| of
   the host f64 CSR product; the SELL SpMM also bitwise repeatable and
   each column bit for bit `spmv_sell` on that column. Times: the
   wrapper's median CUDA-event time, its host time per call, the kernel
   alone, the profiler's device time L2-warm and L2-cold, the function's
   bound, the layout's bound and cuSPARSE's SpMM.
8. Multi-RHS paths through the CLI: `--solver cg --nrhs 8` (block CG, rtol
   1e-10, RCM) on both matrices and `--solver ginkgo --nrhs 8` (batched
   BiCGSTAB) on poisson_2d(512), each through the SELL SpMM and the SELL
   f64 kernel with no BSR SpMM launch, one-RHS `--solver ginkgo`
   (bicgstab_ir, `fp64(fp32_ir_auto)`, SELL f32 and f64) on
   random_spd(6408, 23);
   then `--solver cg --nrhs 4` on poisson_2d(128) on the card and with
   `--platform cpu`: both reach 1e-10 within max(3, 10%) block iterations
   of each other, and the CPU run launches nothing.
9. Alternate SpMV kernels K6 (exact-block `spmv_bsr_compact`), K7
   (`spmv_bsr(variant="selector")`) and K8 (`variant="onehot"`), which no
   solver path runs. Each runs the SELL f32 kernel over its layout's
   packed form (K6: `BsrCompact.packed`; K7 and K8: the uniform layout's
   for their gather rule), built once per layout (`pack_ms`, first and
   again). First their API path (each public entry called once on RCM
   poisson_2d(512) and random_spd(6408, 23), each result within
   2e-5·max|y| of the host f64 CSR matvec, none counted as `sell_f32`),
   then each kernel against its plain version (within 1e-5·max|y|) with
   the median CUDA-event times, bounds and cuSPARSE's time; each also bit
   for bit `spmv_sell` on `SellMatrix.from_csr` of the same matrix,
   bitwise repeatable, one SELL kernel and no other device work per call
   (profiler), with its host ms per call, profiler device ms L2-warm and
   L2-cold beside `spmv_sell`'s on the same operator, the packed layout's
   bytes and bound and the dense design's. The 1.34 GB selector is freed
   after it.
10. The XLA-only layouts through the CLI: `cg_ir --opt layout=ell` on
   poisson_2d(512) (true relres ≤ 1e-10 through the f64 SELL product, with
   no K1, K5 or SELL f32 launch) and fp64 `cg --opt layout=bsr_xla` on
   random_spd(6408, 23) (≤ 1e-10).
11. Sliced-ELL kernels (in phase 2): `spmv_sell` (f32) and `spmv_sell_f64`,
   which replace K5 and K2 on every solver path, on the RCM SELL layouts
   of both matrices: each within 1e-5·max|y| (f32) or 1e-13·max|y| (f64)
   of its plain version, the f64 one also within 1e-13·max|y| of the host
   f64 CSR matvec, bitwise repeatable, with the wrapper's median
   CUDA-event time, the kernel alone over back-to-back launches, bytes,
   bound and cuSPARSE's time (random_spd's row is K1's operator). Since
   no solver path runs the BSR K1, K5, K2 and K3, phase 2 also drives
   their public entries once (the "bsr K1/classed/df64/mm API" path), each
   result within 5e-13·max|y| (K2) or 2e-5·max|y| (K1, K5, K3 per column)
   of the host f64 product.
12. Direct solvers through the CLI, each to true relres ≤ 1e-10: no
   `--solver` (the reference's default, `cholmod`) and `--solver cusolver`
   on random_spd(6408, 23) (`fp64(fp32_ir_auto)`, through the SELL f64
   kernel); `cholmod --ordering amd` on poisson_2d(512), delegated to the
   sparse host schedule, which launches nothing; `sparse_cholesky --opt
   schedule=block --ordering amd` on poisson_2d(512) (f32 blocked sweeps
   on the card refined through the SELL f64 kernel; blocks and levels):
   both read the AMD ordering and factor from the cache phase 18 filled; `cholmod --nrhs 8` on
   random_spd(6408, 23) (worst column); `cholmod` on poisson_2d(64) on the
   card and with `--platform cpu`: the same refinement passes, no launch
   on the CPU run.
13. Native FP64 against f32 + refinement for the dense direct path on
   random_spd(6408, 23) (not a path: nothing on the main path runs the f64
   factor): `torch.linalg.cholesky` in f64, two f64 triangular solves and
   two refinement passes, against `cholesky_ir` factor-once and refactor;
   true relres, factor and solve seconds of each.
14. GMRES and the block-Jacobi and Chebyshev preconditioners through the
   CLI, RCM, at full width: `gmres --precond amg_classical` on
   poisson_2d(512) (fp64, delegated to gmres_ir: `fp64(fp32_ir_auto)`,
   through the SELL f32 kernel, K4 and the SELL f64 kernel), `gmres` on
   random_spd(6408, 23) (Jacobi, `fp64(fp32_ir_auto)`), the same at
   `--precision fp32` (f32 GMRES on the SELL f32 kernel, held to its rtol
   1e-5, no f64 launch), and `cg_ir --precond chebyshev` and `--precond
   block_jacobi` on poisson_2d(512); each to true relres ≤ 1e-10 (the
   fp32 one ≤ 1e-5), with no BSR kernel launch.
15. Native FP64 GMRES against `gmres_ir` on RCM random_spd(6408, 23)
   (not a path: fp64 `gmres` delegates to `gmres_ir`): `gmres_loop` in
   f64 on `spmv_sell_f64`, true relres, inner iterations and solve
   seconds of each.
16. The triangular-sweep kernels (`tri_sweep_f32`, `tri_sweep_f64`: the
   one-CTA run and pair kernels and the wide-level kernel, which also runs
   a run's pre-pass; one launch per segment of a sweep's plan, all from
   one call) against their plain version (the JAX package's
   `_sweep` in torch ops) on the IC(0) factor of RCM poisson_2d(512) and
   the AMD sparse Cholesky factor of poisson_2d(512), in f32 and f64, and
   on the IC(0) factor of RCM random_spd(6408, 23) in f64: each sweep
   within 1e-5·max|x| (f32) or 1e-12·max|x| (f64), one launch per
   segment, bitwise repeatable, the apply within 1e-4 (f32) or 1e-12 (f64)
   of the host's f64 `spchol.tri_solve`; k = 8 columns in one launch per
   segment, bitwise repeatable, each column within the same tolerance of
   its k = 1 sweep; a forced capacity (256 rows on IC(0) of
   poisson_2d(512) in f32, 64 on IC(0) of random_spd in f64) so that runs
   and wide levels both run on the card, against the plain version;
   levels, launches per sweep, ms per sweep (k = 1 and k = 8) and per
   apply, µs per level, the kernels' own device ms per sweep (profiler:
   the events' summed durations, none where the trace lost one),
   the plain version's ms, the bytes bound, cuSPARSE's SpSV
   (`torch.triangular_solve` with a sparse CSR L, or why it is refused)
   and the host solve's ms; then the chain floor: a bidiagonal L, n =
   4096, one row per level, one launch of the pair kernel, its µs per
   level beside its bytes bound.
17. The slice-10 paths through the CLI, each to true relres ≤ 1e-10: `cg_ir
   --precond ic0` (RCM) on poisson_2d(512) (`tri_sweep_f32`, SELL f32 and
   f64), fp64 `cg --precond ic0` (RCM) on random_spd(6408, 23)
   (`tri_sweep_f64`, SELL f64), `sparse_cholesky --opt schedule=level
   --ordering amd` on poisson_2d(512) (`tri_sweep_f32`, SELL f64; its
   factor from phase 18's cache) and
   `cholesky_band` (RCM) on both matrices (SELL f64, no sweep launch); the
   n=262k runs with one trial and one warm-up.
18. The harness slice (run right after phase 6; its paths listed last):
   the setup cache on poisson_2d(512), `cg_ir --precond amg_classical`
   RCM: the exact hit of phase 5's entry (`exact_hit`, the miss's
   iterations and true relres); a same-pattern re-assembly A2 = D·A·D
   (d = 1 + 0.5·ix/511 at grid point (ix, iy)) written as a file, a
   pattern hit (`pattern_hit_device_rap`, ≤ 1e-10, `rap_device_s`, peak
   device memory, the plans' bytes and triples) beside the same solve
   without the cache (a full rebuild); the refreshed level-1 operator
   within 1e-12 relative of the host `rap(P0ᵀ, A2, P0)` and a second
   refresh bitwise equal; phase 3's `--roofline` records of both matrices
   (shares of 3350 GB/s in (0, 1.05], `spmv_s` within 1.5× of the
   profiled L2-cold SELL f32 kernel on the same operator); `cg_ir
   --profile-dir` on random_spd(6408, 23) (the trace holds
   `spmv_sell_f32_kernel`); `--debug-nans`: `spmv_sell` on a NaN x raises
   on the card and passes the NaN when off, and `cg_ir --debug-nans` on
   poisson_2d(512) takes phase 3's iterations (both solve_s printed); the
   sparse Cholesky factor (`sparse_cholesky --ordering amd` through the
   solver API on the file the CLI reads): a miss, then a hit with the same
   x bit for bit, into the cache phases 12 and 17 read.
19. Distributed paths (`parallel/`, run first, right after the build and
   before any torch.profiler session, which would leave a cost on every
   later CUDA call; its paths are listed first): the CLI with `--devices
   1`, an NCCL group of
   one on the card: `cg_ir --ordering rcm --rtol 1e-10` (SELL f32 and f64)
   and `cg --nrhs 8` (the simultaneous-column block CG: SELL SpMM and SELL
   f64) on poisson_2d(512), and `ginkgo` (f64 BiCGSTAB, rtol 1e-4), `gmres`
   and `cg` (f64, rtol 1e-10, SELL f64) on random_spd(6408, 23), each with
   strategy "halo", local SpMV "bsr", no BSR launch, its iterations,
   passes, solve_s and wall time beside the single-device run of the same
   command, run right after it; the distributed `cg_ir` x within 1e-9 of the single-device x
   (solver API, group backend "nccl"), the host time of one `fused_psum`
   on NCCL at world size 1, and `cg_ir` on poisson_2d(128) with and
   without `--devices 1` (the same iterations; the cost per iteration of
   the collectives); the D = 4 per-rank operators of RCM
   poisson_2d(512) on the card: each rank's SELL f32, f64 and k = 8 SpMM
   kernels on an x_ext assembled by hand, against their plain versions
   (1e-5, 1e-13, 1e-5 of max|y|) and, rows concatenated, the host product
   (f64 within 1e-13, SpMM within 2e-5); `--devices` one more than the
   cards exits 1 with "requested N devices, have M". Since slice 14 also
   the AMG family over the ranks and the 2-D grid, each an NCCL group of
   one on poisson_2d(512): `cg_ir --precond amg_classical --ordering rcm
   --rtol 1e-10 --devices 1` (true relres ≤ 1e-10, `fp64(fp32_ir_auto)`,
   level 0 "bsr": SELL f32 and f64; its iterations, passes and solve_s
   printed again beside the single-device run of phase 5), `hypre
   --devices 1` (2 f64 cycles: relres finite and below 1, SELL f64),
   `paralmond --devices 1` (one K-cycle, SELL f64), `cg_ir --devices 1
   --mesh 1x1` (≤ 1e-10, within 5% of the `--devices 1` iterations, SELL
   f32 and f64), `cg --nrhs 8 --devices 1 --mesh 1x1` (worst column ≤
   1e-10, SELL SpMM and f64) and `cg --precond amg --rtol 1e-8 --devices 1
   --mesh 1x1` (converged by the host true residual; the 2-D hierarchy's
   gather ELL launches no kernel), none launching a BSR kernel; then, in
   one process, each rank's gathered-frame block of a 2 x 2 grid of RCM
   poisson_2d(512) and each D = 4 rank's block of every P and R of its
   `amg_classical` hierarchy through the SELL f32, f64 and k = 8 SpMM
   kernels against their plain versions (1e-5, 1e-13, 1e-5 of max|y|),
   the grid's partials summed and scattered on the host (f32 within 1e-5,
   f64 within 1e-12 of the host product) and the transfers' rank rows
   concatenated (f64 within 1e-12); `--mesh 2x2 --devices 1` exits 1 with
   the JAX CLI's message. Since slice 15, the last module slice, also (after
   the AMG and grid paths): `python -m lsbench_tpu_torch.scale` on
   poisson_2d(512) with `--devices 1,2,4 --iters 100 --reps 3 --json
   --ordering rcm --mesh2d` (its `main`: the `1x1` record, halo, 100
   iterations; 2 and 4 skipped with the JAX message on one card; elapsed_s,
   Gnnz/s and rank 0's launches, SELL f64 and no BSR kernel);
   `run_dryrun(1, platform="cuda")` (every distributed solver of the dry
   run in a spawned NCCL group of one, every assert; SELL f32, f64 and
   SpMM launches, no BSR); the CLI's `cg_ir --devices 1 --coordinator
   127.0.0.1:<free port> --num-processes 1 --process-id 0` (a TCPStore
   rendezvous: the `--devices 1` run's iterations and passes, true relres
   ≤ 1e-10, SELL f32 and f64, backend_init_s printed beside the FileStore
   group's), and `--num-processes 2 --process-id 2` and `--coordinator
   nohost` exiting 1 with the JAX messages; then, not paths, the sweep's
   solve through the solver API (DistributedCg after 100 fixed
   iterations within 1e-12 of the single-device f64 CG's x) and the
   communication model of RCM poisson_2d(512) (the CG volumes at D = 1,
   2, 4, 8 and on the 2 × 2 grid, the AMG-CG-IR solver's at `--devices
   1`, the predicted efficiency at D = 2, 4, 8 from the sweep's time per
   iteration, printed as a model with its link parameters). Each new
   path prints its phase_s.
20. The CG loop's if-node guard (`graph_if_guard_f32`, `graph_if_guard_f64`:
   the guard kernel of `csrc/graph_if.cu`; run after phase 2): for each
   dtype, one CUDA graph of 4 slots, each the guard and an if-node whose
   body marks its slot and halves the value, captured as the block graph
   of `solvers/cg.py::CgGraphs` is (the guard on a capturing stream, the
   bodies on another), on 0-d card tensors: it, its limit (int64), the
   value and its bound (f32 or f64). Replayed from the rows of the CPU
   test of its plain version (it == limit, value == bound, a value or a
   bound NaN, both 0, a stop inside the block), it must leave the count,
   the slots marked and the value that `graph_if.go` applied slot by slot
   gives; each capture counts 4 launches. Printed: the device time of
   one slot, skipped and run (CUDA events over a replay, per slot), and
   of the plain version's kernels. The cg_ir path of phase 3 must launch
   the f32 guard.

Each path's launch counts are read from counters set to 0 just before it.
Beside each kernel's times the record carries the bound of its function
(`bound_ms`: the larger of the bytes y = A·x must move, with A in CSR form
(values, int32 column indices and row offsets) and x read and y written
once, over 3.35 TB/s, and its 2·nnz operations over the card's peak for
their type) and the time of the cuSPARSE product
`torch.sparse_csr_tensor(...) @ x` on the same operator (`library_ms`,
timed here only; the port never calls it). The log also prints the bound
of the bytes the kernel's own layout streams (its padding included) beside
each bound. The last two lines are the
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
SELL_SOURCE = "lsbench_tpu_torch/csrc/sell_spmv.cu"
SELL_SPMM_SOURCE = "lsbench_tpu_torch/csrc/sell_spmm.cu"
TRI_SOURCE = "lsbench_tpu_torch/csrc/tri_sweep.cu"
GRAPH_IF_SOURCE = "lsbench_tpu_torch/csrc/graph_if.cu"
# The JAX package tests its CG loop's stop rule in `lax.while_loop`'s cond.
GUARD_REPLACES = ("lsbench_tpu/solvers/cg.py:49 (lax.while_loop cond, "
                  "no Pallas)")
# The triangular sweep has no Pallas kernel: the JAX package scans it.
TRI_REPLACES = ("lsbench_tpu/solvers/sparse_cholesky.py:342 (XLA lax.scan, "
                "no Pallas)")
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
    # K6, K7 and K8: the SELL f32 kernel over the layouts' packed forms.
    "spmv_bsr_compact_f32": ("bsr_compact_f32", SELL_SOURCE,
                             "lsbench_tpu/ops/spmv_pallas.py:543"),
    "spmv_bsr_selector_f32": ("bsr_selector_f32", SELL_SOURCE,
                              "lsbench_tpu/ops/spmv_pallas.py:135"),
    "spmv_bsr_onehot_f32": ("bsr_onehot_f32", SELL_SOURCE,
                            "lsbench_tpu/ops/spmv_pallas.py:27"),
    # The redesigns of K5 and K2 for the solver paths (sliced ELL).
    "spmv_sell_f32": ("sell_f32", SELL_SOURCE,
                      "lsbench_tpu/ops/spmv_pallas.py:187"),
    "spmv_sell_f64": ("sell_f64", SELL_SOURCE,
                      "lsbench_tpu/ops/spmv_pallas.py:396"),
    # The redesign of K3 for the multi-RHS solver paths.
    "spmm_sell_f32": ("sell_mm_f32", SELL_SPMM_SOURCE,
                      "lsbench_tpu/ops/spmv_pallas.py:255"),
    # One sparse triangular sweep per launch: IC(0) and the level schedule.
    "tri_sweep_f32": ("tri_sweep_f32", TRI_SOURCE, TRI_REPLACES),
    "tri_sweep_f64": ("tri_sweep_f64", TRI_SOURCE, TRI_REPLACES),
    # The guard of each if-node of the CG loop's block graph.
    "graph_if_guard_f32": ("if_guard_f32", GRAPH_IF_SOURCE, GUARD_REPLACES),
    "graph_if_guard_f64": ("if_guard_f64", GRAPH_IF_SOURCE, GUARD_REPLACES),
}
# The main-path runs whose launch counts the record lists, in order.
PATHS = ("cg_ir --devices 1 poisson_2d(512)",
         "cg --nrhs 8 --devices 1 poisson_2d(512)",
         "ginkgo --devices 1 random_spd(6408,23)",
         "gmres --devices 1 random_spd(6408,23)",
         "cg --devices 1 random_spd(6408,23)",
         "cg_ir amg_classical --devices 1 poisson_2d(512)",
         "hypre --devices 1 poisson_2d(512)",
         "paralmond --devices 1 poisson_2d(512)",
         "cg_ir --devices 1 --mesh 1x1 poisson_2d(512)",
         "cg --nrhs 8 --devices 1 --mesh 1x1 poisson_2d(512)",
         "cg --precond amg --devices 1 --mesh 1x1 poisson_2d(512)",
         "scale --devices 1,2,4 --iters 100 --mesh2d poisson_2d(512) (1x1)",
         "parallel.dryrun 1 poisson_2d(8) (rank 0)",
         "cg_ir --coordinator --num-processes 1 --devices 1 poisson_2d(512)",
         "cg_ir --roofline poisson_2d(512) + random_spd(6408,23)",
         "cg_ir amg_classical poisson_2d(512)", "hypre poisson_2d(512)",
         "hypre poisson_2d(128)", "cg --nrhs 8 poisson_2d(512)",
         "cg --nrhs 8 random_spd(6408,23)", "ginkgo --nrhs 8 poisson_2d(512)",
         "ginkgo random_spd(6408,23)", "cg --nrhs 4 poisson_2d(128)",
         "spmv variants API poisson_2d(512) + random_spd(6408,23)",
         "cg_ir --opt layout=ell poisson_2d(512)",
         "cg --opt layout=bsr_xla random_spd(6408,23)",
         "bsr K1/classed/df64/mm API poisson_2d(512) + random_spd(6408,23)",
         "cholmod (no --solver) random_spd(6408,23)",
         "cusolver random_spd(6408,23)",
         "cholmod --ordering amd poisson_2d(512)",
         "sparse_cholesky --opt schedule=block --ordering amd poisson_2d(512)",
         "cholmod --nrhs 8 random_spd(6408,23)",
         "cholmod poisson_2d(64)",
         "gmres --precond amg_classical poisson_2d(512)",
         "gmres random_spd(6408,23)",
         "gmres --precision fp32 random_spd(6408,23)",
         "cg_ir --precond chebyshev poisson_2d(512)",
         "cg_ir --precond block_jacobi poisson_2d(512)",
         "cg_ir --precond ic0 poisson_2d(512)",
         "cg --precond ic0 random_spd(6408,23)",
         "sparse_cholesky --opt schedule=level --ordering amd poisson_2d(512)",
         "cholesky_band random_spd(6408,23)",
         "cholesky_band poisson_2d(512)",
         "cg_ir amg_classical --cache exact hit poisson_2d(512)",
         "cg_ir amg_classical --cache pattern hit D·A·D poisson_2d(512)",
         "cg_ir amg_classical D·A·D poisson_2d(512) (rebuild)",
         "cg_ir --profile-dir random_spd(6408,23)",
         "cg_ir --debug-nans poisson_2d(512)",
         "sparse_cholesky --cache --ordering amd poisson_2d(512) (API)")
# The AMG-CG-IR command of the AMG and harness phases.
AMG_CG_IR = ["--solver", "cg_ir", "--precond", "amg_classical", "--ordering",
             "rcm", "--rtol", "1e-10", "--trials", "2", "--warmups", "1",
             "--json"]
# Records one phase leaves for a later one (the cache's miss).
HARNESS = {}
# The distributed paths' records, by label, for later comparisons.
DIST_RECORDS = {}
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


def card_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
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


def function_bound(A, value_bytes: int, kind: str, k: int = 1
                   ) -> tuple[float, str]:
    """The bound of Y = A·X with X of k columns, whatever the layout: the
    bytes of A in CSR form (values and int32 column indices of the
    nonzeros, int32 row offsets), X read and Y written once; 2 operations
    per nonzero and column."""
    nbytes = (A.nnz * (value_bytes + 4) + (A.nrows + 1) * 4
              + (A.ncols + A.nrows) * value_bytes * k)
    return bound(nbytes, 2 * A.nnz * k, kind)


def layout_bound_ms(nbytes: int) -> float:
    """The bytes bound of a layout that streams nbytes (padding included)."""
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


def kernel_phase(matrices) -> tuple[dict, dict]:
    """Compare every kernel with its plain version at the main path's
    shapes. Returns {kernel name: {max_abs_err, ms, plain_ms, shape}} at the
    shape the main path runs it on (max_abs_err over all shapes), and the
    launch counts of the BSR K5/K2 API path."""
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
    api_counts = bsr_api_path(P, R, p_cls, p_64, r_uni, r_lo)

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
            vb = 8 if f64 else 4  # K2's hi/lo f32 pair is 8 B per value
            b_ms, b_by = function_bound(A, vb, "f64" if f64 else "f32")
            lay = (nbytes + layout_index_bytes[name]
                   + (A.ncols + A.nrows) * vb)
            lib = library_ms(A, lib_dtype[f64], x)
            entry.update(ms=ms, plain_ms=plain_ms, shape=shape,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib)
            print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                  f"{layout_bound_ms(lay):.4f} ms ({lay} B), cuSPARSE "
                  f"{lib:.4f} ms")
    results["spmm_bsr_f32"] = spmm_cases(
        {"poisson_2d(512) RCM uniform": (P, p_uni),
         "random_spd(6408,23) RCM uniform": (R, r_uni)}, rng)
    del p_cls, p_uni, p_64, r_uni, r_lo
    torch.cuda.empty_cache()
    results.update(sell_cases({"poisson_2d(512)": P,
                               "random_spd(6408,23)": R}, rng))
    results["spmm_sell_f32"] = sell_spmm_cases(
        {"poisson_2d(512)": P, "random_spd(6408,23)": R}, rng)
    return results, api_counts


def bsr_api_path(P, R, p_cls, p_64, r_uni, r_lo) -> dict:
    """The BSR K1, K5, K2 and K3, which no solver path runs since the
    sliced-ELL kernels took their place: each public entry once (uniform K1
    on RCM random_spd(6408, 23), classed on RCM poisson_2d(512), df64 on
    it, df64_lo on random_spd, the k=8 SpMM on random_spd), counters set to
    0 just before and read just after, each result held to the host f64
    product (per column for the SpMM). Returns the counts."""
    import scipy.sparse as sp
    import torch

    from lsbench_tpu_torch.ops import spmv_bsr as ops
    rng = np.random.default_rng(3)
    xp, xr = rng.standard_normal(P.ncols), rng.standard_normal(R.ncols)
    Xr = rng.standard_normal((R.ncols, 8))
    dev = p_64.blocks_hi.device
    x32 = torch.as_tensor(xp, dtype=torch.float32, device=dev)
    xp64 = torch.as_tensor(xp, device=dev)
    xr64 = torch.as_tensor(xr, device=dev)
    xr32 = torch.as_tensor(xr, dtype=torch.float32, device=dev)
    Xr32 = torch.as_tensor(Xr, dtype=torch.float32, device=dev)
    reset_counts()
    out = {"spmv_bsr [random_spd(6408,23)]": (
               R, xr, ops.spmv_bsr(r_uni, xr32), 2e-5),
           "spmv_bsr_classed [poisson_2d(512)]": (
               P, xp, ops.spmv_bsr_classed(p_cls, x32), 2e-5),
           "spmv_bsr_df64 [poisson_2d(512)]": (
               P, xp, ops.spmv_bsr_df64(p_64, xp64), 5e-13),
           "spmv_bsr_df64_lo [random_spd(6408,23)]": (
               R, xr, ops.spmv_bsr_df64_lo(r_uni, r_lo, xr64), 5e-13),
           "spmm_bsr k=8 [random_spd(6408,23)]": (
               R, Xr, ops.spmm_bsr(r_uni, Xr32), 2e-5)}
    torch.cuda.synchronize()
    counts = read_counts()
    check(counts["bsr_f32"] == 1
          and counts["bsr_classed_f32"] == len(p_cls.blocks)
          and counts["bsr_f64acc"] == 2 and counts["bsr_mm_f32"] == 1,
          f"bsr API path launches {counts}")
    for label, (A, x_np, y, rel) in out.items():
        host = sp.csr_matrix((A.vals, A.cols, A.offs), shape=A.shape)
        y_host = host @ x_np
        err = np.abs(y.double().cpu().numpy() - y_host).max(axis=0)
        tol = rel * np.abs(y_host).max(axis=0)
        check(y.shape == y_host.shape and bool(np.all(err <= tol)),
              f"{label}: max|kernel - host f64| = {err} > {tol}")
        print(f"bsr API {label}: host_err={np.max(err):.3e} (tol "
              f"{np.min(tol):.3e})")
    print(f"bsr K1/classed/df64/mm API path: launches={counts}")
    return counts


def host_call_ms(fn, calls: int = 200) -> float:
    """Host time of one call: the host clock around `calls` calls that are
    not waited for (the card runs behind), divided by the count."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e3


def kernel_alone_ms(fn, args, launches: int = 200) -> float:
    """Time of one launch: CUDA events around `launches` back-to-back calls
    of a kernel's entry point alone (no wrapper checks, no allocation), so
    the wrapper's host time does not show. Where one launch takes less
    host time than its kernel takes on the card, this is the kernel's
    device time; otherwise it is the launch rate."""
    import torch

    from lsbench_tpu_torch.ops import _cuda
    _cuda.check(fn(*args), "kernel alone")
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(launches):
        fn(*args)
    end.record()
    end.synchronize()
    _cuda.check(fn(*args), "kernel alone")
    return start.elapsed_time(end) / launches


def traced_device_events(run) -> list[dict]:
    """The device events (kernels, copies, memsets) of `run()` under
    torch.profiler, from its chrome trace."""
    import torch

    from lsbench_tpu_torch.harness.profile_solve import _device_events
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return _device_events(path)


def profiled_kernel_ms(fn, args, kernel: str, flush=None,
                       launches: int = 50) -> float | None:
    """Median device duration of the kernel named `kernel` over `launches`
    calls under torch.profiler; with `flush`, a write of a buffer larger
    than the 50 MB L2 before each call, so the kernel reads its operands
    from HBM. None if the trace holds no such kernel."""
    import statistics

    def run():
        for _ in range(launches):
            if flush is not None:
                flush.zero_()
            fn(*args)
    durs = [e["dur"] for e in traced_device_events(run)
            if e["cat"] == "kernel" and kernel in e["name"]]
    return statistics.median(durs) / 1e3 if durs else None


def _fmt(v: float | None) -> str:
    return "n/a" if v is None else f"{v:.4f}"


def sell_cases(matrices, rng) -> dict:
    """The sliced-ELL kernels (the redesigned K5 and K2) against their plain
    versions, the host f64 matvec and cuSPARSE on the RCM SELL layout of
    each matrix; returns the record entries at poisson_2d(512)."""
    import torch

    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import _cuda
    from lsbench_tpu_torch.ops import spmv_sell as ops

    dev = torch.device("cuda")
    lib = _cuda.library("sell_spmv")
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    results = {}
    for label, A in matrices.items():
        t0 = time.perf_counter()
        S = SellMatrix.from_csr(A, dtypes=(torch.float32, torch.float64),
                                device=dev)
        torch.cuda.synchronize()
        widths = np.bincount(S.widths)
        print(f"sell layout {label} RCM: n_slices={S.n_slices} "
              f"n_stored={S.n_stored} (nnz {A.nnz}, "
              f"{S.n_stored / A.nnz:.4f}x) {S.bytes_streamed} B (cols, "
              f"slice_off, f32 and f64 values), widths "
              f"{ {w: int(c) for w, c in enumerate(widths) if c} } built in "
              f"{time.perf_counter() - t0:.2f} s")
        x_np = rng.standard_normal(A.ncols)
        for name, f64 in (("spmv_sell_f32", False), ("spmv_sell_f64", True)):
            dtype = torch.float64 if f64 else torch.float32
            kern = ops.spmv_sell_f64 if f64 else ops.spmv_sell
            plain = ops.spmv_sell_f64_plain if f64 else ops.spmv_sell_plain
            vals = S.vals64 if f64 else S.vals
            x = torch.as_tensor(x_np, dtype=dtype, device=dev)
            y_k, y_again, y_p = kern(S, x), kern(S, x), plain(S, x)
            torch.cuda.synchronize()
            tag = f"{name} [{label} RCM sell]"
            check(y_k.shape == (A.nrows,) and bool(torch.isfinite(y_k).all()),
                  f"{tag}: bad output")
            check(torch.equal(y_k, y_again), f"{tag}: not bitwise repeatable")
            scale = float(y_p.abs().max())
            err = float((y_k - y_p).abs().max())
            tol = (1e-13 if f64 else 1e-5) * scale
            check(err <= tol, f"{tag}: max|kernel - plain| = {err:.3e} > "
                              f"{tol:.3e}")
            y_host = A.matvec(x_np)
            host_err = float(np.abs(y_k.double().cpu().numpy() - y_host).max())
            host_tol = (1e-13 if f64 else 2e-5) * float(np.abs(y_host).max())
            check(host_err <= host_tol, f"{tag}: max|kernel - host f64| = "
                                        f"{host_err:.3e} > {host_tol:.3e}")
            ms = median_ms(lambda: kern(S, x))
            plain_ms = median_ms(lambda: plain(S, x))
            host_ms = host_call_ms(lambda: kern(S, x))
            y = torch.empty(A.nrows, dtype=dtype, device=dev)
            args = (vals.data_ptr(), S.cols.data_ptr(),
                    S.slice_off.data_ptr(), x.data_ptr(), y.data_ptr(),
                    A.nrows, torch.cuda.current_stream().cuda_stream)
            entry_fn = getattr(lib, "lsb_" + name)
            alone = kernel_alone_ms(entry_fn, args)
            warm = profiled_kernel_ms(entry_fn, args, name + "_kernel")
            cold = profiled_kernel_ms(entry_fn, args, name + "_kernel", flush)
            vb = 8 if f64 else 4
            nbytes = ((vb + 4) * S.n_stored + 8 * S.slice_off.numel()
                      + vb * (A.ncols + A.nrows))
            b_ms, b_by = function_bound(A, vb, "f64" if f64 else "f32")
            lib_ms = library_ms(A, dtype, x)
            print(f"kernel {tag}: max_abs_err={err:.3e} (tol {tol:.3e}) "
                  f"host_err={host_err:.3e} wrapper {ms:.4f} ms (host "
                  f"{host_ms:.4f} ms per call), kernel "
                  f"alone {alone:.4f} ms, device (profiler) L2-warm "
                  f"{_fmt(warm)} ms, L2-cold {_fmt(cold)} ms, plain "
                  f"{plain_ms:.4f} ms; {nbytes} B: {nbytes / ms / 1e6:.1f} "
                  f"GB/s by the wrapper, {nbytes / alone / 1e6:.1f} GB/s "
                  f"alone")
            print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                  f"{layout_bound_ms(nbytes):.4f} ms ({nbytes} B), cuSPARSE "
                  f"{lib_ms:.4f} ms")
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            times = dict(ms=ms, plain_ms=plain_ms, launch_ms=alone,
                         wrapper_host_ms=host_ms, device_ms_l2_warm=warm,
                         device_ms_l2_cold=cold, shape=f"{label} RCM sell",
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
            if label == "poisson_2d(512)":
                entry.update(times)
            else:
                # K1's operator: random_spd's uniform layout in the JAX
                # package, sliced ELL on the port's solver paths.
                entry[label] = times
        del S
    del flush
    torch.cuda.empty_cache()
    return results


def sell_spmm_cases(matrices, rng) -> dict:
    """The SELL SpMM (the redesigned K3) against its plain version and the
    host f64 CSR product, column by column, and against the f32 SELL SpMV
    on each column (bit for bit), for k in {1, 3, 8, 16} on the RCM SELL
    layout of each matrix, with its times, bounds and cuSPARSE's SpMM;
    returns the record entry with k=8 on poisson_2d(512)."""
    import scipy.sparse as sp
    import torch

    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import _cuda
    from lsbench_tpu_torch.ops import spmv_sell as ops

    dev = torch.device("cuda")
    entry_fn = _cuda.library("sell_spmm").lsb_spmm_sell_f32
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    result = {"max_abs_err": 0.0}
    for label, A in matrices.items():
        S = SellMatrix.from_csr(A, device=dev)
        host = sp.csr_matrix((A.vals, A.cols, A.offs), shape=A.shape)
        for k in (1, 3, 8, 16):
            X_np = rng.standard_normal((A.ncols, k))
            X = torch.as_tensor(X_np, dtype=torch.float32, device=dev)
            Y_k, Y_again = ops.spmm_sell(S, X), ops.spmm_sell(S, X)
            Y_p = ops.spmm_sell_plain(S, X)
            cols_equal = all(torch.equal(Y_k[:, j], ops.spmv_sell(
                S, X[:, j].contiguous())) for j in range(k))
            torch.cuda.synchronize()
            tag = f"spmm_sell_f32 [{label} RCM sell, k={k}]"
            check(Y_k.shape == (A.nrows, k)
                  and bool(torch.isfinite(Y_k).all()), f"{tag}: bad output")
            check(torch.equal(Y_k, Y_again), f"{tag}: not bitwise repeatable")
            check(cols_equal, f"{tag}: a column differs from spmv_sell's")
            err = (Y_k - Y_p).abs().amax(dim=0).cpu().numpy()
            tol = 1e-5 * Y_p.abs().amax(dim=0).cpu().numpy()
            check(bool(np.all(err <= tol)), f"{tag}: max|kernel - plain| "
                  f"per column {err} > {tol}")
            Y_host = host @ X_np
            host_err = np.abs(Y_k.double().cpu().numpy() - Y_host).max(axis=0)
            host_tol = 2e-5 * np.abs(Y_host).max(axis=0)
            check(bool(np.all(host_err <= host_tol)), f"{tag}: max|kernel - "
                  f"host f64| per column {host_err} > {host_tol}")
            ms = median_ms(lambda: ops.spmm_sell(S, X))
            plain_ms = median_ms(lambda: ops.spmm_sell_plain(S, X))
            host_ms = host_call_ms(lambda: ops.spmm_sell(S, X))
            Y = torch.empty(A.nrows, k, dtype=torch.float32, device=dev)
            args = (S.vals.data_ptr(), S.cols.data_ptr(),
                    S.slice_off.data_ptr(), X.data_ptr(), Y.data_ptr(),
                    A.nrows, k, torch.cuda.current_stream().cuda_stream)
            alone = kernel_alone_ms(entry_fn, args)
            warm = profiled_kernel_ms(entry_fn, args, "spmm_sell_f32_kernel")
            cold = profiled_kernel_ms(entry_fn, args, "spmm_sell_f32_kernel",
                                      flush)
            nbytes = (8 * S.n_stored + 8 * S.slice_off.numel()
                      + 4 * k * (A.ncols + A.nrows))
            b_ms, b_by = function_bound(A, 4, "f32", k)
            lib_ms = library_ms(A, torch.float32, X)
            print(f"kernel {tag}: max_abs_err={err.max():.3e} (tol "
                  f"{tol.min():.3e}..{tol.max():.3e}) host_err="
                  f"{host_err.max():.3e} wrapper {ms:.4f} ms (host "
                  f"{host_ms:.4f} ms per call), kernel alone {alone:.4f} ms, "
                  f"device (profiler) L2-warm {_fmt(warm)} ms, L2-cold "
                  f"{_fmt(cold)} ms, plain {plain_ms:.4f} ms; {nbytes} B: "
                  f"{nbytes / alone / 1e6:.1f} GB/s alone")
            print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                  f"{layout_bound_ms(nbytes):.4f} ms ({nbytes} B), cuSPARSE "
                  f"SpMM {lib_ms:.4f} ms")
            result["max_abs_err"] = max(result["max_abs_err"],
                                        float(err.max()))
            if k == 8 and label == "poisson_2d(512)":
                result.update(ms=ms, plain_ms=plain_ms, launch_ms=alone,
                              wrapper_host_ms=host_ms, device_ms_l2_warm=warm,
                              device_ms_l2_cold=cold,
                              shape=f"{label} RCM sell, k=8", bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib_ms)
        del S
    del flush
    torch.cuda.empty_cache()
    return result


def spmm_cases(layouts, rng) -> dict:
    """K3's BSR port (ops API) against its plain version and the host f64
    CSR product, column by column, for k in {1, 3, 8, 16} on each uniform
    layout; returns the record entry with k=8 on poisson_2d(512)."""
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
                b_ms, b_by = function_bound(A, 4, "f32", k)
                lay = (nbytes + op.block_cols.numel() * 4
                       + (A.ncols + A.nrows) * 4 * k)
                lib = library_ms(A, torch.float32, X)
                result.update(ms=ms, plain_ms=plain_ms,
                              shape=f"{shape}, k=8", bound_ms=b_ms,
                              bound_by=b_by, library_ms=lib)
                print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                      f"{layout_bound_ms(lay):.4f} ms ({lay} B), cuSPARSE "
                      f"SpMM {lib:.4f} ms")
    return result


# (it, limit, value, bound) before a replay of the guard phase's graph.
GUARD_ROWS = ((0, 5, 2.0, 1.0), (5, 5, 2.0, 1.0), (0, 5, 1.0, 1.0),
              (4, 9, 0.5, 1.0), (0, 5, 0.0, 0.0), (0, 5, float("nan"), 1.0),
              (0, 5, 2.0, float("nan")), (0, 9, 4.0, 1.0), (3, 5, 8.0, 1.0),
              (0, 9, 1e6, 1.0))
GUARD_SLOTS = 4


def graph_if_phase() -> dict:
    """The if-node guard on the card against its plain version
    (`graph_if.go`) applied slot by slot: one graph of GUARD_SLOTS slots
    for each dtype, replayed from each of GUARD_ROWS. Returns the
    `measured` entries of both guard kernels."""
    import torch

    from lsbench_tpu_torch.ops import graph_if

    dev = torch.device("cuda", 0)
    out = {}
    for dt, name in ((torch.float32, "graph_if_guard_f32"),
                     (torch.float64, "graph_if_guard_f64")):
        counter = KERNELS[name][0]
        it = torch.zeros((), dtype=torch.int64, device=dev)
        limit = torch.zeros((), dtype=torch.int64, device=dev)
        value = torch.zeros((), dtype=dt, device=dev)
        tol = torch.zeros((), dtype=dt, device=dev)
        ran = torch.zeros(GUARD_SLOTS, dtype=torch.int32, device=dev)
        marks = [ran[j] for j in range(GUARD_SLOTS)]

        def body(j):
            marks[j].fill_(1)
            value.mul_(0.5)
        graph_if.load(dev)
        body(0)                     # load the bodies' kernels
        torch.cuda.synchronize(dev)
        capturing, bodies = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        pool = torch.cuda.MemPool()
        graph = torch.cuda.CUDAGraph()
        before = graph_if.LAUNCHES[counter]
        with torch.cuda.stream(capturing):
            graph.capture_begin()
            for j in range(GUARD_SLOTS):
                with graph_if.if_node(it, limit, value, tol, bodies, pool):
                    body(j)
            graph.capture_end()
        check(graph_if.LAUNCHES[counter] - before == GUARD_SLOTS,
              f"{name}: {graph_if.LAUNCHES[counter] - before} launches "
              f"counted for {GUARD_SLOTS} guards captured")

        def start(row):
            i, m, v, b = row
            it.fill_(i)
            limit.fill_(m)
            value.fill_(v)
            tol.fill_(b)
            ran.zero_()
        for row in GUARD_ROWS:
            start(row)
            graph.replay()
            torch.cuda.synchronize(dev)
            got = (int(it), ran.tolist(), value.item())
            start(row)              # the plain version, slot by slot
            want_ran = []
            for j in range(GUARD_SLOTS):
                go = bool(graph_if.go(it, limit, value, tol))
                if go:
                    it.add_(1)
                    value.mul_(0.5)
                want_ran.append(int(go))
            want = (int(it), want_ran, value.item())
            check(got[:2] == want[:2] and (got[2] == want[2] or (
                np.isnan(got[2]) and np.isnan(want[2]))),
                  f"{name} {row}: the graph gave (it, slots run, value) "
                  f"{got}, the plain version {want}")

        def slot_ms(row, reps=20):
            """Median CUDA-event time of a replay from `row`, a slot."""
            times = []
            for _ in range(reps + 1):
                start(row)
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                graph.replay()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            return float(np.median(times[1:])) / GUARD_SLOTS
        skipped = slot_ms((5, 5, 2.0, 1.0))     # every slot skipped
        run = slot_ms((0, 9, 1e30, 1.0))        # every slot run
        plain = median_ms(lambda: graph_if.go(it, limit, value, tol))
        nbytes = 3 * 8 + 2 * value.element_size()   # it read and written
        b_ms, b_by = bound(nbytes, 2, "f32" if dt == torch.float32 else "f64")
        print(f"graph_if guard {name}: {len(GUARD_ROWS)} rows as the plain "
              f"version; ms a slot skipped {skipped:.5f}, run "
              f"(with its body's 2 kernels) {run:.5f}; plain version's "
              f"kernels {plain:.5f} ms; bound {b_ms:.2e} ms ({b_by})")
        out[name] = {"max_abs_err": 0.0, "ms": skipped, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     "shape": f"0-d, {GUARD_SLOTS} slots a graph",
                     "slot_run_ms": run}
        del graph, pool
    return out


def main_path_phase(matrices) -> dict:
    """Run cg_ir through the port's CLI on each matrix, with `--roofline`
    (the harness phase checks it); return the launch counts of the whole
    phase."""
    import torch

    from lsbench_tpu_torch.harness.bench import BenchRecord
    from lsbench_tpu_torch.harness.cli import main as cli_main
    from lsbench_tpu_torch.matrix.io import write_matrix

    expect = ("sell_f32", "sell_f64", "if_guard_f32")
    total = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, A in matrices.items():
            fname = os.path.join(tmp, label.split("(")[0] + ".txt")
            t0 = time.perf_counter()
            write_matrix(A, fname)
            write_s = time.perf_counter() - t0
            buf = io.StringIO()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli_main(["--matrix", fname, "--solver", "cg_ir",
                               "--ordering", "rcm", "--rtol", "1e-10",
                               "--trials", "2", "--warmups", "1", "--json",
                               "--roofline"])
            wall_s = time.perf_counter() - t0
            ran = read_counts()
            peak = torch.cuda.max_memory_allocated()
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
            HARNESS[label] = rec
            check(rec["converged"] is True, f"{label}: not converged")
            check(rec["true_relres"] <= 1e-10,
                  f"{label}: true_relres {rec['true_relres']:.3e} > 1e-10")
            for k in expect:
                check(ran[k] > 0, f"{label}: kernel {k} never launched")
            for k in ("bsr_f32", "bsr_classed_f32", "bsr_f64acc"):
                check(ran[k] == 0, f"{label}: BSR kernel {k} launched {ran}")
            for k, v in ran.items():
                total[k] = total.get(k, 0) + v
            jax_it, jax_passes = JAX_CPU_ITERS[label]
            print(f"main path {label}: n={rec['n']} nnz={rec['nnz']} "
                  f"iters={rec['iters']} passes={rec['refine_passes']} "
                  f"(JAX on CPU, ELL layout: {jax_it}/{jax_passes}) "
                  f"true_relres={rec['true_relres']:.3e} "
                  f"setup_s={rec['setup_s']:.3f} (layout_s="
                  f"{rec['setup_breakdown']['layout_s']:.3f}) "
                  f"solve_s={rec['solve_s']:.4f} "
                  f"first_call_s={rec['first_call_s']:.3f} "
                  f"peak_device_mem_bytes={peak} "
                  f"write_s={write_s:.2f} cli_wall_s={wall_s:.2f} "
                  f"launches={ran}")
            print(f"  csv: {out[1]}")
    return total


def reset_counts() -> None:
    from lsbench_tpu_torch.ops import launches
    launches.reset()


def read_counts() -> dict:
    from lsbench_tpu_torch.ops import launches
    return launches.read()


def _op_summary(op) -> str:
    import torch
    if isinstance(op, torch.Tensor):
        return f"dense {op.numel() * op.element_size()} B"
    kind = type(op).__name__
    extra = (f" k8={op.k8} k_real={op.k_real} J={op.j_blocks}"
             if kind == "WindowEll" else "")
    return f"{kind}{extra} {op.bytes_streamed} B"


def well_launch_ms(op, x) -> tuple[float, float | None]:
    """One K4 launch alone (no wrapper checks, no allocation, x read in
    place): `kernel_alone_ms` of its entry point and the profiler's
    L2-warm device time."""
    import torch

    from lsbench_tpu_torch.ops import _cuda
    fn = _cuda.library("well_spmv").lsb_spmv_well_f32
    y = torch.empty(op.nrows, dtype=torch.float32, device=x.device)
    args = (op.vals.data_ptr(), op.lcols.data_ptr(), op.w0.data_ptr(),
            x.data_ptr(), y.data_ptr(), op.nrows, op.n_pad, op.k_eff,
            torch.cuda.current_stream().cuda_stream)
    return (kernel_alone_ms(fn, args),
            profiled_kernel_ms(fn, args, "spmv_well_f32_kernel"))


def sell_operator_times(M, S, x) -> dict:
    """The SELL f32 wrapper's median time, the kernel alone, the function's
    bound, the layout's bytes and their bound, and cuSPARSE's time on
    operator M laid out as S, x on the card."""
    import torch

    from lsbench_tpu_torch.ops import _cuda
    from lsbench_tpu_torch.ops import spmv_sell as ops
    y = torch.empty(M.nrows, dtype=torch.float32, device=x.device)
    args = (S.vals.data_ptr(), S.cols.data_ptr(), S.slice_off.data_ptr(),
            x.data_ptr(), y.data_ptr(), M.nrows,
            torch.cuda.current_stream().cuda_stream)
    nbytes = 8 * S.n_stored + 8 * S.slice_off.numel() + 4 * (M.ncols
                                                              + M.nrows)
    b_ms, b_by = function_bound(M, 4, "f32")
    fn = _cuda.library("sell_spmv").lsb_spmv_sell_f32
    return {"ms": median_ms(lambda: ops.spmv_sell(S, x)),
            "kernel_alone_ms": kernel_alone_ms(fn, args),
            "device_ms_l2_warm": profiled_kernel_ms(fn, args,
                                                    "spmv_sell_f32_kernel"),
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "layout_bound_ms": layout_bound_ms(nbytes),
            "library_ms": library_ms(M, torch.float32, x)}


def amg_kernel_phase(A) -> tuple[dict, dict]:
    """K4 against its plain version and the host f64 matvec on every
    window-ELL operator of the amg_classical hierarchy of RCM-ordered
    poisson_2d(512), each beside the SELL f32 kernel on the same operator,
    and the SELL f32 kernel (the redesigned K1) on every operator laid out
    as SELL. Returns K4's {max_abs_err, ms, plain_ms, shape, ...} with the
    times of the level-0 P, and the SELL kernel's times on the level-1 A."""
    import torch

    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import spmv_sell
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
    sell_level1 = {}
    rng = np.random.default_rng(1)
    n_well = n_sell = 0
    for lvl, (m, lp) in enumerate(zip(mats, params)):
        print(f"  level {lvl}: n={m['A'].nrows} nnz(A)={m['A'].nnz} "
              + " ".join(f"{k.upper()}=[{_op_summary(lp[k])}]"
                         for k in ("a", "p", "r")))
        for key in ("a", "p", "r"):
            op = lp[key]
            M = m[key.upper()]
            if isinstance(op, SellMatrix):
                # The redesigned K1 on each operator the JAX package lays
                # out as BSR (rectangular ones included: x has ncols).
                x_np = rng.standard_normal(M.ncols)
                x = torch.as_tensor(x_np, dtype=torch.float32, device=dev)
                y_k = spmv_sell.spmv_sell(op, x)
                y_p = spmv_sell.spmv_sell_plain(op, x)
                torch.cuda.synchronize()
                label = f"level {lvl} {key.upper()} ({M.nrows}x{M.ncols})"
                err = float((y_k - y_p).abs().max())
                tol = 1e-5 * float(y_p.abs().max())
                y_host = M.matvec(x_np)
                host_err = float(np.abs(y_k.double().cpu().numpy()
                                        - y_host).max())
                host_tol = 2e-5 * float(np.abs(y_host).max())
                check(y_k.shape == (M.nrows,) and err <= tol
                      and host_err <= host_tol,
                      f"spmv_sell_f32 [{label}]: shape {tuple(y_k.shape)}, "
                      f"max|kernel - plain| {err:.3e} (tol {tol:.3e}), "
                      f"max|kernel - host f64| {host_err:.3e} (tol "
                      f"{host_tol:.3e})")
                n_sell += 1
                if lvl == 1 and key == "a":
                    sell_level1 = sell_operator_times(M, op, x)
                    sell_level1["shape"] = f"amg_classical {label}"
                    print(f"kernel spmv_sell_f32 [{label}]: max_abs_err="
                          f"{err:.3e} host_err={host_err:.3e} "
                          + " ".join(f"{k}={v:.4f}" if isinstance(v, float)
                                     else f"{k}={v}"
                                     for k, v in sell_level1.items()))
                continue
            if not isinstance(op, WindowEll):
                continue
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
            host_ms = host_call_ms(lambda: spmv_well(op, x))
            launch_ms, warm_ms = well_launch_ms(op, x)
            nbytes = op.bytes_streamed
            # The SELL f32 kernel on the same operator and x, for the AMG
            # layout model's window-ELL against SELL choice.
            same = sell_operator_times(M, SellMatrix.from_csr(M, device=dev),
                                       x)
            print(f"kernel spmv_well_f32 [{label}]: max_abs_err={err:.3e} "
                  f"(tol {tol:.3e}) host_err={host_err:.3e} wrapper "
                  f"{ms:.4f} ms (host {host_ms:.4f} ms per call), kernel "
                  f"alone {launch_ms:.4f} ms, device (profiler) L2-warm "
                  f"{_fmt(warm_ms)} ms ({nbytes} B), plain {plain_ms:.4f} "
                  f"ms; SELL f32 on the same operator: wrapper "
                  f"{same['ms']:.4f} ms, kernel alone "
                  f"{same['kernel_alone_ms']:.4f} ms, device (profiler) "
                  f"L2-warm {_fmt(same['device_ms_l2_warm'])} ms "
                  f"({same['bytes']} B)")
            result["max_abs_err"] = max(result["max_abs_err"], err)
            n_well += 1
            if lvl == 0 and key == "p":
                b_ms, b_by = function_bound(M, 4, "f32")
                lay = 4 * (op.vals.numel() + op.lcols.numel()
                           + op.w0.numel() + M.ncols + M.nrows)
                lib = library_ms(M, torch.float32, x)
                result.update(ms=ms, plain_ms=plain_ms, launch_ms=launch_ms,
                              wrapper_host_ms=host_ms,
                              device_ms_l2_warm=warm_ms,
                              shape=f"poisson_2d(512) RCM amg_classical "
                                    f"{label}, k8={op.k8} "
                                    f"k_real={op.k_real} J={op.j_blocks}",
                              bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                              sell_same_operator={
                                  k: same[k] for k in (
                                      "ms", "kernel_alone_ms",
                                      "device_ms_l2_warm")})
                print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                      f"{layout_bound_ms(lay):.4f} ms ({lay} B), cuSPARSE "
                      f"{lib:.4f} ms")
    check("ms" in result, "level-0 P is not window-ELL")
    check(bool(sell_level1), "level-1 A is not SELL")
    print(f"  {n_well} window-ELL and {n_sell} SELL operators checked")
    del params
    torch.cuda.empty_cache()
    return result, sell_level1


def cli_path(label: str, fname: str, argv: list[str]):
    """Run the CLI once; return (record, launch counts of this run, wall s).
    Counters are set to 0 just before the run and read just after."""
    from lsbench_tpu_torch.harness.bench import BenchRecord
    from lsbench_tpu_torch.harness.cli import main as cli_main

    from lsbench_tpu_torch.harness import cache
    from lsbench_tpu_torch.utils import debug

    buf = io.StringIO()
    reset_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli_main(["--matrix", fname, *argv])
    finally:  # --cache and --debug-nans stay on in the process: undo them
        cache.enable(False)
        debug.enable_debug_nans(False)
    wall_s = time.perf_counter() - t0
    ran = read_counts()
    out = buf.getvalue().splitlines()
    check(rc == 0, f"{label}: CLI exited {rc}")
    check(len(out) == 3 and out[0] == BenchRecord.CSV_HEADER
          and out[1].startswith(fname + ","),
          f"{label}: unexpected CLI output {out[:2]}")
    print(f"  csv: {out[1]}")
    return json.loads(out[2]), ran, wall_s


def amg_paths_phase(tmp: str, A512, A128, amg_cache: str) -> list[dict]:
    """The AMG-CG-IR path (with `--cache-dir amg_cache`: the setup cache's
    miss, which the harness phase hits) and the hypre path through the CLI;
    returns each path's launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    f512 = os.path.join(tmp, "poisson_512.txt")
    f128 = os.path.join(tmp, "poisson_128.txt")
    write_matrix(A512, f512)
    write_matrix(A128, f128)
    counts = []

    t0 = time.perf_counter()
    rec, ran, wall = cli_path(
        "amg-cg-ir", f512, [*AMG_CG_IR, "--cache-dir", amg_cache])
    check(rec["converged"] is True, "amg-cg-ir: not converged")
    check(rec["setup_breakdown"]["hier_cache"] == "miss",
          f"amg-cg-ir: hier_cache {rec['setup_breakdown']['hier_cache']}")
    HARNESS["amg_miss"] = rec
    check(rec["true_relres"] <= 1e-10,
          f"amg-cg-ir: true_relres {rec['true_relres']:.3e} > 1e-10")
    for k in ("sell_f32", "well_f32", "sell_f64"):
        check(ran[k] > 0, f"amg-cg-ir: kernel {k} never launched")
    check(ran["bsr_f32"] == 0, f"amg-cg-ir: K1 launched {ran}")
    bd = rec["setup_breakdown"]
    print(f"amg-cg-ir path poisson_2d(512): hier_cache=miss "
          f"iters={rec['iters']} passes={rec['refine_passes']} "
          f"true_relres={rec['true_relres']:.3e} setup_s={rec['setup_s']:.3f}"
          f" (hierarchy as precond_s={bd['precond_s']:.3f}, ordering_s="
          f"{bd['ordering_s']:.3f}, layout_s={bd['layout_s']:.3f}) "
          f"solve_s={rec['solve_s']:.4f} first_call_s="
          f"{rec['first_call_s']:.3f} cli_wall_s={wall:.2f} launches={ran} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)
    dist = DIST_RECORDS.get("cg_ir amg_classical")
    if dist is not None:
        print(f"amg-cg-ir poisson_2d(512): --devices 1 iters={dist['iters']} "
              f"passes={dist['refine_passes']} solve_s={dist['solve_s']:.4f}"
              f" | single-device iters={rec['iters']} passes="
              f"{rec['refine_passes']} solve_s={rec['solve_s']:.4f}")

    t0 = time.perf_counter()
    hypre = ["--solver", "hypre", "--trials", "2", "--warmups", "1", "--json"]
    rec, ran, wall = cli_path("hypre", f512, hypre)
    check(rec["precision"] == "fp64(fp32_cycles_auto)",
          f"hypre: precision {rec['precision']}")
    check(bool(np.isfinite(rec["true_relres"])) and rec["true_relres"] < 1,
          f"hypre: true_relres {rec['true_relres']}")
    for k in ("well_f32", "sell_f32"):
        check(ran[k] > 0, f"hypre: kernel {k} never launched")
    check(ran["bsr_f32"] == 0, f"hypre: K1 launched {ran}")
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
        for k in ("sell_mm_f32", "sell_f64"):
            check(ran[k] > 0, f"block-cg {label}: kernel {k} never launched")
        check(ran["bsr_mm_f32"] == 0, f"block-cg {label}: K3's BSR port "
                                      f"launched {ran}")
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
    check(ran["sell_mm_f32"] > 0 and ran["sell_f64"] > 0
          and ran["bsr_mm_f32"] == 0, f"ginkgo --nrhs 8: kernels {ran}")
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
    check(ran["sell_f32"] > 0 and ran["sell_f64"] > 0
          and ran["bsr_f32"] == 0, f"ginkgo: kernels {ran}")
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
    check(ran["sell_mm_f32"] > 0 and ran["bsr_mm_f32"] == 0,
          f"block-cg poisson_2d(128): kernels {ran}")
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
    before and read just after. Each runs the SELL f32 kernel over its
    layout's packed form (K6: the exact blocks', `BsrCompact.packed`; K7
    and K8: the uniform layout's for their gather rule), built once per
    layout (`pack_ms`) before the API path."""
    import torch

    from lsbench_tpu_torch.matrix.bsr import BsrCompact, BsrMatrix
    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import _cuda
    from lsbench_tpu_torch.ops import spmv_bsr as ops
    from lsbench_tpu_torch.ops import spmv_sell
    from lsbench_tpu_torch.ordering import rcm_ordering

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    # kernel → (layout index in `layouts[label]`, its packed form, what
    # the pack reads)
    packs = {
        "spmv_bsr_compact_f32": (2, lambda C: C.packed(), "exact blocks"),
        "spmv_bsr_selector_f32": (1, lambda B: B.packed("selector"),
                                  "selector"),
        "spmv_bsr_onehot_f32": (1, lambda B: B.packed("onehot"), "onehot")}
    layouts, pack_ms = {}, {}
    for label, A in matrices.items():
        P = A.permuted(rcm_ordering(A))
        t0 = time.perf_counter()
        B = BsrMatrix.from_csr(P, device=dev, with_sel=True)
        C = BsrCompact.from_csr(P, device=dev)
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0
        for name, (idx, pack, what) in packs.items():
            # The first pack of the process, then the same pack again on a
            # copy of the layout (`.to` starts an empty cache).
            times = []
            layout = (None, B, C)[idx]
            for lay in (layout, layout.to(dev)):
                t0 = time.perf_counter()
                packed = pack(lay)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            pack_ms[label, name] = times
            print(f"pack {what} {label} RCM: n_stored={packed.n_stored} "
                  f"nnz={packed.nnz} in {times[0]:.2f} ms (again "
                  f"{times[1]:.2f} ms)")
        x_np = rng.standard_normal(P.ncols)
        layouts[label] = (P, B, C, x_np, torch.as_tensor(
            x_np, dtype=torch.float32, device=dev))
        print(f"variant layouts {label} RCM: uniform G={B.n_groups} "
              f"S={B.slots} C={B.n_col_blocks} ({B.bytes_streamed} B blocks,"
              f" {B.sel.numel() * 4} B selector), exact T={C.n_blocks} "
              f"({C.bytes_streamed} B) built in {built_s:.2f} s")

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
    check(api_counts["sell_f32"] == 0,
          f"K6/K7/K8 counted under sell_f32: {api_counts}")
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

    sell_fn = _cuda.library("sell_spmv").lsb_spmv_sell_f32
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device=dev)  # 256 MB
    stream = torch.cuda.current_stream().cuda_stream

    def sell_args(S, x, y):
        return (S.vals.data_ptr(), S.cols.data_ptr(), S.slice_off.data_ptr(),
                x.data_ptr(), y.data_ptr(), S.nrows, stream)

    def sell_bytes(S):  # vals f32, cols int32, slice_off int64
        return 8 * S.n_stored + 8 * S.slice_off.numel()

    results = {}
    for label, (P, B, C, x_np, x) in layouts.items():
        lib = library_ms(P, torch.float32, x)
        io_bytes = (P.ncols + P.nrows) * 4
        b_ms, b_by = function_bound(P, 4, "f32")
        # spmv_sell on the CSR's own SELL layout: K6, K7 and K8 must give
        # its bits, and are timed beside it on the same operator.
        R = SellMatrix.from_csr(P, device=dev)
        y_sell = spmv_sell.spmv_sell(R, x)
        y_buf = torch.empty(P.nrows, dtype=torch.float32, device=dev)
        sell_warm = profiled_kernel_ms(sell_fn, sell_args(R, x, y_buf),
                                       "spmv_sell_f32_kernel")
        sell_cold = profiled_kernel_ms(sell_fn, sell_args(R, x, y_buf),
                                       "spmv_sell_f32_kernel", flush)
        sell_ms = median_ms(lambda: spmv_sell.spmv_sell(R, x))
        sell_host_ms = host_call_ms(lambda: spmv_sell.spmv_sell(R, x))
        print(f"spmv_sell_f32 [{label} RCM sell, same operator]: wrapper "
              f"{sell_ms:.4f} ms (host {sell_host_ms:.4f} ms per call), "
              f"device (profiler) L2-warm {_fmt(sell_warm)} ms, L2-cold "
              f"{_fmt(sell_cold)} ms")
        # What K6, K7 and K8 streamed per call before they ran on the
        # packed layout: the dense blocks and their block ids (K6: bcols
        # and one range offset per row group) or the selector.
        earlier = {
            "spmv_bsr_compact_f32": (C.bytes_streamed + 4 * (
                C.bcols.numel() + C.n_groups + 1), "exact blocks"),
            "spmv_bsr_selector_f32": (B.bytes_streamed + B.sel.numel() * 4,
                                      "uniform + selector"),
            "spmv_bsr_onehot_f32": (B.bytes_streamed
                                    + 4 * B.block_cols.numel(), "uniform")}
        for name, (fn, plain, idx) in entries.items():
            op = (P, B, C)[idx]
            y_k, y_again, y_p = fn(op, x), fn(op, x), plain(op, x)
            torch.cuda.synchronize()
            scale = float(y_p.abs().max())
            err = float((y_k - y_p).abs().max())
            tol = 1e-5 * scale
            check(err <= tol, f"{name} [{label}]: max|kernel - plain| = "
                              f"{err:.3e} > {tol:.3e}")
            ms = median_ms(lambda: fn(op, x))
            plain_ms = median_ms(lambda: plain(op, x))
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
            times = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=lib)
            check(torch.equal(y_k, y_sell), f"{name} [{label}]: not "
                  "spmv_sell(SellMatrix.from_csr(P), x) bit for bit")
            check(torch.equal(y_k, y_again),
                  f"{name} [{label}]: not bitwise repeatable")
            S = packs[name][1](op)
            nbytes, kind = sell_bytes(S), f"packed {packs[name][2]}"
            host_ms = host_call_ms(lambda: fn(op, x))
            args = sell_args(S, x, y_buf)
            warm = profiled_kernel_ms(sell_fn, args, "spmv_sell_f32_kernel")
            cold = profiled_kernel_ms(sell_fn, args, "spmv_sell_f32_kernel",
                                      flush)
            # One launch per call is the counter's to show (the API
            # path); the trace shows that nothing else runs on the card
            # (no fill, no copy). It may miss some of the launches.
            per_call = wrapper_device_ops(lambda: fn(op, x))
            check(set(per_call) <= {"spmv_sell_f32_kernel"},
                  f"{name} [{label}]: device work per call {per_call}")
            was, was_kind = earlier[name]
            lay_ms = layout_bound_ms(nbytes + io_bytes)
            first, again = pack_ms[label, name]
            times.update(pack_ms=first, pack_again_ms=again,
                         wrapper_host_ms=host_ms, device_ms_l2_warm=warm,
                         device_ms_l2_cold=cold, layout_bound_ms=lay_ms,
                         layout_bytes=nbytes, earlier_design_bytes=was,
                         device_ops_per_call=per_call,
                         sell_same_operator={
                             "ms": sell_ms,
                             "wrapper_host_ms": sell_host_ms,
                             "device_ms_l2_warm": sell_warm,
                             "device_ms_l2_cold": sell_cold})
            ratio = (f"{warm / sell_warm:.3f}" if warm and sell_warm
                     else "n/a")
            extra = (f"; pack {first:.2f} ms (again {again:.2f}), host "
                     f"{host_ms:.4f} ms per call, device (profiler) "
                     f"L2-warm {_fmt(warm)} ms ({ratio}x spmv_sell's), "
                     f"L2-cold {_fmt(cold)} ms, device work per call "
                     f"{per_call}, wrapper {ms / lib:.3f}x cuSPARSE; "
                     f"earlier design {was} B ({was_kind}): layout "
                     f"bound {layout_bound_ms(was + io_bytes):.4f} ms")
            print(f"kernel {name} [{label} RCM {kind}]: max_abs_err="
                  f"{err:.3e} (tol {tol:.3e}) host_err="
                  f"{host_errs[label, name]:.3e} wrapper {ms:.4f} ms "
                  f"({nbytes / ms / 1e6:.1f} GB/s of {nbytes} B) plain "
                  f"{plain_ms:.4f} ms{extra}")
            print(f"  bound {b_ms:.4f} ms ({b_by}), layout bound "
                  f"{layout_bound_ms(nbytes + io_bytes):.4f} ms, cuSPARSE "
                  f"{lib:.4f} ms")
            if label == "poisson_2d(512)":
                entry.update(times, shape=f"{label} RCM {kind}")
        del R
    del layouts, flush
    torch.cuda.empty_cache()
    return results, api_counts


def wrapper_device_ops(fn, calls: int = 20) -> dict:
    """Device work per call of `fn` under torch.profiler: {kernel, copy or
    memset name: events in the trace / calls}; the SELL f32 kernel under
    its short name."""
    import collections
    fn()

    def run():
        for _ in range(calls):
            fn()
    short = "spmv_sell_f32_kernel"
    names = collections.Counter(short if short in e["name"] else e["name"]
                                for e in traced_device_events(run))
    return {k: v / calls for k, v in names.items()}


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
            check(ran["sell_f64"] > 0, f"{label}: sell_f64 never launched")
            check(ran["bsr_f32"] == ran["bsr_classed_f32"]
                  == ran["sell_f32"] == 0,
                  f"{label}: an f32 kernel launched with the ELL layout: "
                  f"{ran}")
        print(f"{argv[1]} --opt {argv[-1]} path {label}: "
              f"iters={rec['iters']} passes={rec.get('refine_passes')} "
              f"precision={rec['precision']} "
              f"true_relres={rec['true_relres']:.3e} "
              f"setup_s={rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
              f"cli_wall_s={wall:.2f} launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
    return counts


def direct_paths_phase(tmp: str, matrices, A64, spchol_cache: str
                       ) -> list[dict]:
    """The direct solvers through the CLI: the default solver (cholmod) and
    cusolver on random_spd(6408,23), cholmod --ordering amd (delegated to
    the sparse host schedule) and sparse_cholesky's blocked device schedule
    on poisson_2d(512), cholmod --nrhs 8, and cholmod on poisson_2d(64) on
    the card against --platform cpu. The two AMD runs on poisson_2d(512)
    read their ordering and factor from `spchol_cache` (`--cache-dir`),
    which the harness phase filled. Returns each path's launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    files = {}
    for label, A in (*matrices.items(), ("poisson_2d(64)", A64)):
        files[label] = os.path.join(tmp, label.split("(")[0]
                                    + f"_{A.nrows}_direct.txt")
        write_matrix(A, files[label])
    rspd, p512 = files["random_spd(6408,23)"], files["poisson_2d(512)"]
    timed = ["--rtol", "1e-10", "--trials", "2", "--warmups", "1", "--json"]
    counts = []

    def dense_ir(label, fname, argv, solver, nrhs=1):
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(label, fname, argv + timed)
        check(rec["solver"] == solver, f"{label}: solver {rec['solver']}")
        check(rec["precision"] == "fp64(fp32_ir_auto)",
              f"{label}: precision {rec['precision']}")
        check(rec.get("nrhs", 1) == nrhs, f"{label}: nrhs {rec.get('nrhs')}")
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"{label}: true_relres {rec['true_relres']:.3e}")
        check(ran["sell_f64"] > 0, f"{label}: sell_f64 never launched {ran}")
        print(f"{label} path: passes={rec['refine_passes']} precision="
              f"{rec['precision']} true_relres={rec['true_relres']:.3e} "
              f"setup_s={rec['setup_s']:.3f} (factor_s="
              f"{rec['setup_breakdown']['factor_s']:.3f}) solve_s="
              f"{rec['solve_s']:.5f}"
              + (f" per-RHS ms={rec['solve_s'] / nrhs * 1e3:.3f} relres_cols="
                 f"{max(rec['relres_cols']):.3e}" if nrhs > 1 else "")
              + f" first_call_s={rec['first_call_s']:.3f} cli_wall_s="
              f"{wall:.2f} launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
        return rec

    dense_ir("cholmod (no --solver) random_spd(6408,23)", rspd, [], "cholmod")
    dense_ir("cusolver random_spd(6408,23)", rspd, ["--solver", "cusolver"],
             "cusolver")

    for label, argv, schedule in (
            ("cholmod --ordering amd poisson_2d(512)",
             ["--solver", "cholmod", "--ordering", "amd"], "host"),
            ("sparse_cholesky block --ordering amd poisson_2d(512)",
             ["--solver", "sparse_cholesky", "--opt", "schedule=block",
              "--ordering", "amd"], "block")):
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(label, p512, argv + [
            "--rtol", "1e-10", "--trials", "1", "--warmups", "1", "--json",
            "--cache-dir", spchol_cache])
        check("factor_s" not in rec["setup_breakdown"],
              f"{label}: the factor was not read from the cache")
        check(rec["schedule"] == schedule, f"{label}: schedule "
                                           f"{rec['schedule']}")
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"{label}: true_relres {rec['true_relres']:.3e}")
        if schedule == "host":
            check(rec.get("delegated") == "sparse_cholesky",
                  f"{label}: delegated {rec.get('delegated')}")
            check(sum(ran.values()) == 0, f"{label}: host schedule launched "
                                          f"{ran}")
        else:
            check(rec["precision"] == "fp64(fp32_ir_auto)",
                  f"{label}: precision {rec['precision']}")
            check(ran["sell_f64"] > 0, f"{label}: sell_f64 never launched")
        bd = rec["setup_breakdown"]
        print(f"{label} path: delegated={rec.get('delegated')} schedule="
              f"{rec['schedule']} precision={rec['precision']} fill_nnz="
              f"{rec['fill_nnz']} (the JAX package's AMD: 9.06M) blocks="
              f"{rec['blocks']} levels={rec['levels']} true_relres="
              f"{rec['true_relres']:.3e} setup_s={rec['setup_s']:.3f} "
              f"(ordering_s={bd['ordering_s']:.3f}, factor cached, "
              f"level_build_s={bd['level_build_s']:.3f}) solve_s="
              f"{rec['solve_s']:.4f} first_call_s={rec['first_call_s']:.3f} "
              f"cli_wall_s={wall:.2f} launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)

    dense_ir("cholmod --nrhs 8 random_spd(6408,23)", rspd,
             ["--solver", "cholmod", "--nrhs", "8"], "cholmod", nrhs=8)

    t0 = time.perf_counter()
    small = ["--solver", "cholmod", "--trials", "1", "--warmups", "1",
             "--json"]
    f64 = files["poisson_2d(64)"]
    rec_dev, ran, _ = cli_path("cholmod 64 cuda", f64, small)
    counts.append(ran)
    check(ran["sell_f64"] > 0, f"cholmod poisson_2d(64): launches {ran}")
    rec_cpu, ran_cpu, _ = cli_path("cholmod 64 cpu", f64,
                                   small + ["--platform", "cpu"])
    check(sum(ran_cpu.values()) == 0, f"--platform cpu launched {ran_cpu}")
    for where, rec in (("card", rec_dev), ("cpu", rec_cpu)):
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"cholmod poisson_2d(64) {where}: true_relres "
              f"{rec['true_relres']:.3e}")
    check(rec_dev["refine_passes"] == rec_cpu["refine_passes"],
          f"cholmod poisson_2d(64): {rec_dev['refine_passes']} passes on the "
          f"card, {rec_cpu['refine_passes']} with the plain versions")
    print(f"cholmod poisson_2d(64): card {rec_dev['refine_passes']} passes, "
          f"true_relres {rec_dev['true_relres']:.3e}; plain (cpu) "
          f"{rec_cpu['refine_passes']}, {rec_cpu['true_relres']:.3e} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    return counts


def fp64_direct_measurement(A) -> dict:
    """Native FP64 against f32 + refinement for the dense direct path on
    random_spd(6408,23), natural order, b[i] = i: `torch.linalg.cholesky` in
    f64 with two f64 triangular solves and the two refinement passes of the
    JAX package's non-TPU branch (residual on the f64 ELL product), against
    the port's `cholesky_ir` (factor once: the f32 inverse; refactor: an
    f32 factor in every solve). Measured only; no path calls the f64 route.
    Returns each one's true relres, factor and solve seconds."""
    import torch

    from lsbench_tpu_torch.matrix.ell import EllMatrix
    from lsbench_tpu_torch.ops.spmv import spmv_ell
    from lsbench_tpu_torch.solvers.direct import (CholeskyIrSolver, _tri,
                                                  _symmetric_dense)
    dev = torch.device("cuda")
    b_np = np.arange(A.nrows, dtype=np.float64)
    b = torch.as_tensor(b_np, device=dev)

    def relres(x):
        x = x.cpu().numpy()
        return float(np.linalg.norm(b_np - A.matvec(x))
                     / np.linalg.norm(b_np))

    def wall(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times))

    sym = torch.as_tensor(_symmetric_dense(A), device=dev)
    ell = EllMatrix.from_csr(A, dtype=torch.float64, device=dev)
    L, factor_s = wall(lambda: torch.linalg.cholesky(sym))

    def f64_solve(L):
        x = _tri(L, b)
        for _ in range(2):
            x = x + _tri(L, b - spmv_ell(ell, x))
        return x

    x, solve_s = wall(lambda: f64_solve(L))
    out = {"fp64 factor once": dict(true_relres=relres(x), factor_s=factor_s,
                                    solve_s=solve_s)}
    x, solve_s = wall(lambda: f64_solve(torch.linalg.cholesky(sym)))
    out["fp64 refactor"] = dict(true_relres=relres(x), solve_s=solve_s)
    del sym, L
    for label, refactor in (("cholesky_ir factor once", False),
                            ("cholesky_ir refactor", True)):
        t0 = time.perf_counter()
        s = CholeskyIrSolver(A, ordering="none", rtol=1e-10,
                             refactor_each_solve=refactor, device=dev)
        setup_s = time.perf_counter() - t0
        fn = s.solve_fn()
        x, solve_s = wall(lambda: fn(b))
        out[label] = dict(true_relres=relres(x), setup_s=setup_s,
                          solve_s=solve_s,
                          refine_passes=s.solve(b).extra["refine_passes"])
        del s, fn
    torch.cuda.empty_cache()
    for label, m in out.items():
        print(f"fp64 vs f32+IR [{label}]: "
              + " ".join(f"{k}={v:.4e}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in m.items()))
    return out


def krylov_paths_phase(tmp: str, matrices) -> list[dict]:
    """GMRES and the block-Jacobi and Chebyshev preconditioners through the
    CLI, each with RCM at full width: `gmres --precond amg_classical` on
    poisson_2d(512) (fp64, delegated to gmres_ir: SELL f32 and K4 in the
    V-cycle, SELL f64 residual), `gmres` on random_spd(6408,23) (Jacobi)
    at fp64 and at fp32 (its own bar: the f32 rtol it is given), and
    `cg_ir --precond chebyshev` and `--precond block_jacobi` on
    poisson_2d(512). Returns each path's launch counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    files = {}
    for label, A in matrices.items():
        files[label] = os.path.join(tmp, label.split("(")[0] + "_krylov.txt")
        write_matrix(A, files[label])
    runs = (  # (label, matrix, argv, precision, rtol, kernels that must run)
        ("gmres amg_classical", "poisson_2d(512)",
         ["--solver", "gmres", "--precond", "amg_classical"],
         "fp64(fp32_ir_auto)", 1e-10, ("sell_f32", "well_f32", "sell_f64")),
        ("gmres", "random_spd(6408,23)", ["--solver", "gmres"],
         "fp64(fp32_ir_auto)", 1e-10, ("sell_f32", "sell_f64")),
        ("gmres --precision fp32", "random_spd(6408,23)",
         ["--solver", "gmres", "--precision", "fp32"], "fp32", 1e-5,
         ("sell_f32",)),
        ("cg_ir chebyshev", "poisson_2d(512)",
         ["--solver", "cg_ir", "--precond", "chebyshev"], "fp64", 1e-10,
         ("sell_f32", "sell_f64")),
        ("cg_ir block_jacobi", "poisson_2d(512)",
         ["--solver", "cg_ir", "--precond", "block_jacobi"], "fp64", 1e-10,
         ("sell_f32", "sell_f64")))
    counts = []
    for label, matrix, argv, precision, rtol, expect in runs:
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(
            f"{label} {matrix}", files[matrix],
            [*argv, "--ordering", "rcm", "--rtol", str(rtol), "--trials",
             "2", "--warmups", "1", "--json"])
        check(rec["solver"] == argv[1], f"{label} {matrix}: solver "
                                        f"{rec['solver']}")
        check(rec["precision"] == precision,
              f"{label} {matrix}: precision {rec['precision']}")
        check(rec["converged"] is True and rec["true_relres"] <= rtol,
              f"{label} {matrix}: converged {rec['converged']} true_relres "
              f"{rec['true_relres']:.3e} > {rtol}")
        for k in expect:
            check(ran[k] > 0, f"{label} {matrix}: kernel {k} never "
                              f"launched {ran}")
        check(ran["bsr_f32"] == ran["bsr_classed_f32"] == 0,
              f"{label} {matrix}: a BSR kernel launched {ran}")
        if precision == "fp32":
            check(ran["sell_f64"] == 0, f"{label}: f64 residual at fp32 {ran}")
        bd = rec["setup_breakdown"]
        print(f"{label} path {matrix}: iters={rec['iters']} "
              f"passes={rec.get('refine_passes')} precision="
              f"{rec['precision']} true_relres={rec['true_relres']:.3e} "
              f"setup_s={rec['setup_s']:.3f} (precond_s="
              f"{bd.get('precond_s', float('nan')):.3f}) solve_s="
              f"{rec['solve_s']:.4f} first_call_s={rec['first_call_s']:.3f} "
              f"cli_wall_s={wall:.2f} launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
    return counts


def fp64_gmres_measurement(A) -> dict:
    """Native FP64 GMRES against `gmres_ir` on random_spd(6408,23), RCM,
    Jacobi, rtol 1e-10, b[i] = i: `gmres_loop` in f64 on `spmv_sell_f64`
    called directly (no solver takes this route: fp64 `gmres` delegates to
    `gmres_ir`), against `GmresIrSolver` (f32 GMRES on `spmv_sell` + the
    f64 residual). Returns each one's true relres, inner iterations and
    median solve seconds."""
    import torch

    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops.spmv_sell import spmv_sell_f64
    from lsbench_tpu_torch.ordering import rcm_ordering
    from lsbench_tpu_torch.solvers.gmres import gmres_loop, max_restarts_for
    from lsbench_tpu_torch.solvers.preconditioners import jacobi_precond
    from lsbench_tpu_torch.solvers.refine import GmresIrSolver

    dev = torch.device("cuda")
    P = A.permuted(rcm_ordering(A))
    b_np = np.arange(P.nrows, dtype=np.float64)
    b = torch.as_tensor(b_np, device=dev)

    def relres(x):
        return float(np.linalg.norm(b_np - P.matvec(x.cpu().numpy()))
                     / np.linalg.norm(b_np))

    def wall(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return out, float(np.median(times))

    S = SellMatrix.from_csr(P, dtypes=(torch.float64,), device=dev)
    pstate, papply = jacobi_precond(P, torch.float64, dev)
    cap = max_restarts_for(P, None, 30)
    (x, iters, _, _), solve_s = wall(lambda: gmres_loop(
        lambda v: spmv_sell_f64(S, v), lambda r: papply(pstate, r), b,
        1e-10, cap, 30, torch.float64))
    out = {"native fp64 gmres_loop": dict(true_relres=relres(x),
                                          iters=iters, solve_s=solve_s)}
    s = GmresIrSolver(P, rtol=1e-10, device=dev)
    res, solve_s = wall(lambda: s.solve(b))
    out["gmres_ir"] = dict(true_relres=relres(res.x), iters=res.iters,
                           refine_passes=res.extra["refine_passes"],
                           solve_s=solve_s)
    for label, m in out.items():
        print(f"fp64 gmres vs gmres_ir [{label}]: "
              + " ".join(f"{k}={v:.4e}" if isinstance(v, float) else
                         f"{k}={v}" for k, v in m.items()))
    return out


def spsv_ms(cp, ci, cx, b, lower: bool) -> tuple[float | None, str]:
    """Median time of cuSPARSE's triangular solve (`torch.triangular_solve`
    with L, or Lᵀ, as a sparse CSR tensor on the card) on one sweep of b:
    the library call computing the kernel's function, timed only. Returns
    (None, why) where the build refuses the call."""
    import warnings

    import torch
    n = len(cp) - 1
    col_of = np.repeat(np.arange(n), np.diff(cp))
    if lower:  # CSR of L: the CSC entries sorted by row
        order = np.lexsort((col_of, ci))
        rows, cols, vals = ci[order], col_of[order], cx[order]
        offs = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=offs[1:])
    else:  # CSR of Lᵀ is L's CSC
        offs, cols, vals = cp, ci, cx
    dev = b.device
    try:
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore")
            M = torch.sparse_csr_tensor(
                torch.as_tensor(offs, dtype=torch.int64, device=dev),
                torch.as_tensor(cols, dtype=torch.int64, device=dev),
                torch.as_tensor(vals, dtype=b.dtype, device=dev),
                size=(n, n))
            b2 = b[:, None]
            torch.triangular_solve(b2, M, upper=not lower)
            return median_ms(lambda: torch.triangular_solve(
                b2, M, upper=not lower)), ""
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def profiled_sweep_ms(fn, args, launches: int, sweeps: int = 20
                      ) -> tuple[float | None, int]:
    """The sweep kernels' own device time per sweep: the length of the
    union of the `tri_sweep_*_kernel` events' intervals in the profiler's
    trace of `sweeps` calls of fn(*args) (of `launches` launches each),
    over `sweeps` (a union, not a sum: each launch is a programmatic
    dependent launch, which may start while the one before it runs and
    wait for it); and the number of such events. A first traced sweep, not
    counted, and a ~10 ms spin kernel at the start of the measured trace
    warm the profiler up (traces have lost the events of their first
    milliseconds). None for the time where the trace holds another number
    of events than it launched."""
    import torch

    from lsbench_tpu_torch.harness.profile_solve import _union_us

    def run():
        torch.cuda._sleep(20_000_000)
        for _ in range(sweeps):
            fn(*args)
    traced_device_events(lambda: fn(*args))
    events = [e for e in traced_device_events(run)
              if e["cat"] == "kernel" and "tri_sweep_" in e["name"]]
    if len(events) != sweeps * launches:
        return None, len(events)
    return _union_us(events) / sweeps / 1e3, len(events)


def _plan_summary(S) -> str:
    from lsbench_tpu_torch.ops import tri_sweep as ts
    runs = [(int(l1 - l0), int(w)) for k, l0, l1, w in S.plan
            if k not in (ts.WIDE, ts.PRE)]
    pairs = sum(1 for k in S.plan[:, 0] if k == ts.PAIR)
    pres = sum(1 for k in S.plan[:, 0] if k == ts.PRE)
    wide = sum(1 for k in S.plan[:, 0] if k == ts.WIDE)
    lanes = np.bincount(S.lvl_lg.cpu().numpy().astype(np.int64))
    return (f"{len(S.plan)} launches ({len(runs)} runs ({pairs} pair, "
            f"{pres} after a pre-pass launch) of "
            f"{sum(n for n, _ in runs)} levels on "
            f"{sorted({w for _, w in runs})} threads, {wide} wide; levels "
            f"by lanes per row "
            f"{ {1 << i: int(c) for i, c in enumerate(lanes) if c} })")


def tri_chain_floor(dev) -> dict:
    """The run kernel on a pure chain: a bidiagonal L (diagonal 2,
    subdiagonal −1), n = 4096, every level one row: one run launch per
    `MAX_RUN_LEVELS` levels. Each sweep within the tolerance of its plain
    version; the µs per level of the forward sweep is the design's
    per-level floor, printed beside the bytes bound."""
    import torch

    from lsbench_tpu_torch.ops import tri_sweep as ts
    from lsbench_tpu_torch.solvers import sparse_cholesky as sc

    n = 4096
    cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.r_[np.full(n - 1, 2), 1], out=cp[1:])
    ci = np.empty(cp[-1], dtype=np.int64)
    ci[cp[:-1]] = np.arange(n)
    ci[cp[:-2] + 1] = np.arange(1, n)
    cx = np.full(cp[-1], -1.0)
    cx[cp[:-1]] = 2.0
    host, meta = sc.pack_tri_host(cp, ci, cx, n)
    check(meta["nlev_f"] == meta["nlev_b"] == n, "chain: one row per level")
    b = np.random.default_rng(13).standard_normal(n)
    out = {}
    for dtype in (torch.float32, torch.float64):
        f64 = dtype == torch.float64
        state = sc.upload_tri(host, dtype, dev, plain=True)
        bt = torch.as_tensor(b, dtype=dtype, device=dev)
        runs = -(-n // ts.MAX_RUN_LEVELS)
        for S in (state.f, state.b):
            x, x_p = ts.tri_sweep(S, bt), ts.tri_sweep_plain(S, bt)
            err = float((x - x_p).abs().max())
            tol = (1e-12 if f64 else 1e-5) * float(x_p.abs().max())
            check(err <= tol and len(S.plan) == runs
                  and set(S.plan[:, 0].tolist()) == {ts.PAIR},
                  f"chain {dtype}: {err:.3e} > {tol:.3e} or plan "
                  f"{S.plan.tolist()}")
        ms = median_ms(lambda: ts.tri_sweep(state.f, bt))
        dev_ms, _ = profiled_sweep_ms(ts.tri_sweep, (state.f, bt), runs)
        vb = 8 if f64 else 4
        nbytes = (n - 1) * (vb + 4) + 3 * n * vb
        b_ms, _ = bound(nbytes, 2 * n, "f64" if f64 else "f32")
        key = "f64" if f64 else "f32"
        out[key] = dict(ms=ms, device_ms=dev_ms, us_per_level=ms * 1e3 / n,
                        device_us_per_level=(None if dev_ms is None
                                             else dev_ms * 1e3 / n),
                        bound_ms=b_ms)
        print(f"tri sweep chain floor [{key}, bidiagonal n={n}, {n} "
              f"levels, {runs} launch(es)]: wrapper {ms:.4f} ms = "
              f"{ms * 1e3 / n:.4f} us per level; device (profiler) "
              f"{_fmt(dev_ms)} ms; bytes bound {b_ms:.4f} ms ({nbytes} B)")
    return out


def tri_sweep_phase(matrices) -> dict:
    """The triangular-sweep kernels against their plain version (the JAX
    package's `_sweep` in torch ops) on the factors the new paths sweep:
    the IC(0) factor of RCM poisson_2d(512) (f32: `cg_ir --precond ic0`;
    f64 too), the AMD sparse Cholesky factor of poisson_2d(512) (f32: the
    `level` schedule; f64 too) and the IC(0) factor of RCM
    random_spd(6408,23) (f64: `cg --precond ic0`). Each sweep within
    1e-5·max|x| (f32) or 1e-12·max|x| (f64) of the plain version, one
    launch per segment of its plan, bitwise repeatable; k = 8 columns in
    one launch per segment, bitwise repeatable, each column within the
    same tolerance of the k = 1 sweep of that column; a forced capacity
    (256 rows on IC(0) of poisson_2d(512) in f32, 64 on IC(0) of
    random_spd in f64) so that runs and wide levels alternate, against the
    plain version. Prints the launches per sweep, the wrapper's
    CUDA-event ms per sweep (k = 1 and 8) and per apply, µs per level, the
    kernels' own device ms per sweep (profiler), the plain version's ms,
    the bytes bound (each factor entry, b, x and dinv read or written once,
    ÷ 3.35 TB/s), cuSPARSE's SpSV (`torch.triangular_solve` with a sparse
    CSR L) and the host's native `spchol.tri_solve` on the same factor;
    then the chain floor (`tri_chain_floor`). Returns the record
    entries."""
    import torch

    from lsbench_tpu_torch.native import spchol
    from lsbench_tpu_torch.ops import tri_sweep as ts
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.solvers import sparse_cholesky as sc
    from lsbench_tpu_torch.solvers.ic0 import ic0_factor

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    A512, rspd = matrices["poisson_2d(512)"], matrices["random_spd(6408,23)"]

    def ic0_of(A, ordering):
        return ic0_factor(A.permuted(get_ordering(ordering, A)))

    def amd_factor(A):
        As = sc.symmetrize(A.permuted(get_ordering("amd", A)))
        return sc.numeric_factor(As, *sc.symbolic_rows(
            As, sc.elimination_tree(As)))

    cases = (  # (label, factor, dtypes, record key, forced capacity)
        ("IC(0) poisson_2d(512) RCM", lambda: ic0_of(A512, "rcm"),
         (torch.float32, torch.float64), None, (torch.float32, 256)),
        ("AMD factor poisson_2d(512)", lambda: amd_factor(A512),
         (torch.float32, torch.float64), "amd_factor", None),
        ("IC(0) random_spd(6408,23) RCM", lambda: ic0_of(rspd, "rcm"),
         (torch.float64,), "random_spd(6408,23)", (torch.float64, 64)))
    results = {}

    def held(tag, S, b, x, tol_rel):
        """x against the plain sweep; returns max |x − plain|."""
        x_p = ts.tri_sweep_plain(S, b)
        check(x.shape == b.shape and bool(torch.isfinite(x).all()),
              f"{tag}: bad output")
        err = float((x - x_p).abs().max())
        tol = tol_rel * float(x_p.abs().max())
        check(err <= tol, f"{tag}: max|kernel - plain| = {err:.3e} > "
                          f"{tol:.3e}")
        return err

    for label, make, dtypes, key, forced in cases:
        t0 = time.perf_counter()
        cp, ci, cx = make()
        factor_s = time.perf_counter() - t0
        n = len(cp) - 1
        t0 = time.perf_counter()
        host, meta = sc.pack_tri_host(cp, ci, cx, n)
        pack_s = time.perf_counter() - t0
        b_np = rng.standard_normal(n)
        b8_np = rng.standard_normal((n, 8))
        host_x = spchol.tri_solve(cp, ci, cx, b_np)
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            spchol.tri_solve(cp, ci, cx, b_np)
            walls.append(time.perf_counter() - t0)
        host_ms = float(np.median(walls)) * 1e3
        nnz = int(cp[-1]) - n
        print(f"tri sweep [{label}]: n={n} strict-lower nnz={nnz} "
              f"nlev_f={meta['nlev_f']} nlev_b={meta['nlev_b']} segments="
              f"{meta['n_segments']} pad_waste={meta['waste']:.4f} "
              f"factor_s={factor_s:.2f} pack_tri_host_s={pack_s:.2f} host "
              f"spchol.tri_solve {host_ms:.4f} ms per apply (both sweeps)")
        for dtype in dtypes:
            f64 = dtype == torch.float64
            name = "tri_sweep_f64" if f64 else "tri_sweep_f32"
            tol_rel = 1e-12 if f64 else 1e-5
            tag = f"{name} [{label}]"
            t0 = time.perf_counter()
            state = sc.upload_tri(host, dtype, dev, plain=True)
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            print(f"  {tag} plan: forward {_plan_summary(state.f)}, "
                  f"backward {_plan_summary(state.b)}")
            b = torch.as_tensor(b_np, dtype=dtype, device=dev)
            b8 = torch.as_tensor(b8_np, dtype=dtype, device=dev)
            errs, k8_errs = {}, {}
            for sweep, S in (("f", state.f), ("b", state.b)):
                ts.reset_launches()
                x_k = ts.tri_sweep(S, b)
                torch.cuda.synchronize()
                check(ts.LAUNCHES[name] == len(S.plan),
                      f"{tag} {sweep}: {ts.LAUNCHES[name]} launches, plan "
                      f"has {len(S.plan)}")
                check(torch.equal(ts.tri_sweep(S, b), x_k),
                      f"{tag} {sweep}: not bitwise repeatable")
                errs[sweep] = held(f"{tag} {sweep}", S, b, x_k, tol_rel)
                # k = 8: one launch per segment for all columns.
                ts.reset_launches()
                X = ts.tri_sweep(S, b8)
                torch.cuda.synchronize()
                check(ts.LAUNCHES[name] == len(S.plan),
                      f"{tag} {sweep} k=8: {ts.LAUNCHES[name]} launches for "
                      f"{len(S.plan)} segments")
                check(torch.equal(ts.tri_sweep(S, b8), X),
                      f"{tag} {sweep} k=8: not bitwise repeatable")
                worst = 0.0
                for j in range(8):
                    x1 = ts.tri_sweep(S, b8[:, j].contiguous())
                    err = float((X[:, j] - x1).abs().max())
                    tol = tol_rel * float(x1.abs().max())
                    check(err <= tol, f"{tag} {sweep} k=8 column {j}: "
                                      f"{err:.3e} > {tol:.3e} of k=1")
                    worst = max(worst, err)
                k8_errs[sweep] = worst
            state.check()
            x = sc.apply_tri(state, b).double().cpu().numpy()
            apply_err = float(np.abs(x - host_x).max() / np.abs(host_x).max())
            check(apply_err <= (1e-12 if f64 else 1e-4),
                  f"{tag}: apply vs host f64 tri_solve {apply_err:.3e}")
            ms_f = median_ms(lambda: ts.tri_sweep(state.f, b))
            ms_b = median_ms(lambda: ts.tri_sweep(state.b, b))
            ms_f8 = median_ms(lambda: ts.tri_sweep(state.f, b8))
            ms_apply = median_ms(lambda: sc.apply_tri(state, b))
            plain_ms = median_ms(lambda: ts.tri_sweep_plain(state.f, b),
                                 reps=5)
            dev_ms, ev_f = profiled_sweep_ms(ts.tri_sweep, (state.f, b),
                                             len(state.f.plan))
            dev_b_ms, ev_b = profiled_sweep_ms(ts.tri_sweep, (state.b, b),
                                               len(state.b.plan))
            vb = 8 if f64 else 4
            nbytes = nnz * (vb + 4) + 3 * n * vb
            b_ms, b_by = bound(nbytes, 2 * nnz + 2 * n, "f64" if f64 else "f32")
            lib_f, why_f = spsv_ms(cp, ci, cx, b, lower=True)
            lib_b, why_b = spsv_ms(cp, ci, cx, b, lower=False)
            launches = (len(state.f.plan), len(state.b.plan))
            print(f"kernel {tag}: max_abs_err f={errs['f']:.3e} b="
                  f"{errs['b']:.3e}, k=8 vs k=1 f={k8_errs['f']:.3e} b="
                  f"{k8_errs['b']:.3e} (apply vs host f64 {apply_err:.3e}) "
                  f"upload_s={upload_s:.2f}; launches per sweep {launches}; "
                  f"wrapper forward {ms_f:.4f} ms "
                  f"({ms_f * 1e3 / meta['nlev_f']:.3f} us per level), "
                  f"backward {ms_b:.4f} ms "
                  f"({ms_b * 1e3 / meta['nlev_b']:.3f} us per level), "
                  f"forward k=8 {ms_f8:.4f} ms, apply {ms_apply:.4f} ms; "
                  f"device (profiler) forward {_fmt(dev_ms)} ms, backward "
                  f"{_fmt(dev_b_ms)} ms ({ev_f} and {ev_b} kernel events "
                  f"for {20 * launches[0]} and {20 * launches[1]} "
                  f"launches); plain forward {plain_ms:.4f} ms")
            print(f"  bound {b_ms:.4f} ms ({b_by}, {nbytes} B); cuSPARSE "
                  f"SpSV forward {_fmt(lib_f)} ms{' ' + why_f if why_f else ''}"
                  f", backward {_fmt(lib_b)} ms{' ' + why_b if why_b else ''}"
                  f"; host spchol.tri_solve {host_ms:.4f} ms per apply")
            times = dict(max_abs_err=max(errs.values()), ms=ms_f,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_f, shape=f"{label} forward sweep",
                         backward_ms=ms_b, apply_ms=ms_apply, k8_ms=ms_f8,
                         k8_max_abs_err=max(k8_errs.values()),
                         launches_per_sweep=launches,
                         device_ms_profiler=dev_ms,
                         device_backward_ms_profiler=dev_b_ms,
                         nlev=(meta["nlev_f"], meta["nlev_b"]),
                         us_per_level=ms_f * 1e3 / meta["nlev_f"],
                         library_backward_ms=lib_b,
                         host_tri_solve_ms=host_ms)
            if lib_f is None:
                times["library_note"] = why_f
            del state
            if forced is not None and forced[0] == dtype:
                cap = forced[1]
                host_cap, _ = sc.pack_tri_host(cp, ci, cx, n, capacity=cap)
                state = sc.upload_tri(host_cap, dtype, dev, plain=True)
                del host_cap
                for sweep, S in (("f", state.f), ("b", state.b)):
                    kinds = set(int(k) for k in S.plan[:, 0])
                    check(ts.WIDE in kinds and kinds & {ts.RUN, ts.PAIR},
                          f"{tag} capacity {cap} {sweep}: plan kinds {kinds}")
                    ts.reset_launches()
                    x_w = ts.tri_sweep(S, b)
                    torch.cuda.synchronize()
                    check(ts.LAUNCHES[name] == len(S.plan),
                          f"{tag} capacity {cap}: launches")
                    check(torch.equal(ts.tri_sweep(S, b), x_w),
                          f"{tag} capacity {cap}: not bitwise repeatable")
                    err = held(f"{tag} capacity {cap} {sweep}", S, b, x_w,
                               tol_rel)
                ms_w = median_ms(lambda: ts.tri_sweep(state.f, b))
                print(f"  {tag} forced capacity {cap}: forward "
                      f"{_plan_summary(state.f)}, backward "
                      f"{_plan_summary(state.b)}; max_abs_err {err:.3e}; "
                      f"wrapper forward {ms_w:.4f} ms")
                times["forced_wide"] = dict(
                    capacity=cap, ms=ms_w, max_abs_err=err,
                    launches_per_sweep=(len(state.f.plan),
                                        len(state.b.plan)))
                del state
            entry = results.setdefault(name, {"max_abs_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"],
                                       times["max_abs_err"])
            if key is None:
                entry.update(times)
            else:
                entry[key] = times
            del b, b8
        torch.cuda.empty_cache()
    floor = tri_chain_floor(dev)
    results["tri_sweep_f32"]["chain_floor"] = floor["f32"]
    results["tri_sweep_f64"]["chain_floor"] = floor["f64"]
    return results


def tri_paths_phase(tmp: str, matrices, spchol_cache: str) -> list[dict]:
    """The slice-10 paths through the CLI: `cg_ir --precond ic0` on RCM
    poisson_2d(512) (f32 sweeps), fp64 `cg --precond ic0` on RCM
    random_spd(6408,23) (f64 sweeps, SELL f64 SpMV), `sparse_cholesky --opt
    schedule=level --ordering amd` on poisson_2d(512) (f32 sweeps refined
    by the SELL f64 residual; its AMD ordering and factor read from
    `spchol_cache`) and `cholesky_band` (RCM) on both matrices (f32 band
    factor, SELL f64 residual); each to true relres ≤ 1e-10. The n=262k
    runs take one trial and one warm-up. Returns each path's launch
    counts."""
    from lsbench_tpu_torch.matrix.io import write_matrix

    files = {}
    for label, A in matrices.items():
        files[label] = os.path.join(tmp, label.split("(")[0] + "_tri.txt")
        write_matrix(A, files[label])
    one = ["--trials", "1", "--warmups", "1"]
    two = ["--trials", "2", "--warmups", "1"]
    runs = (  # (path, matrix, argv, precision, kernels that must run)
        ("cg_ir --precond ic0", "poisson_2d(512)",
         ["--solver", "cg_ir", "--precond", "ic0", "--ordering", "rcm",
          *one], "fp64", ("tri_sweep_f32", "sell_f32", "sell_f64")),
        ("cg --precond ic0", "random_spd(6408,23)",
         ["--solver", "cg", "--precond", "ic0", "--ordering", "rcm", *two],
         "fp64", ("tri_sweep_f64", "sell_f64")),
        ("sparse_cholesky --opt schedule=level --ordering amd",
         "poisson_2d(512)",
         ["--solver", "sparse_cholesky", "--opt", "schedule=level",
          "--ordering", "amd", "--cache-dir", spchol_cache, *one],
         "fp64(fp32_ir_auto)",
         ("tri_sweep_f32", "sell_f64")),
        ("cholesky_band", "random_spd(6408,23)",
         ["--solver", "cholesky_band", "--ordering", "rcm", *two],
         "fp64(fp32_ir_auto)", ("sell_f64",)),
        ("cholesky_band", "poisson_2d(512)",
         ["--solver", "cholesky_band", "--ordering", "rcm", *one],
         "fp64(fp32_ir_auto)", ("sell_f64",)))
    counts = []
    for path, matrix, argv, precision, expect in runs:
        label = f"{path} {matrix}"
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(label, files[matrix],
                                  [*argv, "--rtol", "1e-10", "--json"])
        check(rec["solver"] == argv[1], f"{label}: solver {rec['solver']}")
        check(rec["precision"] == precision,
              f"{label}: precision {rec['precision']}")
        check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
              f"{label}: converged {rec['converged']} true_relres "
              f"{rec['true_relres']:.3e}")
        for k in expect:
            check(ran[k] > 0, f"{label}: kernel {k} never launched {ran}")
        check(ran["bsr_f32"] == ran["bsr_classed_f32"] == ran["bsr_f64acc"]
              == 0, f"{label}: a BSR kernel launched {ran}")
        if "--cache-dir" in argv:
            check("factor_s" not in rec["setup_breakdown"],
                  f"{label}: the factor was not read from the cache")
        if argv[1] == "cholesky_band":
            check(ran["tri_sweep_f32"] == ran["tri_sweep_f64"] == 0,
                  f"{label}: the band solve launched a sweep {ran}")
        bd = rec["setup_breakdown"]
        detail = {"cg_ir": f"precond_s={bd.get('precond_s', 0):.3f}",
                  "cg": f"precond_s={bd.get('precond_s', 0):.3f}",
                  "sparse_cholesky":
                      f"fill_nnz={rec.get('fill_nnz')} levels="
                      f"{rec.get('levels')} pad_waste="
                      f"{rec.get('pad_waste', 0):.4f} ordering_s="
                      f"{bd.get('ordering_s', 0):.3f}, factor cached, "
                      f"level_build_s={bd.get('level_build_s', 0):.3f}",
                  "cholesky_band":
                      f"bandwidth={rec.get('bandwidth')} layout_s="
                      f"{bd.get('layout_s', 0):.3f} factor_s="
                      f"{bd.get('factor_s', 0):.3f}"}[argv[1]]
        print(f"{label} path: iters={rec['iters']} passes="
              f"{rec.get('refine_passes')} precision={rec['precision']} "
              f"true_relres={rec['true_relres']:.3e} setup_s="
              f"{rec['setup_s']:.3f} ({detail}) solve_s={rec['solve_s']:.4f} "
              f"first_call_s={rec['first_call_s']:.3f} cli_wall_s={wall:.2f} "
              f"launches={ran} phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
    return counts


def _csr_max_diff(M1, M2) -> float:
    """max |M1 − M2| over the union of the two patterns."""
    from lsbench_tpu_torch.matrix.csr import CsrMatrix
    r1, c1, v1 = M1.to_coo()
    r2, c2, v2 = M2.to_coo()
    D = CsrMatrix.from_coo(np.concatenate([r1, r2]), np.concatenate([c1, c2]),
                           np.concatenate([v1, -v2]), nrows=M1.nrows,
                           ncols=M1.ncols)
    return float(np.abs(D.vals).max())


def harness_paths_phase(tmp: str, matrices, amg_cache: str,
                        spchol_cache: str) -> list[dict]:
    """The harness slice at n=262,144: the setup cache (exact and pattern
    hits of the AMG-CG-IR hierarchy that the AMG paths phase stored in
    `amg_cache`, the numeric RAP against the host, the sparse Cholesky
    factor into `spchol_cache`), the main path phase's `--roofline` records
    (L2-cold, against this phase's own profiled cold SELL f32 time),
    `--profile-dir` and `--debug-nans`. `tmp` holds the AMG paths phase's
    poisson_2d(512) file. Returns each path's launch counts."""
    import torch

    from lsbench_tpu_torch.harness import cache
    from lsbench_tpu_torch.harness.profile_solve import _device_events
    from lsbench_tpu_torch.matrix.csr import CsrMatrix
    from lsbench_tpu_torch.matrix.io import read_matrix, write_matrix
    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import _cuda
    from lsbench_tpu_torch.ops import spmv_sell as ops
    from lsbench_tpu_torch.ops.spgemm import rap
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.solvers import amg, get_solver
    from lsbench_tpu_torch.utils import debug

    A = matrices["poisson_2d(512)"]
    f512 = os.path.join(tmp, "poisson_512.txt")  # the AMG paths phase's
    frs = os.path.join(tmp, "random_spd.txt")
    write_matrix(matrices["random_spd(6408,23)"], frs)
    counts = []
    timed = ["--trials", "2", "--warmups", "1", "--json"]

    # Exact hit: the AMG paths phase's run, again.
    t0 = time.perf_counter()
    rec, ran, wall = cli_path("amg-cg-ir exact hit", f512,
                              [*AMG_CG_IR, "--cache-dir", amg_cache])
    miss = HARNESS["amg_miss"]
    bd = rec["setup_breakdown"]
    check(bd["hier_cache"] == "exact_hit", f"exact hit: {bd['hier_cache']}")
    check(rec["iters"] == miss["iters"]
          and rec["true_relres"] == miss["true_relres"],
          f"exact hit: iters {rec['iters']} true_relres "
          f"{rec['true_relres']!r}, miss {miss['iters']} "
          f"{miss['true_relres']!r}")
    for k in ("sell_f32", "well_f32", "sell_f64"):
        check(ran[k] > 0, f"exact hit: kernel {k} never launched")
    print(f"cache exact hit poisson_2d(512): hier_cache=exact_hit iters="
          f"{rec['iters']} true_relres={rec['true_relres']:.3e} (miss: "
          f"{miss['iters']}, {miss['true_relres']:.3e}) setup_s="
          f"{rec['setup_s']:.3f} (miss {miss['setup_s']:.3f}; precond_s="
          f"{bd['precond_s']:.3f}) solve_s={rec['solve_s']:.4f} cli_wall_s="
          f"{wall:.2f} launches={ran} phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    # Pattern hit: A2 = D·A·D, D smooth in the natural grid order.
    t0 = time.perf_counter()
    g = 512
    d = 1.0 + 0.5 * (np.arange(A.nrows) // g) / (g - 1)
    A2 = CsrMatrix(A.nrows, A.ncols, A.offs, A.cols,
                   d[A.row_indices()] * A.vals * d[A.cols])
    f2 = os.path.join(tmp, "poisson_512_dad.txt")
    write_matrix(A2, f2)
    write_s = time.perf_counter() - t0
    amg._REFRESHERS.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rec, ran, wall = cli_path("amg-cg-ir pattern hit", f2,
                              [*AMG_CG_IR, "--cache-dir", amg_cache])
    peak = torch.cuda.max_memory_allocated()
    bd = rec["setup_breakdown"]
    check(bd["hier_cache"] == "pattern_hit_device_rap",
          f"pattern hit: {bd['hier_cache']}")
    check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
          f"pattern hit: true_relres {rec['true_relres']:.3e}")
    for k in ("sell_f32", "well_f32", "sell_f64"):
        check(ran[k] > 0, f"pattern hit: kernel {k} never launched")
    (refresher,) = amg._REFRESHERS.values()
    plan_bytes = sum(t.numel() * t.element_size()
                     for p in refresher._plans for q in (p.ra, p.rap)
                     for t in (q.a_idx, q.b_idx, q.slot_pos, *q.pads))
    triples = [(p.ra.a_idx.numel(), p.rap.a_idx.numel())
               for p in refresher._plans]
    counts.append(ran)
    hit = rec
    rec, ran, wall2 = cli_path("amg-cg-ir D·A·D rebuild", f2, AMG_CG_IR)
    check(rec["setup_breakdown"]["hier_cache"] == "miss",
          f"rebuild: {rec['setup_breakdown']['hier_cache']}")
    check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
          f"rebuild: true_relres {rec['true_relres']:.3e}")
    counts.append(ran)
    print(f"cache pattern hit poisson_2d(512) D·A·D: hier_cache="
          f"pattern_hit_device_rap iters={hit['iters']} passes="
          f"{hit['refine_passes']} true_relres={hit['true_relres']:.3e} "
          f"setup_s={hit['setup_s']:.3f} (rap_symbolic_s="
          f"{bd['rap_symbolic_s']:.3f} rap_device_s="
          f"{bd['rap_device_s']:.4f} precond_s={bd['precond_s']:.3f}; miss "
          f"{miss['setup_s']:.3f}) solve_s={hit['solve_s']:.4f} "
          f"peak_device_mem_bytes={peak} plan_bytes={plan_bytes} "
          f"triples(ra, rap) per level={triples} cli_wall_s={wall:.2f}; "
          f"full rebuild: iters={rec['iters']} passes="
          f"{rec['refine_passes']} true_relres={rec['true_relres']:.3e} "
          f"setup_s={rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
          f"cli_wall_s={wall2:.2f}; write_s={write_s:.2f}")

    # The refreshed level-1 operator against the host RAP, and repeatable.
    t0 = time.perf_counter()
    A2p = read_matrix(f2)
    A2p = A2p.permuted(get_ordering("rcm", A2p))
    vals1 = refresher.level_values(A2p.vals)
    torch.cuda.synchronize()
    rap_s = time.perf_counter() - t0
    vals2 = refresher.level_values(A2p.vals)
    check(all(torch.equal(a, b) for a, b in zip(vals1, vals2)),
          "numeric RAP: a second refresh differs")
    m0, nxt = refresher._mats[0], refresher._mats[1]["A"]
    got = CsrMatrix(nxt.nrows, nxt.ncols, nxt.offs, nxt.cols,
                    vals1[1].cpu().numpy())
    ref = rap(m0["P"].transpose(), A2p, m0["P"])
    rel = _csr_max_diff(got, ref) / float(np.abs(ref.vals).max())
    check(rel <= 1e-12, f"numeric RAP level 1: rel diff {rel:.3e} > 1e-12")
    print(f"numeric RAP level 1 (n={nxt.nrows}, nnz={nxt.nnz}) vs host "
          f"rap(P0ᵀ, A2, P0): max rel diff {rel:.3e}; second refresh "
          f"bitwise equal; chain + read back {rap_s:.4f} s "
          f"phase_s={time.perf_counter() - t0:.2f}")
    amg._REFRESHERS.clear()
    del refresher, vals1, vals2
    torch.cuda.empty_cache()

    # --roofline: the main path phase's records, held to the phase's own
    # profiled cold SELL f32 time of the same operator.
    flush = torch.empty(64 * 2**20, dtype=torch.float32, device="cuda")
    for label in matrices:
        t0 = time.perf_counter()
        rec = HARNESS[label]
        r = rec["roofline"]
        for k in ("hbm_utilization", "function_utilization"):
            check(r[k] is not None and 0 < r[k] <= 1.05,
                  f"roofline {label}: {k} {r[k]}")
        M = matrices[label]
        M = M.permuted(get_ordering("rcm", M))
        S = SellMatrix.from_csr(M, dtypes=(torch.float32,), device="cuda")
        check(S.bytes_streamed == r["stream_bytes"],
              f"roofline {label}: stream_bytes {r['stream_bytes']} vs the "
              f"layout's {S.bytes_streamed}")
        x = torch.rand(M.ncols, device="cuda")
        y = torch.empty(M.nrows, device="cuda")
        args = (S.vals.data_ptr(), S.cols.data_ptr(), S.slice_off.data_ptr(),
                x.data_ptr(), y.data_ptr(), M.nrows,
                torch.cuda.current_stream().cuda_stream)
        fn = _cuda.library("sell_spmv").lsb_spmv_sell_f32
        cold = profiled_kernel_ms(fn, args, "spmv_sell_f32_kernel",
                                  flush=flush)
        ratio = r["spmv_s"] * 1e3 / cold
        check(1 / 1.5 <= ratio <= 1.5,
              f"roofline {label}: spmv_s {r['spmv_s'] * 1e3:.4f} ms vs the "
              f"profiled cold kernel {cold:.4f} ms")
        print(f"roofline {label} (cg_ir --roofline, main path phase): "
              f"{json.dumps(r)} profiled cold kernel {cold:.4f} ms (ratio "
              f"{ratio:.3f}) phase_s={time.perf_counter() - t0:.2f}")
        if label == "poisson_2d(512)":
            # --debug-nans: the wrapper raises on the card; off, NaN passes.
            x[0] = float("nan")
            check(bool(torch.isnan(ops.spmv_sell(S, x)).any()),
                  "debug-nans off: the NaN did not pass through")
            debug.enable_debug_nans(True)
            try:
                ops.spmv_sell(S, x)
                raised = None
            except FloatingPointError as e:
                raised = str(e)
            finally:
                debug.enable_debug_nans(False)
            check(raised is not None and "spmv_sell_f32" in raised,
                  f"debug-nans: spmv_sell on the card raised {raised!r}")
            print(f"--debug-nans on the card: spmv_sell raised "
                  f"FloatingPointError({raised!r}); off, the NaN passed")
        del S, x, y

    t0 = time.perf_counter()
    prof = os.path.join(tmp, "prof")
    rec, ran, wall = cli_path(
        "cg_ir --profile-dir random_spd(6408,23)", frs,
        ["--solver", "cg_ir", "--ordering", "rcm", "--rtol", "1e-10",
         "--profile-dir", prof, *timed])
    check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
          f"--profile-dir: true_relres {rec['true_relres']:.3e}")
    counts.append(ran)
    (path,) = [os.path.join(prof, f) for f in os.listdir(prof)]
    ev = _device_events(path)
    n_sell = sum(1 for e in ev if e["cat"] == "kernel"
                 and "spmv_sell_f32_kernel" in e["name"])
    check(n_sell > 0, f"--profile-dir: no spmv_sell_f32_kernel in {path} "
                      f"({len(ev)} device events)")
    print(f"--profile-dir random_spd(6408,23): {os.path.getsize(path)} B "
          f"trace, {len(ev)} device events, {n_sell} spmv_sell_f32_kernel "
          f"of the run's {ran['sell_f32']} launches; cli_wall_s={wall:.2f} "
          f"phase_s={time.perf_counter() - t0:.2f}")

    t0 = time.perf_counter()
    off = HARNESS["poisson_2d(512)"]
    on, ran, _ = cli_path(
        "cg_ir --debug-nans poisson_2d(512)", f512,
        ["--solver", "cg_ir", "--ordering", "rcm", "--rtol", "1e-10",
         "--debug-nans", *timed])
    counts.append(ran)
    check(on["iters"] == off["iters"] and on["true_relres"] <= 1e-10,
          f"--debug-nans: iters {on['iters']} vs {off['iters']}")
    print(f"cg_ir --debug-nans poisson_2d(512): iters={on['iters']} "
          f"(without, main path phase: {off['iters']}) solve_s="
          f"{on['solve_s']:.4f} (without: {off['solve_s']:.4f}) "
          f"phase_s={time.perf_counter() - t0:.2f}")

    # The sparse Cholesky factor: a miss, then a hit with the same x.
    t0 = time.perf_counter()
    A512 = read_matrix(f512)  # the file the CLI's AMD runs read
    cls, params = get_solver("sparse_cholesky")
    params.update(ordering="amd", device="cuda")
    b = np.arange(A512.nrows, dtype=np.float64)
    cache.enable(True)
    cache.set_cache_dir(spchol_cache)
    try:
        reset_counts()
        xs, setups = [], []
        for _ in range(2):
            t1 = time.perf_counter()
            solver = cls(A512, **params)
            setups.append((time.perf_counter() - t1,
                           dict(solver.setup_breakdown)))
            xs.append(solver.solve(b).x)
        ran = read_counts()
    finally:
        cache.enable(False)
    check("factor_s" in setups[0][1] and "factor_s" not in setups[1][1],
          f"spchol cache: breakdowns {setups}")
    check(torch.equal(xs[0], xs[1]), "spchol cache: the hit's x differs")
    counts.append(ran)
    (m_s, m_bd), (h_s, h_bd) = setups
    print(f"sparse_cholesky --ordering amd poisson_2d(512) cache: miss "
          f"setup_s={m_s:.3f} (ordering_s={m_bd['ordering_s']:.3f} "
          f"symbolic_s={m_bd['symbolic_s']:.3f} factor_s="
          f"{m_bd['factor_s']:.3f}), hit setup_s={h_s:.3f} (ordering_s="
          f"{h_bd['ordering_s']:.3f}); x bitwise equal; "
          f"phase_s={time.perf_counter() - t0:.2f}")
    return counts


def distributed_paths_phase(tmp: str, matrices, card: str) -> list[dict]:
    """The row-partitioned solvers (`parallel/`) through the CLI with
    `--devices 1`: an NCCL group of one on the card, every collective a
    real NCCL call. `cg_ir --ordering rcm --rtol 1e-10` and `cg --nrhs 8`
    on poisson_2d(512), `ginkgo` (f64 BiCGSTAB, rtol 1e-4), `gmres` and `cg`
    (f64) on random_spd(6408,23), each through the SELL kernels of its
    precision, then the single-device run of the same command. Then,
    not counted as paths: the distributed `cg_ir` x against the
    single-device x (< 1e-9), the D = 4 per-rank operators of RCM
    poisson_2d(512) (each rank's SELL f32, f64 and k = 8 SpMM kernels on an
    x_ext assembled by hand, against their plain versions and, rows
    concatenated, the host product), and `--devices` one more than the
    cards exiting 1 with the JAX package's message; the AMG family and the
    2-D grid (`amg_and_grid_paths`, `grid_operator_check`,
    `amg_transfer_check`) and `--mesh 2x2 --devices 1` exiting 1. Returns
    each path's launch counts."""
    import torch
    import torch.distributed as dist

    from lsbench_tpu_torch.harness.cli import main as cli_main
    from lsbench_tpu_torch.matrix.generate import poisson_2d
    from lsbench_tpu_torch.matrix.io import write_matrix
    from lsbench_tpu_torch.ops import spmv_sell
    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.parallel.dist_cg_ir import DistributedCgIr
    from lsbench_tpu_torch.parallel.dist_spmv import (build_halo_sell_plan,
                                                      fused_psum)
    from lsbench_tpu_torch.parallel.mesh import make_row_mesh
    from lsbench_tpu_torch.solvers.refine import CgIrSolver

    files = {}
    for label, A in matrices.items():
        files[label] = os.path.join(tmp, label.split("(")[0] + "_dist.txt")
        write_matrix(A, files[label])
    quick = ["--trials", "2", "--warmups", "1", "--json"]
    p512, rspd = "poisson_2d(512)", "random_spd(6408,23)"
    runs = (  # (label, matrix, argv, precision, rtol, kernels that must run)
        ("cg_ir", p512, ["--solver", "cg_ir", "--ordering", "rcm", "--rtol",
                         "1e-10", "--trials", "1", "--warmups", "0",
                         "--json"], "fp64(fp32_ir_auto)", 1e-10,
         ("sell_f32", "sell_f64")),
        ("cg --nrhs 8", p512, ["--solver", "cg", "--nrhs", "8", "--ordering",
                               "rcm", "--rtol", "1e-10", "--trials", "1",
                               "--warmups", "0", "--json"],
         "fp64(fp32_ir)", 1e-10, ("sell_mm_f32", "sell_f64")),
        ("ginkgo", rspd, ["--solver", "ginkgo", "--ordering", "rcm", *quick],
         "fp64", 1e-4, ("sell_f64",)),
        ("gmres", rspd, ["--solver", "gmres", "--ordering", "rcm", "--rtol",
                         "1e-10", *quick], "fp64", 1e-10, ("sell_f64",)),
        ("cg", rspd, ["--solver", "cg", "--ordering", "rcm", "--rtol",
                      "1e-10", *quick], "fp64", 1e-10, ("sell_f64",)))
    counts = []
    for label, matrix, argv, precision, rtol, expect in runs:
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(f"{label} --devices 1 {matrix}",
                                  files[matrix], [*argv, "--devices", "1"])
        check(rec["precision"] == precision and rec["strategy"] == "halo"
              and rec["local_spmv"] == "bsr",
              f"{label} --devices 1: precision {rec['precision']} strategy "
              f"{rec.get('strategy')} local_spmv {rec.get('local_spmv')}")
        check(rec["converged"] is True and rec["true_relres"] <= rtol,
              f"{label} --devices 1 {matrix}: true_relres "
              f"{rec['true_relres']:.3e} > {rtol}")
        for k in expect:
            check(ran[k] > 0, f"{label} --devices 1: kernel {k} never "
                              f"launched {ran}")
        check(all(ran[k] == 0 for k in ran if k.startswith("bsr")),
              f"{label} --devices 1: a BSR kernel launched {ran}")
        DIST_RECORDS[label] = rec
        # The single-device run of the same command, right after it.
        one, _, one_wall = cli_path(f"{label} {matrix}", files[matrix], argv)
        print(f"distributed path {label} --devices 1 {matrix}: "
              f"iters={rec['iters']} passes={rec.get('refine_passes')} "
              f"true_relres={rec['true_relres']:.3e} setup_s="
              f"{rec['setup_s']:.3f} solve_s={rec['solve_s']:.4f} "
              f"first_call_s={rec['first_call_s']:.3f} cli_wall_s={wall:.2f}"
              f" | single-device {one['solver']} ({one['precision']}): "
              f"iters={one['iters']} passes={one.get('refine_passes')} "
              f"solve_s={one['solve_s']:.4f} cli_wall_s={one_wall:.2f} | "
              f"{card} | launches={ran} "
              f"phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)

    counts += amg_and_grid_paths(files[p512], card, DIST_RECORDS["cg_ir"])
    counts += multi_process_paths(files[p512], matrices[p512], card)

    # The distributed x against the single-device x, and the cost of one
    # fused all_reduce on NCCL at world size 1 (not paths).
    t0 = time.perf_counter()
    A = matrices[p512]
    b = np.arange(A.nrows, dtype=np.float64)
    with make_row_mesh(1, platform="cuda") as mesh:
        check(dist.get_backend(mesh.group) == "nccl",
              f"the card's group is {dist.get_backend(mesh.group)}")
        x_d = DistributedCgIr(A, mesh, ordering="rcm").solve(b).x
        one = torch.ones((), device=mesh.device)
        fused_psum(mesh, one, one)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(1000):
            s = fused_psum(mesh, one, one)
        float(s[0])
        psum_us = (time.perf_counter() - t1) * 1e3
    x_s = CgIrSolver(A, ordering="rcm", device="cuda").solve(b).x
    rel = float(torch.linalg.norm(x_d - x_s) / torch.linalg.norm(x_s))
    check(rel < 1e-9, f"cg_ir --devices 1 x vs single-device x: {rel:.3e}")
    print(f"cg_ir --devices 1 vs single-device x, {p512}: ‖Δx‖/‖x‖ = "
          f"{rel:.3e} (< 1e-9), group backend nccl; one fused_psum of two "
          f"scalars on NCCL at world size 1: {psum_us:.2f} µs (host clock, "
          f"1000 calls); {time.perf_counter() - t0:.2f} s")
    # The same at n=16384: the per-iteration price of the collectives.
    f128 = os.path.join(tmp, "poisson_2d_128_dist.txt")
    write_matrix(poisson_2d(128), f128)
    small = ["--solver", "cg_ir", "--ordering", "rcm", "--rtol", "1e-10",
             "--trials", "2", "--warmups", "1", "--json"]
    r1 = cli_path("cg_ir poisson_2d(128)", f128, small)[0]
    rd = cli_path("cg_ir --devices 1 poisson_2d(128)", f128,
                  [*small, "--devices", "1"])[0]
    check(rd["iters"] == r1["iters"], f"poisson_2d(128): {rd['iters']} "
                                      f"iterations, single {r1['iters']}")
    print(f"cg_ir poisson_2d(128): --devices 1 solve_s={rd['solve_s']:.4f}, "
          f"single-device {r1['solve_s']:.4f}, {rd['iters']} iterations: "
          f"+{(rd['solve_s'] - r1['solve_s']) / rd['iters'] * 1e6:.1f} µs "
          f"per iteration")

    # Each D = 4 rank's operator on the card, from an x_ext built by hand.
    t0 = time.perf_counter()
    Ar = A.permuted(get_ordering("rcm", A))
    D, dev = 4, torch.device("cuda")
    rng = np.random.default_rng(12)
    x = rng.standard_normal(Ar.nrows)
    X = rng.standard_normal((Ar.nrows, 8))
    ys, Ys, errs = [], [], {"f32": 0.0, "f64": 0.0, "mm": 0.0}
    for r in range(D):
        p = build_halo_sell_plan(Ar, D, r, (torch.float32, torch.float64),
                                 device=dev)
        lo, H = r * p.nloc, p.halo
        check(not p.needs_all_gather and H > 0, f"rank {r}: halo {H}")

        def ext(v):
            pad = np.zeros((p.n_pad + 2 * H, *v.shape[1:]))
            pad[H: H + Ar.nrows] = v
            return torch.as_tensor(pad[lo: lo + p.n_ext], device=dev)
        x64 = ext(x)
        x32 = x64.float()
        X32 = ext(X).float().contiguous()
        y32 = spmv_sell.spmv_sell(p.sell, x32)
        y64 = spmv_sell.spmv_sell_f64(p.sell, x64)
        Y32 = spmv_sell.spmm_sell(p.sell, X32)
        torch.cuda.synchronize()
        scale, mscale = float(y64.abs().max()), float(Y32.abs().max())
        e32 = float((y32 - spmv_sell.spmv_sell_plain(p.sell, x32)).abs().max())
        e64 = float((y64 - spmv_sell.spmv_sell_f64_plain(p.sell, x64)
                     ).abs().max())
        emm = float((Y32 - spmv_sell.spmm_sell_plain(p.sell, X32)).abs().max())
        check(e32 <= 1e-5 * scale and e64 <= 1e-13 * scale
              and emm <= 1e-5 * mscale,
              f"rank {r} of 4: kernel vs plain f32 {e32:.3e} f64 {e64:.3e} "
              f"spmm {emm:.3e} (scale {scale:.3e})")
        errs = {"f32": max(errs["f32"], e32), "f64": max(errs["f64"], e64),
                "mm": max(errs["mm"], emm)}
        ys.append(y64.cpu().numpy())
        Ys.append(Y32.double().cpu().numpy())
        print(f"  rank {r} of 4: rows [{lo}, {lo + p.nloc}) halo {H} n_ext "
              f"{p.n_ext} stored {p.sell.n_stored} nnz {p.sell.nnz}")
    y = np.concatenate(ys)[: Ar.nrows]
    Y = np.concatenate(Ys)[: Ar.nrows]
    host = Ar.matvec(x)
    host_X = np.stack([Ar.matvec(X[:, j]) for j in range(8)], axis=1)
    g64 = float(np.abs(y - host).max() / np.abs(host).max())
    gmm = float(np.abs(Y - host_X).max() / np.abs(host_X).max())
    check(g64 <= 1e-13 and gmm <= 2e-5,
          f"D=4 ranks concatenated vs host: f64 {g64:.3e} spmm {gmm:.3e}")
    print(f"D=4 per-rank operators, RCM {p512}: max |kernel - plain| "
          f"f32 {errs['f32']:.3e} f64 {errs['f64']:.3e} spmm(k=8) "
          f"{errs['mm']:.3e}; ranks concatenated vs host f64: f64 "
          f"{g64:.3e}, spmm {gmm:.3e} (relative to max|y|); "
          f"{time.perf_counter() - t0:.2f} s")

    grid_operator_check(Ar)
    amg_transfer_check(Ar)

    # More ranks than cards: refused before any rank starts.
    have = torch.cuda.device_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli_main(["--matrix", files[rspd], "--solver", "cg_ir",
                       "--devices", str(have + 1)])
    msg = f"requested {have + 1} devices, have {have}"
    check(rc == 1 and msg in err.getvalue() and not out.getvalue(),
          f"--devices {have + 1}: rc {rc}, stderr {err.getvalue()!r}")
    print(f"--devices {have + 1} on {have} card(s): exit 1, \"{msg}\"")
    # A grid whose size is not --devices: the JAX CLI's refusal.
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()) as out:
        rc = cli_main(["--matrix", files[rspd], "--solver", "cg_ir",
                       "--devices", "1", "--mesh", "2x2"])
    msg = "--mesh 2x2 needs 4 devices but --devices=1"
    check(rc == 1 and msg in err.getvalue() and not out.getvalue(),
          f"--mesh 2x2 --devices 1: rc {rc}, stderr {err.getvalue()!r}")
    print(f"--mesh 2x2 --devices 1: exit 1, \"{msg}\"")
    return counts


def free_port() -> int:
    """A TCP port of 127.0.0.1 that nothing listens on now."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def multi_process_paths(f512: str, A, card: str) -> list[dict]:
    """The last module slice's entry points on the card: the scaling sweep
    (`python -m lsbench_tpu_torch.scale`), the distributed dry run
    (`run_dryrun(1)`), the CLI's `--coordinator` group of one, then (not
    paths) the sweep's x against the single-device CG's and the
    communication model of RCM poisson_2d(512). Returns the three paths'
    launch counts: rank 0's, counted in its own process for the sweep and
    the dry run (their ranks are spawned), the CLI's here."""
    import torch

    from lsbench_tpu_torch.harness import scale
    from lsbench_tpu_torch.parallel.dryrun import run_dryrun

    counts = []
    # The scaling sweep on one card: the 1x1 record; 2 and 4 skipped.
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = scale.main(["--matrix", f512, "--devices", "1,2,4", "--iters",
                         "100", "--reps", "3", "--json", "--ordering", "rcm",
                         "--mesh2d"])
    recs = [json.loads(ln) for ln in out.getvalue().splitlines()
            if ln.startswith("{")]
    have = torch.cuda.device_count()
    skip = (f"# skipping device counts {[d for d in (2, 4) if d > have]}: "
            f"only {have} devices (cuda)")
    check(rc == 0 and [r["mesh"] for r in recs][:1] == ["1x1"]
          and (have > 1 or (len(recs) == 1 and skip in err.getvalue())),
          f"scale: rc {rc}, meshes {[r['mesh'] for r in recs]}, stderr "
          f"{err.getvalue()!r}")
    rec = recs[0]
    ran = rec["launches"]
    check(ran["sell_f64"] > 0 and not any(ran[k] for k in ran
                                          if k.startswith("bsr")),
          f"scale 1x1: launches {ran}")
    check(rec["strategy"] == "halo" and rec["iters"] == 100,
          f"scale 1x1: {rec}")
    print(f"multi-process path scale --devices 1,2,4 --iters 100 --reps 3 "
          f"--ordering rcm --mesh2d poisson_2d(512): mesh {rec['mesh']} "
          f"elapsed_s={rec['elapsed_s']} ({rec['elapsed_s'] / 100 * 1e6:.1f}"
          f" µs/iteration) Gnnz/s={rec['nnz_per_s'] / 1e9:.4f} strategy "
          f"{rec['strategy']}; stderr \"{err.getvalue().strip()}\" | {card} |"
          f" launches={ran} phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)
    t1_iter = rec["elapsed_s"] / 100

    # The dry run: every distributed solver, an NCCL group of one.
    t0 = time.perf_counter()
    dry = run_dryrun(1, platform="cuda")
    ran = dry["launches"]
    check(all(ran[k] > 0 for k in ("sell_f32", "sell_f64", "sell_mm_f32"))
          and not any(ran[k] for k in ran if k.startswith("bsr")),
          f"dryrun 1: launches {ran}")
    print("multi-process path parallel.dryrun 1 (cuda): " + ", ".join(
        f"{k} {it} it {r:.2e}" for k, (it, r) in dry["solves"].items())
        + f" | {card} | launches={ran} "
          f"phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)

    # --coordinator: a group of one process, meeting at a TCPStore.
    t0 = time.perf_counter()
    port = free_port()
    base = DIST_RECORDS["cg_ir"]
    argv = ["--solver", "cg_ir", "--ordering", "rcm", "--rtol", "1e-10",
            "--trials", "1", "--warmups", "0", "--json", "--devices", "1"]
    rec, ran, wall = cli_path(
        "cg_ir --coordinator --devices 1 poisson_2d(512)", f512,
        [*argv, "--coordinator", f"127.0.0.1:{port}", "--num-processes", "1",
         "--process-id", "0"])
    check(rec["iters"] == base["iters"]
          and rec["refine_passes"] == base["refine_passes"]
          and rec["converged"] is True and rec["true_relres"] <= 1e-10
          and "backend_init_s" in rec,
          f"--coordinator --devices 1: iters {rec['iters']} passes "
          f"{rec.get('refine_passes')} true_relres {rec['true_relres']:.3e}"
          f", --devices 1: {base['iters']} {base['refine_passes']}")
    check(ran["sell_f32"] > 0 and ran["sell_f64"] > 0
          and not any(ran[k] for k in ran if k.startswith("bsr")),
          f"--coordinator --devices 1: launches {ran}")
    print(f"multi-process path cg_ir --coordinator 127.0.0.1:{port} "
          f"--num-processes 1 --process-id 0 --devices 1 poisson_2d(512): "
          f"iters={rec['iters']} passes={rec['refine_passes']} "
          f"true_relres={rec['true_relres']:.3e} backend_init_s="
          f"{rec['backend_init_s']:.3f} solve_s={rec['solve_s']:.4f} "
          f"cli_wall_s={wall:.2f} | --devices 1 (FileStore): iters="
          f"{base['iters']} passes={base['refine_passes']} backend_init_s="
          f"{base['backend_init_s']:.3f} solve_s={base['solve_s']:.4f} | "
          f"{card} | launches={ran} phase_s={time.perf_counter() - t0:.2f}")
    counts.append(ran)
    for flags, msg in (
            (["--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
              "2", "--process-id", "2"], "process_id 2 out of range [0, 2)"),
            (["--coordinator", "nohost"],
             "coordinator must be 'host:port', got 'nohost'")):
        err = io.StringIO()
        with contextlib.redirect_stderr(err), \
                contextlib.redirect_stdout(io.StringIO()) as out:
            from lsbench_tpu_torch.harness.cli import main as cli_main
            rc = cli_main(["--matrix", f512, *argv, *flags])
        check(rc == 1 and msg in err.getvalue() and not out.getvalue(),
              f"{flags}: rc {rc}, stderr {err.getvalue()!r}")
        print(f"{' '.join(flags)}: exit 1, \"{msg}\"")

    fixed_iteration_x(A)
    comm_model_report(A, t1_iter, card)
    return counts


def fixed_iteration_x(A) -> None:
    """The sweep's solve through the solver API in a group of one: the
    distributed CG's x after 100 fixed iterations against the single-device
    f64 CG's after the same 100 (within 1e-12 relative)."""
    import torch

    from lsbench_tpu_torch.parallel.dist_cg import DistributedCg
    from lsbench_tpu_torch.parallel.mesh import make_row_mesh
    from lsbench_tpu_torch.solvers.cg import CgSolver

    t0 = time.perf_counter()
    b = np.arange(A.nrows, dtype=np.float64)
    with make_row_mesh(1, platform="cuda") as mesh:
        rd = DistributedCg(A, mesh, rtol=0.0, maxiter=100,
                           ordering="rcm").solve(b)
    rs = CgSolver(A, dtype=torch.float64, rtol=0.0, maxiter=100,
                  ordering="rcm", device="cuda").solve(b)
    rel = float(torch.linalg.norm(rd.x - rs.x) / torch.linalg.norm(rs.x))
    check(rd.iters == rs.iters == 100 and rel <= 1e-12,
          f"fixed-iteration x: iters {rd.iters}/{rs.iters}, rel {rel:.3e}")
    print(f"scale's solve, 100 fixed iterations, RCM poisson_2d(512): "
          f"DistributedCg (NCCL group of one) vs single-device f64 CG x: "
          f"‖Δx‖/‖x‖ = {rel:.3e} (≤ 1e-12); "
          f"{time.perf_counter() - t0:.2f} s")


def comm_model_report(A, t1_iter: float, card: str) -> None:
    """The communication model of RCM poisson_2d(512): the CG volumes at
    D = 1, 2, 4, 8 and on the 2 × 2 grid, the AMG-CG-IR solver's of the
    `--devices 1` path, and the predicted efficiency at D = 2, 4, 8 from
    the sweep's measured time per iteration. A model, not a
    measurement."""
    import dataclasses

    import torch

    from lsbench_tpu_torch.ordering import get_ordering
    from lsbench_tpu_torch.parallel import comm_model as cm
    from lsbench_tpu_torch.parallel.dist_amg import DistributedAmgCgIr
    from lsbench_tpu_torch.parallel.mesh import make_row_mesh

    t0 = time.perf_counter()
    Ar = A.permuted(get_ordering("rcm", A))
    f64 = torch.float64
    link = (f"link {cm.NVLINK4_GBPS} GB/s per direction (NVLink 4, data "
            f"sheet), hop {cm.NVLINK_HOP_LATENCY_S * 1e6} µs (assumed)")
    print(f"communication model (model, not a measurement), RCM "
          f"poisson_2d(512), f64; {link}; t1 = {t1_iter * 1e6:.1f} µs per "
          f"iteration (the scale sweep's 1x1 record on {card}):")
    for D in (1, 2, 4, 8):
        cv = cm.cg_comm_volume(Ar, D, f64)
        eff, t_d = cm.predict_efficiency(t1_iter, cv)
        print(f"  D={D}: {dataclasses.asdict(cv)} bytes_per_iter="
              f"{cv.bytes_per_iter}"
              + (f" predicted efficiency {eff:.3f} (t_iter "
                 f"{t_d * 1e6:.1f} µs)" if D > 1 else ""))
    cv = cm.cg2d_comm_volume(Ar, 2, 2, f64)
    eff, t_d = cm.predict_efficiency(t1_iter, cv)
    print(f"  2x2 grid: {dataclasses.asdict(cv)} predicted efficiency "
          f"{eff:.3f} (t_iter {t_d * 1e6:.1f} µs)")
    classical = dict(coarsening="classical", theta=0.5, interp="jacobi",
                     interp_passes=3, interp_omega=0.5, pmax=8)
    with make_row_mesh(1, platform="cuda") as mesh:
        s = DistributedAmgCgIr(A, mesh, **classical)
        av = cm.amg_comm_volume(s)
    check(av.n_devices == 1 and len(av.levels) == s.n_levels - 1
          and av.psums_per_iter == 2 and av.all_gathers_per_cycle == 1,
          f"AMG-CG-IR comm volume: {av}")
    print(f"  AMG-CG-IR (cg_ir --precond amg_classical --devices 1): "
          f"{s.n_levels} levels, per cycle {av.ppermutes_per_cycle} "
          f"ppermutes, {av.all_gathers_per_cycle} all_gathers, "
          f"{av.psums_per_cycle} psums; per iteration "
          f"{av.ppermutes_per_iter} ppermutes, {av.all_gathers_per_iter} "
          f"all_gathers, {av.psums_per_iter} psums ({av.psum_scalars} "
          f"scalars), {av.bytes_per_iter_payload} B (D = 1 moves none); "
          f"halos A {[lv.a_halo for lv in av.levels]}")
    print(f"  ({time.perf_counter() - t0:.2f} s)")


def amg_and_grid_paths(f512: str, card: str, dist_cg_ir: dict) -> list[dict]:
    """The AMG family over the ranks (`parallel/dist_amg.py`) and the 2-D
    grid (`parallel/dist2d.py`, `dist_amg2d.py`, the 2-D IR classes), each
    through the CLI as an NCCL group of one: `--devices 1`, and `--mesh
    1x1` (the grid's row and column groups, NCCL groups of one too), on
    poisson_2d(512). Returns each path's launch counts."""
    quick = ["--trials", "1", "--warmups", "0", "--json"]
    runs = (  # (label, argv, what must hold, kernels that must run)
        ("cg_ir amg_classical", [*AMG_CG_IR, "--devices", "1"],
         "ir", ("sell_f32", "sell_f64")),
        ("hypre", ["--solver", "hypre", "--trials", "2", "--warmups", "1",
                   "--json", "--devices", "1"], "fixed", ("sell_f64",)),
        ("paralmond", ["--solver", "paralmond", "--trials", "1",
                       "--warmups", "1", "--json", "--devices", "1"],
         "fixed", ("sell_f64",)),
        ("cg_ir --mesh 1x1", ["--solver", "cg_ir", "--ordering", "rcm",
                              "--rtol", "1e-10", *quick, "--devices", "1",
                              "--mesh", "1x1"], "ir", ("sell_f32", "sell_f64")),
        ("cg --nrhs 8 --mesh 1x1", ["--solver", "cg", "--nrhs", "8",
                                    "--ordering", "rcm", "--rtol", "1e-10",
                                    *quick, "--devices", "1", "--mesh",
                                    "1x1"], "ir",
         ("sell_mm_f32", "sell_f64")),
        ("cg --precond amg --mesh 1x1", ["--solver", "cg", "--precond",
                                         "amg", "--rtol", "1e-8", *quick,
                                         "--devices", "1", "--mesh", "1x1"],
         "converge", ()))
    counts = []
    for label, argv, kind, expect in runs:
        t0 = time.perf_counter()
        rec, ran, wall = cli_path(f"{label} --devices 1 poisson_2d(512)",
                                  f512, argv)
        what = f"{label} --devices 1"
        if kind == "ir":
            check(rec["converged"] is True and rec["true_relres"] <= 1e-10,
                  f"{what}: true_relres {rec['true_relres']:.3e} > 1e-10")
        elif kind == "converge":
            check(rec["converged"] is True
                  and rec["true_relres"] <= 1e-8,
                  f"{what}: not converged, true_relres "
                  f"{rec['true_relres']:.3e}")
        else:  # the fixed-cycle protocol: the residual is data
            check(bool(np.isfinite(rec["relres"])) and rec["relres"] < 1
                  and rec["iters"] == (2 if label == "hypre" else 1),
                  f"{what}: relres {rec['relres']} iters {rec['iters']}")
        if label == "cg_ir amg_classical":
            check(rec["precision"] == "fp64(fp32_ir_auto)"
                  and rec["local_spmv"] == "bsr",
                  f"{what}: precision {rec['precision']} local_spmv "
                  f"{rec['local_spmv']}")
            DIST_RECORDS[label] = rec
        if label == "cg_ir --mesh 1x1":
            base = dist_cg_ir["iters"]
            check(abs(rec["iters"] - base) <= 0.05 * base,
                  f"{what}: {rec['iters']} iterations, --devices 1 (1-D) "
                  f"{base}")
        if "--mesh" in label:
            check(rec["mesh"] == [1, 1], f"{what}: mesh {rec.get('mesh')}")
        for k in expect:
            check(ran[k] > 0, f"{what}: kernel {k} never launched {ran}")
        check(all(ran[k] == 0 for k in ran if k.startswith("bsr")),
              f"{what}: a BSR kernel launched {ran}")
        print(f"distributed path {what} poisson_2d(512): "
              f"iters={rec['iters']} passes={rec.get('refine_passes')} "
              f"levels={rec.get('levels')} local_spmv={rec['local_spmv']} "
              f"relres={rec['relres']:.3e} true_relres="
              f"{rec['true_relres']:.3e} setup_s={rec['setup_s']:.3f} "
              f"solve_s={rec['solve_s']:.4f} first_call_s="
              f"{rec['first_call_s']:.3f} cli_wall_s={wall:.2f} | {card} | "
              f"launches={ran} phase_s={time.perf_counter() - t0:.2f}")
        counts.append(ran)
    return counts


def grid_operator_check(Ar) -> None:
    """Each rank's block of a 2 x 2 grid of RCM poisson_2d(512), in its
    gathered frame, through the SELL f32, f64 and k = 8 SpMM kernels on an
    x assembled by hand, against their plain versions; the four partials
    summed and scattered on the host against the host product (one
    process, not a path)."""
    import torch

    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import spmv_sell as ss
    from lsbench_tpu_torch.parallel.dist2d import (build_2d_plan,
                                                   local_block_2d)
    t0 = time.perf_counter()
    pr = pc = 2
    plan = build_2d_plan(Ar, pr, pc, torch.float32)
    cs, rloc, dev = plan.csize, plan.rloc, torch.device("cuda")
    rng = np.random.default_rng(14)
    x = np.zeros(plan.n_pad)
    x[: Ar.nrows] = rng.standard_normal(Ar.nrows)
    X = np.zeros((plan.n_pad, 8))
    X[: Ar.nrows] = rng.standard_normal((Ar.nrows, 8))
    y32, y64, Y = (np.zeros(plan.n_pad), np.zeros(plan.n_pad),
                   np.zeros((plan.n_pad, 8)))
    errs = {"f32": 0.0, "f64": 0.0, "mm": 0.0}
    for i in range(pr):
        for j in range(pc):
            block = local_block_2d(Ar, pr, pc, i, j)
            S = SellMatrix.from_csr(block, (torch.float32, torch.float64),
                                    device=dev)
            # Grid column j's chunks j, pc + j, ... in ascending grid row.
            idx = np.concatenate([np.arange((a * pc + j) * cs,
                                            (a * pc + j + 1) * cs)
                                  for a in range(pr)])
            xg = torch.as_tensor(x[idx], device=dev)
            Xg = torch.as_tensor(X[idx], dtype=torch.float32, device=dev)
            p32, p64 = ss.spmv_sell(S, xg.float()), ss.spmv_sell_f64(S, xg)
            pmm = ss.spmm_sell(S, Xg)
            torch.cuda.synchronize()
            scale, mscale = float(p64.abs().max()), float(pmm.abs().max())
            e32 = float((p32 - ss.spmv_sell_plain(S, xg.float())).abs().max())
            e64 = float((p64 - ss.spmv_sell_f64_plain(S, xg)).abs().max())
            emm = float((pmm - ss.spmm_sell_plain(S, Xg)).abs().max())
            check(e32 <= 1e-5 * scale and e64 <= 1e-13 * scale
                  and emm <= 1e-5 * mscale,
                  f"grid rank ({i}, {j}): kernel vs plain f32 {e32:.3e} "
                  f"f64 {e64:.3e} spmm {emm:.3e} (scale {scale:.3e})")
            errs = {"f32": max(errs["f32"], e32), "f64": max(errs["f64"], e64),
                    "mm": max(errs["mm"], emm)}
            rows = slice(i * rloc, (i + 1) * rloc)  # row block i's partials
            y32[rows] += p32.double().cpu().numpy()
            y64[rows] += p64.cpu().numpy()
            Y[rows] += pmm.double().cpu().numpy()
            print(f"  grid rank ({i}, {j}) of 2x2: block {rloc} x "
                  f"{plan.n_gath}, nnz {block.nnz}, stored {S.n_stored}")
    host = Ar.matvec(x[: Ar.nrows])
    host_X = np.stack([Ar.matvec(X[: Ar.nrows, c]) for c in range(8)], 1)
    n = Ar.nrows
    g32 = float(np.abs(y32[:n] - host).max() / np.abs(host).max())
    g64 = float(np.abs(y64[:n] - host).max() / np.abs(host).max())
    gmm = float(np.abs(Y[:n] - host_X).max() / np.abs(host_X).max())
    check(g32 <= 1e-5 and g64 <= 1e-12 and gmm <= 1e-5,
          f"2x2 partials summed vs host: f32 {g32:.3e} f64 {g64:.3e} "
          f"spmm {gmm:.3e}")
    print(f"2x2 grid operators, RCM poisson_2d(512): max |kernel - plain| "
          f"f32 {errs['f32']:.3e} f64 {errs['f64']:.3e} spmm(k=8) "
          f"{errs['mm']:.3e}; partials summed and scattered vs host: f32 "
          f"{g32:.3e} f64 {g64:.3e} spmm {gmm:.3e} (relative to max|y|); "
          f"{time.perf_counter() - t0:.2f} s")


def amg_transfer_check(Ar) -> None:
    """Each D = 4 rank's block of every P and R of the `amg_classical`
    hierarchy of RCM poisson_2d(512) (as `DistributedAmgCgIr` lays them:
    the halo frame, or global columns where a transfer gathers), through
    the SELL f32, f64 and k = 8 SpMM kernels on an x assembled by hand,
    against their plain versions; the ranks' rows concatenated against the
    host product (one process, not a path)."""
    import torch

    from lsbench_tpu_torch.matrix.csr import CsrMatrix
    from lsbench_tpu_torch.matrix.sell import SellMatrix
    from lsbench_tpu_torch.ops import spmv_sell as ss
    from lsbench_tpu_torch.parallel.dist_amg import _pad_size
    from lsbench_tpu_torch.parallel.dist_spmv import (build_rect_halo_plan,
                                                      local_rect_block)
    from lsbench_tpu_torch.solvers.amg import (AmgOptions,
                                               build_matrix_hierarchy)
    t0 = time.perf_counter()
    D, dev = 4, torch.device("cuda")
    opts = AmgOptions(reorder_coarse=True, coarse_n=64,
                      coarsening="classical", theta=0.5, interp="jacobi",
                      interp_passes=3, interp_omega=0.5, pmax=8)
    mats, Ac = build_matrix_hierarchy(Ar, opts, device="cpu")
    t_h = time.perf_counter() - t0
    nl = [_pad_size(s, D) // D
          for s in [m["A"].nrows for m in mats] + [Ac.nrows]]
    rng = np.random.default_rng(15)
    errs = {"f32": 0.0, "f64": 0.0, "mm": 0.0, "host": 0.0}
    blocks = 0
    summary = []
    for lvl, m in enumerate(mats):
        for name, M, nr, nc in (("P", m["P"], nl[lvl], nl[lvl + 1]),
                                ("R", m["R"], nl[lvl + 1], nl[lvl])):
            plan = build_rect_halo_plan(M, D, nr, nc, torch.float64)
            H = plan.halo
            src = np.zeros(nc * D)
            src[: M.ncols] = rng.standard_normal(M.ncols)
            Xs = np.zeros((nc * D, 8))
            Xs[: M.ncols] = rng.standard_normal((M.ncols, 8))
            ys = []
            for r in range(D):
                if not plan.needs_all_gather:
                    block, _ = local_rect_block(M, D, r, nr, nc)
                    pad = np.zeros(nc * D + 2 * H)
                    pad[H: H + nc * D] = src
                    xr = pad[r * nc: r * nc + nc + 2 * H]
                    padX = np.zeros((nc * D + 2 * H, 8))
                    padX[H: H + nc * D] = Xs
                    Xr = padX[r * nc: r * nc + nc + 2 * H]
                else:  # the rank's rows with global column ids
                    rr, cc, vv = M.to_coo()
                    keep = (rr >= r * nr) & (rr < (r + 1) * nr)
                    block = (CsrMatrix.from_coo(
                        rr[keep] - r * nr, cc[keep], vv[keep], nrows=nr,
                        ncols=nc * D) if keep.any() else CsrMatrix(
                        nr, nc * D, np.zeros(nr + 1, np.int64),
                        np.zeros(0, np.int32), np.zeros(0)))
                    xr, Xr = src, Xs
                if block.nnz == 0:  # a rank of padding rows only
                    ys.append(np.zeros(nr))
                    continue
                S = SellMatrix.from_csr(block, (torch.float32, torch.float64),
                                        device=dev)
                x64 = torch.as_tensor(np.ascontiguousarray(xr), device=dev)
                X32 = torch.as_tensor(np.ascontiguousarray(Xr),
                                      dtype=torch.float32, device=dev)
                p32, p64 = ss.spmv_sell(S, x64.float()), ss.spmv_sell_f64(S, x64)
                pmm = ss.spmm_sell(S, X32)
                torch.cuda.synchronize()
                scale = float(p64.abs().max()) or 1.0
                mscale = float(pmm.abs().max()) or 1.0
                e32 = float((p32 - ss.spmv_sell_plain(S, x64.float())
                             ).abs().max())
                e64 = float((p64 - ss.spmv_sell_f64_plain(S, x64)).abs().max())
                emm = float((pmm - ss.spmm_sell_plain(S, X32)).abs().max())
                check(e32 <= 1e-5 * scale and e64 <= 1e-13 * scale
                      and emm <= 1e-5 * mscale,
                      f"level {lvl} {name} rank {r}: kernel vs plain f32 "
                      f"{e32:.3e} f64 {e64:.3e} spmm {emm:.3e}")
                errs = {"f32": max(errs["f32"], e32 / scale),
                        "f64": max(errs["f64"], e64 / scale),
                        "mm": max(errs["mm"], emm / mscale),
                        "host": errs["host"]}
                ys.append(p64.cpu().numpy())
                blocks += 1
            y = np.concatenate(ys)[: M.nrows]
            host = M.matvec(src[: M.ncols])
            g = float(np.abs(y - host).max() / (np.abs(host).max() or 1.0))
            check(g <= 1e-12, f"level {lvl} {name}: ranks vs host {g:.3e}")
            errs["host"] = max(errs["host"], g)
            summary.append(f"{name}{lvl}:{'gather' if plan.needs_all_gather else H}")
    print(f"D=4 AMG transfer blocks (amg_classical, RCM poisson_2d(512), "
          f"{len(mats) + 1} levels, hierarchy {t_h:.2f} s): {blocks} rank "
          f"blocks, halos {' '.join(summary)}; max |kernel - plain| / "
          f"max|y|: f32 {errs['f32']:.3e} f64 {errs['f64']:.3e} spmm(k=8) "
          f"{errs['mm']:.3e}; ranks concatenated vs host f64 "
          f"{errs['host']:.3e}; {time.perf_counter() - t0:.2f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import lsbench_tpu_torch  # noqa: F401  (fails here, before any output, outside the repo)
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    card = card_line()
    print(f"card: {card}  driver {card_line('driver_version')}  torch "
          f"{torch.__version__} cuda {torch.version.cuda}")
    print(f"build: {build_kernels():.2f} s")

    matrices = main_path_matrices()
    # First, before any torch.profiler session: a session leaves a cost on
    # every later CUDA call of the process, which the distributed paths
    # (more calls per iteration) feel more than the single-device ones.
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts = distributed_paths_phase(tmp, matrices, card)
    print(f"phase distributed paths: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    measured, bsr_api_counts = kernel_phase(matrices)
    print(f"phase kernels: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    measured.update(graph_if_phase())
    print(f"phase graph_if guard: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    path_counts.append(main_path_phase(matrices))
    print(f"phase cg_ir paths: {time.perf_counter() - t0:.2f} s")

    from lsbench_tpu_torch.matrix.generate import poisson_2d
    t0 = time.perf_counter()
    measured["spmv_well_f32"], sell_level1 = amg_kernel_phase(
        matrices["poisson_2d(512)"])
    measured["spmv_sell_f32"]["amg_level1_a"] = sell_level1
    print(f"phase amg kernel: {time.perf_counter() - t0:.2f} s")
    # The setup cache of the AMG and harness phases, and the AMD factor the
    # harness phase stores and the direct and level paths read.
    caches = tempfile.TemporaryDirectory()
    amg_cache = os.path.join(caches.name, "amg")
    spchol_cache = os.path.join(caches.name, "spchol")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:  # its files serve both phases
        path_counts += amg_paths_phase(tmp, matrices["poisson_2d(512)"],
                                       poisson_2d(128), amg_cache)
        print(f"phase amg paths: {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        harness_counts = harness_paths_phase(tmp, matrices, amg_cache,
                                             spchol_cache)
    print(f"phase harness (cache, roofline, profile, debug-nans): "
          f"{time.perf_counter() - t0:.2f} s")
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
    path_counts.append(bsr_api_counts)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += direct_paths_phase(tmp, matrices, poisson_2d(64),
                                          spchol_cache)
    print(f"phase direct paths: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fp64 = fp64_direct_measurement(matrices["random_spd(6408,23)"])
    print("fp64 vs f32+IR: " + json.dumps(fp64))
    print(f"phase fp64 vs f32+IR: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += krylov_paths_phase(tmp, matrices)
    print(f"phase krylov paths: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    fp64 = fp64_gmres_measurement(matrices["random_spd(6408,23)"])
    print("fp64 gmres vs gmres_ir: " + json.dumps(fp64))
    print(f"phase fp64 gmres vs gmres_ir: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    measured.update(tri_sweep_phase(matrices))
    print(f"phase tri sweep kernel: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path_counts += tri_paths_phase(tmp, matrices, spchol_cache)
    print(f"phase ic0, level and band paths: {time.perf_counter() - t0:.2f} s")
    caches.cleanup()
    path_counts += harness_counts
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
                           if "launch_ms" in m else {}),
                        **{k: m[k] for k in ("wrapper_host_ms",
                                             "device_ms_l2_warm",
                                             "device_ms_l2_cold",
                                             "pack_ms", "pack_again_ms",
                                             "layout_bound_ms",
                                             "layout_bytes",
                                             "earlier_design_bytes",
                                             "device_ops_per_call",
                                             "random_spd(6408,23)",
                                             "amg_level1_a",
                                             "sell_same_operator",
                                             "backward_ms", "apply_ms",
                                             "slot_run_ms",
                                             "k8_ms", "k8_max_abs_err",
                                             "launches_per_sweep",
                                             "device_ms_profiler",
                                             "device_backward_ms_profiler",
                                             "forced_wide", "chain_floor",
                                             "nlev",
                                             "us_per_level",
                                             "library_backward_ms",
                                             "library_note",
                                             "host_tri_solve_ms",
                                             "amd_factor")
                           if k in m}})
    print(f"total: {time.perf_counter() - t_start:.2f} s")
    print("paths: " + json.dumps(PATHS))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
