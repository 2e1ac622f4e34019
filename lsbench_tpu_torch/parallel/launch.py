"""Start the ranks of a distributed run, one process each.

A run of N ranks is N processes that join one group (`mesh.make_row_mesh`)
through a FileStore in a temporary directory. The CLI's `--devices N`
runs rank 0 in the calling process and starts ranks 1..N−1 here, each a
`torch.multiprocessing` process of start method `spawn` whose entry
point, `cli_rank`, lives in this package. `run_ranks` runs a function on
N spawned ranks and returns what each returned (the tests run their ranks
so).
"""

from __future__ import annotations

import contextlib
import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback

import torch
import torch.multiprocessing as mp

from lsbench_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S, make_row_mesh


@contextlib.contextmanager
def rendezvous():
    """The FileStore path of a new group, in a directory removed after."""
    d = tempfile.mkdtemp(prefix="lsbench_ranks_")
    try:
        yield os.path.join(d, "store")
    finally:
        shutil.rmtree(d, ignore_errors=True)


def cli_rank(argv: list, rank: int, n: int, init_file: str,
             threads: int) -> None:
    """Entry point of CLI rank `rank` ≥ 1: the CLI's run of `argv` as
    that rank; the process exits with its return code."""
    torch.set_num_threads(threads)
    from lsbench_tpu_torch.harness.cli import run_rank
    rc = run_rank(argv, rank, n, init_file)
    if rc:
        sys.exit(rc)


def threads_per_rank(n: int) -> int:
    """Torch threads for each of n ranks of one host: one where several
    share its cores (each does little between two collectives, and a
    thread pool spinning in one rank holds back the others), the caller's
    own number for a group of one."""
    return 1 if n > 1 else torch.get_num_threads()


def spawn_cli_ranks(argv: list, n: int, init_file: str) -> list:
    """Start CLI ranks 1..n−1 (rank 0 is the caller) and return their
    processes."""
    ctx = mp.get_context("spawn")
    threads = threads_per_rank(n)
    procs = [ctx.Process(target=cli_rank,
                         args=(list(argv), rank, n, init_file, threads))
             for rank in range(1, n)]
    for p in procs:
        p.start()
    return procs


def stop(procs: list, timeout: float) -> list:
    """Join each process within `timeout` seconds in all, terminate those
    still running, and return their exit codes (None: terminated)."""
    deadline = time.monotonic() + timeout
    codes = []
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.terminate()
            p.join(10)
            codes.append(None)
        else:
            codes.append(p.exitcode)
    return codes


def _run_rank(fn, args, rank, n, init_file, platform, results) -> None:
    torch.set_num_threads(1)
    try:
        with make_row_mesh(n, rank, init_file, platform) as mesh:
            out = fn(mesh, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        sys.exit(1)


def run_ranks(n: int, fn, *args, platform: str = "cpu",
              timeout: float = 3 * GROUP_TIMEOUT_S) -> list:
    """Run `fn(mesh, *args)` on n ranks, each a spawned process, and
    return the n results in rank order. `fn` must be importable by name
    and its results picklable. Raises RuntimeError with the traceback of
    the first rank that fails, and TimeoutError when the ranks have not
    all answered within `timeout` seconds; no process outlives the call."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with rendezvous() as init_file:
        procs = [ctx.Process(target=_run_rank,
                             args=(fn, args, rank, n, init_file, platform,
                                   results))
                 for rank in range(n)]
        for p in procs:
            p.start()
        out = {}
        try:
            deadline = time.monotonic() + timeout
            while len(out) < n:
                try:  # drain before joining: a writer blocks until read
                    rank, ok, value = results.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue_mod.Empty:
                    raise TimeoutError(
                        f"{n - len(out)} of {n} ranks did not answer "
                        f"within {timeout} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            stop(procs, timeout=30 if len(out) == n else 0)
    return [out[r] for r in range(n)]
