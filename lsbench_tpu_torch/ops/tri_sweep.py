"""Sparse triangular sweeps: the apply of the IC(0) preconditioner and of
sparse_cholesky's `level` schedule, hand-written CUDA kernels
(`csrc/tri_sweep.cu`) beside their plain PyTorch version.

    tri_sweep(S, b)   x_i = (b_i − Σ_j L_ij·x_j)·dinv_i for every row i,
                      taken in the sweep's level order; b (n,) or (n, k)

The JAX package runs this as `solvers/sparse_cholesky.py::_sweep`, a
`lax.scan` over the dependency levels (no Pallas kernel). The plain version
here is that function in torch ops: per level one gather, product,
`index_add_`, subtraction and product with `dinv`, scattered into x, over
the JAX package's padded level segments (`_pack_levels`). That is ~5
launches per level, and RCM poisson_2d(512)'s IC(0) factor has 1023 levels
per sweep.

`TriSweep` holds one sweep in the kernels' layout, in position space: the
rows in level order (`perm`, position → row; `lvl_offs`, each level's
positions), their strictly-lower entries as CSR by position with each
column already turned into the position of the row it names (ascending
in each row, so that a row's entries on positions before its run are a
prefix, up to `ioffs`), `dinv` by position. `plan` cuts the levels into
the launches of one sweep (`plan_segments`):

  RUN    consecutive levels one block can hold (at most `capacity` rows
         and `RUN_LEVEL_ENTRIES` entries each): one launch of the one-CTA
         kernel, which walks them with a barrier between levels;
  PAIR   such a run whose rows hold at most two entries, each within
         `PAIR_RING` positions of its level's end (IC(0) of a 2-D Poisson
         matrix): the same on the leaner pair kernel, which reads each
         row's entries as a pair by position (`pslot`, `pvals`) and x_j
         only from shared memory;
  PRE    the pre-pass of the run after it, where that run's rows hold ≥
         `_PRE_ENTRIES` entries on positions before the run: one
         row-parallel launch (the wide kernel) sums those into `pre`, and
         the run starts each row's sum from it, so that its block reads x_j
         only of the run's own positions, from its ring;
  WIDE   any other level: one row-parallel launch over it.

No launch waits on another block, so nothing can deadlock and there are no
flags to reset. Each level also has the number of lanes that sum one of
its rows (`lvl_lg`, log2: 1–512 lanes in a run, 1–256 in a wide level),
chosen at pack time from its row count and longest row. The layout and
the plan are validated once, when the sweep is built: every entry names a
row of an earlier level, which is what lets a level's rows run in any
order.

Dispatch: b on the CPU runs the plain version (column by column for an
(n, k) b, as the JAX package's `vmap`); b on the layout's CUDA device
launches each segment once for up to `MAX_COLS` columns, all of a sweep's
segments from one call into `csrc/tri_sweep.cu`, which loops over the plan
on the host (each launch a programmatic dependent launch: it may start
while the one before drains); anything else raises. Each launch adds one
to `LAUNCHES["tri_sweep_f32"]` or `LAUNCHES["tri_sweep_f64"]`, so a sweep
of one b counts one per segment per block of `MAX_COLS` columns. A
launch that fails raises where it is made. With `--debug-nans`
(`utils/debug.py`) each wrapper raises
`FloatingPointError` on a NaN in its output, from the kernel or the plain
version.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.ops import _cuda  # builds nothing until first launch
from lsbench_tpu_torch.utils.debug import checked

LAUNCHES = {"tri_sweep_f32": 0, "tri_sweep_f64": 0}
_NAMES = {torch.float32: "tri_sweep_f32", torch.float64: "tri_sweep_f64"}

# The kernels' fixed shapes (`csrc/tri_sweep.cu`): the pair kernel's most
# threads, which is the default capacity (one row per thread); the run
# kernel's most threads (a barrier costs more the wider the block); the most
# levels one run launch takes (its level tables live in shared memory); the
# most columns one launch sums; the entries per lane loaded a level ahead,
# and loaded at once after.
RUN_THREADS = 1024
_RUN_BLOCK = 512
MAX_RUN_LEVELS = 4096
MAX_COLS = 8
_AHEAD, _BATCH = 6, 4
# The most entries a level of a run may hold: one block streams a level's
# entries through one SM, so a level with more is cheaper as a wide launch
# over the whole card (the AMD factor's widest backward levels hold ~10^5).
RUN_LEVEL_ENTRIES = 8192
# Segment kinds: a run, a wide level, a run whose rows hold ≤ 2 entries
# (the pair kernel), the pre-pass of the run that follows it.
RUN, WIDE, PAIR, PRE = 0, 1, 2, 3
# A run gets a pre-pass where its rows hold this many entries on positions
# before it: one row-parallel launch over the card sums those, so that the
# run's block reads x_j only of its own positions (from its ring).
_PRE_ENTRIES = 4096
# The pair kernel's ring: a pair run's entries name positions within this
# many of their level's end, so x_j is always in shared memory. Fewer
# consecutive such levels than `_MIN_PAIR_LEVELS` stay in the run kernel's
# run rather than cost a launch of their own.
PAIR_RING = 2048
_MIN_PAIR_LEVELS = 32
# Entries per lane a wide launch's group aims at.
_WIDE_LANE_ENTRIES = 4
# Rough costs (µs on an H100) of the run kernel's steps, for choosing each
# run's block, each level's lanes per row and which levels go wide: a
# level's work besides its barrier, a read of x_j, a batch of entries past
# those loaded ahead (their cols, then x_j), a row pass past the first
# (offs first), a shuffle, the tree over a group's warps (two barriers),
# one warp instruction of every warp that holds a row; a barrier of T
# threads (`_bar_us`); and what a wide launch of one level costs.
_LEVEL, _X_US, _BATCH_US, _PASS, _SHFL, _WARPS, _ISSUE = (
    0.08, 0.25, 0.45, 0.5, 0.02, 0.3, 0.0003)
_WIDE_US = 12.0


def _bar_us(threads: int) -> float:
    return 0.07 + 0.0001 * threads


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ceil_div(a, b):
    return -(-a // b)


def _level_cost(rows: np.ndarray, maxlen: np.ndarray,
                threads: int = _RUN_BLOCK) -> tuple[np.ndarray, np.ndarray]:
    """(log2 G, µs) for each level of a run: the lanes per row G in 1, 2,
    ..., `threads` of least estimated time, and that time. A level takes
    ceil(rows·G / threads) passes; a pass reads x_j of the `_AHEAD`
    entries per lane loaded ahead and the rest `_BATCH` at a time, adds
    the lanes in log2(min(G, 32)) shuffles (and, for G > 32, a tree over
    the warps), and issues ~8 instructions per entry and ~60 per row in
    every warp that holds a row."""
    best_cost, best = None, None
    for lg in range(threads.bit_length()):
        G = 1 << lg
        lanes = rows * G
        passes = _ceil_div(lanes, threads)
        epl = _ceil_div(maxlen, G)
        red = min(lg, 5) * _SHFL + (_WARPS if G > 32 else 0)
        issue = (_ceil_div(np.minimum(lanes, threads), 32) * passes
                 * (8 * epl + 60) * _ISSUE)
        rest = _ceil_div(np.maximum(epl - _AHEAD, 0), _BATCH) * _BATCH_US
        cost = (_LEVEL + _bar_us(threads) + passes * (_X_US + rest + red)
                + (passes - 1) * (_PASS + _BATCH_US) + issue)
        if best is None:
            best_cost, best = cost, np.zeros(rows.size, dtype=np.int8)
        else:
            better = cost < best_cost
            best_cost = np.where(better, cost, best_cost)
            best[better] = lg
    return best, best_cost


def _run_block(rows: np.ndarray, maxlen: np.ndarray
               ) -> tuple[int, np.ndarray]:
    """A run's block and its levels' log2 lanes per row: the threads in
    32, ..., `_RUN_BLOCK` whose estimated time over the run's levels
    (`_level_cost`) is least."""
    best = None
    for lg_t in range(5, _RUN_BLOCK.bit_length()):
        lg, cost = _level_cost(rows, maxlen, 1 << lg_t)
        if best is None or cost.sum() < best[0]:
            best = (cost.sum(), 1 << lg_t, lg)
    return best[1], best[2]


def _wide_lg(maxlen: int) -> int:
    """log2 of the lanes per row of a wide launch: about
    `_WIDE_LANE_ENTRIES` entries each, at most its 256-thread block."""
    want = max(1, _ceil_div(int(maxlen), _WIDE_LANE_ENTRIES))
    return min(8, (want - 1).bit_length())


def _pairable(lvl_offs, offs, cols, maxlen, narrow):
    """Which levels the pair kernel takes: stretches of at least
    `_MIN_PAIR_LEVELS` consecutive narrow levels whose rows hold ≤ 2
    entries, each naming a position within `PAIR_RING` of its level's
    end."""
    rows = np.diff(lvl_offs)
    ends = np.repeat(lvl_offs[1:], rows)            # level end by position
    far = np.asarray(cols) < np.repeat(ends, np.diff(offs)) - PAIR_RING
    far_rows = np.zeros(rows.size, dtype=np.int64)
    np.add.at(far_rows, np.repeat(np.repeat(np.arange(rows.size), rows),
                                  np.diff(offs)), far)
    ok = narrow & (maxlen <= 2) & (far_rows == 0)
    edges = np.flatnonzero(np.diff(np.r_[0, ok.astype(np.int8), 0]))
    for a, b in zip(edges[::2], edges[1::2]):   # each stretch [a, b)
        if b - a < _MIN_PAIR_LEVELS:
            ok[a:b] = False
    return ok


def plan_segments(lvl_offs: np.ndarray, offs: np.ndarray, cols: np.ndarray,
                  capacity: int = RUN_THREADS
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Cut a sweep's levels into launches: (kind, l0, l1, width) rows, in
    level order, and each level's log2 lanes per row (`_run_block`,
    `_wide_lg`). A level fits one block if it has ≤ `capacity` rows and ≤
    `RUN_LEVEL_ENTRIES` entries (`_fits_block`). Maximal runs of
    consecutive such levels (at most `MAX_RUN_LEVELS` levels each) are RUN
    segments, whose width is the block's threads (`_run_block`); a run
    whose rows hold ≥ `_PRE_ENTRIES` entries on positions before it comes
    after a PRE segment over the same levels, whose width is the lanes per
    row that sum those (`_wide_lg`), and its own lanes follow the rest of
    each row. A run of levels the pair kernel can take (`_pairable`) is a
    PAIR segment, one lane per row, on the least power of two ≥ 32 threads
    that holds its widest level. Every other level is a WIDE segment of
    its own, whose width is its lanes per row. `cols` ascend in each
    row."""
    lvl_offs = np.asarray(lvl_offs, dtype=np.int64)
    offs = np.asarray(offs, dtype=np.int64)
    rows = np.diff(lvl_offs)
    nlev = rows.size
    lg = np.zeros(nlev, dtype=np.int8)
    if lvl_offs[-1] == 0:
        return np.zeros((0, 4), dtype=np.int64), lg
    maxlen = np.maximum.reduceat(np.diff(offs), lvl_offs[:-1])
    ents = offs[lvl_offs]
    narrow = _fits_block(rows, np.diff(ents), maxlen, capacity)
    pairable = _pairable(lvl_offs, offs, cols, maxlen, narrow)
    segs, l = [], 0
    while l < nlev:
        if not narrow[l]:
            lg[l] = _wide_lg(maxlen[l])
            segs.append((WIDE, l, l + 1, 1 << int(lg[l])))
            l += 1
            continue
        pair = pairable[l]
        l1 = l + 1
        while (l1 < nlev and narrow[l1] and pairable[l1] == pair
               and l1 - l < MAX_RUN_LEVELS):
            l1 += 1
        if pair:
            lanes = int(min(rows[l:l1].max(), RUN_THREADS))
            width = max(32, 1 << (lanes - 1).bit_length())
            kind = PAIR
        else:
            outer = _outer_counts(lvl_offs, offs, cols, l, l1)
            inner = maxlen[l:l1]
            if outer.sum() >= _PRE_ENTRIES:
                segs.append((PRE, l, l1, 1 << _wide_lg(outer.max())))
                p0 = lvl_offs[l]
                inner = np.maximum.reduceat(
                    np.diff(offs[p0:lvl_offs[l1] + 1]) - outer,
                    lvl_offs[l:l1] - p0)
            width, lg[l:l1] = _run_block(rows[l:l1], inner)
            kind = RUN
        segs.append((kind, l, l1, width))
        l = l1
    return np.asarray(segs, dtype=np.int64).reshape(-1, 4), lg


def _outer_counts(lvl_offs, offs, cols, l0, l1) -> np.ndarray:
    """For each position of levels l0 .. l1-1, how many of its entries
    name a position before the first of them (a prefix of its row: `cols`
    ascend in each row)."""
    p0, p1 = int(lvl_offs[l0]), int(lvl_offs[l1])
    e0, e1 = int(offs[p0]), int(offs[p1])
    pos = np.repeat(np.arange(p1 - p0), np.diff(offs[p0:p1 + 1]))
    return np.bincount(pos, weights=np.asarray(cols[e0:e1]) < p0,
                       minlength=p1 - p0).astype(np.int64)


def _fits_block(rows, entries, maxlen, capacity):
    """Which levels one block of a run may take: ≤ `capacity` rows, ≤
    `RUN_LEVEL_ENTRIES` entries, and rows of ≤ 2 entries (the pair kernel)
    or an estimated time in the run kernel (`_level_cost`) below a wide
    launch's."""
    cheap = (maxlen <= 2) | (_level_cost(rows, maxlen)[1] <= _WIDE_US)
    return (rows <= capacity) & (entries <= RUN_LEVEL_ENTRIES) & cheap


def _check_plan(plan: np.ndarray, lvl_lg: np.ndarray, lvl_offs: np.ndarray,
                offs: np.ndarray, cols: np.ndarray) -> None:
    """Refuse a plan the kernels cannot run as it stands: segments that do
    not cut the levels in order, a run longer than `MAX_RUN_LEVELS` or on
    a block that is not a power of two in 32..`_RUN_BLOCK` (a pair run:
    ..`RUN_THREADS`) or narrower than a level's lanes per row, a wide
    segment of more than one level or whose lanes are not its level's, a
    pre-pass not followed by a run of its levels or on more than 256
    lanes, a pair run over rows the pair kernel cannot read. Where a level goes is
    the planner's choice (`plan_segments` at a capacity), not checked."""
    rows = np.diff(lvl_offs)
    offs = np.asarray(offs, dtype=np.int64)
    ok = (plan.ndim == 2 and plan.shape[1] == 4
          and lvl_lg.shape == rows.shape)
    if ok and plan.shape[0]:
        kind, l0, l1, width = plan.T
        pre = kind == PRE  # each followed by a run of the same levels
        nxt = np.flatnonzero(pre) + 1
        ok = (nxt.size == 0 or (nxt[-1] < kind.size
                                and np.all(kind[nxt] == RUN)
                                and np.array_equal(l0[nxt], l0[pre])
                                and np.array_equal(l1[nxt], l1[pre])))
        l0, l1 = l0[~pre], l1[~pre]
        ok = (ok and l0[0] == 0 and l1[-1] == rows.size
              and np.array_equal(l0[1:], l1[:-1]) and np.all(l1 > l0)
              and np.all(np.isin(kind, (RUN, WIDE, PAIR, PRE))))
        if ok and np.any(kind == PAIR):
            maxlen = np.maximum.reduceat(np.diff(offs), lvl_offs[:-1])
            pairable = _pairable(lvl_offs, offs, cols, maxlen,
                                 np.ones(rows.size, dtype=bool))
        for k, a, c, w in plan if ok else ():
            lg = lvl_lg[a:c].astype(np.int64)
            if k == WIDE:
                ok = c == a + 1 and w <= 256 and w == 1 << int(lg[0])
            elif k == PRE:
                ok = 1 <= w <= 256 and w & (w - 1) == 0
            else:
                most = RUN_THREADS if k == PAIR else _RUN_BLOCK
                ok = (c - a <= MAX_RUN_LEVELS and 32 <= w <= most
                      and w & (w - 1) == 0 and lg.min() >= 0
                      and (1 << int(lg.max())) <= w
                      and (k != PAIR or (not lg.any()
                                         and pairable[a:c].all())))
            if not ok:
                break
    elif ok:
        ok = lvl_offs[-1] == 0
    if not ok:
        raise ValueError("TriSweep: the segment plan does not cut the levels "
                         "into launches the kernels can run")


@dataclass(eq=False)
class TriSweep:
    n: int
    nlev: int
    perm: torch.Tensor       # (n,) int32: row at each position, level order
    offs: torch.Tensor       # (n + 1,) int64: entries of each position
    ioffs: torch.Tensor      # (n,) int64: the first entry a run sums (past
                             # those its pre-pass sums); offs[:-1] elsewhere
    cols: torch.Tensor       # (nnz,) int32: the position each entry depends on
    vals: torch.Tensor       # (nnz,) f32 or f64
    dinv: torch.Tensor       # (n,) 1 / diagonal, by position
    pslot: torch.Tensor      # (n, 2) int32: pair runs' entries as ring slots
    pvals: torch.Tensor      # (n, 2) f32 or f64 (both empty without pairs)
    lvl_offs: torch.Tensor   # (nlev + 1,) int64: positions of each level
    lvl_lg: torch.Tensor     # (nlev,) int8: log2 of each level's lanes per row
    lvl_host: np.ndarray     # lvl_offs on the host (wide launches' bounds)
    plan: np.ndarray         # (segments, 4) int64: kind, l0, l1, width
    levels: list | None      # plain version: (rows, slot, cols, vals, dinv, R)

    @classmethod
    def build(cls, perm, offs, cols, vals, dinv, lvl_offs, dtype, device,
              levels=None, plan=None, capacity=None) -> "TriSweep":
        """Validate the host arrays once and upload them in `dtype`. `cols`
        are positions (sorted here inside each row where they are not);
        `plan` is `plan_segments`' (plan, lvl_lg), planned here at
        `capacity` rows per run level (default `RUN_THREADS`, one row per
        thread of the pair kernel) where not given."""
        n = perm.size
        lens = np.diff(offs)
        lvl_offs = np.ascontiguousarray(lvl_offs, dtype=np.int64)
        if (offs.size != n + 1 or offs[0] != 0 or np.any(lens < 0)
                or offs[-1] != cols.size or vals.size != cols.size
                or dinv.size != n
                or not np.array_equal(np.sort(perm), np.arange(n))
                or lvl_offs.size < 2 or lvl_offs[0] != 0
                or lvl_offs[-1] != n or np.any(np.diff(lvl_offs) < 0)
                or (n and np.any(np.diff(lvl_offs) == 0))):
            raise ValueError("TriSweep: inconsistent layout arrays")
        level_start = np.repeat(lvl_offs[:-1], np.diff(lvl_offs))
        if cols.size and (cols.min() < 0 or np.any(
                cols >= np.repeat(level_start, lens))):
            raise ValueError("TriSweep: an entry depends on a position in its "
                             "own or a later level")
        row_of = np.repeat(np.arange(n), lens)
        if cols.size and np.any((np.diff(cols) < 0) & (np.diff(row_of) == 0)):
            order = np.lexsort((cols, row_of))
            cols, vals = cols[order], vals[order]
        plan, lvl_lg = (plan_segments(lvl_offs, offs, cols,
                                      capacity or RUN_THREADS)
                        if plan is None else plan)
        # Contiguous int64 on the host: the launch reads it there.
        plan = np.ascontiguousarray(plan, dtype=np.int64)
        lvl_lg = np.asarray(lvl_lg, dtype=np.int8)
        _check_plan(plan, lvl_lg, lvl_offs, offs, cols)
        ioffs = np.array(offs[:-1], dtype=np.int64)
        for kind, l0, l1, _ in plan:
            if kind == PRE:
                p0, p1 = lvl_offs[l0], lvl_offs[l1]
                ioffs[p0:p1] += _outer_counts(lvl_offs, offs, cols, l0, l1)
        dev = torch.device(device)

        def up(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=dev)

        # The pair kernel's layout: each row's first two entries by
        # position, their columns as ring slots (slot PAIR_RING, value 0
        # past the row's end); empty where the plan has no pair run.
        npair = n if np.any(plan[:, 0] == PAIR) else 0
        pslot = np.full((npair, 2), PAIR_RING, dtype=np.int32)
        pvals = np.zeros((npair, 2))
        for m in range(2 if npair else 0):
            has = lens > m
            pslot[has, m] = cols[offs[:-1][has] + m] % PAIR_RING
            pvals[has, m] = vals[offs[:-1][has] + m]
        return cls(n=n, nlev=lvl_offs.size - 1, perm=up(perm, torch.int32),
                   offs=up(offs, torch.int64), ioffs=up(ioffs, torch.int64),
                   cols=up(cols, torch.int32),
                   vals=up(vals, dtype), dinv=up(dinv, dtype),
                   pslot=up(pslot, torch.int32), pvals=up(pvals, dtype),
                   lvl_offs=up(lvl_offs, torch.int64),
                   lvl_lg=up(lvl_lg, torch.int8), lvl_host=lvl_offs,
                   plan=plan, levels=levels)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def nnz(self) -> int:
        return int(self.cols.numel())

    def launches_per_sweep(self, k: int = 1) -> int:
        """Kernel launches of one sweep of k columns."""
        return len(self.plan) * _ceil_div(max(k, 1), MAX_COLS)


def tri_sweep_plain(S: TriSweep, b: torch.Tensor) -> torch.Tensor:
    """The JAX package's `_sweep` in torch ops, level by level over the
    padded segments: x has a dummy slot n where padding rows write 0."""
    if S.levels is None:
        raise ValueError("tri_sweep: this layout was built without the plain "
                         "version's level arrays")
    x = torch.zeros(S.n + 1, dtype=b.dtype, device=b.device)
    bp = torch.cat([b, b.new_zeros(1)])
    for rows, slot, cols, vals, dinv, R in S.levels:
        s = x.new_zeros(R + 1).index_add_(0, slot, vals * x[cols])[:R]
        x[rows] = (bp[rows] - s) * dinv
    return x[:S.n]


def tri_sweep(S: TriSweep, b: torch.Tensor) -> torch.Tensor:
    """One sweep of S on b, (n,) or (n, k), in S's dtype: the plain version
    for a CPU b, the kernels (each segment once per `MAX_COLS` columns) for
    b on S's CUDA device."""
    name = _NAMES.get(S.dtype)
    if name is None:
        raise TypeError(f"tri_sweep: no kernel for {S.dtype}")
    if b.dtype != S.dtype:
        raise TypeError(f"{name}: b must be {S.dtype}, got {b.dtype}")
    if (b.dim() not in (1, 2) or b.shape[0] != S.n
            or not b.is_contiguous()):
        raise ValueError(f"{name}: b must be contiguous of shape ({S.n},) or "
                         f"({S.n}, k), got {tuple(b.shape)}")
    dev = b.device
    if dev != S.device:
        raise ValueError(f"{name}: b on {dev}, the layout on {S.device}")
    if dev.type == "cpu":
        if b.dim() == 2:
            x = torch.stack([tri_sweep_plain(S, b[:, j].contiguous())
                             for j in range(b.shape[1])], dim=1)
        else:
            x = tri_sweep_plain(S, b)
        return checked(x, name)
    if dev.type != "cuda":
        raise ValueError(f"{name}: operands on {dev}: need the CPU (plain "
                         "version) or a CUDA device (kernel)")
    x = torch.empty_like(b)
    if S.n and b.numel():
        _launch_plan(S, name, b, x)
    return checked(x, name)


def _launch_plan(S: TriSweep, name: str, b: torch.Tensor, x: torch.Tensor
                 ) -> None:
    """Launch every segment of S's plan, in order, once per block of up to
    `MAX_COLS` columns of b (n,) or (n, k), into x: one call of the
    sweep's entry point per block, which launches the segments from the
    host arrays `plan` and `lvl_host`."""
    k = 1 if b.dim() == 1 else b.shape[1]
    xpos = torch.empty_like(b)  # x by position: what later rows read
    # The pre-passes' sums by position, where the plan has any.
    pre = torch.empty_like(b) if np.any(S.plan[:, 0] == PRE) else None
    fn = _cuda.entry("tri_sweep", name)
    arrays = (S.plan.ctypes.data, S.lvl_host.ctypes.data, S.perm.data_ptr(),
              S.ioffs.data_ptr(), S.offs.data_ptr(), S.cols.data_ptr(),
              S.vals.data_ptr(), S.dinv.data_ptr(), S.pslot.data_ptr(),
              S.pvals.data_ptr(), S.lvl_offs.data_ptr(), S.lvl_lg.data_ptr())
    item = b.element_size()
    for c0 in range(0, k, MAX_COLS):
        kc = min(MAX_COLS, k - c0)
        at = c0 * item
        _cuda.launch(fn, name, b.device, *arrays, b.data_ptr() + at,
                     None if pre is None else pre.data_ptr() + at,
                     x.data_ptr() + at, xpos.data_ptr() + at, len(S.plan),
                     kc, k)
        LAUNCHES[name] += len(S.plan)

