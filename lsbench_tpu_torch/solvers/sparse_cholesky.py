"""Sparse direct Cholesky, the scalable CHOLMOD-role path (counterpart of
`lsbench_tpu/solvers/sparse_cholesky.py`).

The reference's default backend factors on the host CPU (CHOLMOD with
`useGPU=0`, cholmod.c:68) after a fill-reducing ordering chosen inside
`analyze` (cholmod-impl.h:25), then times only the triangular solves
(cholmod-impl.h:44-63). The same split here:

- host symbolic phase: elimination tree (Liu's algorithm with path
  compression) and each row's fill pattern by etree reach, after the
  ordering (native approximate minimum degree by default);
- host numeric phase: left-looking sparse column Cholesky over the exact
  fill pattern (flat CSC arrays; native C++ `native/spchol.cpp` with a
  Python fallback of the same arithmetic);
- solve phase (the timed region), by `schedule=`:
  * "host" (what "auto" picks when the native library builds): CSC
    two-sweep substitution and refinement on the CPU, exactly where the
    reference's default backend solves. Nothing of it runs on the card.
  * "block": the partitioned-inverse sweep on the device. Rows are sorted
    by dependency level and cut into blocks of 256; each block's
    within-block couplings are inverted at setup (batched
    `torch.linalg.solve_triangular` against I), and each of the ~n/256
    sequential steps of a sweep is a gather, a segment sum (`index_add_`)
    and one (256,256)@(256,k) product in full f32. At fp64 the sweeps run
    in f32 and the f64 refinement residual is `spmv_sell_f64` (the JAX
    package's TPU branch, where `spmv_bsr_df64` had that place).
  * "level": the level-scheduled sweeps, also `ic0.py`'s apply. Each
    sweep is one launch of the triangular-sweep kernel
    (`ops/tri_sweep.py`, `csrc/tri_sweep.cu`) over the rows in dependency
    level order, where the JAX package scans the levels (`_sweep`); fp64
    sweeps in f32 with the `spmv_sell_f64` refinement residual, as
    "block" does.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.ell import EllMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.native import spchol
from lsbench_tpu_torch.ops import tri_sweep
from lsbench_tpu_torch.ops.spmv import spmv_ell
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell_f64
from lsbench_tpu_torch.ops.tri_sweep import TriSweep
from lsbench_tpu_torch.solvers.base import (SolveResult, Solver,
                                            register_solver, to_numpy,
                                            true_relres)
from lsbench_tpu_torch.solvers.cg import as_dtype, permutation
from lsbench_tpu_torch.solvers.refine import column_residual, refine_columns
from lsbench_tpu_torch.utils.precision import full_f32


# ----------------------------------------------------------- symbolic phase

def elimination_tree(A: CsrMatrix) -> np.ndarray:
    """Liu's etree with path compression; A square, pattern symmetric."""
    n = A.nrows
    parent = np.full(n, -1, dtype=np.int64)
    ancestor = np.full(n, -1, dtype=np.int64)
    offs, cols = A.offs, A.cols
    for i in range(n):
        for k in cols[offs[i]:offs[i + 1]]:
            k = int(k)
            if k >= i:
                continue
            # Walk up the (compressed) ancestor chain from k to i.
            while True:
                a = ancestor[k]
                ancestor[k] = i
                if a == -1:
                    if parent[k] == -1:
                        parent[k] = i
                    break
                if a == i:
                    break
                k = a
    return parent


def symbolic_rows(A: CsrMatrix, parent: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Fill pattern of L by rows (strictly-lower part), via etree reach:
    row i's pattern is the union of the etree paths k→…→i for each k < i
    with A[i,k] ≠ 0. Returns CSR-style (offs, cols), cols ascending."""
    n = A.nrows
    offs, cols = A.offs, A.cols
    mark = np.full(n, -1, dtype=np.int64)
    rows: list[np.ndarray] = []
    counts = np.zeros(n + 1, dtype=np.int64)
    for i in range(n):
        pat = []
        for k in cols[offs[i]:offs[i + 1]]:
            k = int(k)
            if k >= i:
                continue
            while k != -1 and k < i and mark[k] != i:
                mark[k] = i
                pat.append(k)
                k = int(parent[k])
        p = np.sort(np.asarray(pat, dtype=np.int64))
        rows.append(p)
        counts[i + 1] = p.size
    loffs = np.cumsum(counts)
    lcols = (np.concatenate(rows) if loffs[-1] else
             np.zeros(0, dtype=np.int64))
    return loffs, lcols


# ------------------------------------------------------------ numeric phase

def symmetrize(A: CsrMatrix) -> CsrMatrix:
    """(A + Aᵀ)/2, the operator the direct path factors: CHOLMOD's
    one-triangle stype=-1 build (cholmod-impl.h:5-18)."""
    r, c, v = A.to_coo()
    return CsrMatrix.from_coo(np.concatenate([r, c]), np.concatenate([c, r]),
                              np.concatenate([v, v]) * 0.5,
                              nrows=A.nrows, ncols=A.ncols)


def numeric_factor(A: CsrMatrix, loffs: np.ndarray, lcols: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Left-looking column Cholesky over the symbolic pattern.

    `A` must be symmetric (`symmetrize` first); returns CSC arrays
    (cp, ci, cx) of L with its diagonal, rows ascending within each
    column. The numeric loop runs natively (`native/spchol.cpp`) where the
    toolchain builds it, else in this Python loop (the same arithmetic).
    """
    n = A.nrows
    # CSC pattern of L (with the diagonal): column j holds {j} ∪ {i : j ∈ row_i}.
    col_counts = np.ones(n, dtype=np.int64)
    np.add.at(col_counts, lcols, 1)
    cp = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(col_counts, out=cp[1:])
    ci = np.empty(cp[-1], dtype=np.int64)
    fill_pos = cp[:-1].copy()
    ci[fill_pos] = np.arange(n)  # diagonal first in each column
    fill_pos += 1
    row_of = np.repeat(np.arange(n), np.diff(loffs))
    # Rows arrive in ascending i per column because i is scanned in order.
    for i, j in zip(row_of, lcols):
        ci[fill_pos[j]] = i
        fill_pos[j] += 1
    cx = np.zeros(cp[-1])

    try:
        cx = spchol.chol_numeric(n, A.offs, A.cols, A.vals, cp, ci, loffs,
                                 lcols)
        return cp, ci, cx
    except np.linalg.LinAlgError:
        raise
    except Exception:
        pass  # no native toolchain: the Python loop below

    w = np.zeros(n)  # dense accumulator of the current column
    for j in range(n):
        pj = ci[cp[j]:cp[j + 1]]          # rows ≥ j of column j (ascending)
        w[pj] = 0.0
        sl = slice(A.offs[j], A.offs[j + 1])
        ac, av = A.cols[sl], A.vals[sl]
        low = ac >= j
        w[ac[low]] = av[low]
        # Left-looking update over row j's pattern: the ks with L[j,k] ≠ 0.
        for t in range(loffs[j], loffs[j + 1]):
            k = lcols[t]
            ck = ci[cp[k]:cp[k + 1]]
            s = int(np.searchsorted(ck, j))  # rows ≥ j of column k
            ljk = cx[cp[k] + s]
            w[ck[s:]] -= ljk * cx[cp[k] + s: cp[k + 1]]
        dj = w[j]
        if dj <= 0.0:
            raise np.linalg.LinAlgError(
                f"matrix not positive definite at column {j} (d={dj:.3e})")
        dj = np.sqrt(dj)
        vals = w[pj] / dj
        vals[0] = dj
        cx[cp[j]:cp[j + 1]] = vals
    return cp, ci, cx


# ---------------------------------------------------- level schedule

def _level_schedule(n, row_offs, row_cols):
    """Dependency levels of a lower-triangular solve: level[i] =
    1 + max(level[j]) over the js row i references (0 if none)."""
    level = np.zeros(n, dtype=np.int64)
    for i in range(n):
        js = row_cols[row_offs[i]:row_offs[i + 1]]
        if js.size:
            level[i] = level[js].max() + 1
    return level


def _segment_levels(sizes: np.ndarray, max_factor: float = 1.5):
    """Cut the ordered sequence into contiguous segments whose flat padding
    (length · largest size in the segment) stays within `max_factor` of
    their content."""
    segs = []
    start, T, s = 0, 0, 0.0
    for l, sz in enumerate(sizes):
        T2, s2 = max(T, int(sz)), s + float(sz)
        if l > start and T2 * (l - start + 1) > max_factor * s2:
            segs.append((start, l))
            start, T, s = l, int(sz), float(sz)
        else:
            T, s = T2, s2
    segs.append((start, len(sizes)))
    return segs


def _pack_levels(n, row_offs, row_cols, row_vals, diag, level):
    """The JAX package's padded level segments of one sweep, bit for bit,
    as host arrays (f64 values): levels are grouped into contiguous runs of
    similar size (`_segment_levels`) and each run is padded to its own
    (T, R):
      per segment: rows [L,R] (pad → dummy slot n), slot [L,T] (pad → R),
                   cols/vals [L,T] (pad → col n, val 0), dinv [L,R]
    Returns (flat arrays of the segments in order, [(L, T, R)] per segment,
    total padded entries). They feed the plain version of the sweep; the
    kernel reads `_kernel_rows`, built from the same arrays."""
    nlev = int(level.max()) + 1 if n else 1
    lens = np.diff(row_offs)
    order = np.argsort(level, kind="stable")
    lvl_sorted = level[order]
    counts = np.bincount(lvl_sorted, minlength=nlev)
    level_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot_of_row = np.arange(n) - level_start[lvl_sorted]

    lens_sorted = lens[order]
    level_nnz = np.zeros(nlev, dtype=np.int64)
    np.add.at(level_nnz, lvl_sorted, lens_sorted)
    nnz_cum = np.cumsum(lens_sorted) - lens_sorted      # global excl. cumsum
    level_nnz_start = np.zeros(nlev, dtype=np.int64)
    np.cumsum(level_nnz, out=level_nnz_start[:])        # inclusive
    level_nnz_start = np.concatenate([[0], level_nnz_start[:-1]])
    t_off = nnz_cum - level_nnz_start[lvl_sorted]       # within-level offset

    # Segment on the combined row + nnz footprint of each level.
    segs = _segment_levels(level_nnz + counts)

    row_cum = np.concatenate([[0], np.cumsum(counts)])  # rows before level l
    segments, seg_R, total_padded = [], [], 0
    for (l0, l1) in segs:
        L = l1 - l0
        T = max(1, int(level_nnz[l0:l1].max()))
        R = max(1, int(counts[l0:l1].max()))
        r_sel = slice(row_cum[l0], row_cum[l1])         # rows of these levels
        lv_loc = lvl_sorted[r_sel] - l0
        sl_loc = slot_of_row[r_sel]
        rows = np.full((L, R), n, dtype=np.int32)
        dinv = np.zeros((L, R))
        rows[lv_loc, sl_loc] = order[r_sel]
        dinv[lv_loc, sl_loc] = 1.0 / diag[order[r_sel]]

        cols = np.full(L * T, n, dtype=np.int32)
        vals = np.zeros(L * T)
        slot = np.full(L * T, R, dtype=np.int32)
        lens_seg = lens_sorted[r_sel]
        total = int(lens_seg.sum())
        if total:
            nnz_cum_seg = nnz_cum[r_sel]
            intra = (np.arange(total)
                     - np.repeat(nnz_cum_seg - nnz_cum_seg[0], lens_seg))
            dest = np.repeat(lv_loc * T + t_off[r_sel], lens_seg) + intra
            src = np.repeat(row_offs[order[r_sel]], lens_seg) + intra
            cols[dest] = row_cols[src]
            vals[dest] = row_vals[src]
            slot[dest] = np.repeat(sl_loc, lens_seg)
        segments.append((rows, slot, cols, vals, dinv))
        seg_R.append((L, T, R))
        total_padded += L * T

    flat = {"rows": np.concatenate([s[0].ravel() for s in segments]),
            "slot": np.concatenate([s[1] for s in segments]),
            "cols": np.concatenate([s[2] for s in segments]),
            "vals": np.concatenate([s[3] for s in segments]),
            "dinv": np.concatenate([s[4].ravel() for s in segments])}
    return flat, seg_R, total_padded


def _kernel_rows(n, row_offs, row_cols, row_vals, diag, level):
    """The same sweep in the triangular-sweep kernel's layout
    (`ops/tri_sweep.py::TriSweep`): rows in the segments' level order
    (stable: ascending inside a level), their entries as CSR in that order,
    `dinv` by position. No padding."""
    order = np.argsort(level, kind="stable")
    lens = np.diff(row_offs)[order]
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=offs[1:])
    src = np.repeat(row_offs[order] - offs[:-1], lens) + np.arange(offs[-1])
    return {"perm": order.astype(np.int32), "offs": offs,
            "cols": row_cols[src].astype(np.int32), "vals": row_vals[src],
            "dinv": 1.0 / diag[order]}


def _backward_rows(r, c, v, n):
    """Rows of the backward (Lᵀ) sweep: row i references the js > i with
    L[j,i] ≠ 0, i.e. column i of L without its diagonal."""
    uoffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(c, minlength=n), out=uoffs[1:])
    ord_u = np.lexsort((r, c))
    ucols, uvals = r[ord_u], v[ord_u]
    # Levels respect the reverse dependencies (row i needs rows j > i).
    lev_b = np.zeros(n, dtype=np.int64)
    for i in range(n - 1, -1, -1):
        js = ucols[uoffs[i]:uoffs[i + 1]]
        if js.size:
            lev_b[i] = lev_b[js].max() + 1
    return uoffs, ucols, uvals, lev_b


def _sweep_rows(cp, ci, cx, n):
    """The rows of both sweeps from CSC L (with its diagonal): the forward
    rows (strictly-lower CSR of L, columns ascending) and the backward rows
    (`_backward_rows`), each as (offs, cols, vals, level), and diag(L)."""
    row_of = ci
    col_of = np.repeat(np.arange(n), np.diff(cp))
    off_diag = row_of != col_of
    r, c, v = row_of[off_diag], col_of[off_diag], cx[off_diag]
    diag = cx[cp[:-1]]

    order = np.lexsort((c, r))
    r_s, c_s, v_s = r[order], c[order], v[order]
    roffs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(r_s, minlength=n), out=roffs[1:])
    lev_f = _level_schedule(n, roffs, c_s)
    return (roffs, c_s, v_s, lev_f), _backward_rows(r, c, v, n), diag


def pack_tri_host(cp, ci, cx, n):
    """The host half of `pack_tri`: for the forward ("f") and backward
    ("b") sweeps, (flat segment arrays, [(L, T, R)], kernel layout, level
    count), and the JAX package's `meta`."""
    fwd, bwd, diag = _sweep_rows(cp, ci, cx, n)
    host, pads = {}, 0
    for key, (offs, cols, vals, lev) in (("f", fwd), ("b", bwd)):
        flat, seg_R, pad = _pack_levels(n, offs, cols, vals, diag, lev)
        host[key] = (flat, seg_R,
                     _kernel_rows(n, offs, cols, vals, diag, lev),
                     int(lev.max()) + 1 if n else 1)
        pads += pad
    meta = {"nlev_f": host["f"][3], "nlev_b": host["b"][3],
            "rs_f": host["f"][1], "rs_b": host["b"][1],
            "n_segments": len(host["f"][1]) + len(host["b"][1]),
            "waste": pads / max(1, 2 * (fwd[1].size + n))}
    return host, meta


def _plain_levels(flat, seg_R, dtype, device):
    """Upload the padded segments and cut them into one (rows, slot, cols,
    vals, dinv, R) view per level, the plain sweep's steps."""
    dev = torch.device(device)
    t = {k: torch.as_tensor(a, dtype=(dtype if k in ("vals", "dinv")
                                      else torch.int64), device=dev)
         for k, a in flat.items()}
    levels, o_lr, o_lt = [], 0, 0
    for L, T, R in seg_R:
        rw = t["rows"][o_lr:o_lr + L * R].view(L, R)
        di = t["dinv"][o_lr:o_lr + L * R].view(L, R)
        sl = t["slot"][o_lt:o_lt + L * T].view(L, T)
        cl = t["cols"][o_lt:o_lt + L * T].view(L, T)
        vl = t["vals"][o_lt:o_lt + L * T].view(L, T)
        levels += [(rw[l], sl[l], cl[l], vl[l], di[l], R) for l in range(L)]
        o_lr += L * R
        o_lt += L * T
    return levels


class TriPack(NamedTuple):
    """Both sweeps of L Lᵀ, the state `apply_tri` takes."""
    f: TriSweep
    b: TriSweep

    def check(self) -> None:
        """Raise if a kernel launch on either sweep reported a fault (one
        device sync): once per solve."""
        tri_sweep.check(self.f, self.b)


def upload_tri(host, dtype, device, plain=None) -> TriPack:
    """Both sweeps of `pack_tri_host`'s arrays on `device` in `dtype`: the
    kernel's layout and, with `plain` (the default on the CPU, where the
    plain version runs), the padded level segments."""
    plain = torch.device(device).type == "cpu" if plain is None else plain
    sweeps = []
    for key in ("f", "b"):
        flat, seg_R, k, nlev = host[key]
        levels = _plain_levels(flat, seg_R, dtype, device) if plain else None
        sweeps.append(TriSweep.build(k["perm"], k["offs"], k["cols"],
                                     k["vals"], k["dinv"], nlev, dtype,
                                     device, levels))
    return TriPack(*sweeps)


def pack_tri(cp, ci, cx, n, dtype, device="cuda", plain=None):
    """Pack CSC L (with its diagonal) into the forward and backward sweeps
    on `device` (`upload_tri`). Returns (TriPack, meta)."""
    host, meta = pack_tri_host(cp, ci, cx, n)
    return upload_tri(host, dtype, device, plain), meta


# The JAX package's name for one level-scheduled sweep: the kernel's wrapper
# (`ops/tri_sweep.py`), which runs the plain `_sweep` on CPU tensors.
_sweep = tri_sweep.tri_sweep


def apply_tri(state: TriPack, b):
    """x = (L Lᵀ)⁻¹ b through the two sweeps; b (n,) or (n, k), cast to
    the pack's dtype (a strided column is copied)."""
    b = b.to(state.f.dtype).contiguous()
    return _sweep(state.b, _sweep(state.f, b))


def build_level_solver(cp, ci, cx, n, dtype, device="cuda"):
    """(state, apply, nlev_f, nlev_b, waste) with x = apply(state, b)
    applying L then Lᵀ by the level schedule."""
    state, meta = pack_tri(cp, ci, cx, n, dtype, device)
    return state, apply_tri, meta["nlev_f"], meta["nlev_b"], meta["waste"]


# ------------------------------------------ blocked (partitioned-inverse)

def _pack_blocks(n, row_offs, row_cols, row_vals, diag, level, B):
    """The host arrays of one blocked sweep (the JAX package's, bit for bit).

    Rows are sorted by dependency level and cut into blocks of B
    consecutive positions; a block's within-block couplings form a
    lower-triangular B×B in sweep order (dependencies point to earlier
    positions), inverted on the device by `_expand_blocks`. Per step:

        s   = segment_sum(vals · x[cols])   (off-block gather, flat)
        x_b = W_b @ (b_b − s)               (one (B,B)@(B,k) product)

    Returns (host arrays, segments [(L, T)], nb, waste): compact
    (≈ nnz-sized) pieces, padded and inverted on the device."""
    order = np.argsort(level, kind="stable")          # position -> row
    pos = np.empty(n, dtype=np.int64)
    pos[order] = np.arange(n)
    nb = max(1, -(-n // B))
    npad = nb * B
    rows_pad = np.full(npad, n, dtype=np.int32)
    rows_pad[:n] = order

    row_of = np.repeat(np.arange(n), np.diff(row_offs))
    j = np.asarray(row_cols, dtype=np.int64)
    v = np.asarray(row_vals)
    pi, pj = pos[row_of], pos[j]
    bi, bj = pi // B, pj // B
    inblk = bi == bj

    # Dense in-block entries (strictly lower in sweep order) + the diagonal.
    d_flat = (bi[inblk] * B + pi[inblk] % B) * B + pj[inblk] % B
    pall = np.arange(n)  # the diagonal of row order[p] sits at position p
    d_diag = (pall // B * B + pall % B) * B + pall % B
    d_idx = np.concatenate([d_flat, d_diag]).astype(np.int64)
    d_val = np.concatenate([v[inblk], diag[order]])

    # Off-block entries grouped by sweep position (ascending).
    off = ~inblk
    so = np.argsort(pi[off], kind="stable")
    o_col = j[off][so].astype(np.int32)      # gather index into x (row space)
    o_val = v[off][so]
    o_pi = pi[off][so]
    lens = np.bincount(o_pi, minlength=npad).astype(np.int64)
    blk_nnz = lens.reshape(nb, B).sum(axis=1)

    segs = _segment_levels(blk_nnz)
    seg_meta = [(b1 - b0, max(1, int(blk_nnz[b0:b1].max())))
                for b0, b1 in segs]

    # Each entry's destination inside its segment's (L, T) pad.
    blk_start = np.concatenate([[0], np.cumsum(blk_nnz)[:-1]])
    blk_of = o_pi // B
    t_off = np.arange(o_pi.size) - blk_start[blk_of]
    seg_base = np.empty(nb, dtype=np.int64)   # flat base of each block
    base = 0
    for (b0, b1), (L, T) in zip(segs, seg_meta):
        seg_base[b0:b1] = base + (np.arange(b0, b1) - b0) * T
        base += L * T
    o_dest = (seg_base[blk_of] + t_off).astype(np.int64)
    o_slot = (o_pi % B).astype(np.int32)

    host = {"d_idx": d_idx, "d_val": d_val, "o_col": o_col,
            "o_val": o_val, "o_dest": o_dest, "o_slot": o_slot,
            "rows": rows_pad, "nb": nb, "total_padded": base}
    return host, seg_meta, nb, base / max(1, o_pi.size)


def _expand_blocks(host, seg_meta, n, B, dtype, device):
    """Device expansion: the compact arrays → the padded sweep arrays and
    the batched block inverses W, so that only compact data is uploaded.
    Also returns `steps`, one (rows, cols, vals, slot, W) view per block."""
    dev = torch.device(device)
    nb, total = host["nb"], host["total_padded"]
    dense = torch.zeros(nb * B * B, dtype=dtype, device=dev)
    dense[torch.as_tensor(host["d_idx"], device=dev)] = torch.as_tensor(
        host["d_val"], dtype=dtype, device=dev)
    dense = dense.view(nb, B, B)
    # Padding positions have empty rows: a unit diagonal keeps the batched
    # triangular solve nonsingular (their x stays 0: b and the gathers are
    # 0 there).
    eye = torch.eye(B, dtype=dtype, device=dev)
    fix = (torch.diagonal(dense, dim1=1, dim2=2) == 0).to(dtype)
    dense = dense + fix[:, :, None] * eye[None]
    with full_f32():
        W = torch.linalg.solve_triangular(dense, eye.expand(nb, B, B),
                                          upper=False)
    del dense
    o_dest = torch.as_tensor(host["o_dest"], device=dev)
    cols = torch.full((total,), n, dtype=torch.int64, device=dev)
    cols[o_dest] = torch.as_tensor(host["o_col"], dtype=torch.int64,
                                   device=dev)
    vals = torch.zeros(total, dtype=dtype, device=dev)
    vals[o_dest] = torch.as_tensor(host["o_val"], dtype=dtype, device=dev)
    slot = torch.full((total,), B, dtype=torch.int64, device=dev)
    slot[o_dest] = torch.as_tensor(host["o_slot"], dtype=torch.int64,
                                   device=dev)
    rows = torch.as_tensor(host["rows"], dtype=torch.int64, device=dev)

    steps, o_lt, ob = [], 0, 0
    for L, T in seg_meta:
        c = cols[o_lt:o_lt + L * T].view(L, T)
        v = vals[o_lt:o_lt + L * T].view(L, T)
        s = slot[o_lt:o_lt + L * T].view(L, T)
        steps += [(rows[(ob + l) * B:(ob + l + 1) * B], c[l], v[l], s[l],
                   W[ob + l]) for l in range(L)]
        o_lt += L * T
        ob += L
    return {"W": W, "cols": cols, "vals": vals, "slot": slot, "rows": rows,
            "steps": steps}


def _sweep_blocks(sweep, n, B, bp):
    """One blocked triangular sweep; bp (n+1, k) with a zero pad row. One
    sequential step per block (~n/B): a gather, a segment sum, one
    (B,B)@(B,k) product in full f32 and a scatter."""
    k = bp.shape[1]
    x = torch.zeros((n + 1, k), dtype=bp.dtype, device=bp.device)
    seg = torch.empty((B + 1, k), dtype=bp.dtype, device=bp.device)
    with full_f32():
        for rw, cl, vl, sl, Wb in sweep["steps"]:
            s = seg.zero_().index_add_(0, sl, vl[:, None] * x[cl])[:B]
            x[rw] = torch.matmul(Wb, bp[rw] - s)
    return x[:n]


def pack_tri_blocked_host(cp, ci, cx, n, block=256):
    """The host half of `pack_tri_blocked`: the forward and backward
    sweeps' compact arrays from CSC L. Returns ((host_f, seg_f),
    (host_b, seg_b), meta)."""
    (roffs, c_s, v_s, lev_f), (uoffs, ucols, uvals, lev_b), diag = \
        _sweep_rows(cp, ci, cx, n)
    host_f, seg_f, nb, waste_f = _pack_blocks(n, roffs, c_s, v_s, diag,
                                              lev_f, block)
    host_b, seg_b, _, waste_b = _pack_blocks(n, uoffs, ucols, uvals, diag,
                                             lev_b, block)
    meta = {"rs_f": seg_f, "rs_b": seg_b, "block": block, "nb": nb,
            "nlev_f": int(lev_f.max()) + 1, "nlev_b": int(lev_b.max()) + 1,
            "waste": (waste_f + waste_b) / 2}
    return (host_f, seg_f), (host_b, seg_b), meta


def pack_tri_blocked(cp, ci, cx, n, dtype, block=256, device="cuda"):
    """Forward and backward blocked sweeps of CSC L on `device`. Returns
    (state, meta)."""
    (host_f, seg_f), (host_b, seg_b), meta = pack_tri_blocked_host(
        cp, ci, cx, n, block)
    state = {"f": _expand_blocks(host_f, seg_f, n, block, dtype, device),
             "b": _expand_blocks(host_b, seg_b, n, block, dtype, device)}
    return state, meta


def apply_tri_blocked(state, b, *, n, block):
    """x = (L Lᵀ)⁻¹ b through the blocked sweeps; b (n,) or (n, k)."""
    dtype = state["f"]["vals"].dtype
    squeeze = b.ndim == 1
    b2 = (b[:, None] if squeeze else b).to(dtype)
    pad = torch.zeros((1, b2.shape[1]), dtype=dtype, device=b2.device)
    y = _sweep_blocks(state["f"], n, block, torch.cat([b2, pad]))
    x = _sweep_blocks(state["b"], n, block, torch.cat([y, pad]))
    return x[:, 0] if squeeze else x


# ------------------------------------------------------------------- solver

@register_solver("sparse_cholesky")
class SparseCholeskySolver(Solver):
    """Host symbolic and numeric sparse Cholesky (CHOLMOD's CPU split,
    cholmod.c:68); triangular solves on the host or, by the blocked or the
    level schedule, on the device."""

    def __init__(self, A: CsrMatrix, dtype=torch.float64, ordering="amd",
                 rtol=1e-10, max_refine=12, schedule="auto", block=256,
                 device="cuda", **params):
        super().__init__(A, **params)
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        if schedule == "auto":
            # The JAX package measured the native host substitution 26×
            # faster than either device schedule at n=262k, and it is where
            # the reference's default backend solves (cholmod.c:68).
            schedule = "host" if spchol.available() else "block"
        if schedule not in ("block", "level", "host"):
            raise ValueError(f"unknown schedule '{schedule}' (auto | block | "
                             "level | host)")
        self.schedule = schedule
        self.device = torch.device(device)
        self.dtype = as_dtype(dtype)
        self.ordering = ordering
        self.rtol = float(rtol)
        self.max_refine = int(max_refine)
        n = A.nrows
        # fp64 on a device schedule takes the JAX package's TPU branch on
        # every device: f32 sweeps refined by f64 residuals (the
        # `spmv_sell_f64` kernel), recorded as fp32_ir_auto.
        self._ir = schedule != "host" and self.dtype == torch.float64

        t0 = time.perf_counter()
        # The host schedule keeps everything, the permutation too, on the CPU.
        Ap, self._perm, self._inv = permutation(
            ordering, A, "cpu" if schedule == "host" else self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        As = symmetrize(Ap)
        parent = elimination_tree(As)
        loffs, lcols = symbolic_rows(As, parent)
        self.setup_breakdown["symbolic_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cp, ci, cx = numeric_factor(As, loffs, lcols)
        self.setup_breakdown["factor_s"] = time.perf_counter() - t0
        self.fill_nnz = int(cp[-1])
        self.n_levels_f = self.n_levels_b = self.n_blocks = None
        self.pad_waste = 0.0

        t0 = time.perf_counter()
        if schedule == "host":
            # CSC two-sweep substitution on the CPU, refined against the
            # permuted (unsymmetrized) operator: the reference's own split.
            self._cp, self._ci, self._cx = cp, ci, cx
            self._Ap_host = Ap
        else:
            sweep_dtype = torch.float32 if self._ir else self.dtype
            if schedule == "block":
                self._tri, meta = pack_tri_blocked(
                    cp, ci, cx, n, sweep_dtype, block=block,
                    device=self.device)
                self._block = meta["block"]
                self.n_blocks = meta["nb"]
            else:
                self._tri, meta = pack_tri(cp, ci, cx, n, sweep_dtype,
                                           self.device)
            self.n_levels_f, self.n_levels_b = meta["nlev_f"], meta["nlev_b"]
            self.pad_waste = meta["waste"]
            if self._ir:
                op64 = SellMatrix.from_csr(Ap, dtypes=(torch.float64,),
                                           device=self.device)
                self._mv = lambda v: spmv_sell_f64(op64, v)
            else:
                # The factor is of the symmetrized operator; refine against
                # the raw one (the JAX package's non-TPU branch).
                ell = EllMatrix.from_csr(Ap, dtype=self.dtype,
                                         device=self.device)
                self._mv = lambda v: spmv_ell(ell, v)
        self.setup_breakdown["level_build_s"] = time.perf_counter() - t0

    def _tri_apply(self, R: torch.Tensor) -> torch.Tensor:
        if self.schedule == "level":
            return apply_tri(self._tri, R)
        return apply_tri_blocked(self._tri, R, n=self.A.nrows,
                                 block=self._block)

    def _host_solve(self, b) -> torch.Tensor:
        """Host CPU solve and refinement (schedule 'host'); b (n,) or (n, k)."""
        b = to_numpy(b)
        squeeze = b.ndim == 1
        b2 = b[:, None] if squeeze else b
        bp = b2 if self._perm is None else b2[self._perm.numpy()]
        x = spchol.tri_solve(self._cp, self._ci, self._cx, bp)
        bn = np.linalg.norm(bp, axis=0)
        for _ in range(self.max_refine):
            r = bp - np.stack([self._Ap_host.matvec(x[:, j])
                               for j in range(x.shape[1])], axis=1)
            if np.all(np.linalg.norm(r, axis=0)
                      <= self.rtol * np.maximum(bn, 1e-300)):
                break
            x = x + spchol.tri_solve(self._cp, self._ci, self._cx, r)
        if self._inv is not None:
            x = x[self._inv.numpy()]
        return torch.from_numpy(x[:, 0] if squeeze else x)

    def _device_solve(self, b2: torch.Tensor) -> torch.Tensor:
        """A device schedule with refinement (`refine_columns`) until
        every column meets rtol or stops improving; b2 (n, k) on the
        device. The level sweeps' error word is read once, at the end. fp32_ir sweeps the f32 residual scaled to unit norm from
        x = 0; otherwise the first sweep gives x and the refinement sweeps
        run in the solve's dtype."""
        bp = b2 if self._perm is None else b2[self._perm]
        bp = bp.to(torch.float64 if self._ir else self.dtype)
        residual = column_residual(self._mv, bp)
        x0 = None if self._ir else self._tri_apply(bp)
        x, _, _, _ = refine_columns(bp, self._tri_apply, residual, self.rtol,
                                    self.max_refine, x=x0,
                                    unit_f32=self._ir)
        if self.schedule == "level":
            self._tri.check()
        return x if self._inv is None else x[self._inv]

    def _apply_solve(self, b):
        if self.schedule == "host":
            return self._host_solve(b)
        b = torch.as_tensor(b, device=self.device)
        if b.ndim == 2:
            return self._device_solve(b)
        return self._device_solve(b[:, None])[:, 0]

    def solve(self, b) -> SolveResult:
        x = self._apply_solve(b)
        relres = true_relres(self.A, x, b)
        extra = {"fill_nnz": self.fill_nnz, "schedule": self.schedule,
                 "blocks": self.n_blocks,
                 "levels": (self.n_levels_f, self.n_levels_b),
                 "pad_waste": self.pad_waste}
        if self._ir:
            extra["precision_mode"] = "fp32_ir_auto"
        return SolveResult(x=x, iters=1, relres=relres,
                           converged=bool(np.isfinite(relres)), extra=extra)

    def solve_fn(self):
        return self._apply_solve

