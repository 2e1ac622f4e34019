"""Two-pass SpGEMM: host symbolic, device numeric (counterpart of
`lsbench_tpu/ops/spgemm_device.py`).

The Galerkin product's sparsity pattern is fixed per hierarchy, so the
symbolic pass (the output pattern and the expansion plan) runs once on the
host, in NumPy, line for line the JAX package's, and its arrays are that
plan's bit for bit. The numeric pass is plain torch ops on the plan's
device:

    c_vals[slot] = Σ over the slot's triples t of a_vals[a_idx[t]] · b_vals[b_idx[t]]

two gathers, one multiply, one dense row sum per pad class and one
permutation gather. The reduction is the JAX plan's scatter-free
class-padded one, not an `index_add_`: f64 atomics would make the coarse
values depend on the order the card schedules them in, where each row sum
adds a slot's terms in one fixed order, so a re-formed hierarchy is
bitwise repeatable. This re-forms coarse operators on the device when only
the values change (the reference's on-device BoomerAMGSetup, hypre.c:97).

The plan's index arrays are int32 as in the JAX package, uploaded to the
plan's device once, when the plan is built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix

# The largest expansion the int32 plan can index: the zero sentinel sits at
# position `total` of the contribution stream.
MAX_TRIPLES = 2**31 - 1


@dataclass
class SpgemmPlan:
    """Host-built symbolic plan for C = A @ B (pattern and expansion map).

    The expansion triples are sorted by destination slot, the slots are
    grouped into power-of-two pad classes by triple count, and the numeric
    pass gathers each class's contributions into an (n_c, w) array and sums
    its rows. Padding points at the zero sentinel appended at position T of
    the contribution stream, so padded lanes add exactly 0.
    """
    a_idx: torch.Tensor   # (T,) int32 into A.vals, sorted by dest slot
    b_idx: torch.Tensor   # (T,) int32 into B.vals, same order
    pads: tuple           # per class: (n_c, w) int32 into the stream
    slot_pos: torch.Tensor  # (nnz,) int32: slot j's row in the class outputs
    offs: np.ndarray      # C pattern (host)
    cols: np.ndarray
    nrows: int
    ncols: int
    nnz: int


def _class_pads(counts: np.ndarray, total: int, device):
    """Group output slots into pow-2 pad classes; build the gather indices.

    Returns (pads, slot_pos): pads[k] is an (n_k, w_k) int32 tensor of
    positions into the length-(total+1) contribution stream (position
    `total` is the zero sentinel); slot_pos[j] is slot j's row in the
    concatenation of all class outputs."""
    nnz = counts.size
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    width = np.maximum(1, 1 << np.ceil(
        np.log2(np.maximum(counts, 1))).astype(np.int64))
    pads = []
    order_slots = []
    for w in np.unique(width):
        sel = np.flatnonzero(width == w)
        st = starts[sel]
        cnt = counts[sel]
        idx = st[:, None] + np.arange(w)[None, :]
        idx = np.where(np.arange(w)[None, :] < cnt[:, None], idx, total)
        pads.append(torch.as_tensor(idx.astype(np.int32), device=device))
        order_slots.append(sel)
    concat_slots = np.concatenate(order_slots)
    slot_pos = np.empty(nnz, dtype=np.int64)
    slot_pos[concat_slots] = np.arange(nnz)
    return tuple(pads), torch.as_tensor(slot_pos.astype(np.int32),
                                        device=device)


def spgemm_symbolic(A: CsrMatrix, B: CsrMatrix, device="cuda") -> SpgemmPlan:
    """Symbolic pass: expansion triples and the deduplicated output pattern,
    with the index arrays on `device`."""
    if A.ncols != B.nrows:
        raise ValueError(f"shape mismatch: {A.shape} @ {B.shape}")
    a_rows = A.row_indices()
    counts = (B.offs[A.cols + 1] - B.offs[A.cols]).astype(np.int64)
    total = int(counts.sum())
    if total > MAX_TRIPLES:
        raise ValueError(f"spgemm: {total} expansion triples exceed the "
                         f"int32 plan's {MAX_TRIPLES}")
    if total == 0:
        zeros = torch.zeros(1, dtype=torch.int32, device=device)
        return SpgemmPlan(
            a_idx=zeros, b_idx=zeros.clone(), pads=(),
            slot_pos=torch.zeros(0, dtype=torch.int32, device=device),
            offs=np.zeros(A.nrows + 1, dtype=np.int64),
            cols=np.zeros(0, dtype=np.int64),
            nrows=A.nrows, ncols=B.ncols, nnz=0)
    a_idx = np.repeat(np.arange(A.nnz, dtype=np.int64), counts)
    starts = B.offs[A.cols].astype(np.int64)
    ends = np.cumsum(counts)
    b_idx = (np.arange(total, dtype=np.int64)
             - np.repeat(ends - counts, counts) + np.repeat(starts, counts))
    out_i = np.repeat(a_rows, counts)
    out_j = B.cols[b_idx]

    key = out_i * np.int64(B.ncols) + out_j
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // B.ncols).astype(np.int64)
    c_cols = (uniq % B.ncols).astype(np.int64)
    offs = np.zeros(A.nrows + 1, dtype=np.int64)
    np.cumsum(np.bincount(c_rows, minlength=A.nrows), out=offs[1:])
    # Sort the triples by destination slot (stable), then build the
    # scatter-free class-padded reduction layout.
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv, minlength=uniq.size)
    pads, slot_pos = _class_pads(counts, total, device)
    return SpgemmPlan(
        a_idx=torch.as_tensor(a_idx[order].astype(np.int32), device=device),
        b_idx=torch.as_tensor(b_idx[order].astype(np.int32), device=device),
        pads=pads, slot_pos=slot_pos,
        offs=offs, cols=c_cols, nrows=A.nrows, ncols=B.ncols,
        nnz=uniq.size)


def spgemm_numeric_idx(a_idx, b_idx, pads, slot_pos, nnz: int,
                       a_vals: torch.Tensor, b_vals: torch.Tensor
                       ) -> torch.Tensor:
    """The numeric pass on the plan's arrays: C's values in plan order.
    Contributions are gathered per pad class and row-summed densely, and
    the output assembled by one permutation gather."""
    if nnz == 0:
        return a_vals.new_zeros(0, dtype=torch.result_type(a_vals, b_vals))
    contrib = a_vals[a_idx] * b_vals[b_idx]
    contrib_ext = torch.cat([contrib, contrib.new_zeros(1)])
    parts = [contrib_ext[p].sum(dim=1) for p in pads]
    return torch.cat(parts)[slot_pos]


def spgemm_numeric(plan: SpgemmPlan, a_vals: torch.Tensor,
                   b_vals: torch.Tensor) -> torch.Tensor:
    """Device numeric pass: C's values in plan order."""
    return spgemm_numeric_idx(plan.a_idx, plan.b_idx, plan.pads,
                              plan.slot_pos, plan.nnz, a_vals, b_vals)


@dataclass
class RapPlan:
    """Composed plan for the Galerkin triple product R A P."""
    ra: SpgemmPlan
    rap: SpgemmPlan


def rap_symbolic(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix,
                 device="cuda") -> RapPlan:
    """Symbolic RAP: the pattern of RA (with placeholder values: the
    expansion keeps structural zeros, so the pattern does not depend on
    them), then that of (RA)·P."""
    ra = spgemm_symbolic(R, A, device)
    RA_pattern = CsrMatrix(nrows=ra.nrows, ncols=ra.ncols, offs=ra.offs,
                           cols=ra.cols, vals=np.ones(max(ra.nnz, 1)))
    rap = spgemm_symbolic(RA_pattern, P, device)
    return RapPlan(ra=ra, rap=rap)


def rap_numeric_idx(plan_idx, nnz_ra: int, nnz_rap: int,
                    r_vals, a_vals, p_vals) -> torch.Tensor:
    """Numeric RAP with the plan arrays as arguments: `plan_idx` is the
    8-tuple (ra.a_idx, ra.b_idx, ra.pads, ra.slot_pos, rap.a_idx,
    rap.b_idx, rap.pads, rap.slot_pos)."""
    (ra_ai, ra_bi, ra_pd, ra_sp,
     rap_ai, rap_bi, rap_pd, rap_sp) = plan_idx
    ra_vals = spgemm_numeric_idx(ra_ai, ra_bi, ra_pd, ra_sp, nnz_ra,
                                 r_vals, a_vals)
    return spgemm_numeric_idx(rap_ai, rap_bi, rap_pd, rap_sp, nnz_rap,
                              ra_vals, p_vals)


def rap_numeric(plan: RapPlan, r_vals, a_vals, p_vals) -> torch.Tensor:
    """Device numeric RAP: the coarse operator's values in plan order."""
    ra_vals = spgemm_numeric(plan.ra, r_vals, a_vals)
    return spgemm_numeric(plan.rap, ra_vals, p_vals)


def rap_device(R: CsrMatrix, A: CsrMatrix, P: CsrMatrix,
               device="cuda") -> CsrMatrix:
    """Galerkin RAP with the numeric pass on `device`; returns host CSR."""
    plan = rap_symbolic(R, A, P, device)
    f64 = dict(dtype=torch.float64, device=device)
    vals = rap_numeric(plan, torch.as_tensor(R.vals, **f64),
                       torch.as_tensor(A.vals, **f64),
                       torch.as_tensor(P.vals, **f64))
    return CsrMatrix(nrows=plan.rap.nrows, ncols=plan.rap.ncols,
                     offs=plan.rap.offs, cols=plan.rap.cols,
                     vals=vals.cpu().numpy().astype(np.float64))
