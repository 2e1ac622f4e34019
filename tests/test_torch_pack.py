"""Port parity: the packed forms of the uniform BSR layout
(`BsrMatrix.packed`), on which K7 (`spmv_bsr(variant="selector")`) and K8
(`variant="onehot"`) run the SELL f32 kernel on the card.

Each packed form must equal `SellMatrix.from_csr` of the same CSR array for
array (the matrices here have sorted columns and no value that is 0 in
f32), and its plain product must meet the bar of `test_torch_variants.py`
(1e-5 relative to 1 + |y|) against the JAX kernels in interpret mode and
the host f64 matvec. The gather rules are pinned on planted layouts: an
out-of-range block id drops its slot under "onehot" and is never read under
"selector"; a selector that is not exactly one-hot raises; elements in
lanes past ncols or rows past nrows are dropped."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix import bsr as jbsr
from lsbench_tpu.matrix import csr as jcsr
from lsbench_tpu.ops import spmv_pallas as jops

from lsbench_tpu_torch.matrix import bsr as tbsr
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops import spmv_bsr as ops
from lsbench_tpu_torch.ops import spmv_sell

from test_torch_variants import CASES, _close, _x

CPU = torch.device("cpu")
RULES = ("selector", "onehot")
PLAIN = {"selector": ops.spmv_bsr_selector_plain,
         "onehot": ops.spmv_bsr_onehot_plain}

pytestmark = [pytest.mark.parametrize("rule", RULES),
              pytest.mark.parametrize("case", sorted(CASES))]


def _layout(A) -> tbsr.BsrMatrix:
    return tbsr.BsrMatrix.from_csr(A, device=CPU, with_sel=True)


def _same(P: SellMatrix, R: SellMatrix) -> None:
    """Array for array, bit for bit."""
    for f in ("cols", "slice_off", "vals"):
        a, b = getattr(P, f), getattr(R, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert P.vals64 is None
    assert (P.nrows, P.ncols, P.nnz) == (R.nrows, R.ncols, R.nnz)


def _with(B: tbsr.BsrMatrix, **arrays) -> tbsr.BsrMatrix:
    """B with some arrays replaced (its selector kept unless given)."""
    fields = dict(blocks=B.blocks, block_cols=B.block_cols, sel=B.sel,
                  nrows=B.nrows, ncols=B.ncols, nnz=B.nnz)
    return tbsr.BsrMatrix(**{**fields, **arrays})


def _real_slot(B: tbsr.BsrMatrix) -> tuple[int, int]:
    """A slot holding a nonzero element of a real row."""
    blk = B.blocks.view(B.n_groups, B.slots, 8, 128)
    g, s = (int(i) for i in torch.nonzero(blk.flatten(2).any(dim=2))[0])
    return g, s


def test_packed_form_equals_sell_from_csr(case, rule):
    A = CASES[case]()
    _same(_layout(A).packed(rule), SellMatrix.from_csr(A, device=CPU))


def test_packed_form_matches_jax_and_host(case, rule):
    A = CASES[case]()
    x = _x(A.ncols, 11)
    y = spmv_sell.spmv_sell_plain(_layout(A).packed(rule),
                                  torch.as_tensor(x, dtype=torch.float32))
    assert y.dtype == torch.float32 and y.shape == (A.nrows,)
    JB = jbsr.BsrMatrix.from_csr(
        jcsr.CsrMatrix(A.nrows, A.ncols, A.offs, A.cols, A.vals))
    y_jax = np.asarray(jops.spmv_bsr(JB, jnp.asarray(x), variant=rule,
                                     interpret=True))
    y64 = y.numpy().astype(np.float64)
    assert _close(y64, y_jax)
    assert _close(y64, A.matvec(x))


def test_out_of_range_block_id(case, rule):
    """Under "onehot" a slot whose id lies outside [0, C) is dropped, as
    the one-hot product gathers 0 there; under "selector" block_cols is
    never read, so the pack does not change."""
    A = CASES[case]()
    B = _layout(A)
    g, s = _real_slot(B)
    x = torch.as_tensor(_x(A.ncols, 12), dtype=torch.float32)
    for bad_id in (B.n_col_blocks, -1):
        bad = B.block_cols.clone()
        bad[g, s] = bad_id
        Bad = _with(B, block_cols=bad)
        P = Bad.packed(rule)
        if rule == "selector":
            _same(P, B.packed(rule))
            continue
        slot = B.blocks[g, s * 8:(s + 1) * 8]
        assert P.nnz == B.packed(rule).nnz - int(torch.count_nonzero(slot))
        y = spmv_sell.spmv_sell_plain(P, x)
        assert _close(y.numpy().astype(np.float64),
                      PLAIN[rule](Bad, x).numpy().astype(np.float64))
        # The slot's rows lose exactly that block's product.
        part = torch.zeros(B.n_groups * 8)
        cb = int(B.block_cols[g, s])
        xb = torch.zeros(128)
        xb[: min(128, A.ncols - 128 * cb)] = x[128 * cb:128 * (cb + 1)]
        part[g * 8:(g + 1) * 8] = slot @ xb
        y0 = spmv_sell.spmv_sell_plain(B.packed(rule), x)
        assert _close(y.numpy().astype(np.float64),
                      (y0 - part[: A.nrows]).numpy().astype(np.float64))


def test_selector_not_one_hot_raises(case, rule):
    """A selector row with two nonzeros, or a 2.0, is refused when the
    "selector" form is packed; the "onehot" form never reads the
    selector."""
    A = CASES[case]()
    B = _layout(A)
    C = B.n_col_blocks
    two = B.sel.clone()
    two[0, (int(B.block_cols.view(-1)[0]) + 1) % C] = 1.0
    doubled = B.sel.clone()
    doubled[0] *= 2.0
    bad_sels = [doubled] + ([two] if C > 1 else [])
    for bad in bad_sels:
        Bad = _with(B, sel=bad)
        if rule == "selector":
            with pytest.raises(ValueError, match="one-hot"):
                Bad.packed(rule)
            assert rule not in Bad._packed
        else:
            _same(Bad.packed(rule), B.packed(rule))


def test_elements_past_ncols_and_nrows_dropped(case, rule):
    """Nonzeros planted where the x table is 0 (lanes at or past ncols)
    and in rows at or past nrows are dropped: the pack equals the clean
    one, and its product the plain version's."""
    A = CASES[case]()
    B = _layout(A)
    G, S, C = B.n_groups, B.slots, B.n_col_blocks
    blocks, bcols = B.blocks.clone(), B.block_cols.clone()
    real = -(-A.nrows // 8)
    # A real slot at the last column block: one that is there, or an empty
    # slot moved to it (its product stays 0).
    at_last = torch.nonzero(bcols[:real] == C - 1)
    if at_last.numel():
        g, s = (int(i) for i in at_last[0])
    else:
        empty = torch.nonzero(~blocks.view(G, S, 8, 128)[:real].flatten(2)
                              .any(dim=2))
        assert empty.numel(), "no slot to plant lanes past ncols in"
        g, s = (int(i) for i in empty[0])
        bcols[g, s] = C - 1
    first_past = A.ncols - 128 * (C - 1)
    assert first_past < 128, "ncols is a multiple of 128"
    blocks[g, s * 8:(s + 1) * 8, first_past:] = 7.0
    assert G * 8 > A.nrows
    blocks[G - 1, :8, :] = 5.0       # a GPS padding group
    blocks[real - 1, A.nrows % 8 or 8:8, :] = 3.0  # the last group's tail
    sel = torch.from_numpy(tbsr._bsr_selector(bcols.numpy(), A.ncols))
    Bad = _with(B, blocks=blocks, block_cols=bcols, sel=sel)
    P = Bad.packed(rule)
    _same(P, SellMatrix.from_csr(A, device=CPU))
    x = torch.as_tensor(_x(A.ncols, 13), dtype=torch.float32)
    assert _close(spmv_sell.spmv_sell_plain(P, x).numpy().astype(np.float64),
                  PLAIN[rule](Bad, x).numpy().astype(np.float64))


def test_pack_cached_and_rebuilt_by_to(case, rule):
    A = CASES[case]()
    B = _layout(A)
    P = B.packed(rule)
    assert B.packed(rule) is P and P.device == CPU
    moved = B.to(CPU)
    assert not moved._packed
    Q = moved.packed(rule)
    assert Q is not P and Q.device == CPU
    _same(Q, P)
    # On the CPU the wrapper is the plain version; an x off the CPU and
    # off CUDA raises.
    x = torch.as_tensor(_x(A.ncols, 14), dtype=torch.float32)
    assert torch.equal(ops.spmv_bsr(B, x, variant=rule), PLAIN[rule](B, x))
    with pytest.raises(ValueError):
        ops.spmv_bsr(B, x.to("meta"), variant=rule)
