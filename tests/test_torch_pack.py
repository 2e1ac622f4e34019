"""Port parity: the packed forms of the uniform BSR layout
(`BsrMatrix.packed`), on which K7 (`spmv_bsr(variant="selector")`) and K8
(`variant="onehot"`) run the SELL f32 kernel on the card, and of the
exact-block layout (`BsrCompact.packed`), on which K6 (`spmv_bsr_compact`)
runs it.

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

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from test_torch_variants import CASES, _close, _port_csr, _x

CPU = torch.device("cpu")
RULES = ("selector", "onehot")
PLAIN = {"selector": ops.spmv_bsr_selector_plain,
         "onehot": ops.spmv_bsr_onehot_plain}



def _rule_case(test):
    """Each gather-rule test runs for every rule on every case."""
    return pytest.mark.parametrize("case", sorted(CASES))(
        pytest.mark.parametrize("rule", RULES)(test))


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


@_rule_case
def test_packed_form_equals_sell_from_csr(case, rule):
    A = CASES[case]()
    _same(_layout(A).packed(rule), SellMatrix.from_csr(A, device=CPU))


@_rule_case
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


@_rule_case
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


@_rule_case
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


@_rule_case
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


@_rule_case
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


# ------------------------------------------- K6: the exact-block pack

COMPACT = {
    "poisson_2d(40)": lambda: _port_csr(j_poisson_2d(40)),
    "random_spd(300,9) RCM": CASES["random_spd(300,9) RCM"],
    "T%16!=0 poisson_2d(17)": CASES["T%16!=0 poisson_2d(17)"],
    "C=1 poisson_2d(9)": CASES["C=1 poisson_2d(9)"],
}


def _compact(A) -> tbsr.BsrCompact:
    return tbsr.BsrCompact.from_csr(A, device=CPU)


def _jax_compact(C: tbsr.BsrCompact, blocks=None, gids=None, bcols=None):
    """The JAX layout holding C's arrays (or the ones given)."""
    def arr(t, given):
        return jnp.asarray((t if given is None else given).numpy())
    return jbsr.BsrCompact(blocks=arr(C.blocks, blocks),
                           gids=arr(C.gids, gids), bcols=arr(C.bcols, bcols),
                           nrows=C.nrows, ncols=C.ncols, nnz=C.nnz,
                           n_groups=C.n_groups)


def _close6(y: torch.Tensor, ref) -> bool:
    """Within 1e-6 of the largest |ref| (f32 sums taken in another
    order)."""
    ref = np.asarray(ref, dtype=np.float64)
    err = np.abs(y.numpy().astype(np.float64) - ref).max()
    return err <= 1e-6 * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_packed_form_equals_sell_from_csr(case):
    A = COMPACT[case]()
    C = _compact(A)
    P = C.packed()
    _same(P, SellMatrix.from_csr(A, device=CPU))
    x = _x(A.ncols, 15)
    xt = torch.as_tensor(x, dtype=torch.float32)
    y = spmv_sell.spmv_sell_plain(P, xt)
    y_jax = np.asarray(jops.spmv_bsr_compact(_jax_compact(C), jnp.asarray(x),
                                             interpret=True))
    assert _close6(y, ops.spmv_bsr_compact_plain(C, xt))
    assert _close6(y, y_jax)
    assert _close(y.numpy().astype(np.float64), A.matvec(x))


def _planted(C: tbsr.BsrCompact, kind: str):
    """(blocks, gids, bcols) of C with one fault planted, and the change
    the pack must show: "same" (the clean pack, array for array), or the
    number of entries it gains (negative: loses)."""
    blocks, gids, bcols = C.blocks.clone(), C.gids.clone(), C.bcols.clone()
    real = int(blocks.flatten(1).any(dim=1).sum())  # sorted, padding last
    if kind == "zero element":
        t, r, c = (int(i) for i in torch.nonzero(blocks[:real])[3])
        blocks[t, r, c] = 0.0
        return blocks, gids, bcols, -1
    if kind == "row past nrows":
        last = torch.nonzero(gids[:real] == C.n_groups - 1)[0, 0]
        blocks[last, C.nrows % 8:, :] = 3.0
        return blocks, gids, bcols, "same"
    if kind == "lane past ncols":
        C_last = C.n_col_blocks - 1
        t = torch.nonzero(bcols[:real] == C_last)[0, 0]
        blocks[t, :, C.ncols - 128 * C_last:] = 7.0
        return blocks, gids, bcols, "same"
    if kind == "padding blocks":
        pad = torch.zeros((5, 8, 128), dtype=torch.float32)
        ids = torch.tensor([0, C.n_groups - 1, 3, 0, 1], dtype=torch.int32)
        return (torch.cat([blocks, pad]), torch.cat([gids, ids]),
                torch.cat([bcols, ids.flip(0) % C.n_col_blocks]), "same")
    if kind == "unsorted gids":
        order = torch.randperm(blocks.shape[0],
                               generator=torch.Generator().manual_seed(5))
        return blocks[order], gids[order], bcols[order], 0
    if kind == "duplicated block":
        t = real // 2
        dup = blocks[t:t + 1] * 0.5
        return (torch.cat([blocks, dup]), torch.cat([gids, gids[t:t + 1]]),
                torch.cat([bcols, bcols[t:t + 1]]),
                int(torch.count_nonzero(dup)))
    raise ValueError(kind)


PLANTS = ("zero element", "row past nrows", "lane past ncols",
          "padding blocks", "unsorted gids", "duplicated block")


@pytest.mark.parametrize("kind", PLANTS)
def test_compact_pack_planted(kind):
    """Each planted layout's pack gives the plain version's product and
    the JAX kernel's in interpret mode; what it drops or keeps is pinned
    against the clean pack."""
    A = COMPACT["T%16!=0 poisson_2d(17)"]()
    C = _compact(A)
    assert A.ncols % 128 and A.nrows % 8  # lanes and rows to plant in
    blocks, gids, bcols, change = _planted(C, kind)
    Bad = tbsr.BsrCompact(blocks=blocks, gids=gids, bcols=bcols,
                          nrows=C.nrows, ncols=C.ncols, nnz=C.nnz,
                          n_groups=C.n_groups)
    P, clean = Bad.packed(), C.packed()
    if change == "same":
        _same(P, clean)
    else:
        assert P.nnz == clean.nnz + change
    x = _x(A.ncols, 16)
    xt = torch.as_tensor(x, dtype=torch.float32)
    y = spmv_sell.spmv_sell_plain(P, xt)
    y_jax = np.asarray(jops.spmv_bsr_compact(
        _jax_compact(C, blocks, gids, bcols), jnp.asarray(x), interpret=True))
    assert _close6(y, ops.spmv_bsr_compact_plain(Bad, xt))
    assert _close6(y, y_jax)
    assert torch.equal(ops.spmv_bsr_compact(Bad, xt),
                       ops.spmv_bsr_compact_plain(Bad, xt))


@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_pack_cached_and_rebuilt_by_to(case):
    C = _compact(COMPACT[case]())
    P = C.packed()
    assert C.packed() is P and P.device == CPU
    moved = C.to(CPU)
    assert moved._packed is None
    Q = moved.packed()
    assert Q is not P
    _same(Q, P)
    x = torch.as_tensor(_x(C.ncols, 17), dtype=torch.float32)
    with pytest.raises(ValueError):
        ops.spmv_bsr_compact(C, x.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(COMPACT))
def test_compact_kernel_is_spmv_sell_on_card(case, cuda_device):
    """K6 on the card is the SELL f32 kernel over the packed form: the
    bits of `spmv_sell` on the CSR's SELL layout, one launch counted as
    K6's, none as the SELL kernel's."""
    A = COMPACT[case]()
    C = tbsr.BsrCompact.from_csr(A, device=cuda_device)
    x = torch.as_tensor(_x(A.ncols, 18), dtype=torch.float32,
                        device=cuda_device)
    ref = spmv_sell.spmv_sell(SellMatrix.from_csr(A, device=cuda_device), x)
    before = ops.LAUNCHES["bsr_compact_f32"]
    sell_before = spmv_sell.LAUNCHES["sell_f32"]
    y = ops.spmv_bsr_compact(C, x)
    assert torch.equal(y, ref)
    assert ops.LAUNCHES["bsr_compact_f32"] == before + 1
    assert spmv_sell.LAUNCHES["sell_f32"] == sell_before
    plain = ops.spmv_bsr_compact_plain(C, x)
    assert float((y - plain).abs().max()) <= 1e-5 * float(plain.abs().max())
