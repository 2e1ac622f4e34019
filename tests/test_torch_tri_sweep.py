"""The triangular-sweep kernels' layout and launch plan (`ops/tri_sweep.py`,
`csrc/tri_sweep.cu`) on the CPU, and the kernels against their plain
version on the card.

Factors: IC(0) and the sparse Cholesky factor (AMD) of poisson_2d(64) and
random_spd(300, 9), both sweeps of each, at the default capacity (the run
kernel's 1024 rows) and at a forced capacity of 8 rows, where both kinds
of segment occur.

Bars:
- the plan covers every level, so every position, once and in level
  order; a run's levels each fit one block (≤ capacity rows and ≤
  `RUN_LEVEL_ENTRIES` entries), a wide segment is one level that does
  not;
- a host walk of the layout as the kernels walk it (segment by segment,
  in position space, each row summed by its segment's group: lane l takes
  entries l, l + G, ..., the lanes added by the xor tree) in f64 equals the
  plain sweep within 1e-12·max|x|; the walk also reads x_j through a small
  ring of recent positions where the run kernel would, and checks that
  the slot holds x_j;
- with k = 3 columns the walk's apply (forward then backward) equals the
  JAX package's `apply_tri` on the same factor within 1e-12·max|x|;
- on the card (`cuda`): each segment kind against the plain version, f32
  within 1e-5·max|x| and f64 within 1e-12·max|x| (another summation
  order than `index_add_`), k columns in one launch per segment, bitwise
  repeatable; a launch the kernel refuses raises.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lsbench_tpu.matrix.generate import poisson_2d as j_poisson_2d
from lsbench_tpu.matrix.generate import random_spd as j_random_spd
from lsbench_tpu.solvers import sparse_cholesky as jsc

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.ops import _cuda
from lsbench_tpu_torch.ops import tri_sweep as ts
from lsbench_tpu_torch.ordering import get_ordering
from lsbench_tpu_torch.solvers import sparse_cholesky as tsc
from lsbench_tpu_torch.solvers.ic0 import ic0_factor

CPU = torch.device("cpu")
MATRICES = {"poisson_2d(64)": lambda: j_poisson_2d(64),
            "random_spd(300,9)": lambda: j_random_spd(300, 9)}
# label → (matrix, factor kind, ordering)
FACTORS = {
    "ic0 poisson_2d(64) rcm": ("poisson_2d(64)", "ic0", "rcm"),
    "ic0 random_spd(300,9) rcm": ("random_spd(300,9)", "ic0", "rcm"),
    "amd factor poisson_2d(64)": ("poisson_2d(64)", "chol", "amd"),
    "amd factor random_spd(300,9)": ("random_spd(300,9)", "chol", "amd"),
}
CAPACITIES = (None, 8)
# Pre-passes at a small size: runs of capacity 8 rows, each with one where
# its rows hold any entry on a position before it.
PRE_PASSES = dict(capacity=8, pre_entries=1)


@functools.lru_cache(maxsize=None)
def _factor(label):
    name, kind, ordering = FACTORS[label]
    JA = MATRICES[name]()
    A = CsrMatrix(JA.nrows, JA.ncols, JA.offs, JA.cols, JA.vals)
    Ap = A.permuted(get_ordering(ordering, A))
    if kind == "ic0":
        return ic0_factor(Ap)
    As = tsc.symmetrize(Ap)
    return tsc.numeric_factor(As, *tsc.symbolic_rows(
        As, tsc.elimination_tree(As)))


@functools.lru_cache(maxsize=None)
def _host(label, capacity, pre_entries=None):
    """pack_tri_host at `capacity`; with `pre_entries`, every run whose
    rows hold that many entries before it gets a pre-pass."""
    cp, ci, cx = _factor(label)
    default = ts._PRE_ENTRIES
    ts._PRE_ENTRIES = default if pre_entries is None else pre_entries
    try:
        return tsc.pack_tri_host(cp, ci, cx, len(cp) - 1, capacity)
    finally:
        ts._PRE_ENTRIES = default


def _pack(label, capacity, dtype, device, plain=True, pre_entries=None):
    host, meta = _host(label, capacity, pre_entries)
    return tsc.upload_tri(host, dtype, device, plain), meta


def _xor_tree(a):
    """Lane 0 of `acc += shfl_xor(acc, o)` for o = len/2, ..., 1 (lanes on
    axis 0)."""
    a, idx, o = a.copy(), np.arange(a.shape[0]), a.shape[0] // 2
    while o:
        a = a + a[idx ^ o]
        o //= 2
    return a[0]


def _group_sum(prods, G, init=0.0):
    """One row's sums (prods: entries × columns) as the kernels take them:
    lane l sums entries l, l + G, ... in order, lane 0 from `init` (a
    pre-pass's sum); G ≤ 32 lanes meet in one xor tree, more in a tree per
    warp and a tree over the warps' sums."""
    lanes = np.zeros((G, prods.shape[1]))
    lanes[0] += init
    for m in range(0, prods.shape[0], G):  # entries m .. m+G-1, one each
        chunk = prods[m:m + G]
        lanes[:chunk.shape[0]] += chunk
    if G <= 32:
        return _xor_tree(lanes)
    top = np.zeros((32, prods.shape[1]))
    top[:G // 32] = [_xor_tree(w) for w in lanes.reshape(-1, 32,
                                                         prods.shape[1])]
    return _xor_tree(top)


def _walk(S, B, ring_slots=32):
    """The kernels' sweep of B (n, k) on the host in f64: the plan's
    segments in order, levels in order inside a run, x by position, each
    row summed by its level's lanes (at most the run's block); a pre-pass
    sums the next run's rows' entries on positions before that run (a
    prefix of each row, up to `ioffs`), and the run each row's rest from
    that sum. A run also keeps a ring of `ring_slots` positions (slot =
    position mod W) and reads x_j from it where the run kernel would (j ≥
    max(run start, level end − W)): the slot must hold position j."""
    perm, offs, ioffs = S.perm.numpy(), S.offs.numpy(), S.ioffs.numpy()
    cols, vals = S.cols.numpy(), S.vals.double().numpy()
    dinv, lvl = S.dinv.double().numpy(), S.lvl_host
    lgs = S.lvl_lg.numpy()
    k = B.shape[1]
    xpos = np.full((S.n, k), np.nan)
    pre = np.zeros((S.n, k))
    with_pre = False
    ring_pos = np.full(ring_slots, -1)
    pslot, pvals = S.pslot.numpy(), S.pvals.double().numpy()
    W = ts.PAIR_RING
    for kind, l0, l1, width in S.plan:
        run0 = lvl[l0]
        if kind == ts.PRE:  # the next run's rows: their entries before it
            for p in range(run0, lvl[l1]):
                js = cols[offs[p]:ioffs[p]]
                assert np.all(js < run0)
                assert np.all(cols[ioffs[p]:offs[p + 1]] >= run0)
                pre[p] = _group_sum(vals[offs[p]:ioffs[p], None]
                                    * xpos[js], width)
            with_pre = True
            continue
        assert kind != ts.RUN or with_pre or np.array_equal(
            ioffs[run0:lvl[l1]], offs[run0:lvl[l1]])
        if kind == ts.PAIR:  # the pair kernel's ring, preloaded
            pair_pos = np.full(W + 1, -1)
            before = np.arange(max(run0 - W, 0), run0)
            pair_pos[before % W] = before
        for level in range(l0, l1):
            s, e = lvl[level], lvl[level + 1]
            G = 1 << int(lgs[level])
            if kind != ts.WIDE:
                G = min(G, width)
            lo = max(run0, e - ring_slots)
            for p in range(s, e):
                q0 = ioffs[p] if kind == ts.RUN else offs[p]
                js = cols[q0:offs[p + 1]]
                assert np.all(js < s)  # only earlier levels
                if kind == ts.PAIR:  # x_j from the slot: it holds j
                    slots = pslot[p, :js.size]
                    assert np.array_equal(pair_pos[slots], js)
                    assert np.all(pslot[p, js.size:] == W)
                    assert not pvals[p, js.size:].any()
                near = (js >= lo) & (kind == ts.RUN)
                assert np.array_equal(ring_pos[js[near] % ring_slots],
                                      js[near])
                xj = xpos[js]
                assert not np.isnan(xj).any()
                prods = vals[q0:offs[p + 1], None] * xj
                xpos[p] = (B[perm[p]] - _group_sum(
                    prods, G, pre[p] if with_pre else 0.0)) * dinv[p]
            if kind == ts.RUN:
                ring_pos[np.arange(s, e) % ring_slots] = np.arange(s, e)
            elif kind == ts.PAIR:
                pair_pos[np.arange(s, e) % W] = np.arange(s, e)
        with_pre = False
    x = np.empty_like(xpos)
    x[perm] = xpos
    return x


def _max_err(x, ref):
    return np.abs(np.asarray(x) - np.asarray(ref)).max() / np.abs(
        np.asarray(ref)).max()


def _plan_kinds(S, nlev, cap, pre_entries):
    """Check S's plan against its levels at capacity `cap` and pre-pass
    threshold `pre_entries`; returns the kinds of segment it holds."""
    assert S.nlev == nlev
    lvl = S.lvl_host
    rows = np.diff(lvl)
    assert lvl[0] == 0 and lvl[-1] == S.n and np.all(rows > 0)
    plan = S.plan
    pre = plan[:, 0] == ts.PRE
    # The segments but the pre-passes cut the levels in order, so
    # positions 0..n-1 once; a pre-pass comes just before its run.
    bounds = [(int(l0), int(l1)) for _, l0, l1, _ in plan[~pre]]
    assert bounds[0][0] == 0 and bounds[-1][1] == nlev
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    covered = np.concatenate([np.arange(lvl[l0], lvl[l1])
                              for l0, l1 in bounds])
    np.testing.assert_array_equal(covered, np.arange(S.n))
    offs, cols = S.offs.numpy(), S.cols.numpy()
    lgs = S.lvl_lg.numpy().astype(np.int64)
    ents = np.diff(offs[lvl])
    maxlen = np.maximum.reduceat(np.diff(offs), lvl[:-1])
    fits = ((rows <= cap) & (ents <= ts.RUN_LEVEL_ENTRIES)
            & ((maxlen <= 2)
               | (ts._level_cost(rows, maxlen)[1] <= ts._WIDE_US)))
    pairs = ts._pairable(lvl, offs, cols, maxlen, fits)
    ioffs = S.ioffs.numpy()
    for i, (kind, l0, l1, width) in enumerate(plan):
        p0, p1 = lvl[l0], lvl[l1]
        if kind in (ts.RUN, ts.PAIR):
            assert fits[l0:l1].all()
            assert l1 - l0 <= ts.MAX_RUN_LEVELS
            # a run is maximal: the end, a level it cannot hold or one
            # of the other kind of run follows it
            assert (l1 == nlev or not fits[l1] or pairs[l1] != pairs[l0]
                    or l1 - l0 == ts.MAX_RUN_LEVELS)
            # the block: a power of two of threads, no narrower than a
            # level's lanes per row; a pair run's holds its widest level
            assert width in (32, 64, 128, 256, 512, 1024)
            assert (1 << lgs[l0:l1]).max() <= width
            if kind == ts.PAIR:
                lanes = min(rows[l0:l1].max(), 1024)
                assert width == max(32, 1 << int(lanes - 1).bit_length())
            else:
                assert width <= ts._RUN_BLOCK
            # a pair run: rows of at most two entries near their level's
            # end, one lane each; a run holds no such level
            assert pairs[l0:l1].all() if kind == ts.PAIR else \
                not pairs[l0:l1].any()
            assert kind != ts.PAIR or not lgs[l0:l1].any()
            # a run's entries on positions before it: summed by its
            # pre-pass (just before it) where they are many enough
            outer = sum(int(np.sum(cols[offs[p]:offs[p + 1]] < p0))
                        for p in range(p0, p1))
            has_pre = i > 0 and plan[i - 1][0] == ts.PRE
            assert has_pre == (kind == ts.RUN and outer >= pre_entries)
            if not has_pre:
                np.testing.assert_array_equal(ioffs[p0:p1], offs[p0:p1])
        elif kind == ts.PRE:
            assert plan[i + 1].tolist() == [ts.RUN, l0, l1, plan[i + 1][3]]
            outer = [int(np.sum(cols[offs[p]:offs[p + 1]] < p0))
                     for p in range(p0, p1)]
            np.testing.assert_array_equal(ioffs[p0:p1],
                                          offs[p0:p1] + outer)
            assert width == 1 << ts._wide_lg(max(outer)) <= 256
        else:
            assert kind == ts.WIDE and l1 == l0 + 1
            assert not fits[l0] and width == 1 << lgs[l0] <= 256
    assert S.launches_per_sweep(1) == len(plan)
    assert S.launches_per_sweep(11) == 2 * len(plan)
    return set(plan[:, 0].tolist())


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("label", sorted(FACTORS))
def test_plan_covers_levels_within_capacity(label, capacity):
    state, meta = _pack(label, capacity, torch.float64, CPU)
    cap = ts.RUN_THREADS if capacity is None else capacity
    kinds = set()
    for S, nlev in ((state.f, meta["nlev_f"]), (state.b, meta["nlev_b"])):
        kinds |= _plan_kinds(S, nlev, cap, ts._PRE_ENTRIES)
    if capacity == 8:
        assert ts.WIDE in kinds and kinds & {ts.RUN, ts.PAIR}


@pytest.mark.parametrize("label", sorted(FACTORS))
def test_plan_pre_passes(label):
    """With a pre-pass wherever a run's rows hold any entry before it,
    every such run has one, and a sparse factor's plan has some."""
    state, meta = _pack(label, dtype=torch.float64, device=CPU,
                        **PRE_PASSES)
    kinds = set()
    for S, nlev in ((state.f, meta["nlev_f"]), (state.b, meta["nlev_b"])):
        kinds |= _plan_kinds(S, nlev, PRE_PASSES["capacity"],
                             PRE_PASSES["pre_entries"])
    if "amd" in label:
        assert ts.PRE in kinds


def test_plan_groups_fit_the_rows():
    """One lane per row for IC(0) of a 2-D Poisson matrix (rows of ≤ 2
    entries) in one pair run of 64 threads (its widest level has 64
    rows); many lanes for a lone long row; a wide level's lanes follow its
    longest row up to its block."""
    state, _ = _pack("ic0 poisson_2d(64) rcm", None, torch.float64, CPU)
    assert state.f.plan.tolist() == [[ts.PAIR, 0, state.f.nlev, 64]]
    S = state.f
    lens = np.diff(S.offs.numpy())
    for m in range(2):  # the pair layout: entry m's ring slot, or the
        has = lens > m    # zero slot and 0
        np.testing.assert_array_equal(
            S.pslot.numpy()[:, m], np.where(has, S.cols.numpy()[
                np.minimum(S.offs.numpy()[:-1] + m, S.nnz - 1)]
                % ts.PAIR_RING, ts.PAIR_RING))
        assert not S.pvals.numpy()[~has, m].any()
    assert not state.f.lvl_lg.any()
    lg = ts._level_cost(np.array([1, 512, 254, 1]),
                       np.array([2786, 2, 35, 1]))[0]
    assert lg[0] >= 8 and lg[1] == 0 and 1 <= lg[2] <= 3 and lg[3] == 0
    assert ts._wide_lg(2) == 0 and ts._wide_lg(35) == 4
    assert ts._wide_lg(10**6) == 8


def test_plan_refused_where_it_breaks_the_capacity():
    """A plan whose blocks cannot hold their levels' lanes per row, that
    skips a segment, or that runs rows the pair kernel cannot read on it,
    is refused when the sweep is built."""
    state, _ = _pack("amd factor random_spd(300,9)", 8, torch.float64, CPU)
    S = state.b
    args = (S.perm.numpy(), S.offs.numpy(), S.cols.numpy(),
            S.vals.numpy(), S.dinv.numpy(), S.lvl_host, torch.float64, CPU)
    lg = S.lvl_lg.numpy()
    narrow = S.plan.copy()
    narrow[:, 0], narrow[:, 3] = ts.RUN, 32  # every segment a 32-thread run
    ts.TriSweep.build(*args, plan=(narrow, np.minimum(lg, 5)))
    with pytest.raises(ValueError, match="segment plan"):  # 64 lanes a row
        ts.TriSweep.build(*args, plan=(narrow, np.full_like(lg, 6)))
    with pytest.raises(ValueError, match="segment plan"):
        ts.TriSweep.build(*args, plan=(S.plan[1:], lg))
    pair = S.plan.copy()
    pair[:, 0] = ts.PAIR  # rows of more than two entries
    with pytest.raises(ValueError, match="segment plan"):
        ts.TriSweep.build(*args, plan=(pair, np.zeros_like(lg)))
    ts.TriSweep.build(*args, plan=(S.plan, lg))


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("label", sorted(FACTORS))
def test_segment_walk_matches_plain(label, capacity):
    state, _ = _pack(label, capacity, torch.float64, CPU)
    b = np.random.default_rng(5).standard_normal(state.f.n)
    for S in (state.f, state.b):
        x = ts.tri_sweep(S, torch.as_tensor(b)).numpy()
        assert _max_err(_walk(S, b[:, None])[:, 0], x) <= 1e-12


@pytest.mark.parametrize("label", sorted(FACTORS))
def test_segment_walk_with_pre_passes_matches_plain(label):
    state, _ = _pack(label, dtype=torch.float64, device=CPU, **PRE_PASSES)
    b = np.random.default_rng(5).standard_normal(state.f.n)
    for S in (state.f, state.b):
        x = ts.tri_sweep(S, torch.as_tensor(b)).numpy()
        assert _max_err(_walk(S, b[:, None])[:, 0], x) <= 1e-12


@functools.lru_cache(maxsize=None)
def _jax_apply_k3(label):
    """(B, the JAX package's apply_tri of each column of B)."""
    cp, ci, cx = _factor(label)
    n = len(cp) - 1
    B = np.random.default_rng(6).standard_normal((n, 3))
    j_state, j_apply, *_ = jsc.build_level_solver(cp, ci, cx, n,
                                                  jnp.float64)
    return B, np.stack([np.asarray(j_apply(j_state, jnp.asarray(B[:, j])))
                        for j in range(3)], axis=1)


@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("label", sorted(FACTORS))
def test_segment_walk_k3_matches_jax_apply(label, capacity):
    state, _ = _pack(label, capacity, torch.float64, CPU, plain=False)
    B, x_jax = _jax_apply_k3(label)
    x = _walk(state.b, _walk(state.f, B))
    assert _max_err(x, x_jax) <= 1e-12


@pytest.mark.parametrize("label,capacity,kind", [
    ("ic0 poisson_2d(64) rcm", 32, ts.PAIR),   # pair runs and wide levels
    ("amd factor poisson_2d(64)", 8, ts.RUN)])  # runs and wide levels
def test_launch_arguments_match_the_entry_points(label, capacity, kind,
                                                 monkeypatch):
    """What the wrapper hands the sweep's entry point: as many arguments as
    `_cuda.SOURCES` declares (ctypes would shift any extra one), one call
    per block of ≤ 8 columns with the columns' pointers offset by the
    block, the plan and the level offsets as host arrays, and one launch
    counted per segment of each call."""
    cp, ci, cx = _factor(label)
    host, _ = tsc.pack_tri_host(cp, ci, cx, len(cp) - 1, capacity)
    S = tsc.upload_tri(host, torch.float32, CPU, plain=False).b
    assert {ts.WIDE, kind} <= set(S.plan[:, 0].tolist())
    calls = []
    declared = {name[len("lsb_"):]: n_ptr + n_int
                for name, n_ptr, n_int in _cuda.SOURCES["tri_sweep"]}
    monkeypatch.setattr(_cuda, "entry", lambda stem, name: name)
    monkeypatch.setattr(_cuda, "launch",
                        lambda fn, name, dev, *args: calls.append((fn, args)))
    B = torch.zeros((S.n, 11))
    x = torch.empty_like(B)
    ts.reset_launches()
    ts._launch_plan(S, "tri_sweep_f32", B, x)
    assert len(calls) == 2
    assert ts.LAUNCHES["tri_sweep_f32"] == 2 * len(S.plan)
    assert S.plan.flags.c_contiguous and S.plan.dtype == np.int64
    for (fn, args), c0 in zip(calls, (0, 8)):
        assert fn == "tri_sweep_f32" and len(args) == declared[fn]
        assert args[:2] == (S.plan.ctypes.data, S.lvl_host.ctypes.data)
        assert args[2:4] == (S.perm.data_ptr(), S.ioffs.data_ptr())
        assert args[-7] == B.data_ptr() + 4 * c0  # b, pre, x, xpos, 3 ints
        assert args[-6] is None  # no pre-pass in this plan
        assert args[-5] == x.data_ptr() + 4 * c0
        assert args[-3:] == (len(S.plan), 8 if c0 == 0 else 3, 11)


def test_launch_passes_the_pre_buffer(monkeypatch):
    """A plan with pre-passes gets a buffer of the pre-passes' sums, one
    (n, k) array like b, offset by each block of columns."""
    state, _ = _pack("amd factor poisson_2d(64)", dtype=torch.float32,
                     device=CPU, plain=False, **PRE_PASSES)
    S = state.f
    assert ts.PRE in S.plan[:, 0]
    calls = []
    monkeypatch.setattr(_cuda, "entry", lambda stem, name: name)
    monkeypatch.setattr(_cuda, "launch",
                        lambda fn, name, dev, *args: calls.append(args))
    B = torch.zeros((S.n, 11))
    x = torch.empty_like(B)
    ts._launch_plan(S, "tri_sweep_f32", B, x)
    pre = [args[-6] for args in calls]
    assert len(pre) == 2 and pre[1] - pre[0] == 4 * 8
    assert pre[0] not in (B.data_ptr(), x.data_ptr(), calls[0][-4])


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("capacity", CAPACITIES)
@pytest.mark.parametrize("label", sorted(FACTORS))
def test_kernels_match_plain_on_card(label, capacity, dtype, tol,
                                     cuda_device):
    state, _ = _pack(label, capacity, dtype, cuda_device)
    name = ts._NAMES[dtype]
    B = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (state.f.n, 3)), dtype=dtype, device=cuda_device)
    for S in (state.f, state.b):
        for b in (B[:, 0].contiguous(), B):
            plain = (ts.tri_sweep_plain(S, b) if b.dim() == 1 else
                     torch.stack([ts.tri_sweep_plain(S, b[:, j].contiguous())
                                  for j in range(3)], dim=1))
            ts.reset_launches()
            x = ts.tri_sweep(S, b)
            torch.cuda.synchronize()
            assert ts.LAUNCHES[name] == len(S.plan)  # all columns at once
            assert (x - plain).abs().max() <= tol * plain.abs().max()
            assert torch.equal(ts.tri_sweep(S, b), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
@pytest.mark.parametrize("label", sorted(FACTORS))
def test_kernels_with_pre_passes_match_plain_on_card(label, dtype, tol,
                                                     cuda_device):
    """Runs after pre-passes (and the rest of such a plan) against the
    plain version, at k = 1 and 3, one launch per segment, bitwise
    repeatable."""
    state, _ = _pack(label, dtype=dtype, device=cuda_device, **PRE_PASSES)
    name = ts._NAMES[dtype]
    B = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (state.f.n, 3)), dtype=dtype, device=cuda_device)
    for S in (state.f, state.b):
        for b in (B[:, 0].contiguous(), B):
            plain = (ts.tri_sweep_plain(S, b) if b.dim() == 1 else
                     torch.stack([ts.tri_sweep_plain(S, b[:, j].contiguous())
                                  for j in range(3)], dim=1))
            ts.reset_launches()
            x = ts.tri_sweep(S, b)
            torch.cuda.synchronize()
            assert ts.LAUNCHES[name] == len(S.plan)
            assert (x - plain).abs().max() <= tol * plain.abs().max()
            assert torch.equal(ts.tri_sweep(S, b), x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_kernels_many_columns_on_card(dtype, tol, cuda_device):
    """k = 11: two blocks of columns (8 + 3), each column the k = 1 sweep
    within the tolerance."""
    state, _ = _pack("amd factor poisson_2d(64)", 8, dtype, cuda_device)
    S = state.b
    B = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (S.n, 11)), dtype=dtype, device=cuda_device)
    ts.reset_launches()
    X = ts.tri_sweep(S, B)
    torch.cuda.synchronize()
    assert ts.LAUNCHES[ts._NAMES[dtype]] == 2 * len(S.plan)
    for j in range(11):
        x1 = ts.tri_sweep(S, B[:, j].contiguous())
        assert (X[:, j] - x1).abs().max() <= tol * x1.abs().max()


@pytest.mark.cuda
def test_refused_launch_raises(cuda_device):
    """A segment the kernels cannot take (a run of no level) makes the
    sweep's entry point return an error, and the wrapper raise."""
    state, _ = _pack("ic0 random_spd(300,9) rcm", None, torch.float32,
                     cuda_device)
    S, b = state.f, torch.ones(state.f.n, device=cuda_device)
    x = torch.empty_like(b)
    plan = np.array([[ts.RUN, 0, 0, 32]], dtype=np.int64)  # no level
    fn = _cuda.entry("tri_sweep", "tri_sweep_f32")
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        _cuda.launch(fn, "tri_sweep_f32", b.device, plan.ctypes.data,
                     S.lvl_host.ctypes.data, S.perm.data_ptr(),
                     S.ioffs.data_ptr(), S.offs.data_ptr(),
                     S.cols.data_ptr(), S.vals.data_ptr(), S.dinv.data_ptr(),
                     S.pslot.data_ptr(), S.pvals.data_ptr(),
                     S.lvl_offs.data_ptr(), S.lvl_lg.data_ptr(),
                     b.data_ptr(), None, x.data_ptr(), x.data_ptr(), 1, 1, 1)
