"""Blocked band Cholesky with the numeric factor on the device (counterpart
of `lsbench_tpu/solvers/band_cholesky.py`, registered `cholesky_band`).

An RCM ordering concentrates the matrix inside a band of half-width w;
the Cholesky fill of a banded SPD matrix stays inside the band, so the
band is the supernodal structure: one dense panel per block step and no
symbolic phase. The factor walks the n/nb pivot-block steps carrying a
dense (w+nb)×(w+nb) window W; per step

    Ld = chol(W[:nb,:nb])            nb×nb dense Cholesky
    Lp = W[nb:,:nb] · Ld⁻ᵀ           w×nb triangular solve
    T  = W[nb:,nb:] − Lp·Lpᵀ         w×w trailing update

then the window shifts by nb rows and the next band slab streams in. The
solves are blocked band substitutions carrying the last w entries of x.

The JAX package writes both as `lax.scan`s of XLA ops (no Pallas kernel);
here they are host loops over the pivot steps of plain torch ops on the
device (`torch.linalg.cholesky_ex`, `torch.linalg.solve_triangular`,
`torch.matmul`), in full f32 (`full_f32`). fp64 is the f32 factor refined
by f64 residuals on `spmv_sell_f64` (`refine_columns`), recorded as
fp32_ir_auto, the JAX package's TPU branch on every device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from lsbench_tpu_torch.matrix.csr import CsrMatrix
from lsbench_tpu_torch.matrix.sell import SellMatrix
from lsbench_tpu_torch.ops.spmv_sell import spmv_sell_f64
from lsbench_tpu_torch.solvers.base import SolveResult, Solver, register_solver
from lsbench_tpu_torch.solvers.cg import permutation
from lsbench_tpu_torch.solvers.refine import column_residual, refine_columns
from lsbench_tpu_torch.solvers.sparse_cholesky import symmetrize
from lsbench_tpu_torch.utils.precision import full_f32


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def band_layout(A: CsrMatrix, nb: int = 128):
    """Host: half-bandwidth and the dense inputs of the banded factor, the
    JAX package's arrays bit for bit.

    Returns (W0, slabs, nsteps, w, n_pad):
      W0     (m, m)            initial symmetric window, m = w + nb
      slabs  (nsteps - 1, nb, m) incoming rows per step, strictly lower
                               plus half the diagonal (added as S + Sᵀ)
    Rows beyond n get an identity diagonal (their solution entries are 0
    for a padded b). A must be pattern-symmetric (its symmetric part).
    """
    n = A.nrows
    r, c, v = A.to_coo()
    w = int(np.abs(r - c).max(initial=0))
    w = _round_up(max(w, nb), nb)
    m = w + nb
    n_pad = _round_up(n, nb) + m  # an extra window of identity tail
    nsteps = (n_pad - m) // nb + 1  # step 0 takes W0; then the slabs

    # Dense band rows: band[i] holds A[i, i-w .. i] at positions 0..w.
    lower = c <= r
    rl, cl, vl = r[lower], c[lower], v[lower]
    band = np.zeros((n_pad, w + 1))
    band[rl, w - (rl - cl)] = vl
    band[np.arange(n, n_pad), w] = 1.0  # identity tail

    # Initial window: rows 0..m-1, symmetric dense.
    W0 = np.zeros((m, m))
    for t in range(m):
        lo = max(0, t - w)
        W0[t, lo:t + 1] = band[t, w - (t - lo):w + 1]
    W0 = W0 + W0.T - np.diag(np.diag(W0))

    # Slabs: after pivot step j, rows m + j*nb .. m + (j+1)*nb - 1 enter
    # the window (the last step takes none).
    n_slab = nsteps - 1
    slabs = np.zeros((n_slab, nb, m))
    for j in range(n_slab):
        base = m + j * nb
        for t in range(nb):
            # window row w + t; cols i-w..i → window cols t..w+t
            row = band[base + t, :].copy()
            row[-1] *= 0.5  # half diagonal: S + Sᵀ restores it
            slabs[j, t, t:w + t + 1] = row
    return W0, slabs, nsteps, w, n_pad


def factor_band(W0: torch.Tensor, slabs: torch.Tensor, *, nb: int):
    """The blocked band factor (module docstring): Ld (nsteps, nb, nb) and
    Lp (nsteps, w, nb) on W0's device in its dtype. As the JAX package's
    `lax.linalg.cholesky` does, each pivot block is symmetrized first.
    Raises LinAlgError if a pivot block is not positive definite (checked
    once, after the last step)."""
    m = W0.shape[0]
    w = m - nb
    nsteps = slabs.shape[0] + 1
    Ld = W0.new_empty((nsteps, nb, nb))
    Lp = W0.new_empty((nsteps, w, nb))
    info = torch.zeros(nsteps, dtype=torch.int32, device=W0.device)
    W = W0.clone()
    with full_f32():
        for j in range(nsteps):
            P = W[:nb, :nb]
            Ld[j], info[j] = torch.linalg.cholesky_ex((P + P.T) * 0.5)
            # Lp = W[nb:, :nb] · Ld⁻ᵀ  (solve Ld · Lpᵀ = W[nb:, :nb]ᵀ).
            Lp[j] = torch.linalg.solve_triangular(
                Ld[j], W[nb:, :nb].T, upper=False).T
            T = W[nb:, nb:] - torch.matmul(Lp[j], Lp[j].T)
            W = torch.zeros_like(W)
            W[:w, :w] = T
            if j < nsteps - 1:
                W[w:, :] += slabs[j]
                W[:, w:] += slabs[j].T
    bad = torch.nonzero(info).flatten()
    if bad.numel():
        raise np.linalg.LinAlgError(
            f"band factor: pivot block {int(bad[0])} is not positive "
            "definite")
    return Ld, Lp


def solve_band(Ld: torch.Tensor, Lp: torch.Tensor, b_pad: torch.Tensor, *,
               nb: int) -> torch.Tensor:
    """x = (L Lᵀ)⁻¹ b by blocked band substitutions; b_pad of length
    nsteps·nb (the padded system), x the same."""
    nsteps = Ld.shape[0]
    w = Lp.shape[1]
    bb = b_pad.view(nsteps, nb, 1)
    y = torch.empty_like(bb)
    acc = b_pad.new_zeros((w, 1))
    with full_f32():
        for j in range(nsteps):
            y[j] = torch.linalg.solve_triangular(Ld[j], bb[j] - acc[:nb],
                                                 upper=False)
            acc = torch.cat([acc[nb:], acc.new_zeros((nb, 1))]) \
                + torch.matmul(Lp[j], y[j])
        x = torch.empty_like(bb)
        v = b_pad.new_zeros((w, 1))
        for j in range(nsteps - 1, -1, -1):
            rhs = y[j] - torch.matmul(Lp[j].T, v)
            x[j] = torch.linalg.solve_triangular(Ld[j].T, rhs, upper=True)
            v = torch.cat([x[j], v[:w - nb]])
    return x.view(-1)


@register_solver("cholesky_band")
class BandCholeskySolver(Solver):
    """RCM-banded blocked Cholesky with the numeric factor on the device:
    the CHOLMOD-role direct solver for banded workloads. The f32 factor
    plus f64 refinement reaches the reference's 1e-10 (cusparse.c:184)."""

    def __init__(self, A: CsrMatrix, dtype=None, ordering="rcm", rtol=1e-10,
                 max_refine=12, nb: int = 128, max_band_mb: float = 2048.0,
                 device="cuda", **params):
        super().__init__(A, **params)
        del dtype  # fixed structure: f32 factor / f64 refinement
        if A.nrows != A.ncols:
            raise ValueError("Cholesky requires a square matrix")
        self.device = torch.device(device)
        self.rtol = float(rtol)
        self.max_refine = int(max_refine)
        self.nb = int(nb)
        n = A.nrows

        t0 = time.perf_counter()
        Ap, self._perm, self._inv = permutation(ordering, A, self.device)
        self.setup_breakdown["ordering_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        W0, slabs, nsteps, w, _ = band_layout(symmetrize(Ap), nb=self.nb)
        band_mb = (slabs.size + W0.size) * 4 / 1e6
        if band_mb > max_band_mb:
            raise ValueError(
                f"band layout needs {band_mb:.0f} MB (w={w}); matrix is "
                "not banded enough — use sparse_cholesky or cg_ir")
        self.bandwidth = w
        self.setup_breakdown["layout_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()

        def up(a):
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        self._Ld, self._Lp = factor_band(up(W0), up(slabs), nb=self.nb)
        del W0, slabs
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.setup_breakdown["factor_s"] = time.perf_counter() - t0
        self._nsol = nsteps * self.nb
        op64 = SellMatrix.from_csr(Ap, dtypes=(torch.float64,),
                                   device=self.device)
        self._mv = lambda v: spmv_sell_f64(op64, v)

    def _band_solve32(self, R32: torch.Tensor) -> torch.Tensor:
        """f32 band solves of the columns of R32 (n, k)."""
        n = self.A.nrows
        out = []
        for j in range(R32.shape[1]):
            rp = R32.new_zeros(self._nsol)
            rp[:n] = R32[:, j]
            out.append(solve_band(self._Ld, self._Lp, rp, nb=self.nb)[:n])
        return torch.stack(out, dim=1)

    def _solve(self, b):
        b = torch.as_tensor(b, device=self.device).to(torch.float64)
        bp = b if self._perm is None else b[self._perm]
        x, passes, rr, bb = refine_columns(
            bp[:, None], self._band_solve32, column_residual(self._mv, bp[:, None]),
            self.rtol, self.max_refine)
        x = x[:, 0]
        return (x if self._inv is None else x[self._inv]), int(passes[0]), \
            float(torch.sqrt(rr[0])), float(torch.sqrt(bb[0]))

    def solve(self, b) -> SolveResult:
        x, passes, rnorm, bnorm = self._solve(b)
        relres = rnorm / bnorm if bnorm > 0 else 0.0
        return SolveResult(x=x, iters=passes, relres=relres,
                           converged=relres <= self.rtol or bnorm == 0.0,
                           extra={"precision_mode": "fp32_ir_auto",
                                  "bandwidth": self.bandwidth,
                                  "refine_passes": passes})

    def solve_fn(self):
        return lambda b: self._solve(b)[0]
