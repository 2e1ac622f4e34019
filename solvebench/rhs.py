"""The traffic generator: right-hand sides b = A·x for x known exactly.

One generator reads every mix's parameters (`traffic/<name>.json`):

    rhs_per_solve   columns of b in one solve (k)
    pool            vectors u_0 … u_{pool−1}, seeded normal, made on the
                    device in one call
    pair_shift      solve s, column c, takes t = s·k + c and
                    x = u_{t mod pool} + ε_t · u_{(t + pair_shift) mod pool}
    eps_scale       ε_t is seeded, uniform in [−eps_scale, eps_scale]
    check_every     every this many solves (from a seeded offset), the
                    solution is kept for the check after the window
    max_checks      at most this many kept solutions

Set-up forms the products A·u_i once, in float64, with the reference's
matvec; by linearity b = A·u_i + ε·A·u_j is A·x. Every solve gets another
ε, so no two solves of a run share a b, and the same seed gives the same
sequence. Forming b is two device ops, done before a solve's clock starts.
"""

from __future__ import annotations

import numpy as np
import torch

from solvebench.reference import CsrReference


class RhsStream:
    def __init__(self, params: dict, ref: CsrReference, seed: int, device):
        self.k = int(params["rhs_per_solve"])
        self.pool = int(params["pool"])
        self.shift = int(params["pair_shift"])
        self.eps_scale = float(params["eps_scale"])
        self.check_every = int(params["check_every"])
        self.max_checks = int(params["max_checks"])
        if self.pool < 2 or self.shift % self.pool == 0:
            raise ValueError("traffic: pool >= 2 and pair_shift not a "
                             "multiple of pool")
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed))
        U = torch.randn((ref.n, self.pool), generator=gen,
                        dtype=torch.float64, device=device)
        # (pool, n): each product contiguous.
        self.AU = ref.matvec(U).t().contiguous()
        del U
        self._rng = np.random.default_rng(int(seed))
        self.check_offset = int(self._rng.integers(self.check_every))
        self._eps: list[float] = []

    def eps(self, t: int) -> float:
        """ε_t, drawn in order of t from the seed."""
        while len(self._eps) <= t:
            self._eps.append(float(self._rng.uniform(-self.eps_scale,
                                                      self.eps_scale)))
        return self._eps[t]

    def pair(self, t: int) -> tuple[int, int, float]:
        return t % self.pool, (t + self.shift) % self.pool, self.eps(t)

    def column(self, t: int) -> torch.Tensor:
        i, j, e = self.pair(t)
        return self.AU[i] + e * self.AU[j]

    def rhs(self, s: int) -> torch.Tensor:
        """b of solve s: (n,) for one column, (n, k) otherwise; contiguous
        float64 on the device."""
        if self.k == 1:
            return self.column(s)
        return torch.stack([self.column(s * self.k + c)
                            for c in range(self.k)], dim=1)

    def checked(self, s: int) -> bool:
        """Whether solve s's solution is kept for the check."""
        return s % self.check_every == self.check_offset
