"""Zero-chain hard instances for the lower bound (paper Appendix B), the
torch port of the JAX package's ``core/lower_bound.py``.

The Carmon et al. component functions (Lemma 7), their odd/even splits
(Lemma 8), the progress measure ``prog``, and the two adversarial
instances of Theorem 4:

* Instance 1 — homogeneous f_i with the coordinate-masking Bernoulli oracle
  (drives the statistical term sqrt(Delta L sigma^2 / nT)).
* Instance 2 — odd/even split functions assigned to two far-apart node sets
  I1, I2 on the sun-shaped schedule (drives the network term
  Delta L / (T (1 - beta))).

Gradients come from ``torch.autograd``.  :func:`psi` keeps the reference's
safe ``where``: the masked branch is evaluated at a harmless point, so its
gradient is an exact 0 past ``prog`` (the zero-chain property) and never
0·∞ = NaN.  ``Instance1.oracle`` draws its Bernoulli mask from a
``torch.Generator``, where the reference draws from ``jax.random``.  These
are analysis objects (the optimality-gap dashboard's constants, the lower
bound demo), not on the training path.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

# Lemma 7 constants
DELTA0 = 12.0    # h(0) - inf h <= DELTA0 * d
ELL0 = 152.0     # smoothness of h
G_INF = 23.0     # sup ||grad h||_inf


def _t(z) -> torch.Tensor:
    return z if isinstance(z, torch.Tensor) else torch.tensor(
        z, dtype=torch.float32)


def psi(z) -> torch.Tensor:
    """psi(z) = exp(1 - 1/(2z-1)^2) for z > 1/2, else 0 (safe for
    autograd)."""
    z = _t(z)
    on = z > 0.5
    safe = torch.where(on, z, torch.full_like(z, 0.75))
    val = torch.exp(1.0 - 1.0 / (2.0 * safe - 1.0) ** 2)
    return torch.where(on, val, torch.zeros_like(val))


def phi(z) -> torch.Tensor:
    """phi(z) = sqrt(e) * int_{-inf}^z exp(-t^2/2) dt = sqrt(2 pi e) *
    ndtr(z)."""
    return math.sqrt(2.0 * math.pi * math.e) * torch.special.ndtr(_t(z))


def _chain_terms(x: torch.Tensor) -> torch.Tensor:
    """terms[j] = psi(-x_j) phi(-x_{j+1}) - psi(x_j) phi(x_{j+1}),
    j = 0..d-2."""
    a, b = x[:-1], x[1:]
    return psi(-a) * phi(-b) - psi(a) * phi(b)


def h(x: torch.Tensor) -> torch.Tensor:
    """Lemma 7 zero-chain function."""
    return -psi(torch.ones((), dtype=x.dtype)) * phi(x[0]) \
        + torch.sum(_chain_terms(x))


def _link_mask(x: torch.Tensor, parity: int) -> torch.Tensor:
    j = torch.arange(1, x.shape[0], device=x.device)   # 1-based link index
    return (j % 2 == parity).to(x.dtype)


def h1(x: torch.Tensor) -> torch.Tensor:
    """Lemma 8: even-j links (j = 2, 4, ... in 1-based indexing) + head
    term."""
    terms = _chain_terms(x)
    return -2.0 * psi(torch.ones((), dtype=x.dtype)) * phi(x[0]) \
        + 2.0 * torch.sum(terms * _link_mask(x, 0))


def h2(x: torch.Tensor) -> torch.Tensor:
    """Lemma 8: odd-j links."""
    return 2.0 * torch.sum(_chain_terms(x) * _link_mask(x, 1))


def prog(x: torch.Tensor) -> torch.Tensor:
    """prog(x) = max{j : x_j != 0} (1-based), 0 if x = 0."""
    idx = torch.arange(1, x.shape[-1] + 1, device=x.device)
    return torch.amax(torch.where(x != 0, idx, torch.zeros_like(idx)),
                      dim=-1)


def _grad(f, x: torch.Tensor) -> torch.Tensor:
    """The gradient of the scalar ``f`` at ``x`` (autograd, no graph kept)."""
    with torch.enable_grad():
        y = x.detach().requires_grad_()
        (g,) = torch.autograd.grad(f(y), y)
    return g


# ---------------------------------------------------------------------------
# Instance 1: homogeneous functions + Bernoulli coordinate-masking oracle
# ---------------------------------------------------------------------------

class Instance1(NamedTuple):
    d: int
    lam: float
    L: float
    p: float

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return (self.L * self.lam ** 2 / ELL0) * h(x / self.lam)

    def grad_f(self, x: torch.Tensor) -> torch.Tensor:
        return _grad(self.f, x)

    def oracle(self, x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        """[O(x; Z)]_j = [grad f(x)]_j (1 + 1{j > prog(x)} (Z/p - 1)), Z ~
        Bernoulli(p) per coordinate, drawn from ``gen``."""
        g = self.grad_f(x)
        z = torch.bernoulli(torch.full(g.shape, self.p, dtype=g.dtype,
                                       device=g.device), generator=gen)
        j = torch.arange(1, self.d + 1, device=g.device)
        mask = (j > prog(x)).to(g.dtype)
        return g * (1.0 + mask * (z / self.p - 1.0))


def make_instance1(L: float, Delta: float, sigma: float, n: int,
                   T: int) -> Instance1:
    """Parameter choices from Appendix B.1, Instance 1 (Step 3)."""
    lam = (ELL0 / L) * (Delta * L * sigma ** 2 / (
        3 * n * T * ELL0 * DELTA0 * G_INF ** 2)) ** 0.25
    d = max(2, int((3 * L * Delta * n * T * G_INF ** 2
                    / (sigma ** 2 * ELL0 * DELTA0)) ** 0.5))
    p = min(L ** 2 * lam ** 2 * G_INF ** 2 / (ELL0 ** 2 * sigma ** 2), 1.0)
    return Instance1(d=d, lam=lam, L=L, p=p)


# ---------------------------------------------------------------------------
# Instance 2: odd/even split functions on far-apart node sets
# ---------------------------------------------------------------------------

class Instance2(NamedTuple):
    n: int
    d: int
    lam: float
    L: float

    @property
    def set1(self) -> tuple:
        return tuple(range(0, math.ceil(self.n / 4)))           # I1 (0-based)

    @property
    def set2(self) -> tuple:
        return tuple(range(self.n - math.ceil(self.n / 4), self.n))  # I2

    def _scale(self) -> float:
        return self.n / math.ceil(self.n / 4)

    def f_i(self, i: int, x: torch.Tensor) -> torch.Tensor:
        c = self.L * self.lam ** 2 / (2 * ELL0)
        s = self._scale()
        if i in self.set1:
            return c * (s / 2.0) * h1(x / self.lam)
        if i in self.set2:
            return c * (s / 2.0) * h2(x / self.lam)
        return (x * 0).sum()

    def f(self, x: torch.Tensor) -> torch.Tensor:
        """Global average = L lam^2 h(x/lam) / (2 ell0) * (scale*|I|/n)."""
        return sum(self.f_i(i, x) for i in range(self.n)) / self.n

    def grad_stacked(self, xs: torch.Tensor) -> torch.Tensor:
        """Full-batch per-node gradients for stacked models xs: (n, d)."""
        return torch.stack([_grad(lambda y, i=i: self.f_i(i, y), xs[i])
                            for i in range(self.n)])


def make_instance2(L: float, Delta: float, n: int, beta: float, T: int,
                   C: float = 1.0) -> Instance2:
    """Parameter choices from Appendix B.1, Instance 2 (Step 3)."""
    d = max(2, int(C * (1 - beta) * T) + 2)
    lam = (2 * ELL0 / L) * math.sqrt(
        2 * Delta * L / (3 * C * (1 - beta) * T * 2 * ELL0 * DELTA0)) / 2
    # ensure the Delta budget (14): d * lam^2 <= 2 ell0 Delta / (L DELTA0)
    cap = math.sqrt(2 * ELL0 * Delta / (L * DELTA0 * d))
    lam = min(lam, cap)
    return Instance2(n=n, d=d, lam=lam, L=L)
