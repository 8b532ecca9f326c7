"""Online optimality-gap tracking against the paper's lower bound (a copy
of the JAX package's ``obs/optimality.py``, pure Python, with the port's
``lower_bound``).

The paper (Theorem 4, via the zero-chain instances in
:mod:`repro_torch.core.lower_bound`) shows that ANY algorithm in the class
must satisfy, after a budget of ``T`` oracle/gossip rounds over a network with
mixing parameter ``beta``::

    min_t E||grad f(x_t)||^2  >=  c1 * sqrt(Delta L sigma^2 / (n T))
                                + c2 * Delta L / ((1 - beta) T)

(statistical term + network term).  A :class:`GapTracker` consumes the
measured ``grad_norm`` series (fed by the
:class:`repro_torch.obs.metrics.ObsRecorder` flush) and reports, per
(algorithm x topology-class x channel) *cell*, how far the run's best
measured squared gradient norm sits above that floor — the repo's
empirical read on the paper's "optimal complexity" claim.

The floor is a *scaling* statement: absolute constants are unity here, so
``gap_ratio`` is meaningful for comparing cells and tracking progress, not
as a certified constant-sharp bound.  ``fit_rate`` estimates the empirical
decay slope d log(min-so-far) / d log(T) to compare against the bound's
-1/2 (statistical regime) and -1 (network regime) exponents.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from ..core import lower_bound as lb


def theoretical_floor(T: float, *, n: int, beta: float, L: float = 1.0,
                      Delta: float = 1.0, sigma: float = 1.0) -> float:
    """The Theorem 4 floor on min E||grad f||^2 after budget T (unit
    constants).  ``sigma=0`` drops the statistical term (full-batch
    oracles); ``beta`` is the schedule's mixing parameter (0 = perfect
    mixing, 1 = never mixes — the network term diverges)."""
    T = max(float(T), 1.0)
    stat = math.sqrt(Delta * L * sigma ** 2 / (n * T)) if sigma > 0 else 0.0
    net = Delta * L / ((1.0 - min(beta, 1.0 - 1e-12)) * T)
    return stat + net


def statistical_term(T: float, *, n: int, L: float = 1.0, Delta: float = 1.0,
                     sigma: float = 1.0) -> float:
    return theoretical_floor(T, n=n, beta=0.0, L=L, Delta=Delta,
                             sigma=sigma) - Delta * L / max(float(T), 1.0)


# Named bounds a report can cite.  Each maps (T, n, beta, L, Delta, sigma)
# -> floor value; "paper" is Theorem 4 (the tight one — matched by
# MC-DSGT up to constants/log factors), "centralized" is the beta-free
# sqrt(DeltaL sigma^2 / nT) reference (what perfect mixing would allow).
BOUNDS: Dict[str, Callable[..., float]] = {
    "paper": lambda T, n, beta, L=1.0, Delta=1.0, sigma=1.0:
        theoretical_floor(T, n=n, beta=beta, L=L, Delta=Delta, sigma=sigma),
    "centralized": lambda T, n, beta, L=1.0, Delta=1.0, sigma=1.0:
        theoretical_floor(T, n=n, beta=0.0, L=L, Delta=Delta, sigma=sigma),
}

# Tie to the hard-instance constants so the report can say which regime the
# adversarial constructions would pin (Appendix B).
INSTANCE_CONSTANTS = {"DELTA0": lb.DELTA0, "ELL0": lb.ELL0, "G_INF": lb.G_INF}


def cell_key(algo: str, topology: Optional[str] = None,
             channel: Optional[str] = None) -> str:
    """The (algorithm x topology-class x channel) cell label the gap is
    tracked per.  ``channel=None`` means the ideal (lossless) channel."""
    return f"{algo}/{topology or 'static'}/{channel or 'ideal'}"


def fit_rate(ts, vals) -> Optional[float]:
    """Least-squares slope of log(val) vs log(T) — the empirical decay
    exponent.  None when fewer than 3 usable points."""
    pts = [(math.log(t), math.log(v)) for t, v in zip(ts, vals)
           if t > 0 and v > 0]
    if len(pts) < 3:
        return None
    mx = sum(x for x, _ in pts) / len(pts)
    my = sum(y for _, y in pts) / len(pts)
    den = sum((x - mx) ** 2 for x, _ in pts)
    if den <= 0:
        return None
    return sum((x - mx) * (y - my) for x, y in pts) / den


class GapTracker:
    """Running min ||grad f||^2 vs the lower-bound floor for one cell.

    ``update(t, gnorm2)`` is fed by the ObsRecorder flush with the
    measured squared gradient norm at budget ``t``; the tracker keeps the
    best-so-far trajectory (the quantity the bound constrains) downsampled
    to ``max_points`` for the rate fit.
    """

    def __init__(self, *, cell: str, n: int, beta: float, L: float = 1.0,
                 Delta: float = 1.0, sigma: float = 1.0,
                 bound: str = "paper", max_points: int = 512):
        if bound not in BOUNDS:
            raise ValueError(f"unknown bound {bound!r}; "
                             f"known: {sorted(BOUNDS)}")
        self.cell = cell
        self.n = int(n)
        self.beta = float(beta)
        self.L, self.Delta, self.sigma = float(L), float(Delta), float(sigma)
        self.bound = bound
        self.max_points = int(max_points)
        self.T = 0
        self.best: Optional[float] = None
        self._traj: list[tuple[int, float]] = []  # (t, best-so-far)

    def update(self, t: int, gnorm2: float) -> None:
        gnorm2 = float(gnorm2)
        if not math.isfinite(gnorm2):
            return
        self.T = max(self.T, int(t))
        if self.best is None or gnorm2 < self.best:
            self.best = gnorm2
        self._traj.append((int(t), self.best))
        if len(self._traj) > 2 * self.max_points:
            self._traj = self._traj[:: 2]

    def floor(self, T: Optional[int] = None) -> float:
        return BOUNDS[self.bound](T if T is not None else self.T, self.n,
                                  self.beta, self.L, self.Delta, self.sigma)

    def summary(self) -> dict:
        """{cell, T, n, beta, floor, best, gap_ratio, rate_slope} — the
        per-cell record the summary event and report render."""
        floor = self.floor() if self.T else None
        gap = (self.best / floor if self.best is not None and floor
               else None)
        return {
            "cell": self.cell, "bound": self.bound,
            "T": self.T, "n": self.n, "beta": round(self.beta, 6),
            "floor": floor, "best_grad_sq": self.best,
            "gap_ratio": gap,
            "rate_slope": fit_rate(*zip(*self._traj)) if self._traj else None,
        }
