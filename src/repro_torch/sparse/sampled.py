"""Sampled-client mobility topologies: k of n nodes participate per round.

The cross-device federated regime the paper frames as a time-varying
network: a fleet of n (up to 10^6) devices of which only a sampled cohort
of k check in each round.  Every draw is a pure function of ``(seed, t)``
(plus node/leg ids), like the dense mobility schedules — but via the
random-access counter streams of :mod:`repro.sim.hashrand`, because at
n = 10^6 we may only do O(k) work per round:

* **cohort**    — k distinct node ids via Floyd's sampling algorithm,
  O(k) time and memory (no O(n) permutation);
* **positions** — random-waypoint motion evaluated only at the sampled
  ids: waypoints are hashed per ``(node, leg)``, so any node's position at
  any round is random-access, O(1);
* **edges**     — unit-disk graph among the k sampled positions (O(k^2)
  pairwise test, n-independent) with Metropolis weights on the sampled
  subgraph, giving a doubly stochastic round (Assumption 3; non-sampled
  nodes sit on the implied diagonal with weight 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..sim import hashrand
from .plan import SparseRound, _as_edge_arrays
from .schedule import SparseWeightSchedule

_SAMPLE_TAG = 0x5E1    # per-round participant draw
_WAYPOINT_X_TAG = 0x5E2  # per-(node, leg) waypoint coordinates
_WAYPOINT_Y_TAG = 0x5E3


def sample_participants(n: int, k: int, seed: int, t: int) -> np.ndarray:
    """k distinct ids from [0, n) — Floyd's algorithm, O(k) not O(n)."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, _SAMPLE_TAG, t)))
    chosen = set()
    for j in range(n - k, n):
        v = int(rng.integers(0, j + 1))
        chosen.add(j if v in chosen else v)
    return np.sort(np.fromiter(chosen, dtype=np.int64, count=k))


def waypoint_positions(nodes: np.ndarray, t: int, *, seed: int,
                       leg_rounds: int) -> np.ndarray:
    """(len(nodes), 2) random-waypoint positions at round t, random-access:
    each node interpolates between hashed per-(node, leg) waypoints."""
    leg, r = divmod(t, leg_rounds)
    frac = r / leg_rounds
    ax = hashrand.counter_uniform(seed, _WAYPOINT_X_TAG, nodes, leg)
    ay = hashrand.counter_uniform(seed, _WAYPOINT_Y_TAG, nodes, leg)
    bx = hashrand.counter_uniform(seed, _WAYPOINT_X_TAG, nodes, leg + 1)
    by = hashrand.counter_uniform(seed, _WAYPOINT_Y_TAG, nodes, leg + 1)
    return np.stack([ax + (bx - ax) * frac, ay + (by - ay) * frac], axis=1)


def metropolis_edges(nodes: np.ndarray, adj: np.ndarray):
    """Metropolis-Hastings weights on a sampled subgraph.

    ``adj`` is the (k, k) boolean adjacency among ``nodes`` (diagonal
    ignored); returns global-id edge arrays with
    ``w_ij = 1 / (1 + max(deg_i, deg_j))`` — symmetric, row sums < 1, so
    the implied-diagonal round is doubly stochastic.
    """
    off = adj & ~np.eye(len(nodes), dtype=bool)
    deg = off.sum(axis=1)
    ii, jj = np.nonzero(off)
    w = 1.0 / (1.0 + np.maximum(deg[ii], deg[jj]))
    return _as_edge_arrays(nodes[jj], nodes[ii], w)


@dataclasses.dataclass(frozen=True)
class SampledMobilitySchedule:
    """``random-sampled``: per-round cohort + unit-disk + Metropolis.

    Non-periodic (``period = None``): every round is a fresh ``(seed, t)``
    draw; consumers materialize a horizon window via :func:`materialize`.
    """

    n: int
    sample_k: int
    radius: float = 0.45
    leg_rounds: int = 8
    seed: int = 0

    period = None

    def __post_init__(self):
        if not 2 <= self.sample_k <= self.n:
            raise ValueError(
                f"random-sampled needs 2 <= sample_k <= n; got "
                f"k={self.sample_k}, n={self.n}")

    def round(self, t: int) -> SparseRound:
        nodes = sample_participants(self.n, self.sample_k, self.seed, t)
        pos = waypoint_positions(nodes, t, seed=self.seed,
                                 leg_rounds=self.leg_rounds)
        diff = pos[:, None, :] - pos[None, :, :]
        adj = (diff ** 2).sum(-1) <= self.radius ** 2
        src, dst, w = metropolis_edges(nodes, adj)
        return SparseRound(self.n, src, dst, w)

    def __call__(self, t: int) -> np.ndarray:
        return self.round(t).as_dense()


def sampled_weight_schedule(n: int, sample_k: int, *, radius: float = 0.45,
                            leg_rounds: int = 8, seed: int = 0,
                            horizon: int) -> SparseWeightSchedule:
    """Materialize a ``horizon``-round window of the ideal (fault-free)
    sampled schedule — O(horizon * k^2) total, n-independent."""
    gen = SampledMobilitySchedule(n, sample_k, radius=radius,
                                  leg_rounds=leg_rounds, seed=seed)
    return SparseWeightSchedule(tuple(gen.round(t) for t in range(horizon)))
