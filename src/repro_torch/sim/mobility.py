"""Wireless node mobility producing unit-disk time-varying topologies.

The paper motivates time-varying networks physically: gossip algorithms are
"more robust in wireless scenarios especially when nodes are moving".  This
module generates those scenarios: nodes move in the unit square and a
directed link (j, i) is active at round t iff ||p_i^t - p_j^t|| <= radius
(the unit-disk model), giving a symmetric time-varying adjacency schedule
that plugs into :func:`repro.core.gossip.schedule_from_topology` like every
hand-authored construction.

Both schedules follow the :class:`repro.core.topology.ResampledMatchingSchedule`
pattern — ``period is None`` and every round is a pure function of
``(seed, t)`` drawn from a :class:`numpy.random.SeedSequence` stream, so
out-of-order and repeated ``__call__``/``structure(t)`` queries return
identical rounds (the determinism regression tests pin this).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import topology as topo

# SeedSequence domain tags: keep the mobility streams disjoint from each
# other and from every channel/fault stream (see repro.sim.channel).
_GEOMETRIC_TAG = 0x6E0
_WAYPOINT_TAG = 0x3A7


def unit_disk_adjacency(positions: np.ndarray, radius: float) -> topo.Adjacency:
    """Symmetric unit-disk graph over ``positions`` (n, 2): link iff the
    Euclidean distance is <= ``radius``; self-loops on the diagonal."""
    d2 = ((positions[:, None, :] - positions[None, :, :]) ** 2).sum(-1)
    adj = d2 <= radius * radius
    np.fill_diagonal(adj, True)
    return adj


@dataclasses.dataclass(frozen=True)
class RandomGeometricSchedule:
    """iid random-geometric motion: every round samples fresh uniform
    positions in [0, 1]^2 (a node "teleports" between rounds — the
    memoryless extreme of mobility; :class:`RandomWaypointSchedule` is the
    temporally-correlated one)."""

    n: int
    radius: float = 0.45
    seed: int = 0

    period = None  # non-periodic: every round is a fresh draw

    def positions(self, t: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _GEOMETRIC_TAG, t)))
        return rng.random((self.n, 2))

    def __call__(self, t: int) -> topo.Adjacency:
        return unit_disk_adjacency(self.positions(t), self.radius)

    def structure(self, t: int) -> topo.RoundStructure:
        return topo.classify_adjacency(self(t))


@dataclasses.dataclass(frozen=True)
class RandomWaypointSchedule:
    """Random-waypoint motion: each node travels in a straight line from
    waypoint to waypoint; leg k occupies rounds [k*leg_rounds, (k+1)*leg_rounds)
    and the position interpolates linearly along it.  Waypoints are drawn
    from a seed stream keyed by ``(seed, leg)``, so ``positions(t)`` is
    closed-form in t — no sequential simulation state, hence out-of-order
    determinism.  (The classic formulation moves at constant *speed*; fixing
    the leg *duration* instead keeps random access O(1) while preserving the
    temporally-correlated adjacency the model exists for.)"""

    n: int
    radius: float = 0.45
    leg_rounds: int = 8
    seed: int = 0

    period = None

    def _waypoints(self, leg: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _WAYPOINT_TAG, leg)))
        return rng.random((self.n, 2))

    def positions(self, t: int) -> np.ndarray:
        leg, r = divmod(int(t), self.leg_rounds)
        a = self._waypoints(leg)
        b = self._waypoints(leg + 1)
        return a + (b - a) * (r / self.leg_rounds)

    def __call__(self, t: int) -> topo.Adjacency:
        return unit_disk_adjacency(self.positions(t), self.radius)

    def structure(self, t: int) -> topo.RoundStructure:
        return topo.classify_adjacency(self(t))


def random_geometric_schedule(n: int, radius: float = 0.45,
                              seed: int = 0) -> RandomGeometricSchedule:
    if not 0.0 < radius:
        raise ValueError(f"radius must be positive, got {radius}")
    return RandomGeometricSchedule(n, radius, seed)


def random_waypoint_schedule(n: int, radius: float = 0.45,
                             leg_rounds: int = 8,
                             seed: int = 0) -> RandomWaypointSchedule:
    if not 0.0 < radius:
        raise ValueError(f"radius must be positive, got {radius}")
    if leg_rounds < 1:
        raise ValueError(f"leg_rounds must be >= 1, got {leg_rounds}")
    return RandomWaypointSchedule(n, radius, leg_rounds, seed)
