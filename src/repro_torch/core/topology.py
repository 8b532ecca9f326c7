"""Time-varying communication topologies (paper §2-3).

A topology schedule is a callable ``t -> adjacency`` where ``adjacency`` is a
boolean (n, n) numpy array with ``adj[i, j] == True`` iff the directed link
(j, i) is active at round t (node j can send to node i).  Self-loops are
implied everywhere (``N_G(i)`` always contains i, paper Notations) and are
stored explicitly on the diagonal for convenience.

Everything here is host-side scheduling logic over tiny (n <= 64) graphs, so
plain numpy is used; the distributed runtime consumes the *weight matrices*
built from these graphs (see :mod:`repro.core.gossip`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

Adjacency = np.ndarray  # (n, n) bool, adj[i, j]: j -> i active
Schedule = Callable[[int], Adjacency]


# ---------------------------------------------------------------------------
# Static graph constructors
# ---------------------------------------------------------------------------

def _empty(n: int) -> Adjacency:
    adj = np.zeros((n, n), dtype=bool)
    np.fill_diagonal(adj, True)
    return adj


def complete_graph(n: int) -> Adjacency:
    return np.ones((n, n), dtype=bool)


def star_graph(n: int, center: int = 0) -> Adjacency:
    adj = _empty(n)
    adj[center, :] = True
    adj[:, center] = True
    return adj


def ring_graph(n: int) -> Adjacency:
    adj = _empty(n)
    idx = np.arange(n)
    adj[idx, (idx + 1) % n] = True
    adj[idx, (idx - 1) % n] = True
    return adj


def static_exponential_graph(n: int) -> Adjacency:
    """Each node links to peers at hop distance 2^k (Assran et al. [4])."""
    adj = _empty(n)
    hops = [2 ** k for k in range(max(1, int(math.ceil(math.log2(n)))))] if n > 1 else []
    for i in range(n):
        for h in hops:
            adj[i, (i + h) % n] = True
            adj[(i + h) % n, i] = True
    return adj


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> Adjacency:
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, 1)
    adj = adj | adj.T
    np.fill_diagonal(adj, True)
    return adj


def sun_shaped_graph(n: int, center_set: Sequence[int]) -> Adjacency:
    """Sun-shaped graph S_{n,C} (Definition 1).

    Nodes in C are connected to everyone (C itself forms a complete
    subgraph); rim nodes connect only to C (plus the implicit self-loop).
    """
    center = np.asarray(sorted(set(center_set)), dtype=int)
    if center.size == 0:
        raise ValueError("center set must be non-empty")
    if center.min() < 0 or center.max() >= n:
        raise ValueError(f"center set {center} out of range for n={n}")
    adj = _empty(n)
    adj[center, :] = True
    adj[:, center] = True
    return adj


# ---------------------------------------------------------------------------
# Per-round structure descriptors (gossip-planning layer)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundStructure:
    """What a single round's graph *is*, beyond its adjacency matrix.

    The gossip planner (:meth:`repro.core.gossip.WeightSchedule.plan`) uses
    these tags to lower each round to its cheapest collective:

    * ``empty``     — self-loops only: no communication at all;
    * ``complete``  — K_n: one all-reduce of the node mean;
    * ``matching``  — (possibly partial) matching (``perm`` is the peer
                      involution, fixing unmatched nodes): one point-to-point
                      exchange, O(V) on the wire.  Partial matchings arise
                      when a channel fault drops pairs out of a perfect
                      matching (:mod:`repro.sim.channel`);
    * ``sun``       — S_{n,C} (``center`` is C): two node-axis all-reduces,
                      O(2V) on the wire;
    * ``dense``     — anything else: the generic einsum / all-gather path.
    """

    kind: str                                  # dense|sun|matching|complete|empty
    center: tuple | None = None                # sun: sorted center set C
    perm: tuple | None = None                  # matching: peer involution


def classify_adjacency(adj: Adjacency) -> RoundStructure:
    """Classify one adjacency matrix into a :class:`RoundStructure`.

    Recognition is exact (no tolerance): directed or otherwise unstructured
    graphs fall through to ``dense``, which is always a valid lowering.
    """
    n = adj.shape[0]
    if not np.array_equal(adj, adj.T):
        return RoundStructure("dense")
    off = adj & ~np.eye(n, dtype=bool)
    deg = off.sum(axis=1)
    if not deg.any():
        return RoundStructure("empty")
    if (deg == n - 1).all():
        return RoundStructure("complete")
    if (deg <= 1).all():
        # perfect OR partial matching: unmatched (degree-0) nodes are fixed
        # points of the involution, so a fault-degraded matching still
        # lowers to the one-peer exchange
        perm = np.where(deg == 1, off.argmax(axis=1), np.arange(n))
        if np.array_equal(perm[perm], np.arange(n)):
            return RoundStructure("matching", perm=tuple(int(p) for p in perm))
    center = np.flatnonzero(deg == n - 1)
    if center.size:
        want = np.zeros(n, dtype=bool)
        want[center] = True
        rim = np.setdiff1d(np.arange(n), center)
        if all(np.array_equal(off[i], want & (np.arange(n) != i)) for i in rim):
            return RoundStructure("sun", center=tuple(int(c) for c in center))
    return RoundStructure("dense")


# ---------------------------------------------------------------------------
# Time-varying schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StaticSchedule:
    """Constant graph: G^t = G for all t."""

    adjacency: Adjacency

    @property
    def n(self) -> int:
        return self.adjacency.shape[0]

    @property
    def period(self) -> int:
        return 1

    def __call__(self, t: int) -> Adjacency:
        return self.adjacency

    def structure(self, t: int) -> RoundStructure:
        return classify_adjacency(self.adjacency)


@dataclasses.dataclass(frozen=True)
class PeriodicSchedule:
    """G^t cycles through a finite list of graphs."""

    graphs: tuple

    @property
    def n(self) -> int:
        return self.graphs[0].shape[0]

    @property
    def period(self) -> int:
        return len(self.graphs)

    def __call__(self, t: int) -> Adjacency:
        return self.graphs[t % len(self.graphs)]

    def structure(self, t: int) -> RoundStructure:
        return classify_adjacency(self(t))


def one_peer_exponential_schedule(n: int) -> PeriodicSchedule:
    """One-peer exponential graph (Ying et al. [42]): at round t every node i
    talks to exactly one peer at hop 2^(t mod log2 n).  Requires n a power
    of two."""
    if n & (n - 1):
        raise ValueError(f"one-peer exponential requires power-of-two n, got {n}")
    tau = max(1, int(math.log2(n)))
    graphs = []
    for k in range(tau):
        adj = _empty(n)
        idx = np.arange(n)
        peer = idx ^ (2 ** k)  # hypercube matching: involution, one peer each
        adj[idx, peer] = True
        adj[peer, idx] = True
        graphs.append(adj)
    return PeriodicSchedule(tuple(graphs))


def random_matching_schedule(n: int, period: int = 16, seed: int = 0) -> PeriodicSchedule:
    """EquiRand/MATCHA-flavoured schedule: each round activates a uniformly
    random perfect matching (n even), so every node talks to exactly one
    peer per round [32, 39]."""
    if n % 2:
        raise ValueError("random matching requires even n")
    rng = np.random.default_rng(seed)
    return PeriodicSchedule(tuple(_random_matching(n, rng)
                                  for _ in range(period)))


def _random_matching(n: int, rng: np.random.Generator) -> Adjacency:
    perm = rng.permutation(n)
    adj = _empty(n)
    for a, b in zip(perm[0::2], perm[1::2]):
        adj[a, b] = adj[b, a] = True
    return adj


def erdos_renyi_schedule(n: int, p: float = 0.5, period: int = 8,
                         seed: int = 0) -> PeriodicSchedule:
    """Time-varying Erdős–Rényi graphs: each of the ``period`` rounds is an
    independent G(n, p) draw (plus self-loops).  Unstructured by design —
    the gossip planner lowers every round to the dense path — so it serves
    as the generic-topology scenario surface and the planner's control
    case."""
    rng = np.random.default_rng(seed)
    graphs = tuple(
        erdos_renyi_graph(n, p, seed=int(rng.integers(2 ** 31)))
        for _ in range(period))
    return PeriodicSchedule(graphs)


@dataclasses.dataclass(frozen=True)
class ResampledMatchingSchedule:
    """Non-periodic random-matching schedule: round t activates a fresh
    uniformly random perfect matching drawn from a seed stream keyed by
    ``(seed, t)`` — no round is ever reused, unlike the periodic
    :func:`random_matching_schedule`.

    ``period`` is ``None``: consumers that need a finite window (the gossip
    planner, :func:`repro.core.gossip.schedule_from_topology`) materialize a
    ``horizon`` of rounds instead."""

    n: int
    seed: int = 0

    period = None  # non-periodic: every round is a fresh draw

    def __call__(self, t: int) -> Adjacency:
        rng = np.random.default_rng(np.random.SeedSequence((self.seed, t)))
        return _random_matching(self.n, rng)

    def structure(self, t: int) -> RoundStructure:
        return classify_adjacency(self(t))


def resampled_matching_schedule(n: int, seed: int = 0) -> ResampledMatchingSchedule:
    if n % 2:
        raise ValueError("random matching requires even n")
    return ResampledMatchingSchedule(n, seed)


def federated_schedule(n: int, local_steps: int) -> PeriodicSchedule:
    """Federated averaging as a time-varying network: ``local_steps`` rounds
    of the empty (self-loop only) graph followed by one complete-graph round
    (paper §1: "alternating between global averaging and local updates")."""
    graphs = [_empty(n)] * local_steps + [complete_graph(n)]
    return PeriodicSchedule(tuple(graphs))


def sun_shaped_schedule(
    n: int,
    beta: float,
    avoid: Sequence[int] = (),
) -> PeriodicSchedule:
    """Theorem 3 construction: rotating sun-shaped graphs.

    Picks ``k = ceil(n * (1 - beta))`` center nodes per round, rotating the
    center set through ``p = floor((n - |avoid|) / k)`` disjoint subsets of
    ``[n] \\ avoid``.  ``avoid`` is the union of the two "far" sets I1, I2
    from the lower-bound construction (their nodes never serve as centers);
    pass ``avoid=()`` for the generic training schedule.
    """
    if not 0.0 <= beta <= 1.0 - 1.0 / n + 1e-12:
        raise ValueError(f"Theorem 3 requires beta in [0, 1-1/n]; got {beta} (n={n})")
    k = int(math.ceil(n * (1.0 - beta)))
    k = min(max(k, 1), n)
    avoid_set = sorted(set(avoid))
    pool = [i for i in range(n) if i not in avoid_set]
    if k >= n:
        return PeriodicSchedule((complete_graph(n),))
    p = len(pool) // k
    if p == 0:
        # Fewer than k nodes outside `avoid`: no avoid-respecting chunking
        # exists (paper: p = 0), so the center must dip into `avoid`; any two
        # sets are then at effective distance 1, matching eq. (5).
        center = (pool + avoid_set)[:k]
        return PeriodicSchedule((sun_shaped_graph(n, center),))
    graphs = [sun_shaped_graph(n, pool[q * k:(q + 1) * k]) for q in range(p)]
    return PeriodicSchedule(tuple(graphs))


# ---------------------------------------------------------------------------
# Effective distance / diameter (Definition 2)
# ---------------------------------------------------------------------------

def _frontier_rounds(schedule: Schedule, start: frozenset, targets: frozenset,
                     t0: int, max_rounds: int) -> int:
    """Rounds until any node of ``targets`` enters the neighborhood closure of
    ``start``, communicating over G^{t0}, G^{t0+1}, ... (inf if > max_rounds).

    NOTE on orientation: Definition 2 composes neighborhoods as
    N_{G^t}(N_{G^{t+1}}(... N_{G^{t+R-1}}(i)...)) — the innermost (first
    expansion) uses the *latest* graph.  For undirected graphs — all the
    paper's constructions — composition order does not change the reach-time
    set sizes, and we expand forward in time which matches how messages
    physically propagate; tests pin this equivalence on the Theorem 3
    schedules.
    """
    n = schedule(0).shape[0]
    reached = np.zeros(n, dtype=bool)
    reached[list(start)] = True
    tgt = np.zeros(n, dtype=bool)
    tgt[list(targets)] = True
    if (reached & tgt).any():
        return 0
    for r in range(1, max_rounds + 1):
        adj = schedule(t0 + r - 1)
        reached = reached | (adj[:, reached].any(axis=1))
        if (reached & tgt).any():
            return r
    return max_rounds + 1


def effective_distance(schedule, set_a: Sequence[int], set_b: Sequence[int],
                       period: int | None = None, max_rounds: int | None = None) -> int:
    """dist_{{G^t}}(I1, I2) per Definition 2, for periodic schedules.

    The minimum over start rounds t of the max over both directions of the
    frontier reach time.  For periodic schedules only the start round
    ``t mod period`` matters.
    """
    n = schedule(0).shape[0]
    p = period if period is not None else getattr(schedule, "period", 1)
    cap = max_rounds if max_rounds is not None else n * p + n + 1
    a, b = frozenset(set_a), frozenset(set_b)
    best = cap + 1
    for t0 in range(p):
        fwd = _frontier_rounds(schedule, a, b, t0, cap)
        bwd = _frontier_rounds(schedule, b, a, t0, cap)
        best = min(best, max(fwd, bwd))
    return best


def _all_pairs_first_reach(schedule: Schedule, t0: int,
                           max_rounds: int) -> np.ndarray:
    """``first[i, j]`` = rounds until j enters the neighborhood closure of
    {i}, communicating over G^{t0}, G^{t0+1}, ... (``max_rounds + 1`` when it
    never does) — every source propagated at once as one boolean frontier
    matrix per round, instead of n independent single-source scans."""
    n = schedule(t0).shape[0]
    reach = np.eye(n, dtype=bool)
    first = np.where(reach, 0, max_rounds + 1)
    for r in range(1, max_rounds + 1):
        if reach.all():
            break
        adj = schedule(t0 + r - 1)
        # closure step for every source s at once:
        # reach'[s, i] = reach[s, i] OR any_j (adj[i, j] AND reach[s, j])
        new = reach | ((reach.astype(np.int32) @ adj.T.astype(np.int32)) > 0)
        first[new & ~reach] = r
        reach = new
    return first


def effective_diameter(schedule, period: int | None = None) -> int:
    """max over node pairs of the Definition 2 effective distance — one
    all-pairs frontier propagation per start round (exactly equal to the
    pairwise :func:`effective_distance` scan it replaces; pinned by tests
    on the Theorem 3 schedules)."""
    n = schedule(0).shape[0]
    if n <= 1:
        return 0
    p = period if period is not None else getattr(schedule, "period", 1)
    if p is None:
        raise ValueError("non-periodic schedule requires period=<rounds>")
    cap = n * p + n + 1
    best = np.full((n, n), cap + 1, dtype=np.int64)
    for t0 in range(p):
        first = _all_pairs_first_reach(schedule, t0, cap)
        np.minimum(best, np.maximum(first, first.T), out=best)
    return int(best[~np.eye(n, dtype=bool)].max())


def _effective_diameter_pairwise(schedule, period: int | None = None) -> int:
    """Reference implementation (O(n^2) single-source scans) kept for the
    equality pin in tests."""
    n = schedule(0).shape[0]
    diam = 0
    for i in range(n):
        for j in range(i + 1, n):
            diam = max(diam, effective_distance(schedule, (i,), (j,), period))
    return diam


def theorem3_distance_formula(n: int, beta: float, size_a: int, size_b: int) -> int:
    """The exact effective distance of the Theorem 3 construction, eq. (5):
    floor((n - |I1| - |I2|) / ceil(n(1-beta))) + 1."""
    if size_a + size_b >= n:
        return 1
    k = int(math.ceil(n * (1.0 - beta)))
    return (n - size_a - size_b) // k + 1
