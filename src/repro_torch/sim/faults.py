"""Node churn, straggler injection, and weight-matrix repair.

The data path this module anchors (see README "channel → repair →
lowering"): an *ideal* weight schedule W^t (built from any topology by
:func:`repro.core.gossip.schedule_from_topology`) is degraded by one or
more link/node fault models (:mod:`repro.sim.channel` and the classes
here), the surviving links are *repaired* back into a valid mixing matrix
by :func:`repair_weights`, and the realized per-round matrices flow through
the existing :meth:`repro.core.gossip.WeightSchedule.plan` lowering — a
degraded matching still takes the cheap one-peer/ppermute path and a fully
dropped round lowers to a free ``empty`` round — on both the host runtime
(:func:`repro.core.algorithms.run`) and the distributed runtime
(:mod:`repro.dist.steps`, plan tensors staged once).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..core import gossip, topology as topo
from . import channel as chan, hashrand

_CHURN_BLOCK_TAG = 0xC0
_CHURN_STEP_TAG = 0xC1
_STRAGGLER_TAG = 0x57

# Counter-hash tags for the edge-list query path (O(edges) sparse
# scenarios): distinct streams from the dense draws above, equal in
# distribution but not bitwise equal — see repro.sim.channel.
_CHURN_EDGE_BLOCK_TAG = 0xC2
_CHURN_EDGE_STEP_TAG = 0xC3
_STRAGGLER_EDGE_TAG = 0x58


def repair_weights(W: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Renormalize the surviving links of ``W`` back to a mixing matrix.

    Off-diagonal weight on dropped links moves to the sender's diagonal
    (the "lazy" repair: a node that hears nothing from a peer keeps that
    share of its own value) — exactly what the partial-averaging protocol
    does physically when a message is lost and the receiver reuses its own
    state for the missing summand.

    For symmetric ``W`` and a symmetric ``mask`` the repaired matrix is
    again symmetric and doubly stochastic, so it passes
    :func:`repro.core.gossip.check_assumption3` on the realized sparsity
    pattern.  A *directed* (asymmetric) mask yields the documented
    row-stochastic fallback: every row still sums to 1 (each node performs
    a convex combination of what it received) but columns need not — such
    matrices are usable by row-stochastic gossip variants only, and
    :func:`realize_weight_schedule` therefore symmetrizes every mask.
    """
    W = np.asarray(W, np.float64)
    n = W.shape[0]
    eye = np.eye(n, dtype=bool)
    keep = np.asarray(mask, bool) & ~eye
    out = np.where(keep, W, 0.0)
    lost = np.where(~keep & ~eye, W, 0.0).sum(axis=1)
    out[eye] = W[eye] + lost
    return out


def repair_edges(w: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """:func:`repair_weights` on an edge list: ``w[keep]``.

    In the Laplacian edge form (:mod:`repro.sparse.plan`, diagonal implied
    as ``1 - rowsum``) dropping an edge IS the lazy repair — the lost
    weight returns to both endpoints' diagonals by construction, with no
    densification and no renormalization pass.  This one-liner exists to
    make that contract explicit (and testable) next to the dense repair.
    """
    return np.asarray(w)[np.asarray(keep, bool)]


@dataclasses.dataclass(frozen=True)
class NodeChurn:
    """Node up/down churn: each node runs a 2-state Markov chain (up/down)
    with per-round failure probability ``p_fail`` and recovery probability
    ``p_recover``.  A down node loses ALL its links for the round (its
    repaired row degenerates to the self-loop).  Random access uses the
    same block-regeneration trick as the Gilbert–Elliott channel."""

    p_fail: float
    p_recover: float = 0.3
    seed: int = 0
    block: int = 64

    def alive(self, t: int, n: int) -> np.ndarray:
        denom = self.p_fail + self.p_recover
        pi_down = self.p_fail / denom if denom > 0 else 0.0
        b0 = (t // self.block) * self.block
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.seed, _CHURN_BLOCK_TAG, t // self.block)))
        down = rng.random(n) < pi_down
        for r in range(b0 + 1, t + 1):
            rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, _CHURN_STEP_TAG, r)))
            u = rng.random(n)
            down = np.where(down, u < 1.0 - self.p_recover, u < self.p_fail)
        return ~down

    def mask(self, t: int, n: int) -> np.ndarray:
        a = self.alive(t, n)
        m = a[:, None] & a[None, :]
        np.fill_diagonal(m, True)
        return m

    def node_alive(self, t: int, nodes) -> np.ndarray:
        """Alive bits for the queried node ids only — the same block-regen
        chain as :meth:`alive` on its own hash stream, O(|nodes| * block)."""
        nodes = np.asarray(nodes)
        denom = self.p_fail + self.p_recover
        pi_down = self.p_fail / denom if denom > 0 else 0.0
        b0 = (t // self.block) * self.block
        down = hashrand.counter_uniform(
            self.seed, _CHURN_EDGE_BLOCK_TAG, t // self.block, nodes) < pi_down
        for r in range(b0 + 1, t + 1):
            u = hashrand.counter_uniform(self.seed, _CHURN_EDGE_STEP_TAG,
                                         r, nodes)
            down = np.where(down, u < 1.0 - self.p_recover, u < self.p_fail)
        return ~down

    def edge_mask(self, t: int, src, dst) -> np.ndarray:
        src, dst = np.asarray(src), np.asarray(dst)
        alive = self.node_alive(t, np.stack([src, dst]))
        return (alive[0] & alive[1]) | (src == dst)


@dataclasses.dataclass(frozen=True)
class StragglerInjection:
    """Straggler injection: each node straggles at round t with probability
    ``prob`` (iid per round), multiplying the latency of every link it
    touches by ``slowdown``; a link whose realized latency
    (:class:`repro.sim.channel.LinkLatencyModel`) exceeds ``deadline``
    misses the round and is treated as dropped.  With the default latency
    model a healthy link (~1.0 nominal) comfortably makes the 2.5x
    deadline, a straggler's 4x link does not — so ``prob`` is effectively
    the per-node straggle rate, with a natural heavy-latency tail on top."""

    prob: float
    slowdown: float = 4.0
    deadline: float = 2.5
    latency: chan.LinkLatencyModel = None
    seed: int = 0

    def mask(self, t: int, n: int) -> np.ndarray:
        lat_model = self.latency or chan.LinkLatencyModel(seed=self.seed)
        lat = lat_model.sample(t, n)
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _STRAGGLER_TAG, t)))
        slow = rng.random(n) < self.prob
        factor = np.where(slow, self.slowdown, 1.0)
        # a link is as slow as its slowest endpoint
        eff = lat * np.maximum(factor[:, None], factor[None, :])
        m = eff <= self.deadline
        np.fill_diagonal(m, True)
        return m

    def edge_mask(self, t: int, src, dst) -> np.ndarray:
        """(E,) deadline mask for queried edges — per-node straggle bits
        and per-edge latencies from their own hash streams."""
        src, dst = np.asarray(src), np.asarray(dst)
        lat_model = self.latency or chan.LinkLatencyModel(seed=self.seed)
        lat = lat_model.edge_sample(t, src, dst)
        slow = hashrand.counter_uniform(self.seed, _STRAGGLER_EDGE_TAG,
                                        t, np.stack([src, dst])) < self.prob
        factor = np.where(slow, self.slowdown, 1.0)
        eff = lat * np.maximum(factor[0], factor[1])
        return (eff <= self.deadline) | (src == dst)


def combined_mask(models: Sequence, t: int, n: int) -> np.ndarray:
    """AND of every model's survival mask, symmetrized (a link needs both
    directions to count as alive — see :func:`repair_weights`), diagonal
    forced True."""
    m = np.ones((n, n), dtype=bool)
    for model in models:
        m &= np.asarray(model.mask(t, n), bool)
    m &= m.T
    np.fill_diagonal(m, True)
    return m


def combined_edge_mask(models: Sequence, t: int, src, dst) -> np.ndarray:
    """AND of every model's edge-level survival mask, O(edges).

    Symmetry needs no extra pass: every ``edge_mask`` hashes canonical
    (lo, hi) endpoint keys, so both directed entries of an undirected edge
    get the same draw."""
    src, dst = np.asarray(src), np.asarray(dst)
    m = np.ones(src.shape, dtype=bool)
    for model in models:
        m &= np.asarray(model.edge_mask(t, src, dst), bool)
    return m | (src == dst)


def realize_weight_schedule(ideal: gossip.WeightSchedule,
                            models: Sequence,
                            rounds: int | None = None,
                            t0: int = 0) -> gossip.WeightSchedule:
    """Materialize the *realized* post-fault weight schedule.

    For each round t in [t0, t0 + rounds): apply every fault model's mask
    to the ideal matrix W^t, repair the survivors
    (:func:`repair_weights`), and re-classify the realized sparsity so the
    gossip planner lowers each round to its cheapest surviving collective
    (degraded matching → ``matching`` with fixed points, everything dropped
    → ``empty``).  Returns a plain :class:`repro.core.gossip.WeightSchedule`
    whose period is the materialized window — callers size ``rounds`` to at
    least the run's total gossip budget, exactly like the non-periodic
    topology schedules."""
    rounds = ideal.period if rounds is None else rounds
    n = ideal.n
    mats, structs = [], []
    for r in range(rounds):
        t = t0 + r
        mask = combined_mask(models, t, n)
        W = repair_weights(ideal(t), mask)
        adj = np.abs(W) > 1e-12
        np.fill_diagonal(adj, True)
        mats.append(W)
        structs.append(topo.classify_adjacency(adj))
    return gossip.WeightSchedule(tuple(mats), tuple(structs))
