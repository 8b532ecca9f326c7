"""Link-level channel degradation: drop models and latency sampling.

Every model exposes ``mask(t, n) -> (n, n) bool`` — True means the link
*survives* round t.  Masks are symmetric (a failed link fails in both
directions: without the reverse path there is no ACK, so the undirected
gossip edge is gone) and the diagonal is always True (a node can always
"talk" to itself).  Like the mobility schedules, every mask is a pure
function of ``(seed, t)`` drawn from :class:`numpy.random.SeedSequence`
streams, so out-of-order and repeated queries are deterministic.

Models
------
* :class:`BernoulliDropChannel` — iid per-round, per-link loss;
* :class:`GilbertElliottChannel` — the classic 2-state bursty-loss chain
  (good/bad per link, losses cluster while a link sits in the bad state);
* :class:`LinkLatencyModel` — per-link lognormal latency samples, consumed
  by the straggler injection in :mod:`repro.sim.faults` (links that miss
  the round deadline are treated as dropped).

The degraded links feed :func:`repro.sim.faults.repair_weights`, which
renormalizes the surviving links back to a valid mixing matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from . import hashrand

# SeedSequence domain tags (disjoint per stream; see repro.sim.mobility).
_BERNOULLI_TAG = 0xB0
_GE_BLOCK_TAG = 0x6E
_GE_STEP_TAG = 0x6F
_GE_LOSS_TAG = 0x70
_LATENCY_TAG = 0x1A7

# Counter-hash tags for the edge-list query path (``edge_mask``).  These
# are separate streams from the dense ``mask`` draws above: equal in
# distribution, NOT bitwise equal — the dense path draws whole (n, n)
# matrices from generator streams, the edge path random-accesses one
# uniform per (t, link) so sparse scenarios stay O(edges) per round.
_BERNOULLI_EDGE_TAG = 0xB1
_GE_EDGE_BLOCK_TAG = 0x71
_GE_EDGE_STEP_TAG = 0x72
_GE_EDGE_LOSS_TAG = 0x73
_LATENCY_EDGE_TAG = 0x1A8


def _symmetric_uniform(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, n) uniforms with u[i, j] == u[j, i] (one draw per undirected
    link; the diagonal is 0)."""
    u = np.triu(rng.random((n, n)), 1)
    return u + u.T


def _symmetric_normal(rng: np.random.Generator, n: int) -> np.ndarray:
    z = np.triu(rng.normal(size=(n, n)), 1)
    return z + z.T


@dataclasses.dataclass(frozen=True)
class BernoulliDropChannel:
    """iid loss: every undirected link drops independently with probability
    ``drop`` at every round."""

    drop: float
    seed: int = 0

    def mask(self, t: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _BERNOULLI_TAG, t)))
        m = _symmetric_uniform(rng, n) >= self.drop
        np.fill_diagonal(m, True)
        return m

    def edge_mask(self, t: int, src, dst) -> np.ndarray:
        """(E,) survival mask for the queried directed edges — O(E), its
        own hash stream (see the edge-tag note at module top).  Symmetric
        in the endpoints; ``src == dst`` entries always survive."""
        lo, hi = hashrand.edge_canonical(src, dst)
        u = hashrand.counter_uniform(self.seed, _BERNOULLI_EDGE_TAG, t, lo, hi)
        return (u >= self.drop) | (lo == hi)


@dataclasses.dataclass(frozen=True)
class GilbertElliottChannel:
    """Gilbert–Elliott bursty loss: each undirected link carries a 2-state
    Markov chain (good/bad).  Transition good→bad with probability
    ``p_bad`` and bad→good with ``p_good`` per round; a link in the bad
    state drops the round with probability ``drop_bad`` (``drop_good`` in
    the good state), so losses arrive in bursts of mean length 1/p_good.

    Random access: the chain regenerates to its stationary law at every
    ``block`` boundary, so the state at round t is reconstructed by
    iterating only ``t mod block`` transitions — still a pure function of
    ``(seed, t)`` (queries out of order or repeated agree exactly), with
    bounded work per query.  Burst correlation is preserved within blocks
    and only the (already memoryless-in-distribution) cross-block coupling
    is cut.
    """

    p_bad: float
    p_good: float = 0.25
    drop_good: float = 0.0
    drop_bad: float = 1.0
    seed: int = 0
    block: int = 64

    def bad_state(self, t: int, n: int) -> np.ndarray:
        """(n, n) bool: which links sit in the bad state at round t."""
        denom = self.p_bad + self.p_good
        pi_bad = self.p_bad / denom if denom > 0 else 0.0
        b0 = (t // self.block) * self.block
        rng = np.random.default_rng(np.random.SeedSequence(
            (self.seed, _GE_BLOCK_TAG, t // self.block)))
        bad = _symmetric_uniform(rng, n) < pi_bad
        for r in range(b0 + 1, t + 1):
            rng = np.random.default_rng(
                np.random.SeedSequence((self.seed, _GE_STEP_TAG, r)))
            u = _symmetric_uniform(rng, n)
            bad = np.where(bad, u < 1.0 - self.p_good, u < self.p_bad)
        return bad

    def mask(self, t: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _GE_LOSS_TAG, t)))
        u = _symmetric_uniform(rng, n)
        drop = np.where(self.bad_state(t, n),
                        u < self.drop_bad, u < self.drop_good)
        np.fill_diagonal(drop, False)
        return ~drop

    def edge_bad_state(self, t: int, lo, hi) -> np.ndarray:
        """Bad-state bits for canonical edge keys — the same block-regen
        chain as :meth:`bad_state`, iterated over only the queried edges
        (O(E * block) hash evaluations, n-independent)."""
        denom = self.p_bad + self.p_good
        pi_bad = self.p_bad / denom if denom > 0 else 0.0
        b0 = (t // self.block) * self.block
        u0 = hashrand.counter_uniform(self.seed, _GE_EDGE_BLOCK_TAG,
                                      t // self.block, lo, hi)
        bad = u0 < pi_bad
        for r in range(b0 + 1, t + 1):
            u = hashrand.counter_uniform(self.seed, _GE_EDGE_STEP_TAG,
                                         r, lo, hi)
            bad = np.where(bad, u < 1.0 - self.p_good, u < self.p_bad)
        return bad

    def edge_mask(self, t: int, src, dst) -> np.ndarray:
        """(E,) survival mask over queried edges — its own hash stream."""
        lo, hi = hashrand.edge_canonical(src, dst)
        u = hashrand.counter_uniform(self.seed, _GE_EDGE_LOSS_TAG, t, lo, hi)
        drop = np.where(self.edge_bad_state(t, lo, hi),
                        u < self.drop_bad, u < self.drop_good)
        return ~drop | (lo == hi)


@dataclasses.dataclass(frozen=True)
class LinkLatencyModel:
    """Per-link lognormal latency: ``sample(t, n)[i, j]`` is the round-t
    latency of link (i, j) in units of the nominal round time (median
    ``exp(mu)``).  Symmetric per undirected link; the diagonal is 0."""

    mu: float = 0.0
    sigma: float = 0.25
    seed: int = 0

    def sample(self, t: int, n: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence((self.seed, _LATENCY_TAG, t)))
        lat = np.exp(self.mu + self.sigma * _symmetric_normal(rng, n))
        np.fill_diagonal(lat, 0.0)
        return lat

    def edge_sample(self, t: int, src, dst) -> np.ndarray:
        """(E,) lognormal latencies for queried edges — its own hash
        stream; ``src == dst`` entries are 0 like the dense diagonal."""
        lo, hi = hashrand.edge_canonical(src, dst)
        z = hashrand.counter_normal(self.seed, _LATENCY_EDGE_TAG, t, lo, hi)
        return np.where(lo == hi, 0.0, np.exp(self.mu + self.sigma * z))
