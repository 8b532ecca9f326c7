"""Materialized windows of sparse gossip rounds.

:class:`SparseWeightSchedule` is the edge-list counterpart of
:class:`repro.core.gossip.WeightSchedule`: a finite window of
:class:`~repro.sparse.plan.SparseRound` objects exposing the same
``period`` / ``__call__`` / ``structure`` / ``stacked`` / ``plan``
interface, so :func:`repro.core.driver.run_algorithm` and
:mod:`repro.exp.build` consume either via duck typing.  Dense
materialization (``__call__``/``stacked``) exists only for small-n
equivalence checks and the host ``gossip_impl="dense"`` path; it raises
past :data:`repro.sparse.plan.DENSE_GUARD`.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..core import topology as topo
from .plan import DENSE_GUARD, SparseGossipPlan, SparseRound, round_from_dense


@dataclasses.dataclass(frozen=True)
class SparseWeightSchedule:
    """A finite window of sparse rounds; round t is ``rounds[t % period]``."""

    rounds: tuple  # tuple[SparseRound, ...]

    is_sparse = True

    def __post_init__(self):
        if not self.rounds:
            raise ValueError("schedule needs at least one round")

    @property
    def n(self) -> int:
        return self.rounds[0].n

    @property
    def period(self) -> int:
        return len(self.rounds)

    def round(self, t: int) -> SparseRound:
        return self.rounds[t % len(self.rounds)]

    @property
    def edges_per_round(self) -> np.ndarray:
        """Directed off-diagonal edge count of each round in the window."""
        return np.array([r.edges for r in self.rounds], dtype=np.int64)

    @property
    def senders_per_round(self) -> np.ndarray:
        """Participating sender count of each round in the window."""
        return np.array([r.senders for r in self.rounds], dtype=np.int64)

    # -- dense compatibility surface (small n only) ---------------------
    def __call__(self, t: int) -> np.ndarray:
        return self.round(t).as_dense()

    def structure(self, t: int) -> topo.RoundStructure:
        rd = self.round(t)
        if rd.kind == "empty":
            return topo.RoundStructure("empty")
        if rd.kind == "matching" and rd.n <= DENSE_GUARD:
            # the dense planner wants the full involution; only worth
            # materializing at small n
            perm = np.arange(rd.n)
            perm[rd.dst] = rd.src
            return topo.RoundStructure("matching",
                                       perm=tuple(int(p) for p in perm))
        return topo.RoundStructure("dense")

    def stacked(self, t0: int, rounds: int, dtype=np.float32) -> np.ndarray:
        if self.n > DENSE_GUARD:
            raise ValueError(
                f"refusing to stack dense matrices for n={self.n} "
                f"(> {DENSE_GUARD}); run this schedule with "
                "gossip_impl='auto' so it stays in edge form")
        return np.stack([self(t0 + r) for r in range(rounds)]).astype(dtype)

    def plan(self, t0: int = 0, rounds: int | None = None, *,
             validate: bool = True, pods=None, sparse=None,
             personalized: bool = False) -> SparseGossipPlan:
        """Lower a window to a :class:`SparseGossipPlan` in O(edges).

        ``pods``/``sparse`` are accepted for interface parity with the
        dense planner and ignored (an edge plan has no two-level lowering
        and is already sparse).
        """
        del pods, sparse
        if personalized:
            raise ValueError("personalized rounds stage per-node dense "
                             "weight rows; the edge-form plan cannot "
                             "lower them")
        rounds = self.period if rounds is None else rounds
        plan = SparseGossipPlan.from_rounds(
            self.round(t0 + r) for r in range(rounds))
        return plan.validate() if validate else plan


def from_weight_schedule(ws, t0: int = 0,
                         rounds: int | None = None) -> SparseWeightSchedule:
    """Convert a window of a dense :class:`repro.core.gossip.WeightSchedule`
    (or any ``t -> (n, n)`` callable with a period) to edge form, pinning
    each round's exact diagonal for bit-exact reconstruction."""
    if rounds is None:
        rounds = getattr(ws, "period", None)
        if rounds is None:
            raise ValueError("non-periodic schedule requires rounds=<window>")
    return SparseWeightSchedule(tuple(
        round_from_dense(np.asarray(ws(t0 + r), dtype=np.float64))
        for r in range(rounds)))
