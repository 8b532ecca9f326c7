"""Fault realization over edge lists — O(edges) per round.

The sparse counterpart of :func:`repro.sim.faults.realize_weight_schedule`:
each round's edges are filtered by the channel/fault models' ``edge_mask``
streams (:mod:`repro.sim.channel`, :mod:`repro.sim.faults`), and the
Laplacian edge form makes repair free — a dropped edge's weight returns to
both endpoints' diagonals by construction (see
:func:`repro.sim.faults.repair_edges`).  No dense matrix is ever built.
"""

from __future__ import annotations

from typing import Sequence

from ..sim import faults as sim_faults
from .schedule import SparseWeightSchedule


def realize_sparse_schedule(ideal, models: Sequence,
                            rounds: int | None = None,
                            t0: int = 0) -> SparseWeightSchedule:
    """Materialize the realized post-fault window of a sparse schedule.

    ``ideal`` is anything with ``round(t) -> SparseRound`` (a
    :class:`~repro.sparse.schedule.SparseWeightSchedule` window or a
    non-periodic generator like
    :class:`~repro.sparse.sampled.SampledMobilitySchedule`).
    """
    if rounds is None:
        rounds = getattr(ideal, "period", None)
        if rounds is None:
            raise ValueError("non-periodic schedule requires rounds=<window>")
    out = []
    for r in range(rounds):
        t = t0 + r
        rd = ideal.round(t)
        if models and rd.edges:
            keep = sim_faults.combined_edge_mask(models, t, rd.src, rd.dst)
            rd = rd.filter(keep)
        out.append(rd)
    return SparseWeightSchedule(tuple(out))
