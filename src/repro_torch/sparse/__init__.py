"""Sparse scenario engine: edge-list gossip plans and sampled clients.

The O(edges) counterpart of the dense planner stack, for scenarios past a
few hundred nodes (100k-1M node fleets with k sampled participants per
round).  See README "Sparse plans & client sampling".

* :mod:`repro.sparse.plan` — :class:`SparseRound` / :class:`SparseGossipPlan`
  (COO edges + per-round segment offsets, Laplacian form);
* :mod:`repro.sparse.schedule` — :class:`SparseWeightSchedule` windows with
  the dense-schedule duck-type surface;
* :mod:`repro.sparse.sampled` — the ``random-sampled`` topology family;
* :mod:`repro.sparse.realize` — O(edges) fault realization;
* :mod:`repro.sparse.telemetry` — power-iteration mixing proxies and
  participating-sender wire pricing.
"""

from .plan import (DENSE_GUARD, SparseGossipPlan, SparseRound,
                   round_from_dense)
from .realize import realize_sparse_schedule
from .sampled import SampledMobilitySchedule, sampled_weight_schedule
from .schedule import SparseWeightSchedule, from_weight_schedule
from .telemetry import SparseTelemetryRecorder, sparse_windowed_gap

__all__ = [
    "DENSE_GUARD",
    "SparseRound",
    "SparseGossipPlan",
    "SparseWeightSchedule",
    "SampledMobilitySchedule",
    "SparseTelemetryRecorder",
    "from_weight_schedule",
    "realize_sparse_schedule",
    "round_from_dense",
    "sampled_weight_schedule",
    "sparse_windowed_gap",
]
