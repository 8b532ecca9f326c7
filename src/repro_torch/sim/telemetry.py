"""Online mixing telemetry over the *realized* (post-fault) schedule, the
port of the JAX package's ``sim/telemetry.py``.

A :class:`TelemetryRecorder` plugs into the driver loop as (part of) the
``record`` hook (:func:`repro_torch.core.driver.run_loop` /
``run_algorithm(telemetry=...)``) and measures, per step, what the lossy
channel actually did to mixing:

* ``consensus``      — consensus distance ||x - x̄||_F of the stacked
                       iterate (how far the node copies have drifted);
* ``spectral_gap``   — 1 - ||Π_r W^r - 11ᵀ/n||₂ over the trailing window
                       of realized matrices (the empirical multi-round
                       contraction; 0 means the realized window does not
                       mix at all);
* ``eff_diameter``   — empirical effective diameter (paper Definition 2)
                       of the realized window's adjacency, via the
                       vectorized all-pairs frontier propagation in
                       :func:`repro_torch.core.topology.effective_diameter`;
                       ``None``/null when the window never connects;
* ``kinds``          — realized plan-kind counts in the window (``empty``
                       = fully dropped rounds, ``matching`` = surviving
                       (possibly partial) matchings, ...).

``dump(path)`` writes the JSON history together with this field reference.

The state metrics (consensus, the per-node dimension behind ``bytes``) read
torch tensors; the window metrics are the reference's numpy, so both
packages give the same numbers for the same realized schedule.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import numpy as np
import torch

from ..core import compress, gossip, topology as topo

TELEMETRY_FIELDS = {
    "step": "driver step index k",
    "t": "total gossip rounds (budget T) consumed after this step",
    "loss": "runtime loss metric when the step reports one, else null",
    "consensus": "consensus distance ||x - x_bar||_F of the stacked iterate",
    "window": "[lo, hi) realized rounds the windowed metrics below cover",
    "spectral_gap": "1 - ||prod_{r in window} W^r - 11^T/n||_2 (empirical "
                    "multi-round mixing contraction of the realized window)",
    "eff_diameter": "empirical effective diameter (Definition 2) of the "
                    "realized window's adjacency; null when the window "
                    "never connects",
    "kinds": "realized gossip-plan round kinds in the window, counted "
             "(empty = fully dropped rounds)",
    "dense_fallback": "rounds in the window the gossip planner could only "
                      "lower to the generic dense einsum (every structured/"
                      "sparse lowering rejected — see GossipRound."
                      "fallback_reason); 0 for a fully structured window",
    "stale_gap": "delay-adjusted spectral gap: the windowed contraction "
                 "of the rounds whose mixing has actually LANDED on the "
                 "state by this step under stale-window gossip — the "
                 "window shifted back by delay*wps rounds (the last "
                 "delay*wps rounds are still in flight).  Equal to "
                 "spectral_gap at delay=0; only emitted when delay > 0",
    "bytes": "payload bytes transmitted by all active senders over the "
             "rounds this step consumed — the quantized wire format "
             "(repro.core.compress.payload_bytes) once compression is on "
             "and past warmup, full f32 otherwise; dropped rounds and "
             "silent nodes transmit nothing",
    "bytes_total": "cumulative payload bytes since step 0 (accumulated "
                   "every step, including steps the log cadence skips)",
    "sec": "wall-clock seconds this step took",
}


_CHUNK_BYTES = 1 << 28


def consensus_distance(x: torch.Tensor) -> float:
    """||x - x̄||_F of a node-stacked tensor (node axis 0), in f32 like the
    reference.  Reduces on the device over blocks of rows of at most
    ``_CHUNK_BYTES``: a temporary never holds a second copy of a large
    state (7.4 GB for the arch trainer's), and one scalar crosses to the
    host.  Squares and sums (``vector_norm``'s CPU reduction accumulates
    in f32 lane by lane: 0.28% low on a 16-node reduced qwen state)."""
    xb = x.mean(dim=0, keepdim=True)
    rows = max(1, _CHUNK_BYTES // max(1, x[0].numel() * x.element_size()))
    sq = sum((c - xb).square_().sum() for c in x.split(rows))
    return float(sq) ** 0.5


def windowed_spectral_gap(mats: np.ndarray) -> float:
    """1 - beta of the window product: the contraction a state actually
    experienced mixing through ``mats`` (R, n, n) in order."""
    P = np.eye(mats.shape[1])
    for W in mats:
        P = W @ P
    return 1.0 - gossip.mixing_beta(P)


def window_adjacency(mats: np.ndarray, tol: float = 1e-12) -> np.ndarray:
    """(R, n, n) bool adjacency of a realized matrix window."""
    adj = np.abs(mats) > tol
    adj |= np.eye(mats.shape[1], dtype=bool)[None]
    return adj


def empirical_effective_diameter(adjs: np.ndarray) -> Optional[int]:
    """Definition 2 effective diameter of the realized window, treated as
    one period; ``None`` when some pair never meets within the cap (the
    window does not connect the network)."""
    adjs = np.asarray(adjs, bool)
    R, n = adjs.shape[0], adjs.shape[1]
    if n <= 1:
        return 0
    sched = topo.PeriodicSchedule(tuple(adjs))
    d = topo.effective_diameter(sched, period=R)
    cap = n * R + n + 1
    return None if d > cap else d


class TelemetryRecorder:
    """Collects per-step mixing telemetry from a realized weight schedule.

    ``record(k, t, state, out, dt)`` has exactly the driver's ``record``
    hook signature (``t`` is the budget AFTER the step, so the step just
    consumed rounds [t - wps, t)); use it directly as the hook, chain it
    from an existing one, or pass the recorder as
    ``driver.run_algorithm(..., telemetry=...)``.
    """

    def __init__(self, realized: gossip.WeightSchedule, wps: int,
                 window: int | None = None, every: int = 1,
                 cache: bool = True, compression=None, delay: int = 0):
        self.realized = realized
        self.wps = wps
        self.window = window if window is not None else max(4 * wps, 8)
        self.every = max(1, every)
        # Stale-window gossip (AlgorithmSpec.delay): the mix issued at step
        # k lands on the state applied to the payload from k-delay, so the
        # last delay*wps rounds of the trailing window are "in flight" —
        # ``stale_gap`` measures the contraction of what actually landed.
        self.delay = max(0, int(delay))
        self.history: list = []
        # Bytes accounting: ``compression`` is a
        # repro_torch.core.compress.CompressionConfig (None = full-precision
        # f32 payloads); the per-node state dim is read lazily off the first
        # recorded state so the recorder needs no model knowledge.
        self.compression = compression
        self.bytes_total = 0
        self._dim: Optional[int] = None
        # Per-round cache of (W float64, bool adjacency, plan kind): the
        # trailing windows of consecutive records overlap in all but
        # ``wps`` rounds, so materializing/classifying each realized round
        # once makes the per-record conversion cost O(new rounds) instead
        # of O(window).  ``cache=False`` recomputes every round per call
        # (the pre-cache behavior, kept for benchmarking the win).
        self.cache = cache
        self._rounds: dict[int, tuple] = {}

    def _round(self, r: int) -> tuple:
        """(W64, adjacency, kind, dense_fallback) for realized round ``r``:
        ``dense_fallback`` is True when the gossip planner can only lower
        this round to the generic dense einsum (plan_round sets a
        fallback_reason on it)."""
        hit = self._rounds.get(r) if self.cache else None
        if hit is None:
            W = np.asarray(self.realized(r), np.float64)
            adj = np.abs(W) > 1e-12
            adj |= np.eye(W.shape[0], dtype=bool)
            s = self.realized.structure(r)
            kind = s.kind if s is not None else \
                topo.classify_adjacency(adj).kind
            rd = gossip.plan_round(W, s)
            hit = (W, adj, kind, rd.fallback_reason is not None)
            if self.cache:
                self._rounds[r] = hit
        return hit

    def _window_rounds(self, lo: int, t: int):
        """Materialize the window [lo, t): stacked float64 matrices, the
        stacked adjacency, and kind counts.  With the cache on, only the
        rounds that entered the window since the last call convert."""
        floor = lo - self.delay * self.wps  # stale window reaches further back
        if self.cache:  # rounds now behind every window never recur
            for r in [r for r in self._rounds if r < floor]:
                del self._rounds[r]
        rounds = [self._round(r) for r in range(lo, t)]
        mats = np.stack([w for w, _, _, _ in rounds])
        adjs = np.stack([a for _, a, _, _ in rounds])
        kinds: dict = {}
        for _, _, kind, _ in rounds:
            kinds[kind] = kinds.get(kind, 0) + 1
        fallbacks = sum(1 for _, _, _, fb in rounds if fb)
        return mats, adjs, kinds, fallbacks

    def _window_metrics(self, t: int) -> dict:
        lo = max(0, t - self.window)
        if t <= lo:
            return {"window": [lo, t], "spectral_gap": None,
                    "eff_diameter": None, "kinds": {}, "dense_fallback": 0}
        mats, adjs, kinds, fallbacks = self._window_rounds(lo, t)
        out = {"window": [lo, t],
               "spectral_gap": round(windowed_spectral_gap(mats), 6),
               "eff_diameter": empirical_effective_diameter(adjs),
               "kinds": kinds,
               "dense_fallback": fallbacks}
        if self.delay:
            shift = self.delay * self.wps
            s_lo, s_t = max(0, lo - shift), max(0, t - shift)
            if s_t <= s_lo:
                out["stale_gap"] = None  # nothing has landed yet
            else:
                s_mats = np.stack([self._round(r)[0]
                                   for r in range(s_lo, s_t)])
                out["stale_gap"] = round(windowed_spectral_gap(s_mats), 6)
        return out

    def _payload_bytes(self, k: int, state: Any) -> int:
        """One sender's payload at step ``k``: the scheme's wire format once
        compression is on and past warmup, full f32 otherwise.  The per-node
        dimension is read off the first recorded (n, ...) state tensor."""
        if self._dim is None:
            self._dim = state.x[0].numel()
        c = self.compression
        if c is None or k < c.warmup:
            return compress.payload_bytes(self._dim, "none")
        return compress.payload_bytes(self._dim, c.scheme, c.group)

    def _step_bytes(self, k: int, t: int, state: Any) -> int:
        """Wire bytes the step that just consumed rounds [t - wps, t)
        transmitted: per active sender (a node with at least one realized
        off-diagonal edge that round), the scheme's payload — full f32
        while compression is off or still in warmup."""
        total = 0
        per = self._payload_bytes(k, state)
        for r in range(max(0, t - self.wps), t):
            _, adj, _, _ = self._round(r)
            off = adj & ~np.eye(adj.shape[0], dtype=bool)
            total += int(np.count_nonzero(off.any(axis=1))) * per
        return total

    def record(self, k: int, t: int, state: Any, out: Any,
               dt: float) -> Optional[dict]:
        # bytes accumulate on EVERY step — before the log-cadence gate —
        # so bytes_total stays exact at any ``every``
        step_bytes = self._step_bytes(int(k), int(t), state)
        self.bytes_total += step_bytes
        if k % self.every:
            return None
        loss = None
        if isinstance(out, dict) and "loss" in out:
            loss = float(out["loss"])
        entry = {"step": int(k), "t": int(t), "loss": loss,
                 "consensus": consensus_distance(state.x),
                 "bytes": step_bytes, "bytes_total": self.bytes_total,
                 "sec": round(float(dt), 4)}
        entry.update(self._window_metrics(int(t)))
        self.history.append(entry)
        return entry

    def dump(self, path: str) -> None:
        """Write ``{"fields": <reference>, "history": [...]}`` as JSON."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump({"fields": TELEMETRY_FIELDS, "history": self.history},
                      f, indent=1)
