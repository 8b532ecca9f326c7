"""Edge-list telemetry: spectral-gap proxies and wire pricing in O(edges),
the port of the JAX package's ``sparse/telemetry.py``
(:func:`sparse_windowed_gap` is its numpy, unchanged).

The dense :class:`repro_torch.sim.telemetry.TelemetryRecorder` materializes
each realized round as an (n, n) float64 matrix and takes a dense SVD of the
window product — O(n^3) per record, impossible at 10^5+ nodes.  This
recorder keeps the identical ``record``/``dump`` interface and history
schema but computes everything from the edge lists:

* ``spectral_gap`` — power iteration on the window product restricted to
  the *participant* subspace (the union of nodes touched by any window
  edge), with the participant-mean deflated on each side.  At full
  participation this equals the dense ``1 - ||prod W - 11^T/n||_2``
  (pinned by tests); under client sampling the full-n gap is trivially 0
  (non-participants never move), so the participant-restricted contraction
  is the quantity that actually tracks mixing progress.
* ``bytes`` — per round, only *participating senders* (distinct ``src``
  ids of the realized edges) are priced.  The dense recorder already
  counts active rows; this is the same contract without densification.
* ``eff_diameter`` — ``None``: the all-pairs frontier propagation is
  inherently O(n^2) and is not approximated here.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..sim import telemetry as sim_telemetry


def sparse_windowed_gap(rounds, iters: int = 40, seed: int = 0) -> float:
    """1 - beta of the window product over the participant subspace.

    ``rounds`` is an ordered sequence of :class:`repro_torch.sparse.plan.
    SparseRound`; beta is estimated as sqrt(lambda_max((P(I-J))^T P(I-J)))
    by power iteration, where P is the window product applied in O(edges)
    per round via scatter-adds and J is the mean over participants.  Each
    round is symmetric (Assumption 3), so P^T is the reversed window.
    """
    active = [r for r in rounds if r.edges]
    if not active:
        return 0.0  # no communication: the window does not mix at all
    parts = np.unique(np.concatenate(
        [np.concatenate([r.src, r.dst]) for r in active]))
    m = parts.size
    local = [(np.searchsorted(parts, r.src).astype(np.int64),
              np.searchsorted(parts, r.dst).astype(np.int64),
              r.w) for r in active]

    def _apply(v, seq):
        for ls, ld, w in seq:
            v = v + np.bincount(ld, weights=w * (v[ls] - v[ld]), minlength=m)
        return v

    rng = np.random.default_rng(seed)
    v = rng.standard_normal(m)
    lam = 0.0
    for _ in range(iters):
        v = v - v.mean()
        nv = np.linalg.norm(v)
        if nv < 1e-30:
            return 1.0  # window contracts deviations to numerical zero
        v = v / nv
        u = _apply(v, local)
        u = u - u.mean()
        y = _apply(u, list(reversed(local)))
        y = y - y.mean()
        lam = float(v @ y)
        v = y
    beta = float(np.sqrt(max(lam, 0.0)))
    return 1.0 - min(beta, 1.0)


class SparseTelemetryRecorder(sim_telemetry.TelemetryRecorder):
    """Drop-in recorder for :class:`repro_torch.sparse.schedule.
    SparseWeightSchedule` — same hook signature, history schema, and
    ``dump`` format as the dense recorder."""

    def _round(self, r: int) -> tuple:
        hit = self._rounds.get(r) if self.cache else None
        if hit is None:
            rd = self.realized.round(r)
            hit = (rd, None, rd.kind)
            if self.cache:
                self._rounds[r] = hit
        return hit

    def _window_metrics(self, t: int) -> dict:
        lo = max(0, t - self.window)
        if t <= lo:
            return {"window": [lo, t], "spectral_gap": None,
                    "eff_diameter": None, "kinds": {}}
        floor = lo - self.delay * self.wps
        if self.cache:
            for r in [r for r in self._rounds if r < floor]:
                del self._rounds[r]
        rounds, kinds = [], {}
        for r in range(lo, t):
            rd, _, kind = self._round(r)
            rounds.append(rd)
            kinds[kind] = kinds.get(kind, 0) + 1
        out = {"window": [lo, t],
               "spectral_gap": round(sparse_windowed_gap(rounds), 6),
               "eff_diameter": None,
               "kinds": kinds}
        if self.delay:
            shift = self.delay * self.wps
            s_lo, s_t = max(0, lo - shift), max(0, t - shift)
            if s_t <= s_lo:
                out["stale_gap"] = None
            else:
                landed = [self._round(r)[0] for r in range(s_lo, s_t)]
                out["stale_gap"] = round(sparse_windowed_gap(landed), 6)
        return out

    def _step_bytes(self, k: int, t: int, state: Any) -> int:
        per = self._payload_bytes(k, state)
        total = 0
        for r in range(max(0, t - self.wps), t):
            rd, _, _ = self._round(r)
            total += rd.senders * per  # only participating senders transmit
        return total
