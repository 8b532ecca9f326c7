"""Metric sinks and the batched in-step-metrics recorder, the port of the
JAX package's ``obs/metrics.py``.

The metric arithmetic lives in :mod:`repro_torch.core.engine`
(:data:`~repro_torch.core.engine.OBS_METRICS`: grad norm, consensus
distance, mixing residual, tracker residual), computed inside the step of
both runtimes as f32 device scalars.  This module is the host side: the
:class:`MetricsSink` protocol with the JSONL :class:`EventLog` backend, and
the :class:`ObsRecorder` that plugs into the driver's ``record`` hook,
buffers the device scalars, and every ``every`` steps moves the batch to
the host in one copy: one ``torch.stack`` of the buffered scalars, copied
with ``non_blocking=True`` into pinned host memory, a ``torch.cuda.Event``
recorded after the copy; a background flusher thread waits on that event
(not on the device) and feeds the sink and the gap tracker.  The hot path
gains no per-step sync or transfer.

Event-log schema (one JSON object per line), the reference's::

    {"event": "meta", ...}      run header (spec hash, algo, n, cell, ...)
    {"event": "step", ...}      per-step metrics (see EVENT_FIELDS)
    {"event": "eval", ...}      eval_fn points (k, t, value)
    {"event": "summary", ...}   end-of-run phase totals + optimality gap
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Optional, Protocol, runtime_checkable

import torch

from ..core import engine

# Host-facing vocabulary: one description per engine metric (the
# reference's words), in the engine's order.
OBS_METRICS = {
    "grad_norm": "||g||_F of the stacked per-node oracle gradients "
                 "(f32 accumulation)",
    "consensus": "consensus distance ||x - x_bar||_F of the post-step "
                 "stacked iterate",
    "mix_residual": "||x_post - x_pre||_F across the step's gossip "
                    "mixing (0 when the realized window did not move "
                    "the state)",
    "tracker_residual": "||mean_i h_i - mean_i g_i||_F — drift of the "
                        "gradient-tracking invariant mean(h) = mean(g) "
                        "(clipping / low-precision trackers / channel "
                        "repair make this nonzero)",
}
if tuple(OBS_METRICS) != engine.OBS_METRICS:
    raise ImportError("obs.metrics.OBS_METRICS must name the engine's "
                      "metrics in its order")

EVENT_FIELDS = {
    "event": "record type: meta | step | eval | summary",
    "step": "driver step index k",
    "t": "total gossip/oracle budget T consumed after this step",
    "sec": "wall-clock seconds of the step dispatch",
    "loss": "runtime scalar loss when the step reports one",
    **OBS_METRICS,
    "phases": "wall-clock seconds per driver phase since the previous "
              "record (data/step/telemetry/checkpoint)",
    "spectral_gap": "realized-window mixing contraction (from the chained "
                    "TelemetryRecorder, when present)",
    "eff_diameter": "realized-window effective diameter (chained "
                    "TelemetryRecorder)",
    "kinds": "realized plan-kind counts (chained TelemetryRecorder)",
    "bytes": "wire bytes this step's realized gossip transmitted — the "
             "compressed payload format once past warmup (chained "
             "TelemetryRecorder)",
    "bytes_total": "cumulative wire bytes since step 0 (chained "
                   "TelemetryRecorder)",
    "value": "eval_fn(x_bar) at an eval event",
}

# Keys the chained TelemetryRecorder contributes to a step event (its
# step/t/loss/sec/consensus duplicates the recorder's own fields).
_TELEMETRY_KEYS = ("window", "spectral_gap", "eff_diameter", "kinds",
                   "bytes", "bytes_total")


@runtime_checkable
class MetricsSink(Protocol):
    """Anything that accepts event dicts: ``emit(event)`` + ``close()``."""

    def emit(self, event: dict) -> None: ...

    def close(self) -> None: ...


class EventLog:
    """Append-only JSONL sink.  Opens lazily (and makes the parent
    directory) on the first emit, so constructing a spec never touches the
    file system."""

    def __init__(self, path: str):
        self.path = path
        self._f = None

    def emit(self, event: dict) -> None:
        if self._f is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._f = open(self.path, "w")
        self._f.write(json.dumps(event, default=_jsonable) + "\n")

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class MemorySink:
    """In-process sink (tests, notebooks): events land in ``.events``."""

    def __init__(self):
        self.events: list[dict] = []
        self.closed = False

    def emit(self, event: dict) -> None:
        self.events.append(event)

    def close(self) -> None:
        self.closed = True


class ChainSink:
    """Fan one emit out to several sinks."""

    def __init__(self, *sinks: MetricsSink):
        self.sinks = tuple(s for s in sinks if s is not None)

    def emit(self, event: dict) -> None:
        for s in self.sinks:
            s.emit(event)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def _jsonable(v):
    try:
        return float(v)
    except (TypeError, ValueError):
        return str(v)


def read_events(path: str, kind: Optional[str] = None) -> list[dict]:
    """Load a JSONL event log (optionally filtered to one event kind)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if kind is None or ev.get("event") == kind:
                out.append(ev)
    return out


class _HostCopy:
    """The device scalars of one flush batch on their way to the host: per
    device one ``torch.stack``, copied ``non_blocking`` into pinned memory
    with a CUDA event recorded after the copy.  A CPU tensor needs neither
    pinned memory nor an event: its stack is the host copy.  Values that
    are not tensors pass through as they are."""

    def __init__(self, leaves: list):
        # the device tensors are not kept: the copies hold their values
        self.plain = [None if isinstance(v, torch.Tensor) else float(v)
                      for v in leaves]
        self.copies = []            # (indices, host tensor, event | None)
        by_dev: dict = {}
        for i, v in enumerate(leaves):
            if isinstance(v, torch.Tensor):
                by_dev.setdefault(v.device, []).append(i)
        for dev, idx in by_dev.items():
            packed = torch.stack([leaves[i].detach().reshape(()).float()
                                  for i in idx])
            if dev.type != "cuda":
                self.copies.append((idx, packed, None))
                continue
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
            self.copies.append((idx, host, event))

    def values(self) -> list:
        """The leaves as floats, once each copy's event has completed (the
        calling thread waits on the events, never on the device)."""
        out = list(self.plain)
        for idx, host, event in self.copies:
            if event is not None:
                event.synchronize()
            for i, v in zip(idx, host.tolist()):
                out[i] = v
        return out


class ObsRecorder:
    """The driver ``record`` hook that turns in-step obs scalars into
    events.

    Plugs in wherever a :class:`repro_torch.sim.telemetry.TelemetryRecorder`
    does (``record(k, t, state, out, dt)``); an existing TelemetryRecorder
    chains *through* it (``telemetry=``) rather than being replaced — its
    windowed mixing fields ride along on the step events and its own
    ``history``/``dump`` keep working.

    Per step this only appends to a host-side buffer; every ``every``
    recorded steps :meth:`flush` starts the buffered batch's one copy to the
    host (:class:`_HostCopy`) and hands it to a background flusher thread,
    which waits for the copy and feeds the sink / gap tracker off the hot
    path.  ``close()`` flushes the tail, joins the flusher, and emits the
    run ``summary`` event, so ``every > 1`` never loses events; an error in
    the flusher surfaces on the next flush or on close.
    ``background=False`` drains synchronously (deterministic interleaving
    for debugging).
    """

    def __init__(self, sink: MetricsSink, *, every: int = 10,
                 telemetry=None, tracer=None, gap=None, profiler=None,
                 meta: Optional[dict] = None, background: bool = True):
        self.sink = sink
        self.every = max(1, int(every))
        self.telemetry = telemetry
        self.tracer = tracer
        self.gap = gap
        self.profiler = profiler
        self.background = background
        self._buf: list[tuple] = []  # raw entries; see hook comment below
        self._closed = False
        self._queue: Optional[queue.SimpleQueue] = None
        self._worker: Optional[threading.Thread] = None
        self._worker_err: Optional[BaseException] = None
        if meta is not None:
            self.sink.emit({"event": "meta", **meta})

    # -- driver hooks -----------------------------------------------------
    #
    # The hot path appends raw tuples; the event dicts are built at drain
    # time (in the flusher thread under ``background=True``):
    #   ("step", k, t, dt, tl, phases, device)   device = {loss?, obs?}
    #   ("eval", k, t, value)

    def record(self, k: int, t: int, state: Any, out: Any,
               dt: float) -> Optional[dict]:
        tl = None
        if self.telemetry is not None:
            tl = self.telemetry.record(k, t, state, out, dt)
        phases = self.tracer.drain() if self.tracer is not None else None
        device = None
        if type(out) is dict:
            device = {kk: out[kk] for kk in ("loss", "obs") if kk in out
                      and out[kk] is not None}
        self._buf.append(("step", k, t, dt, tl, phases, device))
        if self.profiler is not None:
            self.profiler.maybe_stop(k)
        if len(self._buf) >= self.every:
            self.flush()
        return tl

    def eval_event(self, k: int, t: int, value) -> None:
        """An eval_fn point (already host-side in the driver)."""
        self._buf.append(("eval", k, t, float(value)))
        if len(self._buf) >= self.every:
            self.flush()

    # -- flushing ---------------------------------------------------------

    def flush(self) -> None:
        if not self._buf:
            return
        buf, self._buf = self._buf, []
        leaves = []
        for e in buf:
            if e[0] == "step" and e[6] is not None:
                if "loss" in e[6]:
                    leaves.append(e[6]["loss"])
                obs = e[6].get("obs", {})
                leaves.extend(obs[name] for name in sorted(obs))
        batch = (buf, _HostCopy(leaves))
        if self.background:
            if self._worker_err is not None:
                err, self._worker_err = self._worker_err, None
                raise err
            if self._worker is None:
                self._queue = queue.SimpleQueue()
                self._worker = threading.Thread(
                    target=self._drain_loop, name="obs-flush", daemon=True)
                self._worker.start()
            self._queue.put(batch)
        else:
            self._drain_batch(*batch)

    def _drain_loop(self) -> None:
        while True:
            batch = self._queue.get()
            if batch is None:
                return
            try:
                self._drain_batch(*batch)
            except BaseException as e:  # surfaced on the next flush/close
                self._worker_err = e

    def _drain_batch(self, buf, copy: _HostCopy) -> None:
        host_iter = iter(copy.values())
        for entry in buf:
            if entry[0] == "eval":
                _, k, t, value = entry
                base = {"event": "eval", "step": int(k), "t": int(t),
                        "value": value}
            else:
                _, k, t, dt, tl, phases, device = entry
                base = {"event": "step", "step": int(k), "t": int(t),
                        "sec": round(float(dt), 6)}
                if tl:
                    base.update({kk: tl[kk] for kk in _TELEMETRY_KEYS
                                 if kk in tl})
                if phases:
                    base["phases"] = {p: round(v, 6)
                                      for p, v in phases.items()}
                if device is not None:
                    if "loss" in device:
                        base["loss"] = float(next(host_iter))
                    # in sorted order, as the reference's tree round
                    # trip leaves its obs dict
                    for name in sorted(device.get("obs", {})):
                        base[name] = float(next(host_iter))
                if self.gap is not None and "grad_norm" in base:
                    self.gap.update(base["t"], base["grad_norm"] ** 2)
            self.sink.emit(base)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        if self._worker is not None:
            self._queue.put(None)
            self._worker.join()
            self._worker = None
            if self._worker_err is not None:
                raise self._worker_err
        summary: dict = {"event": "summary"}
        if self.tracer is not None:
            summary["phases"] = self.tracer.summary()
        if self.gap is not None:
            summary["optimality"] = self.gap.summary()
        self.sink.emit(summary)
        if self.profiler is not None:
            self.profiler.close()
        self.sink.close()

    # -- conveniences -----------------------------------------------------

    def emit(self, event: dict) -> None:
        """Pass-through for out-of-band events (meta, console mirrors)."""
        self.sink.emit(event)

    @property
    def history(self) -> list:
        """The chained TelemetryRecorder's history (empty when none)."""
        return self.telemetry.history if self.telemetry is not None else []

    def dump(self, path: str) -> None:
        if self.telemetry is not None:
            self.telemetry.dump(path)


def resolve_names(names, rule=None) -> tuple:
    """Normalize an obs metric selection to an engine-ready tuple.

    ``names`` is ``'auto'`` (the rule's default set — tracker residual only
    for tracking rules), a comma-separated string, an iterable of names, or
    None/'' (no metrics).  Unknown names raise with the vocabulary.
    """
    if names is None or names == "":
        return ()
    if names == "auto":
        return (engine.default_obs(rule) if rule is not None
                else engine.OBS_METRICS)
    if isinstance(names, str):
        names = tuple(s.strip() for s in names.split(",") if s.strip())
    names = tuple(names)
    bad = [n for n in names if n not in OBS_METRICS]
    if bad:
        raise ValueError(
            f"unknown obs metric(s) {bad}; known: {sorted(OBS_METRICS)}")
    return names
