"""Phase spans and the opt-in profiler trace, the port of the JAX package's
``obs/trace.py``.

The driver loop (:func:`repro_torch.core.driver.run_loop`) has four
host-visible phases per step — ``data`` (the batch), ``step`` (the step and
its device sync), ``telemetry`` (the record hook) and ``checkpoint``.  A
:class:`Tracer` wraps each in a wall-clock span, and with ``annotate=True``
in a ``torch.profiler.record_function(f"obs:{phase}")`` range too, so the
same labels show up in a profiler timeline.  Inside the step the engine
tags the runtime's grad and mix with ``record_function("obs_grad")`` and
``("obs_mix")``, so a profile (:class:`Profiler`, ``--profile-dir``) splits
a step's device time between them.

The reference's ``mix_depends_on_grad`` and ``overlap_report`` are taint
analyses of a jaxpr; a PyTorch step has no jaxpr, so they are not here
(ROADMAP.md lists them).
"""

from __future__ import annotations

import os
import time

PHASES = ("data", "step", "telemetry", "checkpoint")


class Tracer:
    """Wall-clock phase spans for the driver loop.

    ``span(phase)`` is a context manager; completed spans accumulate into
    ``totals``/``counts`` and queue in ``_pending`` until the next
    :meth:`drain` (the ObsRecorder attaches them to that step's event).

    ``annotate=True`` also enters ``torch.profiler.record_function(
    f"obs:{phase}")`` for each span, so the labels land in a profiler
    timeline; it is off by default, since the range costs a few
    microseconds per span and is only read when a trace
    (``--profile-dir``) is captured.
    """

    def __init__(self, annotate: bool = False):
        self.annotate = annotate
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self._pending: dict[str, float] = {}
        self._spans: dict[str, _Span] = {}

    def span(self, phase: str) -> "_Span":
        # One reusable context-manager object per phase: span() runs every
        # loop phase of every step.  Phases never nest, so reuse is safe.
        s = self._spans.get(phase)
        if s is None:
            s = self._spans[phase] = _Span(self, phase)
        return s

    def drain(self) -> dict[str, float]:
        """Spans accumulated since the last drain (one step's worth)."""
        out, self._pending = self._pending, {}
        return out

    def summary(self) -> dict:
        """Per-phase totals for the run-summary event / report table."""
        return {
            phase: {"total_sec": self.totals[phase],
                    "count": self.counts.get(phase, 0),
                    "mean_ms": 1e3 * self.totals[phase]
                    / max(1, self.counts.get(phase, 0))}
            for phase in sorted(self.totals)
        }


class _Span:
    """Reusable timing context for one Tracer phase (see Tracer.span)."""

    __slots__ = ("tracer", "phase", "ann", "t0")

    def __init__(self, tracer: Tracer, phase: str):
        self.tracer = tracer
        self.phase = phase
        self.ann = None
        self.t0 = 0.0

    def __enter__(self):
        if self.tracer.annotate:
            import torch
            self.ann = torch.profiler.record_function(f"obs:{self.phase}")
            self.ann.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dt = time.perf_counter() - self.t0
        tr, ph = self.tracer, self.phase
        tr.totals[ph] = tr.totals.get(ph, 0.0) + dt
        tr.counts[ph] = tr.counts.get(ph, 0) + 1
        tr._pending[ph] = tr._pending.get(ph, 0.0) + dt
        if self.ann is not None:
            ann, self.ann = self.ann, None
            ann.__exit__(et, ev, tb)
        return False


class Profiler:
    """Opt-in ``torch.profiler`` trace of the first ``steps`` recorded
    steps, CPU and (where the build has it) CUDA activity.

    ``start()`` before the loop, ``maybe_stop(k)`` from the record hook
    (stops once ``steps`` steps have been observed), ``close()`` as a
    stop-on-exit guard.  Stopping exports a Chrome trace,
    ``<dir>/trace.json`` (:attr:`path`); ``prof`` keeps the finished
    ``torch.profiler.profile`` for ``key_averages()``.
    """

    def __init__(self, directory: str, steps: int = 8):
        self.dir = directory
        self.steps = int(steps)
        self.path = os.path.join(directory, "trace.json")
        self.prof = None
        self._active = False
        self._seen = 0

    def start(self):
        if not self._active:
            import torch
            self.prof = torch.profiler.profile(
                activities=sorted(torch.profiler.supported_activities(),
                                  key=str))
            self.prof.start()
            self._active = True
        return self

    def maybe_stop(self, k: int) -> bool:
        """Count one recorded step; stop the trace after ``steps``."""
        del k
        if not self._active:
            return False
        self._seen += 1
        if self._seen >= self.steps:
            self.close()
            return True
        return False

    def close(self):
        if self._active:
            self._active = False
            self.prof.stop()
            os.makedirs(self.dir, exist_ok=True)
            self.prof.export_chrome_trace(self.path)
