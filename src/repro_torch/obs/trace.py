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

The reference's :func:`mix_depends_on_grad` and :func:`overlap_report` read
those same tags out of a step's jaxpr to prove (or refute) that the mix may
overlap the grad.  A PyTorch step has no jaxpr: here they run the step under
a ``TorchDispatchMode`` that follows the data from every ``obs_grad`` op to
the ``obs_mix`` ranges (see :func:`mix_depends_on_grad`).  Under stale-window
gossip (``UpdateRule.delay > 0``) no mix consumes the step's gradient, and
the engine issues the windows before the oracle, on a second CUDA stream on
the card (:mod:`repro_torch.core.engine`).
"""

from __future__ import annotations

import os
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PHASES = ("data", "step", "telemetry", "checkpoint")
MIX, GRAD = "obs_mix", "obs_grad"
_ENTER = torch.ops.profiler._record_function_enter_new.default
_EXIT = torch.ops.profiler._record_function_exit._RecordFunction


# ---------------------------------------------------------------------------
# Overlap verification: data dependence between the obs_grad / obs_mix ranges
# ---------------------------------------------------------------------------

def _tensors(tree) -> list:
    """The tensors in ``tree`` (nested lists, tuples and dicts)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


class _Taint(TorchDispatchMode):
    """The taint propagation of :func:`mix_depends_on_grad` over the ops a
    step dispatches.  Taint is kept per storage (a view shares its base's),
    keyed as :mod:`repro_torch.launch.dryrun` keys live storages: by the
    storage object, dropped by a weakref when the storage dies.

    * an op inside an ``obs_grad`` range taints what it writes: its new
      outputs and the arguments it mutates;
    * any other op reading a tainted storage taints what it writes, and
      inside an ``obs_mix`` range it makes the answer True; an op that
      reads nothing tainted clears the taint of its new outputs (a freed
      storage's memory may come back);
    * the current ranges come from the ``record_function`` enter and exit
      ops, which dispatch through the mode: an enter pushes its name, an
      exit pops the innermost (the exit's handle is a new Python object,
      so it cannot be matched to its enter by identity; the ranges are
      context managers and nest).

    A kernel launched through ctypes, or a wrapper's meta route, reads its
    input through no aten op, so the engine also hands every annotated call
    to :meth:`call` (``engine._annotated``), which treats the range
    atomically, as the reference treats an equation."""

    def __init__(self):
        super().__init__()
        self.tainted = {}
        self.open = []               # the open ranges' names, innermost last
        self.ranges = {MIX: 0, GRAD: 0}
        self.depends = False

    def _hot(self, t: torch.Tensor) -> bool:
        return id(t.untyped_storage()) in self.tainted

    def _taint(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key not in self.tainted:
            self.tainted[key] = weakref.ref(
                st, lambda _, k=key: self.tainted.pop(k, None))

    def _clear(self, t: torch.Tensor) -> None:
        self.tainted.pop(id(t.untyped_storage()), None)

    def call(self, name: str, args, result) -> None:
        """An annotated call of the engine, whole: a mix whose arguments
        are tainted depends on the grad and taints its results; a grad
        taints its results."""
        if name == MIX and any(self._hot(t) for t in _tensors(args)):
            self.depends = True
        elif name != GRAD:
            return
        for t in _tensors(result):
            self._taint(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func is _ENTER:
            self.open.append(args[0])
            if args[0] in self.ranges:
                self.ranges[args[0]] += 1
            return out
        if func is _EXIT:
            self.open.pop()
            return out
        schema = func._schema
        reads, writes = [], []
        for i, a in enumerate(schema.arguments):
            v = args[i] if i < len(args) else kwargs.get(a.name)
            ts = _tensors(v)
            if a.alias_info is not None and a.alias_info.is_write:
                writes += ts
            if not a.is_out:
                reads += ts
        hot = any(self._hot(t) for t in reads)
        if hot and MIX in self.open:
            self.depends = True
        taint = hot or GRAD in self.open
        if taint:
            for t in writes:
                self._taint(t)
        outs = _tensors(out)
        for t, r in zip(outs, schema.returns):
            if r.alias_info is not None:
                continue                   # a view, or a mutated argument
            if taint:
                self._taint(t)
            else:
                self._clear(t)
        return out


def mix_depends_on_grad(fn, *args, **kwargs) -> bool:
    """Whether any ``obs_mix`` range of ``fn(*args, **kwargs)`` (a step of
    either runtime) consumes a value produced under ``obs_grad``.

    The reference's taint propagation over a jaxpr's equations, here over
    the ops the step dispatches, in the order it runs them (see
    :class:`_Taint`): a value written under ``obs_grad`` is tainted, every
    op reading a tainted value taints what it writes, and an ``obs_mix``
    range reading one answers True.  Each engine range is also treated
    whole at its boundary, so a kernel the mode cannot see (a ctypes
    launch, a meta route) still counts.  False means the mix is data
    independent of the step's gradient (the ``delay > 0`` contract); True
    means it serializes after the grad (every synchronous rule whose mix
    payload holds the fresh update).  ``fn`` runs for real: on CPU
    tensors, or on meta tensors, where nothing executes and the verdict is
    the same."""
    return not overlap_report(fn, *args, **kwargs)["overlapped"]


def overlap_report(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` under the taint analysis and report
    whether its gossip mix is overlap-eligible:

    * ``overlapped`` — True when no ``obs_mix`` range depends on an
      ``obs_grad`` output (the stale-window contract);
    * ``mix_eqns`` / ``grad_eqns`` — the ``obs_mix`` / ``obs_grad`` ranges
      the step entered (the reference counts tagged equations; 0 for both
      means the function was not engine-annotated and the verdict is
      vacuous).

    ``fn`` consumes its arguments as a step does (the engine updates its
    state in place)."""
    from ..core import engine

    if engine._analysis is not None:
        raise RuntimeError("overlap_report does not nest")
    mode = _Taint()
    engine._analysis = mode
    try:
        with mode:
            fn(*args, **kwargs)
    finally:
        engine._analysis = None
    return {"overlapped": not mode.depends, "mix_eqns": mode.ranges[MIX],
            "grad_eqns": mode.ranges[GRAD]}


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
