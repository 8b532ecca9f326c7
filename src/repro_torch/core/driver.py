"""Training driver: stages the gossip window on the device once, gathers
each step's window by index, warm-starts, and runs the loop — the port of
the JAX package's ``core/driver.py`` for dense windows and gossip plans.

The staging contract is the reference's: one period of dense matrices (or
an edge plan's tensors) crosses to the device once, and step k gathers
rounds ``(t + arange(wps)) % period`` with t advancing by ``wps`` per step.
:func:`run_algorithm` drives the host runtime (the paper's logistic
regression) on it; :func:`run_loop` also runs the checkpoint cadence and
the phase spans of :mod:`repro_torch.obs.trace`, and
:func:`restore_or_warm` restores a checkpoint or warm-starts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class StagedGossip:
    """Device-resident gossip for a whole run.  ``impl='dense'``:
    ``arrays`` is the (period, n, n) f32 stack and the bound step gathers
    ``wps`` rounds.  ``impl='auto'``: ``arrays`` is the staged plan's
    tensors, which the step receives with its start round ``t``."""

    arrays: object
    period: int
    wps: int
    impl: str = "dense"


def stage(schedule, *, wps: int, device="cpu", impl: str = "dense",
          total: Optional[int] = None, plan=None) -> StagedGossip:
    """Stage ``schedule`` on ``device`` once.  Dense: one full period, or
    ``min(period, total)`` rounds when ``total`` caps the window (a host
    run).  ``impl='auto'``: ``plan``'s tensors (default: one planned
    period).  The step's start round ``t`` is a host int either way, so
    the reference's ``static_t`` (a jit argument) has no counterpart."""
    if impl == "auto":
        if plan is None:
            plan = schedule.plan(0, schedule.period)
        return StagedGossip(stage_plan(plan, device=device), plan.period,
                            wps, "auto")
    period = schedule.period
    if total is not None:
        period = min(period, total)
    arrays = torch.from_numpy(schedule.stacked(0, period)).to(device)
    return StagedGossip(arrays, period, wps)


def stage_plan(plan, device="cpu") -> dict:
    """Upload a plan's :meth:`tensors` (a dense :class:`repro_torch.core.
    gossip.GossipPlan`'s or an edge plan's) to ``device`` once; the step's
    mixer indexes the returned dict by round."""
    return {k: torch.from_numpy(np.asarray(v)).to(device)
            for k, v in plan.tensors().items()}


def bind_step(staged: StagedGossip, core_step):
    """``core_step(state, extra, gossip, t)``: dense, ``gossip`` is the
    step's gathered (wps, n, n) window; auto, the staged plan tensors and
    ``t`` the start round.  Returns ``step(state, extra, t)``."""
    if staged.impl == "auto":
        return lambda state, extra, t: core_step(state, extra, staged.arrays,
                                                 t)
    offsets = torch.arange(staged.wps, device=staged.arrays.device)

    def step(state, extra, t):
        idx = (t + offsets) % staged.period
        return core_step(state, extra, staged.arrays[idx], t)

    return step


def restore_or_warm(state, *, restore: Optional[str] = None, load_fn=None,
                    warm: Optional[Callable] = None, spec=None):
    """Either restore ``(state, start_step)`` from a checkpoint with
    ``load_fn(restore, state)`` or apply the rule's warm start, never both
    (a checkpoint already holds warm state).  ``spec`` is the run's
    :class:`repro_torch.exp.ExperimentSpec` when the caller has one: a
    manifest written next to the checkpoint (``<restore>.spec.json``) that
    disagrees with it on a scenario field warns before the restore."""
    if restore:
        if spec is not None:
            from ..exp import manifest as _mf  # deferred: exp imports core
            _mf.check_restore_spec(restore, spec)
        state, start_step = load_fn(restore, state)
        return state, int(start_step)
    return (warm(state) if warm is not None else state), 0


def run_loop(step, state, *, steps: int, wps: int, period: int,
             start_step: int = 0, extra_fn: Optional[Callable] = None,
             record: Optional[Callable] = None, sync: Callable = lambda: None,
             checkpoint: Optional[str] = None, checkpoint_every: int = 50,
             save_fn=None, tracer=None):
    """The training loop.  ``step(state, extra, t)``; ``t`` advances by
    ``wps`` per step, taken modulo ``period``, from ``start_step * wps``, so
    a restored run resumes the schedule at its phase.  ``extra_fn(k)``
    supplies the per-step input; ``record(k, t, state, out, dt)`` runs after
    every step and its non-None returns form the history.  ``sync`` waits
    for the device, so ``dt`` is the step's time and not its enqueue.
    ``save_fn(path, state, step)`` writes ``checkpoint`` every
    ``checkpoint_every`` steps and once at the end.  ``tracer`` (a
    :class:`repro_torch.obs.trace.Tracer`) times each phase in a span:
    ``data`` (extra_fn), ``step`` (the step and the sync), ``telemetry``
    (the record hook) and ``checkpoint`` (save_fn)."""
    span = (tracer.span if tracer is not None
            else (lambda phase: contextlib.nullcontext()))
    history = []
    t = start_step * wps
    last = start_step + steps - 1
    for k in range(start_step, start_step + steps):
        with span("data"):
            extra = extra_fn(k) if extra_fn is not None else None
        t0 = time.perf_counter()
        with span("step"):
            state, out = step(state, extra, t % period)
            sync()
        dt = time.perf_counter() - t0
        t += wps
        if record is not None:
            with span("telemetry"):
                rec = record(k, t, state, out, dt)
            if rec is not None:
                history.append(rec)
        if checkpoint and save_fn is not None and \
                (k + 1) % checkpoint_every == 0 and k != last:
            with span("checkpoint"):
                save_fn(checkpoint, state, k + 1)
    if checkpoint and save_fn is not None:
        with span("checkpoint"):
            save_fn(checkpoint, state, start_step + steps)
    return state, history


def run_algorithm(algo, x0: torch.Tensor, grad_fn, weight_schedule,
                  num_steps: int, gen: torch.Generator, eval_fn=None,
                  eval_every: int = 1, gossip_impl: str = "dense", plan=None,
                  telemetry=None, obs: tuple = (), tracer=None):
    """Drive a host :class:`repro_torch.core.algorithms.
    DecentralizedAlgorithm` from ``x0`` (n, d) over a weight schedule.

    ``gossip_impl='dense'`` stages one window of dense matrices; ``'auto'``
    lowers the schedule to its plan (``plan`` overrides the default
    one-period plan), a dense :class:`repro_torch.core.gossip.GossipPlan`
    or an edge plan, stages its tensors once and mixes through
    :func:`repro_torch.core.algorithms.plan_step`.  ``gen`` is the
    ``torch.Generator`` every oracle sample draws from (warm start first,
    then each step in order), on ``x0``'s device; the JAX package's
    ``jax.random`` key cannot be replayed in torch.  ``telemetry`` is
    anything with the ``record(k, t, state, out, dt)`` hook, called every
    step (a :class:`repro_torch.obs.metrics.ObsRecorder` too: when it has
    ``eval_event(k, t, value)``, every recorded ``eval_fn`` point goes to
    it).  ``obs`` names the engine's in-step scalars, which reach the hook
    as ``out["obs"]``; ``tracer`` times the loop's phases
    (:func:`run_loop`).

    Returns (final_state, history): ``eval_fn`` of the node-mean model x̄
    every ``eval_every`` steps (plus the final step) as ``(T, value)``
    pairs, T the gossip/oracle budget consumed so far (the paper's Figure 2
    x-axis).  Step times end in ``torch.cuda.synchronize`` on a CUDA
    device."""
    state = algo.init(x0)
    state = algo.warm(state, grad_fn, gen)
    wps = algo.weights_per_step
    obs = tuple(obs)

    def out(res):
        return (res[0], {"obs": res[1]}) if obs else (res, None)

    if gossip_impl == "auto":
        from . import algorithms as alg  # deferred, as in the reference
        if plan is None:
            plan = weight_schedule.plan(0, weight_schedule.period)
        pstep = alg.plan_step(algo, plan)
        staged = stage(weight_schedule, wps=wps, device=x0.device,
                       impl="auto", plan=plan)
        step = bind_step(staged, lambda state, extra, tensors, t: out(
            pstep(state, grad_fn, tensors, t, gen, obs=obs)))
    else:
        staged = stage(weight_schedule, wps=wps, device=x0.device,
                       total=max(1, num_steps * wps))
        step = bind_step(staged, lambda state, extra, Ws, t: out(
            algo.step(state, grad_fn, Ws, gen, obs=obs)))

    def record(k, t, state, out, dt):
        if telemetry is not None:
            telemetry.record(k, t, state, out, dt)
        if eval_fn is None:
            return None
        if k % eval_every == 0 or k == num_steps - 1:
            val = float(eval_fn(state.x.mean(dim=0)))
            if hasattr(telemetry, "eval_event"):
                telemetry.eval_event(k, t, val)
            return (t, val)
        return None

    sync = ((lambda: torch.cuda.synchronize(x0.device))
            if x0.device.type == "cuda" else (lambda: None))
    return run_loop(step, state, steps=num_steps, wps=wps,
                    period=staged.period, record=record, sync=sync,
                    tracer=tracer)
