"""Training driver: stages the gossip window on the device once, gathers
each step's window by index, warm-starts, and runs the loop — the port of
the dense path of the JAX package's ``core/driver.py``.

The staging contract is the reference's: one period of dense matrices
crosses to the device once, and step k gathers rounds
``(t + arange(wps)) % period`` with t advancing by ``wps`` per step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch


@dataclasses.dataclass(frozen=True)
class StagedGossip:
    """Device-resident gossip for a whole run: ``arrays`` is the
    (period, n, n) f32 stack; the bound step gathers ``wps`` rounds."""

    arrays: torch.Tensor
    period: int
    wps: int


def stage(schedule, *, wps: int, device="cpu") -> StagedGossip:
    """Stage one full period of ``schedule`` on ``device``."""
    period = schedule.period
    arrays = torch.from_numpy(schedule.stacked(0, period)).to(device)
    return StagedGossip(arrays, period, wps)


def bind_step(staged: StagedGossip, core_step):
    """``core_step(state, extra, Ws, t)`` with ``Ws`` the step's gathered
    (wps, n, n) window; returns ``step(state, extra, t)``."""
    offsets = torch.arange(staged.wps, device=staged.arrays.device)

    def step(state, extra, t):
        idx = (t + offsets) % staged.period
        return core_step(state, extra, staged.arrays[idx], t)

    return step


def restore_or_warm(state, *, restore: Optional[str] = None,
                    warm: Optional[Callable] = None):
    """``(state, start_step)``: the rule's warm start (checkpoint restore is
    not ported yet)."""
    if restore:
        raise NotImplementedError("checkpoint restore is not ported yet "
                                  "(ROADMAP.md Queue 1 item 10)")
    return (warm(state) if warm is not None else state), 0


def run_loop(step, state, *, steps: int, wps: int, period: int,
             start_step: int = 0, extra_fn: Optional[Callable] = None,
             record: Optional[Callable] = None, sync: Callable = lambda: None):
    """The training loop.  ``step(state, extra, t)``; ``t`` advances by
    ``wps`` per step, taken modulo ``period``.  ``extra_fn(k)`` supplies the
    per-step input; ``record(k, t, state, out, dt)`` runs after every step
    and its non-None returns form the history.  ``sync`` waits for the
    device, so ``dt`` is the step's time and not its enqueue."""
    history = []
    t = start_step * wps
    for k in range(start_step, start_step + steps):
        extra = extra_fn(k) if extra_fn is not None else None
        t0 = time.perf_counter()
        state, out = step(state, extra, t % period)
        sync()
        dt = time.perf_counter() - t0
        t += wps
        if record is not None:
            rec = record(k, t, state, out, dt)
            if rec is not None:
                history.append(rec)
    return state, history
