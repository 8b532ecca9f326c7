"""Local optimizer transforms (init/update pairs) for the decentralized
rules' local update, the port of the JAX package's ``optim/optimizers.py``.
The paper's rules descend on γ·g (or γ·h); momentum and adam are the
framework's extensions.

The state is the flat (n, D) node-stacked matrix, and the optimizer state
lives beside it: ``update(g, state) -> (update, state)`` updates momentum's
buffer and adam's moments IN PLACE (the engine owns its state, and at
qwen1.5-0.5b's full width each moment is a 7.4 GB tensor).  Momentum's
update is its buffer itself; adam's is one new (n, D) tensor, built a row at
a time so that no second temporary of the state's size is made.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], Any]
    update: Callable[[torch.Tensor, Any], tuple]  # (g, state) -> (upd, state)


def sgd() -> Optimizer:
    return Optimizer(lambda p: None, lambda g, s: (g, s))


def momentum(beta: float = 0.9) -> Optimizer:
    def init(params):
        return torch.zeros_like(params)

    def update(g, m):
        m.mul_(beta).add_(g)          # m <- beta m + g
        return m, m

    return Optimizer(init, update)


def adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    def init(params):
        return {"m": torch.zeros_like(params), "v": torch.zeros_like(params),
                "t": 0}

    def update(g, s):
        t = s["t"] + 1
        m, v = s["m"], s["v"]
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        # the bias corrections in f32, as the reference computes them from
        # its int32 step count
        c1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
        c2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
        upd = torch.empty_like(m)
        for mi, vi, ui in zip(m, v, upd):
            den = torch.div(vi, c2).sqrt_().add_(eps)
            torch.div(mi, c1, out=ui).div_(den)
        return upd, {"m": m, "v": v, "t": t}

    return Optimizer(init, update)
