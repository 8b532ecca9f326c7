"""Single-source decentralized update-rule engine, the port of the JAX
package's ``core/engine.py`` for the ``sgd`` and ``tracking`` kinds.

An :class:`UpdateRule` names a rule's structure and one generic :func:`step`
interprets it, with the runtime's gossip and oracle bound in
:class:`EngineOps` (γ = stepsize, Mix = the step's gossip window, R =
accumulation/consensus rounds):

============  =========================================================
``dsgd``      x ← Mix(x − γ·g(x))                           [12]
``dsgt``      x ← Mix(x − γ·h);  h ← Mix(h + g − g⁻)        [40]
``mc_dsgt``   same, R gossip rounds per mix + R-sample grads (Alg. 1)
============  =========================================================

A rule may carry a :class:`~repro_torch.core.compress.CompressionConfig`:
every mix then goes through the runtime's compressed window ``cmix``, which
threads one error-feedback residual per gossiped stream (``EngineState.res``
= (res_x, res_h)), at full precision while ``k < warmup``.

State tensors are node-stacked flat matrices, (n, D) each.  Unlike the JAX
engine, which is pure, :func:`step` updates ``x`` and ``h`` in place and
returns a state holding the same storage (the new oracle sample lands in
g_prev's buffer): at qwen1.5-0.5b's full width each is 7.4 GB, and a
functional update would hold two copies of each.  Callers must not reuse a
state they passed in.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch

from . import compress

# The JAX package's rule vocabulary; the rules after the first three are
# ported with ROADMAP.md Queue 1 item 2.
ALGORITHMS = ("dsgd", "local_sgd", "dsgt", "mc_dsgt", "gt_local", "d2",
              "personalized")
_KINDS = {"dsgd": "sgd", "dsgt": "tracking", "mc_dsgt": "tracking"}


class EngineState(NamedTuple):
    """``x`` (n, D) iterates; ``h`` the gradient tracker and ``g_prev`` the
    previous oracle sample (tracking rules, set by :func:`warm_start`;
    None otherwise); ``k`` the round counter; ``res`` the error-feedback
    residuals (res_x, res_h) of a compressing rule (res_h None for sgd
    rules), None otherwise."""

    x: torch.Tensor
    h: Optional[torch.Tensor]
    g_prev: Optional[torch.Tensor]
    k: int
    res: Optional[tuple] = None


class EngineOps(NamedTuple):
    """What a runtime provides for the generic step.

    mix(offset, rounds, x)
        Apply gossip rounds [offset, offset+rounds) of the step's window to
        the (n, D) matrix ``x``; may mix in place and return ``x``.
    grad(x, out=None) -> (metrics, g)
        One accumulated stochastic-oracle sample per node (Assumption 2),
        an (n, D) matrix, written into ``out`` when given (its old values
        are discarded); ``metrics`` is runtime-defined.
    cmix(offset, rounds, x, res, on) -> (x, res)
        The compressed window for a rule that carries compression: like
        ``mix`` on the quantized payload, threading the stream's residual
        ``res``; ``on`` False (warmup) mixes at full precision and leaves
        ``res`` as it was.
    """

    mix: Callable[[int, int, torch.Tensor], torch.Tensor]
    grad: Callable[..., Tuple[Any, torch.Tensor]]
    cmix: Optional[Callable] = None


@dataclasses.dataclass(frozen=True)
class UpdateRule:
    """``kind``: ``sgd`` (descend on the fresh gradient) or ``tracking``
    (descend on the tracker h, h⁰ = node mean of g⁰, the correction mixed
    with h: h ← Mix(h + g − g⁻), x and h on disjoint R-round windows).
    ``compression``: quantize every gossip payload (None = full f32)."""

    name: str
    kind: str
    gamma: float
    R: int = 1
    compression: Optional[compress.CompressionConfig] = None

    @property
    def uses_tracker(self) -> bool:
        return self.kind == "tracking"

    @property
    def weights_per_step(self) -> int:
        """Gossip rounds one step consumes (the paper's budget accounting)."""
        return 2 * self.R if self.kind == "tracking" else self.R


def make_rule(name: str, gamma: float, R: int = 1,
              compression: Optional[compress.CompressionConfig] = None
              ) -> UpdateRule:
    if name not in ALGORITHMS:
        raise ValueError(f"unknown algo {name!r} (have {sorted(ALGORITHMS)})")
    if name not in _KINDS:
        raise NotImplementedError(f"algo {name!r} is not ported yet (have "
                                  f"{sorted(_KINDS)}; ROADMAP.md Queue 1 "
                                  "item 2)")
    if name == "dsgt" and R != 1:
        raise ValueError(f"{name} uses R=1 (MC-DSGT is the R-round variant)")
    return UpdateRule(name=name, kind=_KINDS[name], gamma=gamma, R=R,
                      compression=compression)


def init_state(rule: UpdateRule, x0: torch.Tensor) -> EngineState:
    """Fresh state at the (n, D) iterate ``x0``: h and g_prev wait for
    :func:`warm_start`; a compressing rule gets zeroed residuals."""
    res = (compress.init_residual(x0, rule.uses_tracker)
           if rule.compression is not None else None)
    return EngineState(x=x0, h=None, g_prev=None, k=0, res=res)


def step(rule: UpdateRule, state: EngineState,
         ops: EngineOps) -> Tuple[EngineState, Any]:
    """One round of ``rule``: (new state, runtime metrics).  Consumes
    ``state``: its x and h (and residuals) are updated in place."""
    gamma, R = rule.gamma, rule.R
    comp = rule.compression
    res = None
    if comp is not None:
        if ops.cmix is None:
            raise ValueError(f"rule {rule.name!r} carries compression but "
                             "the runtime provided no EngineOps.cmix")
        if state.res is None:
            raise ValueError("compression needs residual state: "
                             "init_state materializes EngineState.res")
        res = list(state.res)
    new_res = lambda: None if res is None else tuple(res)  # noqa: E731

    def mix(stream, off, r, mat):
        """Mix window of ``stream`` (0 = x, 1 = h): compressed with that
        stream's residual when the rule compresses, at full precision while
        k < warmup (the gate is a host bool)."""
        if comp is None:
            return ops.mix(off, r, mat)
        mat, res[stream] = ops.cmix(off, r, mat, res[stream],
                                    state.k >= comp.warmup)
        return mat

    if rule.kind == "sgd":
        metrics, g = ops.grad(state.x)
        x = mix(0, 0, R, state.x.add_(g, alpha=-gamma))
        return state._replace(x=x, k=state.k + 1, res=new_res()), metrics

    if state.h is None:
        raise ValueError("call warm_start first (h requires g at x0)")
    x = mix(0, 0, R, state.x.add_(state.h, alpha=-gamma))
    # h + g − g⁻ taken as (h − g⁻) + g: g⁻ leaves h before the new sample
    # overwrites g⁻'s buffer, so the step holds three (n, D) tensors, not four
    h = state.h.sub_(state.g_prev)
    metrics, g = ops.grad(x, state.g_prev)
    h = mix(1, R, R, h.add_(g))
    return EngineState(x=x, h=h, g_prev=g, k=state.k + 1,
                       res=new_res()), metrics


def warm_start(rule: UpdateRule, state: EngineState,
               ops: EngineOps) -> EngineState:
    """Tracker initialization: sgd rules need none; tracking rules query the
    oracle at x⁰ and set h⁰ to the node mean of g⁰ on every node (Algorithm
    1), g⁻ = g⁰."""
    if rule.kind == "sgd":
        return state
    _, g0 = ops.grad(state.x)
    h0 = g0.mean(dim=0, keepdim=True).expand_as(g0).clone()
    return state._replace(h=h0, g_prev=g0)
