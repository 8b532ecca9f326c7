"""Gossip primitives and the host runtime's algorithm layer, the port of the
JAX package's ``core/algorithms.py``.

The dense mixers (:func:`mix`, :func:`multi_consensus`) are the
``gossip_impl="dense"`` path: one matrix product per round.  The arch
trainer's ``"pallas"`` path fuses all R rounds into the Hopper
``gossip_mix`` kernel (:func:`repro_torch.dist.collectives.fused_multi_consensus`).
:func:`sparse_mix` is one edge-list round (Laplacian form), the scatter
route of a :class:`repro_torch.sparse.SparseGossipPlan`.

:func:`from_rule` and :func:`plan_step` bind an engine
:class:`~repro_torch.core.engine.UpdateRule` to the host runtime (the
paper's logistic regression, :func:`run` / :func:`repro_torch.core.driver.
run_algorithm`): a ``grad_fn(x, gen)`` oracle, which draws its samples from
the ``torch.Generator`` ``gen``, and the step's dense weight window or a
staged edge plan, either one behind the error-feedback compressed window
when the rule compresses.  :func:`dsgd`, :func:`dsgt` and :func:`mc_dsgt`
are the paper's three rules (Table 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import compress, driver, engine

GradFn = Callable[[torch.Tensor, torch.Generator], torch.Tensor]


def mix(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """z_i = sum_j W[i, j] x_j (partial-averaging protocol)."""
    return W.to(x.dtype) @ x


def multi_consensus(Ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: apply W^{t1}, ..., W^{t2-1} in sequence; ``Ws`` is the
    (R, n, n) stack for the window [t1, t2)."""
    for r in range(Ws.shape[0]):
        x = mix(Ws[r], x)
    return x


def node_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=0, keepdim=True)


def broadcast_nodes(flat: torch.Tensor, n: int) -> torch.Tensor:
    """n identical copies of a flat (D,) model as an (n, D) matrix."""
    return flat[None].expand(n, -1).clone()


def sparse_mix(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
               x: torch.Tensor) -> torch.Tensor:
    """Edge-list gossip in Laplacian form (see :mod:`repro_torch.sparse.plan`):
    ``x[dst] += w * (x[src] - x[dst])`` over the round's edges, one gather
    and one scatter-add of O(edges) rows.  The contributions are taken from
    the round's input before any is added, as in the JAX package's
    out-of-place scatter, but the add updates ``x`` IN PLACE (returned): a
    copy would read and write all n rows for the few a round touches.
    Padded edges with ``w = 0`` add exactly zero."""
    wx = w.to(x.dtype).reshape((-1,) + (1,) * (x.dim() - 1))
    contrib = wx * (x.index_select(0, src) - x.index_select(0, dst))
    return x.index_add_(0, dst, contrib)


# ---------------------------------------------------------------------------
# The host runtime's algorithm layer (thin adapters over the engine)
# ---------------------------------------------------------------------------

# The host layer's state is the engine's: x, h, g_prev, k and the
# compression residuals.  The JAX package's AlgoState also carries the local
# optimizer's state and the delay queues, which come with ROADMAP.md Queue 1
# items 2 and 7.
AlgoState = engine.EngineState


def state_from_arrays(x, h=None, g_prev=None, k: int = 0, *,
                      device="cpu") -> AlgoState:
    """The port's state from the JAX package's logreg ``AlgoState`` fields as
    numpy arrays (x, h, g_prev: (n, d); k the round counter), copied to
    ``device`` in f32, so both packages can continue from one mid-run
    state."""
    def t(a):
        return None if a is None else torch.tensor(
            np.asarray(a, np.float32), device=device)
    return AlgoState(x=t(x), h=t(h), g_prev=t(g_prev), k=int(k))


def _accumulate(grad_fn: GradFn, x: torch.Tensor, gen: torch.Generator,
                R: int, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Gradient accumulation (1/R) sum_r O(x; zeta_r) (eq. 19): R oracle
    samples, each drawing from ``gen``, summed in the reference's order and
    written into ``out`` when given."""
    g = grad_fn(x, gen)
    acc = g if out is None else out.copy_(g)
    for _ in range(R - 1):
        acc.add_(grad_fn(x, gen))
    return acc if R == 1 else acc.div_(R)


@dataclasses.dataclass(frozen=True)
class DecentralizedAlgorithm:
    """A decentralized optimizer on the host runtime: ``step(state,
    grad_fn, weights, gen)`` with ``weights`` the (weights_per_step, n, n)
    stack of gossip matrices the step consumes.  Built from an engine
    :class:`~repro_torch.core.engine.UpdateRule` by :func:`from_rule`; the
    update arithmetic lives in the engine."""

    name: str
    weights_per_step: int
    init: Callable[[torch.Tensor], AlgoState]
    step: Callable[..., AlgoState]
    warm: Callable[..., AlgoState] = None
    rule: "engine.UpdateRule" = None


def _grad_op(rule: engine.UpdateRule, grad_fn: GradFn,
             gen: torch.Generator):
    return lambda x, out=None: (None, _accumulate(grad_fn, x, gen, rule.R,
                                                  out))


def from_rule(rule: engine.UpdateRule) -> DecentralizedAlgorithm:
    """Bind an UpdateRule to the host runtime: the dense multi-consensus
    mixer over the step's weight window and a ``grad_fn(x, gen)`` oracle.
    A compressing rule mixes through the error-feedback window
    (:func:`repro_torch.core.compress.make_compressed_mixer`) around one
    window matrix per round.  ``init(x0)`` copies ``x0``: the engine updates
    its state in place, and the caller's tensor must survive the run.  (The
    reference's local optimizer hook comes with ROADMAP.md Queue 1 item
    2.)"""

    def _ops(grad_fn, weights, gen):
        cmix = None
        if rule.compression is not None:
            cmix = compress.make_compressed_mixer(
                lambda idx, m: mix(weights[idx], m), rule.compression)
        return engine.EngineOps(
            mix=lambda off, r, x: multi_consensus(weights[off:off + r], x),
            grad=_grad_op(rule, grad_fn, gen), cmix=cmix)

    def init(x0: torch.Tensor) -> AlgoState:
        return engine.init_state(rule, x0.clone())

    def step(state: AlgoState, grad_fn: GradFn, weights: torch.Tensor,
             gen: torch.Generator) -> AlgoState:
        return engine.step(rule, state, _ops(grad_fn, weights, gen))[0]

    def warm(state: AlgoState, grad_fn: GradFn,
             gen: torch.Generator) -> AlgoState:
        return engine.warm_start(rule, state, _ops(grad_fn, None, gen))

    return DecentralizedAlgorithm(rule.name, rule.weights_per_step, init,
                                  step, warm, rule)


def plan_step(algo: DecentralizedAlgorithm, plan):
    """Bind ``algo``'s update rule to a staged edge plan (a
    :class:`repro_torch.sparse.SparseGossipPlan`, or anything with its
    ``make_mixer``).  Returns ``step(state, grad_fn, tensors, t, gen)``
    where ``tensors`` is the plan staged on the device once
    (:func:`repro_torch.core.driver.stage_plan`) and ``t`` the host start
    round.  A dense :class:`repro_torch.core.gossip.GossipPlan` raises: its
    staging and structured mixers are not ported yet."""
    rule = algo.rule
    if rule is None:
        raise ValueError("plan_step requires an engine-rule algorithm "
                         "(built via from_rule)")
    if not hasattr(plan, "make_mixer"):
        raise NotImplementedError("dense GossipPlan mixing (gossip_impl="
                                  "'auto' off the edge-list topologies) is "
                                  "not ported yet (ROADMAP.md Queue 1 item 3)")
    mixer = plan.make_mixer()

    def pstep(state: AlgoState, grad_fn: GradFn, tensors, t: int,
              gen: torch.Generator) -> AlgoState:
        cmix = None
        if rule.compression is not None:
            cmix = compress.make_compressed_mixer(
                lambda idx, m: mixer(tensors, t + idx, 1, m),
                rule.compression)
        ops = engine.EngineOps(
            mix=lambda off, r, x: mixer(tensors, t + off, r, x),
            grad=_grad_op(rule, grad_fn, gen), cmix=cmix)
        return engine.step(rule, state, ops)[0]

    return pstep


# -- The paper's rules, one line each (Table 1). --

def dsgd(gamma: float) -> DecentralizedAlgorithm:
    """DSGD [12]: x^{k+1} = W^k (x^k - gamma * g^k)."""
    return from_rule(engine.make_rule("dsgd", gamma))


def dsgt(gamma: float) -> DecentralizedAlgorithm:
    """DSGT [40]: x^{k+1} = W (x^k - gamma h^k);
    h^{k+1} = W (h^k + g^{k+1} - g^k).  Two gossip rounds per step."""
    return from_rule(engine.make_rule("dsgt", gamma))


def mc_dsgt(gamma: float, R: int) -> DecentralizedAlgorithm:
    """Multi-Consensus DSGT (Algorithm 1): R-sample gradient accumulation
    and R gossip rounds per consensus phase; ``weights`` is the (2R, n, n)
    stack [W^{2kR}, ..., W^{(2k+2)R - 1}] (first R mix x, last R mix h)."""
    return from_rule(engine.make_rule("mc_dsgt", gamma, R=R))


def _item2(name: str):
    def factory(*args, **kwargs):
        raise NotImplementedError(f"algo {name!r} is not ported yet "
                                  "(ROADMAP.md Queue 1 item 2)")
    factory.__name__ = name
    return factory


# the reference's other factories come with their update rules
d2, local_sgd, personalized, gt_local = map(
    _item2, ("d2", "local_sgd", "personalized", "gt_local"))


def warm_start(algo: DecentralizedAlgorithm, state: AlgoState,
               grad_fn: GradFn, gen: torch.Generator) -> AlgoState:
    """Tracker initialization (Algorithm 1's h^0 for the tracking rules)
    -- delegates to the engine."""
    return algo.warm(state, grad_fn, gen)


def run(algo: DecentralizedAlgorithm, x0: torch.Tensor, grad_fn: GradFn,
        weight_schedule, num_steps: int, gen: torch.Generator,
        eval_fn: Optional[Callable] = None, eval_every: int = 1,
        gossip_impl: str = "dense", telemetry=None):
    """Host training loop over a weight schedule, the reference's
    ``algorithms.run`` with a ``torch.Generator`` where it takes a key:
    delegates to :func:`repro_torch.core.driver.run_algorithm`.  Returns
    (final_state, history), history the ``(T, eval_fn(x̄))`` pairs every
    ``eval_every`` steps and at the last, T the gossip/oracle budget
    consumed so far (the paper's Figure 2 x-axis)."""
    return driver.run_algorithm(algo, x0, grad_fn, weight_schedule,
                                num_steps, gen, eval_fn=eval_fn,
                                eval_every=eval_every,
                                gossip_impl=gossip_impl, telemetry=telemetry)
