"""Gossip primitives and the host runtime's algorithm layer, the port of the
JAX package's ``core/algorithms.py``.

The dense mixers (:func:`mix`, :func:`multi_consensus`) are the
``gossip_impl="dense"`` path: one matrix product per round.  The arch
trainer's ``"pallas"`` path fuses all R rounds into the Hopper
``gossip_mix`` kernel (:func:`repro_torch.dist.collectives.fused_multi_consensus`).
The structured mixers (:func:`sun_mix`, :func:`one_peer_mix`,
:func:`complete_mix`, :func:`two_level_mix`, :func:`sparse_mix`) are the
lowerings of a :class:`repro_torch.core.gossip.GossipPlan`'s round kinds,
and :func:`make_plan_mixer` dispatches a staged plan's rounds to them
(``gossip_impl="auto"``).  Each works on the flat (n, D) node-stacked
tensor, writes one output (in place where the round allows it) and makes
no second temporary of the state's size.

:func:`from_rule` and :func:`plan_step` bind an engine
:class:`~repro_torch.core.engine.UpdateRule` to the host runtime (the
paper's logistic regression, :func:`run` / :func:`repro_torch.core.driver.
run_algorithm`): a ``grad_fn(x, gen)`` oracle, which draws its samples from
the ``torch.Generator`` ``gen``, and the step's dense weight window or a
staged plan, either one behind the error-feedback compressed window when
the rule compresses.  :func:`dsgd`, :func:`dsgt` and :func:`mc_dsgt` are
the paper's three rules (Table 1); :func:`d2`, :func:`local_sgd`,
:func:`gt_local` and :func:`personalized` the D² baseline and the
federated/local-update family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

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


def sun_mix(center_mask: torch.Tensor, delta, x: torch.Tensor
            ) -> torch.Tensor:
    """Structured gossip for sun-shaped graphs, W = I − (δ/n) L(S_{n,C}),
    as two node-axis sums and elementwise ops (the reference's formula):

        rim i:    z_i = x_i − (δ/n) k x_i + (δ/n) Σ_{c∈C} x_c
        center c: z_c = x_c − (δ/n) n x_c + (δ/n) Σ_j x_j

    ``center_mask`` (n,) 0/1; ``delta`` a float or a 0-d tensor (a staged
    plan's), taken in ``x``'s dtype either way, so the sun impl and a plan
    round agree bit for bit.  Mixes ``x`` IN PLACE (returned); the
    temporaries are (D,) vectors."""
    n = x.shape[0]
    m = center_mask.to(device=x.device, dtype=x.dtype)
    c = torch.as_tensor(delta, dtype=x.dtype, device=x.device) / n
    k = m.sum()
    St = x.sum(dim=0)
    Sc = m @ x
    degp = k + (n - k) * m
    x.addcmul_(x, (-c * degp)[:, None])
    x.add_(Sc * c)
    return x.addcmul_((c * m)[:, None], (St - Sc)[None])


def sun_multi_consensus(center_masks: torch.Tensor, delta,
                        x: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 on a sun-shaped schedule: R structured mixings;
    ``center_masks`` (R, n)."""
    for r in range(center_masks.shape[0]):
        x = sun_mix(center_masks[r], delta, x)
    return x


def one_peer_mix(peer, w_peer, x: torch.Tensor) -> torch.Tensor:
    """Gossip over a matching: z_i = (1 − w_i) x_i + w_i x_{peer(i)}.
    ``peer`` is the (n,) involution, ``w_peer`` a scalar or an (n,)
    per-node weight (host arrays, or tensors, read to the host once).
    Mixes ``x`` IN PLACE pair by pair (returned): each matched pair (i, j)
    keeps one (D,) copy of row i while both rows are rewritten, so the mix
    holds no second (n, D) tensor.  Unmatched nodes (peer(i) = i) and
    zero-weight pairs are left as they are."""
    perm = (peer.tolist() if torch.is_tensor(peer)
            else np.asarray(peer).tolist())
    n = len(perm)
    w = (w_peer.tolist() if torch.is_tensor(w_peer)
         else np.asarray(w_peer, np.float32).tolist())
    if not isinstance(w, list):
        w = [w] * n
    for i, j in enumerate(perm):
        if j <= i or (w[i] == 0.0 and w[j] == 0.0):
            continue
        xi = x[i].clone()
        x[i].mul_(1.0 - w[i]).add_(x[j], alpha=w[i])
        x[j].mul_(1.0 - w[j]).add_(xi, alpha=w[j])
    return x


def complete_mix(avg_weight, x: torch.Tensor) -> torch.Tensor:
    """Gossip on the complete graph, W = (1 − a) I + a 11ᵀ/n: z = (1 − a) x
    + a x̄, in place (one (D,) temporary, the mean)."""
    a = torch.as_tensor(avg_weight, dtype=x.dtype, device=x.device)
    xbar = x.mean(dim=0, keepdim=True)
    return x.mul_(1.0 - a).add_(a * xbar)


def two_level_mix(B: torch.Tensor, pods: int, x: torch.Tensor
                  ) -> torch.Tensor:
    """Hierarchical gossip for W = B ⊗ J_p (pod-major order, p = ``pods``
    nodes a pod, m = n/p pods): the intra-pod mean, the (m, m) inter-pod
    exchange on the pod means, broadcast back into ``x`` in place.  The
    temporaries are (m, D), m < n."""
    n = x.shape[0]
    xp = x.view((n // pods, pods) + tuple(x.shape[1:]))
    pod_mean = xp.mean(dim=1)
    mixed = B.to(device=x.device, dtype=x.dtype) @ pod_mean.reshape(
        pod_mean.shape[0], -1)
    xp.copy_(mixed.reshape(pod_mean.shape)[:, None])
    return x


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
# Planned gossip: a staged GossipPlan's rounds, each to its lowering
# ---------------------------------------------------------------------------

def make_plan_mixer(plan, *, mode: Optional[str] = None, dense_block=None):
    """Build ``mix_fn(tensors, t0, rounds, x)`` applying rounds [t0,
    t0+rounds) of a :class:`repro_torch.core.gossip.GossipPlan` to the (n,
    D) state ``x`` (mixed in place where the round's lowering allows it;
    use the returned tensor).  ``tensors`` is ``plan.tensors()`` staged on
    the device once (:func:`repro_torch.core.driver.stage_plan`); ``t0`` is
    a host int, taken modulo the period.

    Two dispatch modes, the reference's (default: ``plan.dispatch``):

    * ``dynamic`` — a kind-uniform plan: the rounds' parameters are
      gathered from the staged tensors by ``(t0 + arange(rounds)) % P``
      on the device, then applied one round at a time (a matching's pairs
      from the plan's host copy of the same rounds); a mixed plan raises
      ValueError;
    * ``static`` — consecutive rounds of one kind are grouped from the
      plan's host copy; ``empty`` rounds cost nothing (no launch, no copy).

    ``dense_block(Ws, x)`` mixes each run of consecutive ``dense`` (or
    ``personalized``, whose row-stochastic prior mixes as-is) rounds, Ws
    their (r, n, n) stack; the default is :func:`multi_consensus` (one
    ``W @ x`` a round).  The arch trainer passes the fused Hopper
    ``gossip_mix`` (``auto_dense='pallas'``).  The reference's ``mesh`` /
    ``axis`` (the ppermute matching lowering) have no counterpart on one
    device: matchings take :func:`one_peer_mix`, what the reference runs
    without a mesh."""
    P = plan.period
    kinds = plan.kinds
    if mode is None:
        mode = plan.dispatch
    if mode == "dynamic" and len(set(kinds)) != 1:
        raise ValueError("dynamic plan dispatch requires a kind-uniform plan; "
                         f"got {sorted(set(kinds))}")
    dense = dense_block or multi_consensus

    def _apply_uniform(kind, tensors, start, count, x):
        """Rounds (start + q) % P, q < count, all of ``kind``."""
        if kind == "empty":
            return x
        idx = (start + torch.arange(count, device=x.device)) % P

        def take(key):
            return tensors[key].index_select(0, idx.to(tensors[key].device))

        if kind == "dense":
            return dense(take("W"), x)
        if kind == "personalized":
            # the base support; a personalized rule's realized mix goes
            # through EngineOps.pmix (the loss reweighting)
            return dense(take("pW"), x)
        if kind == "two_level":
            Bs = take("pod_B")
            rnd = lambda r, z: two_level_mix(Bs[r], plan.pods, z)  # noqa: E731
        elif kind == "sun":
            masks, deltas = take("center_mask"), take("delta")
            rnd = lambda r, z: sun_mix(masks[r], deltas[r], z)  # noqa: E731
        elif kind == "complete":
            avg = take("avg_w")
            rnd = lambda r, z: complete_mix(avg[r], z)  # noqa: E731
        elif kind == "sparse":
            src, dst = take("esrc").long(), take("edst").long()
            ew = take("ew")
            rnd = lambda r, z: sparse_mix(src[r], dst[r], ew[r], z)  # noqa: E731
        elif kind == "matching":
            # the pairs are taken from the plan's host copy of the round:
            # the in-place lowering pairs rows on the host, and the staged
            # perm would have to cross back every round
            idxs = [(start + q) % P for q in range(count)]
            rnd = lambda r, z: one_peer_mix(  # noqa: E731
                plan.rounds[idxs[r]].perm, plan.rounds[idxs[r]].w_peer, z)
        else:
            raise ValueError(f"unknown plan round kind {kind!r}")
        for r in range(count):
            x = rnd(r, x)
        return x

    def _apply_static(tensors, t0, rounds, x):
        t0 = int(t0)
        r = 0
        while r < rounds:  # group consecutive same-kind rounds
            kind = plan.rounds[(t0 + r) % P].kind
            stop = r
            while stop < rounds and plan.rounds[(t0 + stop) % P].kind == kind:
                stop += 1
            x = _apply_uniform(kind, tensors, t0 + r, stop - r, x)
            r = stop
        return x

    def _apply_dynamic(tensors, t0, rounds, x):
        return _apply_uniform(kinds[0], tensors, int(t0), rounds, x)

    fn = _apply_static if mode == "static" else _apply_dynamic
    fn.dispatch = mode
    return fn


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

# The host layer's state is the engine's: x, h, g_prev, k, the compression
# residuals, the local optimizer's state (``opt``, also read as the
# reference's ``opt_state``) and a delayed rule's stale payloads (``buf``).
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
    local_opt: Any = None


def _grad_op(rule: engine.UpdateRule, grad_fn: GradFn,
             gen: torch.Generator):
    """The engine's oracle: R accumulated samples, or, for a personalized
    rule, ``grad_fn(x, gen) -> (per-node losses, g)`` as it is (the
    reference's personalized oracle contract)."""
    if rule.personalized:
        return lambda x, out=None: grad_fn(x, gen)
    return lambda x, out=None: (None, _accumulate(grad_fn, x, gen, rule.R,
                                                  out))


def from_rule(rule: engine.UpdateRule, local_opt=None
              ) -> DecentralizedAlgorithm:
    """Bind an UpdateRule to the host runtime: the dense multi-consensus
    mixer over the step's weight window and a ``grad_fn(x, gen)`` oracle.
    A compressing rule mixes through the error-feedback window
    (:func:`repro_torch.core.compress.make_compressed_mixer`) around one
    window matrix per round; a personalized rule reweights the window by
    the oracle's per-node losses.  ``local_opt`` is an
    :class:`repro_torch.optim.Optimizer` (None: the paper's update).
    ``init(x0)`` copies ``x0``: the engine updates its state in place, and
    the caller's tensor must survive the run."""
    if local_opt is not None and not rule.supports_local_opt:
        raise ValueError(f"algo {rule.name!r} does not support a local "
                         "optimizer hook")

    def _ops(grad_fn, weights, gen):
        cmix = pmix = None
        if rule.compression is not None:
            cmix = compress.make_compressed_mixer(
                lambda idx, m: mix(weights[idx], m), rule.compression)
        if rule.personalized:
            pmix = lambda off, r, x, losses: multi_consensus(  # noqa: E731
                engine.personalized_weights(weights[off:off + r], losses,
                                            rule.tau), x)
        return engine.EngineOps(
            mix=lambda off, r, x: multi_consensus(weights[off:off + r], x),
            grad=_grad_op(rule, grad_fn, gen), cmix=cmix,
            local_update=local_opt.update if local_opt else None, pmix=pmix)

    def init(x0: torch.Tensor) -> AlgoState:
        return engine.init_state(
            rule, x0.clone(), opt_init=local_opt.init if local_opt else None)

    def step(state: AlgoState, grad_fn: GradFn, weights: torch.Tensor,
             gen: torch.Generator, obs: tuple = ()) -> AlgoState:
        """One round; with ``obs`` metric names (repro_torch.obs), returns
        ``(state, obs_dict)``, the engine's in-step scalars."""
        es, aux = engine.step(rule, state, _ops(grad_fn, weights, gen),
                              obs=obs)
        return (es, aux[1]) if obs else es

    def warm(state: AlgoState, grad_fn: GradFn,
             gen: torch.Generator) -> AlgoState:
        return engine.warm_start(rule, state, _ops(grad_fn, None, gen))

    return DecentralizedAlgorithm(rule.name, rule.weights_per_step, init,
                                  step, warm, rule, local_opt)


def plan_step(algo: DecentralizedAlgorithm, plan):
    """Bind ``algo``'s update rule to a staged plan: a dense
    :class:`repro_torch.core.gossip.GossipPlan` (its rounds dispatched by
    :func:`make_plan_mixer`) or an edge plan (a
    :class:`repro_torch.sparse.SparseGossipPlan`, anything with its
    ``make_mixer``).  Returns ``step(state, grad_fn, tensors, t, gen)``
    where ``tensors`` is the plan staged on the device once
    (:func:`repro_torch.core.driver.stage_plan`) and ``t`` the host start
    round; ``step.dispatch`` is the mixer's mode.  A personalized rule
    reweights the staged per-node rows ``pW`` by the oracle's losses.  With
    ``obs`` metric names the step returns ``(state, obs_dict)``."""
    rule = algo.rule
    if rule is None:
        raise ValueError("plan_step requires an engine-rule algorithm "
                         "(built via from_rule)")
    mixer = (plan.make_mixer() if hasattr(plan, "make_mixer")
             else make_plan_mixer(plan))
    local_update = algo.local_opt.update if algo.local_opt else None

    def pstep(state: AlgoState, grad_fn: GradFn, tensors, t: int,
              gen: torch.Generator, obs: tuple = ()) -> AlgoState:
        cmix = pmix = None
        if rule.compression is not None:
            cmix = compress.make_compressed_mixer(
                lambda idx, m: mixer(tensors, t + idx, 1, m),
                rule.compression)
        if rule.personalized:
            def pmix(off, r, x, losses):
                pW = tensors["pW"]
                idx = (t + off + torch.arange(r, device=pW.device)) \
                    % plan.period
                Ws = engine.personalized_weights(pW.index_select(0, idx),
                                                 losses, rule.tau)
                return multi_consensus(Ws, x)
        ops = engine.EngineOps(
            mix=lambda off, r, x: mixer(tensors, t + off, r, x),
            grad=_grad_op(rule, grad_fn, gen), cmix=cmix,
            local_update=local_update, pmix=pmix)
        es, aux = engine.step(rule, state, ops, obs=obs)
        return (es, aux[1]) if obs else es

    pstep.dispatch = getattr(mixer, "dispatch", "static")
    return pstep


# -- The paper's rules + the federated/local-update family, one line each. --

def dsgd(gamma: float, local_opt=None) -> DecentralizedAlgorithm:
    """DSGD [12]: x^{k+1} = W^k (x^k - gamma * g^k)."""
    return from_rule(engine.make_rule("dsgd", gamma), local_opt)


def dsgt(gamma: float) -> DecentralizedAlgorithm:
    """DSGT [40]: x^{k+1} = W (x^k - gamma h^k);
    h^{k+1} = W (h^k + g^{k+1} - g^k).  Two gossip rounds per step."""
    return from_rule(engine.make_rule("dsgt", gamma))


def mc_dsgt(gamma: float, R: int) -> DecentralizedAlgorithm:
    """Multi-Consensus DSGT (Algorithm 1): R-sample gradient accumulation
    and R gossip rounds per consensus phase; ``weights`` is the (2R, n, n)
    stack [W^{2kR}, ..., W^{(2k+2)R - 1}] (first R mix x, last R mix h)."""
    return from_rule(engine.make_rule("mc_dsgt", gamma, R=R))


def d2(gamma: float) -> DecentralizedAlgorithm:
    """D^2 [35]: x^{k+1} = W(2 x^k - x^{k-1} - gamma (g^k - g^{k-1})).
    Requires symmetric PSD W (the Theorem 3 matrices qualify)."""
    return from_rule(engine.make_rule("d2", gamma))


def local_sgd(gamma: float, local_opt=None) -> DecentralizedAlgorithm:
    """Local SGD / FedAvg as an update rule: x^{k+1} = W^k x^k - gamma g^k
    with the oracle queried at the mixed iterate.  Over a federated
    schedule, ``empty`` rounds make this a pure local step and the
    periodic ``complete`` round is the global average (paper §1)."""
    return from_rule(engine.make_rule("local_sgd", gamma), local_opt)


def personalized(gamma: float, tau: float = 4.0,
                 local_opt=None) -> DecentralizedAlgorithm:
    """Dada-style personalized neighbor averaging: x ← P(ℓ)(x − γ g) with
    P(ℓ) the loss-proximity reweighting of the round's support
    (:func:`repro_torch.core.engine.personalized_weights`).  ``grad_fn``
    must return ``(per-node losses, grads)``."""
    return from_rule(engine.make_rule("personalized", gamma, tau=tau),
                     local_opt)


def gt_local(gamma: float, local_opt=None) -> DecentralizedAlgorithm:
    """Gradient tracking with local updates (DIGing-style placement):
    x^{k+1} = W^k x^k - gamma h^k;  h^{k+1} = W^k h^k + g^{k+1} - g^k.
    x and h share ONE gossip round per step and the tracker correction
    stays local, so the tracker keeps tracking through empty (local-only)
    rounds of a federated schedule."""
    return from_rule(engine.make_rule("gt_local", gamma), local_opt)


def warm_start(algo: DecentralizedAlgorithm, state: AlgoState,
               grad_fn: GradFn, gen: torch.Generator) -> AlgoState:
    """Tracker/correction initialization (Algorithm 1's h^0 for the
    tracking rules; x^{-1}/g^{-1} for D^2) -- delegates to the engine."""
    return algo.warm(state, grad_fn, gen)


def run(algo: DecentralizedAlgorithm, x0: torch.Tensor, grad_fn: GradFn,
        weight_schedule, num_steps: int, gen: torch.Generator,
        eval_fn: Optional[Callable] = None, eval_every: int = 1,
        gossip_impl: str = "dense", telemetry=None, obs: tuple = (),
        tracer=None):
    """Host training loop over a weight schedule, the reference's
    ``algorithms.run`` with a ``torch.Generator`` where it takes a key:
    delegates to :func:`repro_torch.core.driver.run_algorithm`.  Returns
    (final_state, history), history the ``(T, eval_fn(x̄))`` pairs every
    ``eval_every`` steps and at the last, T the gossip/oracle budget
    consumed so far (the paper's Figure 2 x-axis)."""
    return driver.run_algorithm(algo, x0, grad_fn, weight_schedule,
                                num_steps, gen, eval_fn=eval_fn,
                                eval_every=eval_every,
                                gossip_impl=gossip_impl, telemetry=telemetry,
                                obs=obs, tracer=tracer)
