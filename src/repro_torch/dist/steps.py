"""The decentralized training step over a node-stacked flat state, the port
of the JAX package's ``dist/steps.py``.

The update arithmetic lives in :mod:`repro_torch.core.engine`; this module
binds the engine's :class:`EngineOps` to the gossip mixer that
``gossip_impl`` selects, to the clipped R-microbatch oracle, to the local
optimizer and to the tracker storage cast.  ``make_train_step`` returns

* ``init_state(params, n)`` — n identical copies of ``params`` as the flat
  (n, D) state (and the local optimizer's state);
* ``warm_start(state, batch)`` — the rule's tracker/correction init;
* ``step(state, batch, weights) -> (state, {"loss": ...})`` — one paper
  round; ``batch["tokens"]`` is (n, R, b, S) and ``weights`` the step's
  (wps, n, n) gossip window, or for ``'sun'`` its (wps, n) center masks.
  Under ``'auto'`` it is ``step(state, batch, plan_tensors, t)``:
  ``plan_tensors`` is ``plan.tensors()`` staged on the device once and
  ``t`` the start round (a host int; ``step.gossip_dispatch`` names the
  plan mixer's mode).

Where the JAX step vmaps the per-node gradient and scans the R
microbatches, the port loops over both; every node's gradient is
accumulated straight into its row of one flat (n, D) buffer.  Each node's
accumulated sample is clipped to global norm ``clip`` (default 1.0) before
it enters the tracker, as in the reference; ``clip=None`` is the pure
update.  Mixing runs under ``torch.no_grad()``: it acts on parameters,
outside autograd, so no backward kernel is needed.

``gossip_impl``: ``'dense'`` one matrix product per round; ``'sun'`` the
structured sun rewrite (:func:`repro_torch.core.algorithms.sun_mix`, two
node-axis sums); ``'pallas'`` all R rounds of a window in one pass of the
Hopper ``gossip_mix`` kernel; ``'auto'`` a :class:`repro_torch.core.gossip.
GossipPlan` dispatching every round to its lowering
(:func:`repro_torch.core.algorithms.make_plan_mixer`), with each run of
dense rounds through the einsum (``auto_dense='einsum'``) or through
``gossip_mix`` (``auto_dense='pallas'``).

``compression`` (a :class:`repro_torch.core.compress.CompressionConfig`)
quantizes every gossip payload with error feedback: ``'pallas'`` runs all R
rounds of a window in one pass of the Hopper ``quantized_gossip_mix``
kernel, the other impls wrap their per-round mixer in
:func:`~repro_torch.core.compress.make_compressed_mixer`.  The flat layout
is then aligned to the compression group, and the state carries the
residuals ``res`` = (res_x, res_h).  ``aux_dtype`` (e.g. ``torch.bfloat16``)
stores h and g_prev, and the residuals, in that dtype.

``delay`` d > 0 mixes each window on the payload of d steps ago (the
state's ``buf``: d stale slots per gossiped stream, the tracker's in
``aux_dtype``) and adds only the correction Mix(stale) − stale to the
fresh payload; ``comm_interval`` k > 1 mixes on every k-th step only and
launches nothing in between (see :class:`repro_torch.core.engine.
UpdateRule`).  Both default to the synchronous path, which builds no
wrapper.

``obs`` names the engine's in-step scalars (:data:`repro_torch.core.
engine.OBS_METRICS`): the step's output dict then gains ``"obs"``, f32
device scalars.  The step carries the checkpoint pair of its state,
``step.save_checkpoint(path, state, k)`` and ``step.load_checkpoint(path,
state) -> (state, k)``: the JAX package's file of its ``TrainState``
(:func:`checkpoint_leaves`), so a checkpoint of either package restores in
the other.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional

import torch

from .. import checkpoint as ckpt
from ..core import algorithms as alg, compress, engine
from . import collectives as coll

GOSSIP_IMPLS = ("dense", "sun", "pallas", "auto")
CLIP_CHUNK = 1 << 26      # entries of a gradient row squared at a time


class TrainState(NamedTuple):
    x: torch.Tensor                 # (n, D) stacked model copies
    h: Optional[torch.Tensor]       # (n, D) tracker (tracking) or x^{k-1} (d2)
    g_prev: Optional[torch.Tensor]  # (n, D) previous oracle sample
    step: int                       # round counter
    res: Optional[tuple] = None     # EF residuals (res_x, res_h), compressing
    opt: Any = None                 # local optimizer state
    buf: Optional[tuple] = None     # stale payloads (buf_x, buf_h), delay > 0


def make_train_step(model, cfg, *, algo: str = "mc_dsgt", gamma: float,
                    R: int = 1, aux_dtype=None, gossip_impl: str = "dense",
                    sun_delta: Optional[float] = None, local_opt=None,
                    clip: Optional[float] = 1.0, plan=None,
                    auto_dense: str = "einsum",
                    compression: Optional[compress.CompressionConfig] = None,
                    delay: int = 0, comm_interval: int = 1,
                    tau: float = 4.0, obs: tuple = ()):
    """Build (init_state, warm_start, step) for one decentralized algorithm.

    gossip_impl: ``'dense'``, ``'sun'`` (``sun_delta`` must be given; the
    step's ``weights`` are center masks), ``'pallas'`` (the Hopper
    ``gossip_mix``; the name is the JAX package's spec vocabulary for the
    fused kernel path) or ``'auto'`` (``plan`` must be given;
    ``auto_dense`` ``'einsum'`` or ``'pallas'``).  ``local_opt`` is an
    :class:`repro_torch.optim.Optimizer`; ``tau`` the personalized rule's
    temperature; ``delay`` and ``comm_interval`` the stale window and the
    mixing cadence; ``obs`` the in-step scalars the output dict carries.
    The reference's mesh, unroll and Pallas block/interpret arguments have
    no meaning on one device and are not taken."""
    del cfg
    rule = engine.make_rule(algo, gamma=gamma, R=(1 if algo == "d2" else R),
                            compression=compression, delay=delay,
                            comm_interval=comm_interval, tau=tau)
    if gossip_impl not in GOSSIP_IMPLS:
        raise ValueError(f"unknown gossip_impl {gossip_impl!r}")
    if rule.personalized and gossip_impl not in ("dense", "auto"):
        raise ValueError("personalized weights are reweighted per step in "
                         "full precision; use gossip_impl 'dense' or 'auto'")
    if gossip_impl == "sun" and sun_delta is None:
        raise ValueError("gossip_impl='sun' requires sun_delta")
    if gossip_impl == "auto" and plan is None:
        raise ValueError("gossip_impl='auto' requires plan=GossipPlan")
    if local_opt is not None and not rule.supports_local_opt:
        raise ValueError(f"algo={algo!r} does not support a local-optimizer "
                         "hook")
    if auto_dense not in ("einsum", "pallas"):
        raise ValueError(f"unknown auto_dense {auto_dense!r}")
    layout = flat_layout(model, compression)

    def _mc(Ws, mat):
        if gossip_impl == "sun":
            return alg.sun_multi_consensus(Ws, sun_delta, mat)
        if gossip_impl == "pallas":
            return coll.fused_multi_consensus(Ws, mat)
        return alg.multi_consensus(Ws, mat)

    if gossip_impl == "auto":
        plan_mix = alg.make_plan_mixer(
            plan, dense_block=(coll.fused_multi_consensus
                               if auto_dense == "pallas" else None))

    def _mix_rounds(gossip, t, off, r, mat):
        """Rounds [t+off, t+off+r): from the staged plan under 'auto', else
        the step's ``weights`` slice."""
        with torch.no_grad():
            if gossip_impl == "auto":
                return plan_mix(gossip, t + off, r, mat)
            return _mc(gossip[off:off + r], mat)

    def _clip(grow):
        """Scale the (D,) row to global norm <= ``clip``.  The norm is the
        reference's: each leaf's squares summed, the leaf sums added in
        leaf order (a leaf past CLIP_CHUNK entries a chunk at a time, so no
        temporary is larger).  ``torch.linalg.vector_norm``'s CPU kernel
        accumulates f32 lane by lane and reads 6e-4 low on the reduced
        granite-moe's 3.7M-entry gradient."""
        if clip is None:
            return
        sq = torch.zeros((), dtype=torch.float32, device=grow.device)
        for _, shape, off in layout.entries:
            leaf = grow[off:off + math.prod(shape)]
            sq = sq + sum(c.square().sum() for c in leaf.split(CLIP_CHUNK))
        grow.mul_(torch.clamp(clip / (sq.sqrt() + 1e-12), max=1.0))

    def _grads(x, batch, out=None):
        """Per-node R-sample gradient accumulation (clipped): (mean loss,
        (n, D) gradients, in ``out`` when given); for a personalized rule
        the per-node (n,) losses, pmix's similarity signal.  Node i's
        micro-batch r is every field of the batch at [i, r] (the tokens,
        and a VLM's ``prefix_embeds``)."""
        g = torch.zeros_like(x) if out is None else out.zero_()
        losses = []
        for i in range(x.shape[0]):
            params = layout.grad_leaves(x[i], g[i])
            loss = torch.zeros((), device=x.device)
            for r in range(rule.R):
                micro = model.train_loss(
                    params, {k: v[i, r] for k, v in batch.items()})
                micro.backward()
                loss = loss + micro.detach()
            g[i].div_(rule.R)
            _clip(g[i])
            losses.append(loss / rule.R)
        losses = torch.stack(losses)
        return (losses if rule.personalized else losses.mean()), g

    def _cmix(gossip, t):
        """The compressed window (the state never requires grad, so the
        quantization needs no ``no_grad``)."""
        if compression is None:
            return None
        if gossip_impl == "pallas":
            return lambda off, r, mat, res, on: coll.fused_quantized_consensus(
                gossip[off:off + r], mat, res, compression, on)
        return compress.make_compressed_mixer(
            lambda idx, mat: _mix_rounds(gossip, t, idx, 1, mat), compression)

    def _pmix(gossip, t):
        """The personalized window: the staged per-node rows ``pW`` under
        'auto', the step's weights slice under 'dense', reweighted by the
        step's per-node losses."""
        if not rule.personalized:
            return None

        def pmix(off, r, mat, losses):
            if gossip_impl == "auto":
                pW = gossip["pW"]
                idx = (t + off + torch.arange(r, device=pW.device)) \
                    % plan.period
                Ws = pW.index_select(0, idx)
            else:
                Ws = gossip[off:off + r]
            with torch.no_grad():
                return alg.multi_consensus(
                    engine.personalized_weights(Ws, losses, rule.tau), mat)
        return pmix

    def _ops(batch, gossip, t=0):
        return engine.EngineOps(
            mix=lambda off, r, mat: _mix_rounds(gossip, t, off, r, mat),
            grad=lambda x, out=None: _grads(x, batch, out),
            cmix=_cmix(gossip, t),
            local_update=local_opt.update if local_opt is not None else None,
            cast_aux=lambda tr: coll.tree_cast(tr, aux_dtype),
            pmix=_pmix(gossip, t))

    def init_state(params: dict, n: int) -> TrainState:
        x = alg.broadcast_nodes(layout.flatten(params), n)
        return _to_train(engine.init_state(
            rule, x, opt_init=local_opt.init if local_opt is not None
            else None, res_dtype=aux_dtype))

    def warm_start(state: TrainState, batch) -> TrainState:
        es = engine.warm_start(rule, _to_engine(state), _ops(batch, None))
        return _to_train(es)

    def core(state: TrainState, batch, gossip, t):
        es, aux = engine.step(rule, _to_engine(state),
                              _ops(batch, gossip, t), obs=obs)
        loss = aux[0] if obs else aux
        # a personalized rule's metrics are the per-node losses; the step's
        # "loss" stays their mean
        out = {"loss": loss.mean() if rule.personalized else loss}
        if obs:
            out["obs"] = aux[1]
        return _to_train(es), out

    def save_checkpoint(path: str, state: TrainState, k: int) -> None:
        ckpt.save_checkpoint(
            path, checkpoint_leaves(state, layout, aux_dtype), step=k,
            treedef=f"repro_torch TrainState (x, h, g_prev, step, opt, res, "
            f"buf) as the reference's leaves: {len(layout.entries)} "
            f"parameter leaves a stream, {state.x.shape[0]} nodes")

    def load_checkpoint(path: str, state: TrainState):
        state = _restore_slots(rule, state, aux_dtype)
        leaves, k = ckpt.load_checkpoint(
            path, checkpoint_leaves(state, layout, aux_dtype, restore=True))
        return _restored(state, leaves, layout), int(k)

    if gossip_impl == "auto":
        def step(state: TrainState, batch, plan_tensors, t: int):
            return core(state, batch, plan_tensors, t)
        step.gossip_dispatch = plan_mix.dispatch
    else:
        def step(state: TrainState, batch, weights):
            return core(state, batch, weights, 0)
    step.save_checkpoint = save_checkpoint
    step.load_checkpoint = load_checkpoint
    return init_state, warm_start, step


def flat_layout(model, compression=None) -> coll.FlatLayout:
    """Where each parameter leaf lives in a row of the flat (n, D) state
    that :func:`make_train_step` trains: every leaf aligned to the
    compression group when compressing."""
    return coll.FlatLayout(model.shapes,
                           align=compression.group if compression else 1)


def _to_engine(s: TrainState) -> engine.EngineState:
    return engine.EngineState(s.x, s.h, s.g_prev, s.step, res=s.res,
                              opt=s.opt, buf=s.buf)


def _to_train(s: engine.EngineState) -> TrainState:
    return TrainState(x=s.x, h=s.h, g_prev=s.g_prev, step=s.k, res=s.res,
                      opt=s.opt, buf=s.buf)


# ---------------------------------------------------------------------------
# Checkpoints: the flat state as the reference's TrainState leaves
# ---------------------------------------------------------------------------

def _views(layout: coll.FlatLayout, mat: torch.Tensor) -> list:
    """One (n, *leaf shape) view per parameter leaf of a flat (n, D)
    stream, in ``jax.tree.leaves`` order, without the padding columns."""
    n = mat.shape[0]
    return [mat[:, off:off + math.prod(shape)].view((n,) + shape)
            for _, shape, off in layout.entries]


def checkpoint_leaves(state: TrainState, layout: coll.FlatLayout,
                      aux_dtype=None, *, restore: bool = False) -> list:
    """The leaves of the JAX package's ``TrainState`` for this state, in its
    field order: x, h, g_prev (per parameter, (n, *shape)), step (int32,
    shape []), opt (momentum's buffer; adam's m leaves, t (int32), v
    leaves), res (res_x, then res_h when the rule has one), buf (each stale
    x slot, then each stale h slot).  The reference keeps a rule without a
    tracker's h and g_prev as zero trees (in ``aux_dtype``), which the port
    does not store: :class:`repro_torch.checkpoint.ZeroLeaf`.  Each tensor
    leaf is a view into the state, so saving copies it out and restoring
    (``restore=True``: the scalars become None, for the loader to return)
    writes it in place."""
    x = state.x
    zdt = aux_dtype or x.dtype

    def stream(mat):
        if mat is None:
            return [ckpt.ZeroLeaf((x.shape[0],) + shape, zdt)
                    for _, shape, _ in layout.entries]
        return _views(layout, mat)

    def scalar(v):
        return None if restore else torch.tensor(int(v), dtype=torch.int32)

    leaves = stream(x) + stream(state.h) + stream(state.g_prev)
    leaves.append(scalar(state.step))
    opt = state.opt
    if isinstance(opt, dict):          # adam: sorted keys m, t, v
        leaves += _views(layout, opt["m"]) + [scalar(opt["t"])] \
            + _views(layout, opt["v"])
    elif opt is not None:              # momentum's buffer
        leaves += _views(layout, opt)
    for group in (state.res or ()), *(state.buf or ()):
        for mat in group or ():
            if mat is not None:
                leaves += _views(layout, mat)
    return leaves


def _restore_slots(rule: engine.UpdateRule, state: TrainState,
                   aux_dtype) -> TrainState:
    """``state`` (fresh from ``init_state``) with the slots a warm start
    would have made allocated for a restore to fill: h and g_prev of a
    tracking rule (in ``aux_dtype``) or of a difference rule (h, x⁻, in
    x's dtype), and a delayed tracking rule's stale h slots."""
    x = state.x
    aux = aux_dtype or x.dtype
    if rule.kind == "sgd":
        return state
    h_dtype = aux if rule.kind == "tracking" else x.dtype
    h = state.h if state.h is not None else torch.zeros_like(x, dtype=h_dtype)
    gp = (state.g_prev if state.g_prev is not None
          else torch.zeros_like(x, dtype=aux))
    buf = state.buf
    if rule.delay and rule.uses_tracker and buf is not None and buf[1] is None:
        buf = (buf[0], tuple(torch.zeros_like(x, dtype=aux)
                             for _ in range(rule.delay)))
    return state._replace(h=h, g_prev=gp, buf=buf)


def _restored(state: TrainState, leaves: list, layout) -> TrainState:
    """The state after a restore filled its tensors: the step counter and
    adam's t from their scalar leaves."""
    per = len(layout.entries)
    step = int(leaves[3 * per])
    opt = state.opt
    if isinstance(opt, dict):
        opt = {**opt, "t": int(leaves[4 * per + 1])}
    return state._replace(step=step, opt=opt)
