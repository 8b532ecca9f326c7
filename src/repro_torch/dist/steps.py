"""The decentralized training step over a node-stacked flat state, the port
of the JAX package's ``dist/steps.py``.

The update arithmetic lives in :mod:`repro_torch.core.engine`; this module
binds the engine's :class:`EngineOps` to the gossip mixer that
``gossip_impl`` selects and to the clipped R-microbatch oracle.
``make_train_step`` returns

* ``init_state(params, n)`` — n identical copies of ``params`` as the flat
  (n, D) state;
* ``warm_start(state, batch)`` — the rule's tracker init;
* ``step(state, batch, weights) -> (state, {"loss": ...})`` — one paper
  round; ``batch["tokens"]`` is (n, R, b, S) and ``weights`` the
  (2R, n, n) (tracking) or (R, n, n) (sgd) gossip window.

Where the JAX step vmaps the per-node gradient and scans the R
microbatches, the port loops over both; every node's gradient is
accumulated straight into its row of one flat (n, D) buffer.  Each node's
accumulated sample is clipped to global norm ``clip`` (default 1.0) before
it enters the tracker, as in the reference; ``clip=None`` is the pure
update.  Mixing runs under ``torch.no_grad()``: it acts on parameters,
outside autograd, so no backward kernel is needed.

``compression`` (a :class:`repro_torch.core.compress.CompressionConfig`)
quantizes every gossip payload with error feedback: ``'pallas'`` runs all R
rounds of a window in one pass of the Hopper ``quantized_gossip_mix``
kernel, ``'dense'`` wraps one matrix product per round in
:func:`~repro_torch.core.compress.make_compressed_mixer`.  The flat layout
is then aligned to the compression group, and the state carries the
residuals ``res`` = (res_x, res_h).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import algorithms as alg, compress, engine
from . import collectives as coll

GOSSIP_IMPLS = ("dense", "pallas")


class TrainState(NamedTuple):
    x: torch.Tensor                 # (n, D) stacked model copies
    h: Optional[torch.Tensor]       # (n, D) gradient tracker (tracking rules)
    g_prev: Optional[torch.Tensor]  # (n, D) previous oracle sample
    step: int                       # round counter
    res: Optional[tuple] = None     # EF residuals (res_x, res_h), compressing


def make_train_step(model, cfg, *, algo: str = "mc_dsgt", gamma: float,
                    R: int = 1, gossip_impl: str = "dense",
                    clip: Optional[float] = 1.0,
                    compression: Optional[compress.CompressionConfig] = None):
    """Build (init_state, warm_start, step) for one decentralized algorithm.

    gossip_impl: ``'dense'`` (one matrix product per round) or
    ``'pallas'`` (all R rounds in one pass of the Hopper ``gossip_mix``
    kernel; the name is the JAX package's spec vocabulary for the fused
    kernel path).  The JAX package's ``'sun'`` and ``'auto'`` lowerings are
    not ported yet."""
    del cfg
    rule = engine.make_rule(algo, gamma=gamma, R=R, compression=compression)
    if gossip_impl in ("sun", "auto"):
        raise NotImplementedError(f"gossip_impl={gossip_impl!r} is not "
                                  "ported yet (ROADMAP.md Queue 1 item 3)")
    if gossip_impl not in GOSSIP_IMPLS:
        raise ValueError(f"unknown gossip_impl {gossip_impl!r}")
    layout = flat_layout(model, compression)

    def _mix(Ws, mat):
        with torch.no_grad():
            if gossip_impl == "pallas":
                return coll.fused_multi_consensus(Ws, mat)
            return alg.multi_consensus(Ws, mat)

    def _clip(grow):
        if clip is None:
            return
        nrm = torch.linalg.vector_norm(grow)
        grow.mul_(torch.clamp(clip / (nrm + 1e-12), max=1.0))

    def _grads(x, batch, out=None):
        """Per-node R-sample gradient accumulation (clipped): (mean loss,
        (n, D) gradients, in ``out`` when given)."""
        tokens = batch["tokens"]
        g = torch.zeros_like(x) if out is None else out.zero_()
        losses = []
        for i in range(x.shape[0]):
            params = layout.grad_leaves(x[i], g[i])
            loss = torch.zeros((), device=x.device)
            for r in range(rule.R):
                micro = model.train_loss(params, {"tokens": tokens[i, r]})
                micro.backward()
                loss = loss + micro.detach()
            g[i].div_(rule.R)
            _clip(g[i])
            losses.append(loss / rule.R)
        return torch.stack(losses).mean(), g

    def _cmix(gossip):
        """The compressed window (the state never requires grad, so the
        quantization needs no ``no_grad``)."""
        if compression is None:
            return None
        if gossip_impl == "pallas":
            return lambda off, r, mat, res, on: coll.fused_quantized_consensus(
                gossip[off:off + r], mat, res, compression, on)
        return compress.make_compressed_mixer(
            lambda idx, mat: _mix(gossip[idx:idx + 1], mat), compression)

    def _ops(batch, gossip):
        return engine.EngineOps(
            mix=lambda off, r, mat: _mix(gossip[off:off + r], mat),
            grad=lambda x, out=None: _grads(x, batch, out),
            cmix=_cmix(gossip))

    def init_state(params: dict, n: int) -> TrainState:
        x = alg.broadcast_nodes(layout.flatten(params), n)
        return _to_train(engine.init_state(rule, x))

    def warm_start(state: TrainState, batch) -> TrainState:
        es = engine.warm_start(rule, _to_engine(state), _ops(batch, None))
        return _to_train(es)

    def step(state: TrainState, batch, weights):
        es, loss = engine.step(rule, _to_engine(state), _ops(batch, weights))
        return _to_train(es), {"loss": loss}

    return init_state, warm_start, step


def flat_layout(model, compression=None) -> coll.FlatLayout:
    """Where each parameter leaf lives in a row of the flat (n, D) state
    that :func:`make_train_step` trains: every leaf aligned to the
    compression group when compressing."""
    return coll.FlatLayout(model.shapes,
                           align=compression.group if compression else 1)


def _to_engine(s: TrainState) -> engine.EngineState:
    return engine.EngineState(s.x, s.h, s.g_prev, s.step, res=s.res)


def _to_train(s: engine.EngineState) -> TrainState:
    return TrainState(x=s.x, h=s.h, g_prev=s.g_prev, step=s.k, res=s.res)
