"""Unified model API: ``build(cfg)`` returns the functions the trainer, the
server and the tests share, and ``params_from_jax`` carries a JAX parameter
tree (or serve cache) across.

The port runs the dense decoder (the family of qwen1.5-0.5b, yi-6b,
minitron-4b and nemotron-4-340b: any MLP activation, tied or untied
embeddings), the mamba stack (falcon-mamba-7b's family), the hybrid of
RG-LRU and local attention (recurrentgemma-2b's family), the MoE decoder
(granite-moe-3b-a800m's ``("moe",)`` and llama4-maverick's ``("attn",
"moe")`` with a shared expert) and the VLM backbone on its stub frontend
(internvl2-1b: ``prefix_embeds`` in the batch, text positions scored) and
the encoder-decoder (whisper-tiny, ``arch_type='audio'``:
:mod:`repro_torch.models.encdec`, ``frames`` in the batch) in every mode,
with rmsnorm or layernorm and the optional attention logit softcap; serving
refuses the VLM and the encoder-decoder as the reference does.
``use_pallas`` routes the decoder's attention to the Hopper
``flash_attention`` (prefill, and a train-mode forward that cannot be
differentiated, as in the reference) and ``decode_attention`` (decode),
both with the config's sliding window and without the softcap (neither
kernel takes one, as in the reference), and the mamba and RG-LRU
recurrences to ``linear_recurrence``; the encoder-decoder reaches no
kernel.  ``build`` takes every config the reference's takes.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import tree
from . import encdec, transformer


class Model(NamedTuple):
    cfg: Any
    shapes: dict              # parameter leaf shapes (the JAX layout)
    init: Callable            # (generator, dtype, device, out=None) -> params
    empty: Callable           # (dtype, device, lead=()) -> uninitialised tree
    train_loss: Callable      # (params, batch) -> scalar
    prefill: Callable         # (params, batch, cache) -> (logits, cache)
    decode_step: Callable     # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable      # (batch, max_len, dtype, device) -> cache


def build(cfg) -> Model:
    """The model functions of ``cfg``: the encoder-decoder for
    ``arch_type='audio'``, else the pattern-generic decoder (an unknown
    layer kind or activation raises ValueError, as in the reference)."""
    if cfg.arch_type == "audio":
        return Model(
            cfg=cfg,
            shapes=encdec.param_shapes(cfg),
            init=lambda gen, dtype=torch.float32, device="cpu", out=None:
                encdec.init_params(gen, cfg, dtype, device, out),
            empty=lambda dtype=torch.float32, device="cpu", lead=():
                encdec.empty_params(cfg, dtype, device, lead),
            train_loss=lambda p, b: encdec.train_loss(p, cfg, b),
            prefill=lambda p, b, c: encdec.prefill(p, cfg, b["tokens"],
                                                   b["frames"], c),
            decode_step=lambda p, t, c, pos:
                encdec.decode_step(p, cfg, t, c, pos),
            init_cache=lambda batch, max_len, dtype=torch.bfloat16,
            device="cpu": encdec.init_cache(cfg, batch, max_len, dtype,
                                            device),
        )

    def _prefill(p, b, c):
        return transformer.prefill(p, cfg, b["tokens"], c,
                                   prefix_embeds=b.get("prefix_embeds"),
                                   last_only=cfg.prefill_last_only)

    return Model(
        cfg=cfg,
        shapes=transformer.param_shapes(cfg),
        init=lambda gen, dtype=torch.float32, device="cpu", out=None:
            transformer.init_params(gen, cfg, dtype, device, out),
        empty=lambda dtype=torch.float32, device="cpu", lead=():
            transformer.empty_params(cfg, dtype, device, lead),
        train_loss=lambda p, b: transformer.train_loss(p, cfg, b),
        prefill=_prefill,
        decode_step=lambda p, t, c, pos:
            transformer.decode_step(p, cfg, t, c, pos),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cpu":
            transformer.init_cache(cfg, batch, max_len, dtype, device),
    )


# ---------------------------------------------------------------------------
# Input templates (tensors without values on the meta device by default)
# ---------------------------------------------------------------------------

def train_batch_template(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                         device="meta") -> dict:
    """Per-node training batch as empty tensors on ``device``.  For vlm and
    audio, part of the sequence budget is the stub frontend's embedding:
    a VLM's ``prefix_embeds`` take ``frontend_tokens`` of the ``seq``
    positions; an encoder-decoder's ``frames`` come beside ``seq`` tokens.
    Tokens are int64, the port's index dtype (the reference's are
    int32)."""
    def empty(shape, dt):
        return torch.empty(shape, dtype=dt, device=device)

    if cfg.arch_type == "vlm":
        P = cfg.frontend_tokens
        return {"tokens": empty((batch, seq - P), torch.int64),
                "prefix_embeds": empty((batch, P, cfg.d_model), dtype)}
    if cfg.arch_type == "audio":
        return {"tokens": empty((batch, seq), torch.int64),
                "frames": empty((batch, cfg.encoder_seq, cfg.d_model),
                                dtype)}
    return {"tokens": empty((batch, seq), torch.int64)}


def decode_templates(cfg, batch: int, seq: int, dtype=torch.bfloat16,
                     device="meta"):
    """(token, cache, pos) for a serve step with a ``seq``-long context:
    the (batch, 1) token, the cache :meth:`Model.init_cache` builds for
    ``seq`` positions on ``device`` (built without the model, whose
    parameter shapes would take a parameter tree of meta tensors), and ``pos`` = seq − 1, a host int (the
    port's decode step takes its position from the host), the context's
    last slot."""
    token = torch.empty((batch, 1), dtype=torch.int64, device=device)
    init_cache = (encdec.init_cache if cfg.arch_type == "audio"
                  else transformer.init_cache)
    return token, init_cache(cfg, batch, seq, dtype, device), seq - 1


def materialize_batch(cfg, batch: int, seq: int, gen: torch.Generator,
                      dtype=torch.bfloat16) -> dict:
    """A random training batch matching :func:`train_batch_template`, drawn
    from ``gen`` on its device: tokens uniform over the vocabulary, float
    fields N(0, 0.02²)."""
    tmpl = train_batch_template(cfg, batch, seq, dtype)
    out = {}
    for name, t in tmpl.items():
        if t.dtype == torch.int64:
            out[name] = torch.randint(0, cfg.vocab_size, t.shape,
                                      generator=gen, device=gen.device)
        else:
            out[name] = torch.randn(t.shape, generator=gen,
                                    device=gen.device, dtype=t.dtype) * 0.02
    return out


def params_from_jax(params) -> dict:
    """The JAX package's parameter tree or serve cache (nested dicts of
    arrays, e.g. after ``jax.device_get``) as the port's: the same tree,
    the remainder stack ``rem`` and the encoder-decoder's ``enc``, ``dec``
    and per-layer ``self``/``cross_*`` caches included, the same leaf layouts and dtypes
    (mamba's A_log and rglru's lam stay f32; bf16 stays bf16, bit for bit),
    as CPU tensors.  A copy, no transpose."""
    return tree.map(_tensor, params)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' type, which torch refuses
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)
