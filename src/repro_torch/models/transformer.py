"""Decoder-only transformer for the dense ``("attn",)`` pattern: init,
train-mode forward and the next-token loss, the port of the JAX package's
``models/transformer.py`` train path.

Parameters keep the JAX layout: ``params["units"]["0_attn"]`` holds every
layer's leaves stacked on a leading layer axis.  The forward also takes
``params["units"]`` as a list of per-layer dicts; the trainer passes that
form, whose leaves are separate tensors, so each layer's gradient lands in
its own slice of the flat gradient buffer (see
:func:`repro_torch.dist.collectives.FlatLayout.grad_leaves`).
"""

from __future__ import annotations

import torch

from .. import tree
from . import attention as attn
from . import layers

UNIT = "0_attn"   # the one layer of the dense pattern unit


def _init_one_layer(gen, cfg, dtype, device) -> dict:
    return {"ln1": layers.init_norm(cfg, dtype, device),
            "attn": attn.init_attention(gen, cfg, dtype, device),
            "ln2": layers.init_norm(cfg, dtype, device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device)}


def init_params(gen, cfg, dtype=torch.float32, device="cpu") -> dict:
    """Random parameters from ``gen`` (a torch.Generator on ``device``; may
    be None on the meta device).  The JAX package's ``jax.random`` init draws
    other numbers; :func:`repro_torch.models.params_from_jax` carries those
    across instead."""
    per_layer = [_init_one_layer(gen, cfg, dtype, device)
                 for _ in range(cfg.num_layers)]
    return {"embed": layers.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device),
            "final_norm": layers.init_norm(cfg, dtype, device),
            "units": {UNIT: tree.map(lambda *xs: torch.stack(xs), *per_layer)}}


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes, from an init on the meta device
    (no memory)."""
    return tree.map(lambda t: tuple(t.shape),
                    init_params(None, cfg, torch.float32, "meta"))


def unit_params(units, cfg) -> list:
    """Per-layer parameter dicts from either the stacked or the list form."""
    if isinstance(units, list):
        return units
    return [tree.map(lambda t: t[u], units[UNIT])
            for u in range(cfg.num_layers)]


def _apply_layer(p, x, cfg, rope, positions):
    h = layers.apply_norm(p["ln1"], x)
    q = attn.project_q(p["attn"], h, cfg)
    k, v = attn.project_kv(p["attn"], h)
    cos, sin = rope
    B, S = h.shape[:2]
    qf = layers.apply_rope(q.reshape(B, S, cfg.num_heads, cfg.head_dim),
                           cos, sin)
    q = qf.reshape(q.shape)
    k = layers.apply_rope(k, cos, sin)
    o = attn.attend_full(q, k, v, positions, positions, causal=True,
                         q_chunk=cfg.q_chunk)
    x = x + attn.out_proj(p["attn"], o, cfg)
    h = layers.apply_norm(p["ln2"], x)
    return x + layers.apply_mlp(p["mlp"], h)


def forward(params, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, V)."""
    x = layers.embed_tokens(params["embed"], tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    rope = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for p in unit_params(params["units"], cfg):
        x = _apply_layer(p, x, cfg, rope, positions)
    x = layers.apply_norm(params["final_norm"], x)
    return layers.unembed(params["embed"], x)


def train_loss(params, cfg, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B, S)}.  Mean next-token cross-entropy over
    ``tokens[:, 1:]``, log-softmax in f32."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens)
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    return nll.mean()
