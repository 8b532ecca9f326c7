"""Decoder-only transformer: init, the train-mode forward and loss, and the
serve steps (prefill, decode), the port of the JAX package's
``models/transformer.py``.

Layers are grouped into pattern units (``cfg.pattern``): the dense decoder's
unit is one ``"attn"`` layer, falcon-mamba's one ``"mamba"`` layer,
recurrentgemma's (``"rglru"``, ``"rglru"``, ``"attn"``), granite-moe's one
``"moe"`` layer (attention, then the mixture of experts of
:mod:`repro_torch.models.moe` in place of the MLP) and llama4's
(``"attn"``, ``"moe"``).  Parameters keep the
JAX layout: ``params["units"]["0_attn"]`` (or ``"0_mamba"``, ...) holds every
unit's leaves stacked on a leading layer axis, and the serve cache
``cache["units"]["0_mamba"]`` likewise.  The num_layers % len(pattern)
remainder layers (recurrentgemma's last two rglru layers) form a second,
unstacked stack, ``params["rem"]["0_rglru"]`` ... and ``cache["rem"]``,
walked after the units.  The forward also takes ``params["units"]`` as a
list of per-unit ``{name: layer params}`` dicts; the trainer passes that
form, whose leaves are separate tensors, so each layer's gradient lands in
its own slice of the flat gradient buffer (see
:func:`repro_torch.dist.collectives.FlatLayout.grad_leaves`).  The forward
returns the MoE layers' load-balance loss beside the logits, and
``train_loss`` adds it with the reference's weight 0.01.  A VLM batch's
``prefix_embeds`` (the stub frontend's patch embeddings) go before the
token embeddings, and the loss scores the text positions only.

Every kind serves: an ``"attn"`` (or ``"moe"``) layer's cache is the
ring-buffer KV cache of :mod:`repro_torch.models.attention`, a mamba or
rglru layer's its conv and recurrence state.  With ``cfg.use_pallas`` an
attention layer's prefill (and train-mode forward, which then cannot be
differentiated, as in the reference) runs the ``flash_attention`` wrapper
and its decode the ``decode_attention`` wrapper, both with the config's
window; without it, a windowed prefill longer than the window takes the
block-local sliding attention.  The plain routes apply ``cfg.logit_softcap``
to the attention scores; the kernel routes drop it, as the reference's do
(neither kernel takes a cap).  Unlike the reference, prefill and decode
write the new cache into the ``cache`` they are given and return it.
"""

from __future__ import annotations

import torch

from .. import tree
from ..kernels import ops
from . import attention as attn
from . import layers, moe, rglru, ssm


def unit_names(cfg) -> list:
    return layer_names(cfg.pattern)


def layer_names(pattern) -> list:
    return [f"{i}_{kind}" for i, kind in enumerate(pattern)]


def rem_pattern(cfg) -> tuple:
    """The remainder stack's kinds: the first num_layers % len(pattern) of
    the pattern (empty for most configs)."""
    return tuple(cfg.pattern[:cfg.units_and_rem[1]])


def _init_one_layer(gen, cfg, kind, dtype, device) -> dict:
    if kind == "attn":
        return {"ln1": layers.init_norm(cfg, dtype, device),
                "attn": attn.init_attention(gen, cfg, dtype, device),
                "ln2": layers.init_norm(cfg, dtype, device),
                "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                       dtype, device)}
    if kind == "moe":
        return {"ln1": layers.init_norm(cfg, dtype, device),
                "attn": attn.init_attention(gen, cfg, dtype, device),
                "ln2": layers.init_norm(cfg, dtype, device),
                "moe": moe.init_moe(gen, cfg, dtype, device)}
    if kind == "mamba":
        return {"ln1": layers.init_norm(cfg, dtype, device),
                "mamba": ssm.init_mamba(gen, cfg, dtype, device)}
    if kind == "rglru":
        return {"ln1": layers.init_norm(cfg, dtype, device),
                "rec": rglru.init_rglru(gen, cfg, dtype, device),
                "ln2": layers.init_norm(cfg, dtype, device),
                "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                       dtype, device)}
    raise ValueError(f"unknown layer kind {kind!r}")


def _init_unit(gen, cfg, dtype, device, pattern=None) -> dict:
    pattern = cfg.pattern if pattern is None else pattern
    return {name: _init_one_layer(gen, cfg, kind, dtype, device)
            for name, kind in zip(layer_names(pattern), pattern)}


def empty_params(cfg, dtype, device, lead: tuple = ()) -> dict:
    """An uninitialised parameter tree, each leaf in the dtype the init
    gives it (mamba's A_log and rglru's lam are f32 whatever ``dtype``),
    with extra leading axes ``lead`` (e.g. a fleet axis)."""
    units = cfg.units_and_rem[0]
    unit = _init_unit(None, cfg, dtype, "meta")
    rem = rem_pattern(cfg)
    top = {"embed": layers.init_embed(None, cfg.vocab_size, cfg.d_model,
                                      dtype, "meta", cfg.tie_embeddings),
           "final_norm": layers.init_norm(cfg, dtype, "meta")}

    def alloc(t, *axes):
        return torch.empty(tuple(lead) + axes + tuple(t.shape),
                           dtype=t.dtype, device=device)

    params = tree.map(alloc, top)
    params["units"] = tree.map(lambda t: alloc(t, units), unit)
    if rem:
        params["rem"] = tree.map(alloc, _init_unit(None, cfg, dtype, "meta",
                                                   rem))
    return params


def init_params(gen, cfg, dtype=torch.float32, device="cpu",
                out: dict | None = None) -> dict:
    """Random parameters from ``gen`` (a torch.Generator on ``device``; may
    be None on the meta device), drawn layer by layer into the stacked
    leaves of ``out`` (a tree from :func:`empty_params`, e.g. one fleet
    member's views) or of a new tree.  At most one layer's leaves exist
    beside the result, so a model is built in its own dtype without an f32
    copy of it; the embeddings are drawn straight into ``out``.  The JAX
    package's ``jax.random`` init draws other numbers;
    :func:`repro_torch.models.params_from_jax` carries those across
    instead."""
    if out is None:
        out = empty_params(cfg, dtype, device)
    for u in range(cfg.units_and_rem[0]):
        tree.map(lambda dst, src: dst[u].copy_(src), out["units"],
                 _init_unit(gen, cfg, dtype, device))
    if rem_pattern(cfg):
        tree.map(lambda dst, src: dst.copy_(src), out["rem"],
                 _init_unit(gen, cfg, dtype, device, rem_pattern(cfg)))
    layers.init_embed(gen, cfg.vocab_size, cfg.d_model, dtype, device,
                      cfg.tie_embeddings, out=out["embed"])
    tree.map(lambda dst, src: dst.copy_(src), out["final_norm"],
             layers.init_norm(cfg, dtype, device))
    return out


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (no memory)."""
    return tree.map(lambda t: tuple(t.shape),
                    empty_params(cfg, torch.float32, "meta"))


def unit_params(units, cfg) -> list:
    """Per-unit {name: layer params} from either the stacked or the list
    form (already one such dict per unit)."""
    return layer_list(units, cfg.units_and_rem[0])


def layer_list(stack, n: int) -> list:
    """The n per-layer dicts of a subtree stacked on a leading layer axis,
    or the subtree itself when it is already that list."""
    if isinstance(stack, list):
        return stack
    return [tree.map(lambda t: t[u], stack) for u in range(n)]


def _apply_attn_layer(p, x, cfg, rope, positions, mode, cache, pos):
    """The attention half of an ``"attn"`` or ``"moe"`` layer: x plus the
    attention of its normed input.  mode 'train' (no cache), 'prefill' (the
    prompt's k, v into ``cache``) or 'decode' (one token at ``pos``,
    inserted first)."""
    h = layers.apply_norm(p["ln1"], x)
    q = attn.project_q(p["attn"], h, cfg)
    k, v = attn.project_kv(p["attn"], h)
    cos, sin = rope
    B, S = h.shape[:2]
    qf = layers.apply_rope(q.reshape(B, S, cfg.num_heads, cfg.head_dim),
                           cos, sin)
    q = qf.reshape(q.shape)
    k = layers.apply_rope(k, cos, sin)
    if mode == "decode":
        attn.cache_insert(cache, k, v, pos)
        if cfg.use_pallas:
            o = ops.decode_attention(q, cache["k"], cache["v"], cache["kpos"],
                                     pos, window=cfg.window)
        else:
            o = attn.decode_attend(q, cache, pos, window=cfg.window,
                                   softcap=cfg.logit_softcap)
    else:
        if cfg.use_pallas:
            o = attn.flash_attend(qf, k, v, window=cfg.window)
        elif cfg.window and S > cfg.window:
            o = attn.attend_sliding_block(q, k, v, positions,
                                          window=cfg.window,
                                          softcap=cfg.logit_softcap)
        else:
            o = attn.attend_full(q, k, v, positions, positions, causal=True,
                                 window=cfg.window, softcap=cfg.logit_softcap,
                                 q_chunk=cfg.q_chunk)
        if mode == "prefill":
            attn.cache_prefill(cache, k, v, positions)
    return x + attn.out_proj(p["attn"], o, cfg)


def _apply_layer(p, x, cfg, kind, rope, positions, mode, cache, pos):
    """One layer: (x, aux), aux the MoE load-balance loss in train mode
    (None for the other kinds and modes: prefill and decode drop it, as the
    reference's compiled serve steps do); in prefill and decode mode the
    layer's new cache is written into ``cache`` (views of the stacked
    cache)."""
    if kind in ("attn", "moe"):
        x = _apply_attn_layer(p, x, cfg, rope, positions, mode, cache, pos)
        h = layers.apply_norm(p["ln2"], x)
        if kind == "attn":
            return x + layers.apply_mlp(p["mlp"], h, cfg.mlp_act), None
        y, aux = moe.apply_moe(p["moe"], h, cfg, with_aux=mode == "train")
        return x + y, aux
    if kind == "mamba":
        h = layers.apply_norm(p["ln1"], x)
        y, new = ssm.mamba_forward(
            p["mamba"], h, cfg, state=cache if mode != "train" else None,
            chunk=cfg.scan_chunk)
        if mode != "train":
            tree.map(lambda dst, src: dst.copy_(src), cache, new)
        return x + y, None
    if kind == "rglru":
        h = layers.apply_norm(p["ln1"], x)
        y, new = rglru.rglru_forward(
            p["rec"], h, cfg, state=cache if mode != "train" else None,
            chunk=cfg.scan_chunk)
        if mode != "train":
            tree.map(lambda dst, src: dst.copy_(src), cache, new)
        x = x + y
        h = layers.apply_norm(p["ln2"], x)
        return x + layers.apply_mlp(p["mlp"], h, cfg.mlp_act), None
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# Cache structure
# ---------------------------------------------------------------------------

def _init_layer_cache(cfg, kind, batch, max_len, dtype, device):
    if kind in ("attn", "moe"):
        return attn.init_cache(cfg, batch, max_len, dtype, device)
    if kind == "mamba":
        return ssm.init_mamba_cache(cfg, batch, dtype, device)
    if kind == "rglru":
        return rglru.init_rglru_cache(cfg, batch, dtype, device)
    raise ValueError(kind)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Empty serve cache, the reference's tree: ``{"units": {name: leaves
    stacked on the layer axis}, "rem": {name: leaves}}`` (``rem`` empty
    without remainder layers).  An attention (or MoE) layer's KV cache holds
    C = max_len slots, or min(window, max_len) as a ring (kpos -1 = empty);
    a mamba or rglru layer's cache does not grow with ``max_len``."""
    units = cfg.units_and_rem[0]
    stacked = {
        name: tree.map(lambda t: t[None].repeat((units,) + (1,) * t.dim()),
                       _init_layer_cache(cfg, kind, batch, max_len, dtype,
                                         device))
        for name, kind in zip(unit_names(cfg), cfg.pattern)}
    rem = rem_pattern(cfg)
    return {"units": stacked,
            "rem": {name: _init_layer_cache(cfg, kind, batch, max_len, dtype,
                                            device)
                    for name, kind in zip(layer_names(rem), rem)}}


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------

def forward(params, cfg, tokens: torch.Tensor, *, prefix_embeds=None,
            mode: str = "train", cache: dict | None = None,
            pos: int | None = None, last_only: bool = False):
    """tokens: (B, S) int -> (logits (B, P + S, V) (B, 1, V with
    ``last_only``), aux): aux is the f32 sum of the MoE layers' load-balance
    losses in train mode (the number 0.0 without MoE layers or outside
    train mode: no tensor, no launch).  ``prefix_embeds`` (B, P, D), cast to
    the activations' dtype, go before the token embeddings.  ``mode`` is
    'train', 'prefill' or 'decode'; the latter two update ``cache`` in
    place.  In decode mode the one token sits at absolute position ``pos``
    (its rope angle and its cache slot)."""
    x = layers.embed_tokens(params["embed"], tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    aux = 0.0
    positions = rope = None
    if cfg.num_heads:
        positions = (torch.full((1,), pos, device=x.device)
                     if mode == "decode"
                     else torch.arange(x.shape[1], device=x.device))
        rope = layers.rope_angles(positions, cfg.head_dim, cfg.rope_theta)
    for u, up in enumerate(unit_params(params["units"], cfg)):
        for name, kind in zip(unit_names(cfg), cfg.pattern):
            c = (tree.map(lambda t: t[u], cache["units"][name])
                 if cache is not None else None)
            x, a = _apply_layer(up[name], x, cfg, kind, rope, positions,
                                mode, c, pos)
            if a is not None:
                aux = aux + a
    rem = rem_pattern(cfg)
    for name, kind in zip(layer_names(rem), rem):
        c = cache["rem"][name] if cache is not None else None
        x, a = _apply_layer(params["rem"][name], x, cfg, kind, rope,
                            positions, mode, c, pos)
        if a is not None:
            aux = aux + a
    if last_only:
        x = x[:, -1:]
    x = layers.apply_norm(params["final_norm"], x)
    return layers.unembed(params["embed"], x), aux


def train_loss(params, cfg, batch: dict,
               aux_weight: float = 0.01) -> torch.Tensor:
    """batch: {'tokens': (B, S), optional 'prefix_embeds': (B, P, D)}.
    Mean next-token cross-entropy over the text positions'
    ``tokens[:, 1:]`` (log-softmax in f32), plus ``aux_weight`` times the
    MoE load-balance loss."""
    tokens = batch["tokens"]
    prefix = batch.get("prefix_embeds")
    logits, aux = forward(params, cfg, tokens, prefix_embeds=prefix)
    P = 0 if prefix is None else prefix.shape[1]
    lp = torch.log_softmax(logits[:, P:-1].to(torch.float32), dim=-1)
    tgt = tokens[:, 1:]
    nll = -torch.gather(lp, -1, tgt[..., None])[..., 0]
    if torch.is_tensor(aux):
        return nll.mean() + aux_weight * aux
    return nll.mean()


def prefill(params, cfg, tokens, cache, *, prefix_embeds=None,
            last_only: bool = False):
    """The prompt (after ``prefix_embeds``, when given) into ``cache``
    (updated in place): (logits of the last position (B, 1, V), cache)."""
    logits, _ = forward(params, cfg, tokens, prefix_embeds=prefix_embeds,
                        mode="prefill", cache=cache, last_only=last_only)
    return logits[:, -1:], cache


def decode_step(params, cfg, token, cache, pos):
    """token: (B, 1) int; pos: its absolute position (a host int: an
    attention layer's rope angle and cache slot; a mamba layer's state does
    not use it).  (logits (B, 1, V), cache updated in place)."""
    logits, _ = forward(params, cfg, token, mode="decode", cache=cache,
                        pos=int(pos))
    return logits, cache
