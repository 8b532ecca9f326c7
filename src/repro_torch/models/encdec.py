"""Encoder-decoder transformer (whisper-tiny's backbone, arXiv:2212.04356),
the port of the JAX package's ``models/encdec.py``.

The mel-spectrogram and conv frontend is a stub, as in the reference: a
batch's ``frames`` (B, Se, D) are precomputed frame embeddings.  The
encoder is bidirectional; the decoder is causal, with cross attention whose
k and v are computed once at prefill and cached.  Layernorm, GELU (the tanh
form, as everywhere in the port) and the sinusoidal position table on both
stacks, as in the reference.

Parameters keep the reference's tree: ``embed``, ``enc`` and ``dec`` (every
layer's leaves stacked on a leading layer axis), ``enc_norm`` and
``final_norm``.  The forward also takes ``enc`` and ``dec`` as lists of
per-layer dicts, the form the trainer passes
(:meth:`repro_torch.dist.collectives.FlatLayout.grad_leaves`).  The serve
cache is the reference's too: per decoder layer a ``self`` KV ring, the
encoder's ``cross_k`` and ``cross_v`` (B, Se, KV, hd) and ``cross_kpos``
(Se,), stacked on the layer axis; prefill and decode write into the cache
they are given and return it.

No kernel runs on this family: the reference's encoder-decoder never reads
``cfg.use_pallas`` (every attention is its plain einsum route), and
neither does the port.  Nor does it apply ``cfg.logit_softcap``, which the
reference's encoder-decoder does not read either.  Frames are cast to the
embedding's dtype, as the decoder's ``prefix_embeds`` are.
"""

from __future__ import annotations

import torch

from .. import tree
from . import attention as attn
from . import layers
from .transformer import layer_list

# The cross-attention query's position at decode time: past every encoder
# position, so every frame is visible (the reference's 2**30).
CROSS_POS = 2 ** 30


def _init_encoder_layer(gen, cfg, dtype, device) -> dict:
    return {"ln1": layers.init_norm(cfg, dtype, device),
            "attn": attn.init_attention(gen, cfg, dtype, device),
            "ln2": layers.init_norm(cfg, dtype, device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                                   device)}


def _init_decoder_layer(gen, cfg, dtype, device) -> dict:
    return {"ln1": layers.init_norm(cfg, dtype, device),
            "self": attn.init_attention(gen, cfg, dtype, device),
            "ln_x": layers.init_norm(cfg, dtype, device),
            "cross": attn.init_attention(gen, cfg, dtype, device),
            "ln2": layers.init_norm(cfg, dtype, device),
            "mlp": layers.init_mlp(gen, cfg.d_model, cfg.d_ff, "gelu", dtype,
                                   device)}


def _top(gen, cfg, dtype, device) -> dict:
    return {"embed": layers.init_embed(gen, cfg.vocab_size, cfg.d_model,
                                       dtype, device, cfg.tie_embeddings),
            "enc_norm": layers.init_norm(cfg, dtype, device),
            "final_norm": layers.init_norm(cfg, dtype, device)}


def empty_params(cfg, dtype, device, lead: tuple = ()) -> dict:
    """An uninitialised parameter tree with extra leading axes ``lead``."""
    def alloc(t, *axes):
        return torch.empty(tuple(lead) + axes + tuple(t.shape),
                           dtype=t.dtype, device=device)

    params = tree.map(alloc, _top(None, cfg, dtype, "meta"))
    params["enc"] = tree.map(
        lambda t: alloc(t, cfg.encoder_layers),
        _init_encoder_layer(None, cfg, dtype, "meta"))
    params["dec"] = tree.map(
        lambda t: alloc(t, cfg.num_layers),
        _init_decoder_layer(None, cfg, dtype, "meta"))
    return params


def init_params(gen, cfg, dtype=torch.float32, device="cpu",
                out: dict | None = None) -> dict:
    """Random parameters from ``gen`` (a torch.Generator on ``device``),
    drawn layer by layer into the stacked leaves of ``out`` (a tree from
    :func:`empty_params`) or of a new tree, at the reference's shapes and
    init scales.  The reference's ``jax.random`` draws cannot be replayed:
    :func:`repro_torch.models.params_from_jax` carries those across."""
    if out is None:
        out = empty_params(cfg, dtype, device)
    for u in range(cfg.encoder_layers):
        tree.map(lambda dst, src: dst[u].copy_(src), out["enc"],
                 _init_encoder_layer(gen, cfg, dtype, device))
    for u in range(cfg.num_layers):
        tree.map(lambda dst, src: dst[u].copy_(src), out["dec"],
                 _init_decoder_layer(gen, cfg, dtype, device))
    tree.map(lambda dst, src: dst.copy_(src),
             {k: out[k] for k in ("embed", "enc_norm", "final_norm")},
             _top(gen, cfg, dtype, device))
    return out


def param_shapes(cfg) -> dict:
    """The parameter tree's leaf shapes (no memory)."""
    return tree.map(lambda t: tuple(t.shape),
                    empty_params(cfg, torch.float32, "meta"))


def _attend(p, cfg, x, kv_x, *, causal: bool, window: int = 0):
    """Attention of x's queries over kv_x's keys and values, at positions
    0..Sq-1 and 0..Sk-1: causal (the decoder's self attention, with the
    config's window) or not (the encoder's, and cross attention)."""
    q = attn.project_q(p, x, cfg)
    k, v = attn.project_kv(p, kv_x)
    Sq, Sk = x.shape[1], kv_x.shape[1]
    q_pos = torch.arange(Sq, device=x.device)
    k_pos = torch.arange(Sk, device=x.device)
    if causal and window and Sq > window:
        o = attn.attend_sliding_block(q, k, v, q_pos, window=window)
    else:
        o = attn.attend_full(q, k, v, q_pos, k_pos, causal=causal,
                             window=window, q_chunk=cfg.q_chunk)
    return attn.out_proj(p, o, cfg)


def encode(params, cfg, frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, Se, D) stub embeddings -> (B, Se, D) encoder states."""
    dtype = params["embed"]["embedding"].dtype
    x = frames.to(dtype) + layers.sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(dtype)[None]
    for lp in layer_list(params["enc"], cfg.encoder_layers):
        h = layers.apply_norm(lp["ln1"], x)
        x = x + _attend(lp["attn"], cfg, h, h, causal=False)
        h = layers.apply_norm(lp["ln2"], x)
        x = x + layers.apply_mlp(lp["mlp"], h, "gelu")
    return layers.apply_norm(params["enc_norm"], x)


def _decoder_layer(lp, cfg, x, enc_out, mode, lc, pos):
    """One decoder layer in mode 'train', 'prefill' or 'decode'; ``lc`` is
    the layer's cache (views of the stacked one), written in place."""
    h = layers.apply_norm(lp["ln1"], x)
    if mode == "decode":
        q = attn.project_q(lp["self"], h, cfg)
        k1, v1 = attn.project_kv(lp["self"], h)
        attn.cache_insert(lc["self"], k1, v1, pos)
        o = attn.decode_attend(q, lc["self"], pos, window=cfg.window)
        x = x + attn.out_proj(lp["self"], o, cfg)
        # cross attention against the encoder's cached k and v
        hq = layers.apply_norm(lp["ln_x"], x)
        qx = attn.project_q(lp["cross"], hq, cfg)
        ox = attn.decode_attend(
            qx, {"k": lc["cross_k"], "v": lc["cross_v"],
                 "kpos": lc["cross_kpos"]}, CROSS_POS)
        x = x + attn.out_proj(lp["cross"], ox, cfg)
    else:
        x = x + _attend(lp["self"], cfg, h, h, causal=True, window=cfg.window)
        hq = layers.apply_norm(lp["ln_x"], x)
        x = x + _attend(lp["cross"], cfg, hq, enc_out, causal=False)
        if mode == "prefill":
            S = h.shape[1]
            k, v = attn.project_kv(lp["self"], h)
            attn.cache_prefill(lc["self"], k, v,
                               torch.arange(S, device=h.device))
            kx, vx = attn.project_kv(lp["cross"], enc_out)
            lc["cross_k"].copy_(kx)
            lc["cross_v"].copy_(vx)
            lc["cross_kpos"].copy_(torch.arange(enc_out.shape[1],
                                                device=h.device))
    h = layers.apply_norm(lp["ln2"], x)
    return x + layers.apply_mlp(lp["mlp"], h, "gelu")


def forward(params, cfg, tokens, frames, *, mode: str = "train",
            cache: dict | None = None, pos: int | None = None):
    """tokens: (B, S); frames: (B, Se, D), or None when decoding from the
    cache -> logits (B, S, V).  In decode mode the one token sits at
    absolute position ``pos`` (its sinusoidal row and its cache slot);
    prefill and decode update ``cache`` in place."""
    x = layers.embed_tokens(params["embed"], tokens)
    if mode == "decode":
        posv = torch.full((1,), float(pos), dtype=torch.float32,
                          device=x.device)
        x = x + layers.sinusoidal_at(posv, cfg.d_model).to(x.dtype)[None,
                                                                    None]
        enc_out = None
    else:
        x = x + layers.sinusoidal_positions(
            tokens.shape[1], cfg.d_model, x.device).to(x.dtype)[None]
        enc_out = encode(params, cfg, frames)
    for u, lp in enumerate(layer_list(params["dec"], cfg.num_layers)):
        lc = (tree.map(lambda t: t[u], cache) if cache is not None
              else None)
        x = _decoder_layer(lp, cfg, x, enc_out, mode, lc, pos)
    x = layers.apply_norm(params["final_norm"], x)
    return layers.unembed(params["embed"], x)


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cpu") -> dict:
    """Empty serve cache: per decoder layer the self-attention ring of
    ``max_len`` slots (min(window, max_len) with a window) and the cross
    k, v for ``cfg.encoder_seq`` frames with ``cross_kpos`` 0..Se-1, every
    leaf stacked on a leading layer axis."""
    nl, Se = cfg.num_layers, cfg.encoder_seq
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    one = {"self": attn.init_cache(cfg, batch, max_len, dtype, device),
           "cross_k": torch.zeros((batch, Se, KV, hd), dtype=dtype,
                                  device=device),
           "cross_v": torch.zeros((batch, Se, KV, hd), dtype=dtype,
                                  device=device),
           "cross_kpos": torch.arange(Se, dtype=torch.int32, device=device)}
    return tree.map(lambda t: t[None].repeat((nl,) + (1,) * t.dim()), one)


def train_loss(params, cfg, batch: dict) -> torch.Tensor:
    """batch: {'tokens': (B, S), 'frames': (B, Se, D)}: the mean next-token
    cross-entropy of ``tokens[:, 1:]`` (log-softmax in f32)."""
    tokens = batch["tokens"]
    logits = forward(params, cfg, tokens, batch["frames"])
    lp = torch.log_softmax(logits[:, :-1].to(torch.float32), dim=-1)
    nll = -torch.gather(lp, -1, tokens[:, 1:, None])[..., 0]
    return nll.mean()


def prefill(params, cfg, tokens, frames, cache):
    """Encode ``frames`` and run the prompt into ``cache`` (in place):
    (logits of the last position (B, 1, V), cache)."""
    logits = forward(params, cfg, tokens, frames, mode="prefill",
                     cache=cache)
    return logits[:, -1:], cache


def decode_step(params, cfg, token, cache, pos):
    """token: (B, 1) at absolute position ``pos`` (a host int) -> (logits
    (B, 1, V), cache updated in place)."""
    logits = forward(params, cfg, token, None, mode="decode", cache=cache,
                     pos=int(pos))
    return logits, cache
