"""GQA attention for train mode: projections and chunked full-causal
attention in plain torch ops (no fused attention operator), the port of the
JAX package's ``models/attention.py`` train path.

Shapes: x (B, S, D); q (B, S, KV, G, hd) with G = H // KV; k, v (B, S, KV, hd).
Masked scores take the finite value ``NEG_INF`` = -1e30 and the softmax runs
in f32, as in the reference.
"""

from __future__ import annotations

import math

import torch

from . import layers

NEG_INF = -1e30


def init_attention(gen, cfg, dtype, device) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": layers._dense_init(gen, (D, H, hd), D, dtype, device),
        "wk": layers._dense_init(gen, (D, KV, hd), D, dtype, device),
        "wv": layers._dense_init(gen, (D, KV, hd), D, dtype, device),
        "wo": layers._dense_init(gen, (H, hd, D), H * hd, dtype, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((H, hd), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV, hd), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV, hd), dtype=dtype, device=device)
    return p


def _proj(x, w):
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    D, H, hd = w.shape
    return (x @ w.reshape(D, H * hd)).reshape(x.shape[:-1] + (H, hd))


def project_q(p, x, cfg):
    q = _proj(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    B, S, H, hd = q.shape
    KV = cfg.num_kv_heads
    return q.reshape(B, S, KV, H // KV, hd)


def project_kv(p, x):
    k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k, v


def out_proj(p, o, cfg):
    """o (B, S, H, hd)-flat -> (B, S, D): einsum('bshk,hkd->bsd')."""
    B, S = o.shape[:2]
    H, hd, D = p["wo"].shape
    return o.reshape(B, S, H * hd) @ p["wo"].reshape(H * hd, D)


def _sdpa(q, k, v, mask, scale):
    """q (B,Sq,J,G,hd); k,v (B,Sk,J,hd); mask broadcastable to (B,J,G,Sq,Sk)."""
    s = torch.einsum("bqjgh,bkjh->bjgqk", q, k).to(torch.float32) * scale
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bjgqk,bkjh->bqjgh", p.to(v.dtype), v)


def _pos_mask(q_pos, k_pos, causal):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    return m[None, None, None]  # (1,1,1,Sq,Sk)


def attend_full(q, k, v, q_pos, k_pos, *, causal=True, q_chunk=1024):
    """Attention over query chunks of ``q_chunk``; peak activation
    O(q_chunk * Sk).  Chunking changes no value: each query row's softmax
    is its own."""
    B, Sq, J, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    outs = [_sdpa(q[:, c:c + q_chunk], k, v,
                  _pos_mask(q_pos[c:c + q_chunk], k_pos, causal), scale)
            for c in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, J * G, hd)
