"""GQA attention: projections, chunked causal attention (full or within a
sliding window) and the exact block-local sliding-window attention in plain
torch ops (no fused attention operator), the ring-buffer KV cache and
single-token decode against it, the port of the JAX package's
``models/attention.py``: causal, and for the encoder-decoder bidirectional
(``causal=False``) and cross attention (queries against another sequence,
Sq != Sk), with the optional logit softcap ``cap·tanh(s/cap)`` applied to
the scaled scores before the mask, as in the reference.

Shapes: x (B, S, D); q (B, S, KV, G, hd) with G = H // KV; k, v (B, S, KV, hd).
Masked scores take the finite value ``NEG_INF`` = -1e30 and the softmax runs
in f32, as in the reference; ``kernels/ref.py`` ``masked_softmax_pv`` is the
one copy of that step.  The cache stores each slot's absolute position
beside its keys (``kpos``, -1 = empty), so one mask serves append caches and
ring buffers.  Unlike the reference, ``cache_insert`` and
``cache_prefill`` write into the cache they are given and return it.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops, ref
from . import layers


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


def _softcap(s, cap):
    return cap * torch.tanh(s / cap) if cap else s


def _sdpa(q, k, v, mask, scale, softcap=0.0):
    """q (B,Sq,J,G,hd); k,v (B,Sk,J,hd); mask broadcastable to (B,J,G,Sq,Sk)."""
    s = torch.einsum("bqjgh,bkjh->bjgqk", q, k).to(torch.float32) * scale
    return ref.masked_softmax_pv(_softcap(s, softcap), mask, v)


def _pos_mask(q_pos, k_pos, causal, window=0):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m[None, None, None]  # (1,1,1,Sq,Sk)


def attend_full(q, k, v, q_pos, k_pos, *, causal=True, window=0,
                softcap=0.0, q_chunk=1024):
    """Attention of q (B, Sq, ...) at ``q_pos`` over k, v (B, Sk, ...) at
    ``k_pos``, over query chunks of ``q_chunk``; peak activation O(q_chunk
    * Sk).  ``causal`` masks key k for row q when k > q (off: the encoder's
    bidirectional and the decoder's cross attention); with ``window`` w,
    also when k <= q − w.  Chunking changes no value: each query row's
    softmax is its own (the reference pads the last chunk with rows at
    position −1 and slices them away; the port slices the queries)."""
    B, Sq, J, G, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    outs = [_sdpa(q[:, c:c + q_chunk], k, v,
                  _pos_mask(q_pos[c:c + q_chunk], k_pos, causal, window),
                  scale, softcap)
            for c in range(0, Sq, q_chunk)]
    return torch.cat(outs, dim=1).reshape(B, Sq, J * G, hd)


def attend_sliding_block(q, k, v, q_pos, *, window, softcap=0.0):
    """Exact sliding-window causal attention in O(S · 2w): queries in blocks
    of w attend to their own and the previous key block (the reference's
    ``attend_sliding_block``; its route for S > window with ``use_pallas``
    off).  S is padded to a whole number of blocks: padded queries sit at
    position −10w and are sliced away, padded keys carry position −1 and
    are masked, as is the block before the first."""
    B, S, J, G, hd = q.shape
    w = window
    scale = 1.0 / math.sqrt(hd)
    pad = (-S) % w
    if pad:
        q = torch.cat([q, q.new_zeros((B, pad, J, G, hd))], dim=1)
        k = torch.cat([k, k.new_zeros((B, pad, J, hd))], dim=1)
        v = torch.cat([v, v.new_zeros((B, pad, J, hd))], dim=1)
        q_pos = torch.cat([q_pos, q_pos.new_full((pad,), -10 * w)])
    Sp = q.shape[1]
    nb = Sp // w
    qb = q.reshape(B, nb, w, J, G, hd)
    kb = k.reshape(B, nb, w, J, hd)
    vb = v.reshape(B, nb, w, J, hd)
    # the previous key block (block −1 = zeros, masked out by position)
    k2 = torch.cat([torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], 1),
                    kb], dim=2)                          # (B, nb, 2w, J, hd)
    v2 = torch.cat([torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], 1),
                    vb], dim=2)
    qp = q_pos.reshape(nb, w)
    # key positions come from the block structure (padded keys at −1)
    ar = torch.arange(Sp, device=q.device)
    kpb = torch.where(ar < S, ar, -1).reshape(nb, w)
    kp = torch.cat([torch.cat([kpb.new_full((1, w), -1), kpb[:-1]], 0), kpb],
                   dim=1)                                # (nb, 2w)
    mask = ((kp[:, None, :] <= qp[:, :, None])
            & (kp[:, None, :] > qp[:, :, None] - w) & (kp[:, None, :] >= 0))
    mask = mask[None, :, None, None]                     # (1, nb, 1, 1, w, 2w)
    s = torch.einsum("bnqjgh,bnkjh->bnjgqk", qb, k2).to(torch.float32) * scale
    s = _softcap(s, softcap)
    s = torch.where(mask, s, torch.full((), ref.NEG_INF, device=s.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bnjgqk,bnkjh->bnqjgh", p.to(v2.dtype), v2)
    return o.reshape(B, Sp, J * G, hd)[:, :S]


class _FlashForwardOnly(torch.autograd.Function):
    """``flash_attention`` with no backward: the JAX package's kernel has no
    VJP either, so the reference cannot train through it."""

    @staticmethod
    def forward(ctx, q, k, v, window):
        return ops.attention(q, k, v, causal=True, window=window)

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError(
            "flash_attention has no backward kernel (the JAX package's has no "
            "VJP): train with use_pallas off")


def flash_attend(qf, k, v, *, window: int = 0):
    """The ``use_pallas`` route: qf (B, S, H, hd) post-rope, k, v (B, S, KV,
    hd) -> (B, S, H, hd) through the ``flash_attention`` wrapper, causal.
    Differentiating through it raises."""
    return _FlashForwardOnly.apply(qf, k, v, window)


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, dtype, device="cpu") -> dict:
    """Cache for one attention layer: a ring buffer of C = min(window,
    max_len) slots with a window, else max_len."""
    C = min(cfg.window, max_len) if cfg.window else max_len
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, C, KV, hd), dtype=dtype, device=device),
        "kpos": torch.full((C,), -1, dtype=torch.int32, device=device),
    }


def cache_insert(cache: dict, k1, v1, pos: int) -> dict:
    """Write a single token's k1, v1 (B, 1, KV, hd) at absolute position
    ``pos`` (slot pos % C), in place."""
    slot = pos % cache["k"].shape[1]
    cache["k"][:, slot] = k1[:, 0]
    cache["v"][:, slot] = v1[:, 0]
    cache["kpos"][slot] = pos
    return cache


def cache_prefill(cache: dict, k, v, positions) -> dict:
    """Write a prefill's k, v (B, S, KV, hd) at ``positions`` (S,) in place,
    keeping the last C tokens when S >= C (each at slot pos % C)."""
    C = cache["k"].shape[1]
    if k.shape[1] >= C:
        k, v, positions = k[:, -C:], v[:, -C:], positions[-C:]
    slots = positions % C
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["kpos"][slots] = positions.to(torch.int32)
    return cache


def decode_attend(q1, cache: dict, pos: int, *, window: int = 0,
                  softcap: float = 0.0):
    """q1 (B, 1, J, G, hd) against the cache at position ``pos``; returns
    (B, 1, H, hd)-flat.  The plain route (``use_pallas`` off): the kernel's
    plain version, which divides the scores by √hd where the reference's
    ``decode_attend`` multiplies by 1/√hd (the same bits for hd 64, at most
    an ulp of a score apart otherwise).  With ``softcap`` the scores take
    the reference's order instead (times 1/√hd, capped, then masked); the
    kernel's plain version has no cap, as neither kernel has."""
    if not softcap:
        return ref.decode_attention_ref(q1, cache["k"], cache["v"],
                                        cache["kpos"], pos, window=window)
    B, _, J, G, hd = q1.shape
    kpos = cache["kpos"]
    mask = (kpos >= 0) & (kpos <= pos)
    if window:
        mask &= kpos > pos - window
    s = torch.einsum("bqjgh,bkjh->bjgqk", q1, cache["k"]).to(torch.float32)
    s = _softcap(s * (1.0 / math.sqrt(hd)), softcap)
    return ref.masked_softmax_pv(s, mask, cache["v"]).reshape(B, 1, J * G, hd)
