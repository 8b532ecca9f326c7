"""Plain PyTorch Qwen1.5 (a dense decoder): the parameter tree, the training
loss of one node's micro-batch and its model FLOPs.

Written from the published architecture (hf:Qwen/Qwen1.5-0.5B): token
embeddings; per layer RMSNorm, multi-head attention with biases on q, k and v,
rotary positions on q and k (the split-halves form), a causal softmax, the
output projection, RMSNorm and the SwiGLU MLP; a final RMSNorm and the tied
unembedding; the mean next-token cross-entropy.  The configuration file says
where the run departs from the published model (``reduced``).  Every product
goes through :mod:`.precision`; norms and the softmax run in f32.

A configuration is a dict with the published config's key names
(``hidden_size``, ``num_hidden_layers``, ...).  A parameter is addressed by
its path in the tree the trained program uses, ``units/0_attn/attn/wq``, a
stacked leaf with the layer first; :func:`loss` takes ``get(path, layer)``,
which returns one layer's tensor (``layer`` None for an unstacked leaf).
"""

from __future__ import annotations

import math

import torch

from . import precision as P

NEG_INF = -1e30
UNIT = "units/0_attn"


def sizes(c: dict) -> tuple:
    d, H = c["hidden_size"], c["num_attention_heads"]
    hd = c.get("head_dim") or d // H
    return (c["num_hidden_layers"], d, H, c["num_key_value_heads"], hd,
            c["intermediate_size"], c["vocab_size"])


def param_spec(c: dict) -> list:
    """(path, shape, init) of every leaf: init ``("normal", fan_in)`` (a
    standard normal over sqrt(fan_in)), ``("ones",)`` or ``("zeros",)``."""
    L, d, H, KV, hd, ff, V = sizes(c)
    spec = [("embed/embedding", (V, d), ("normal", d)),
            ("final_norm/scale", (d,), ("ones",)),
            (f"{UNIT}/ln1/scale", (L, d), ("ones",)),
            (f"{UNIT}/ln2/scale", (L, d), ("ones",)),
            (f"{UNIT}/attn/wq", (L, d, H, hd), ("normal", d)),
            (f"{UNIT}/attn/wk", (L, d, KV, hd), ("normal", d)),
            (f"{UNIT}/attn/wv", (L, d, KV, hd), ("normal", d)),
            (f"{UNIT}/attn/wo", (L, H, hd, d), ("normal", H * hd)),
            (f"{UNIT}/mlp/wi", (L, d, ff), ("normal", d)),
            (f"{UNIT}/mlp/wg", (L, d, ff), ("normal", d)),
            (f"{UNIT}/mlp/wo", (L, ff, d), ("normal", ff))]
    if c["qkv_bias"]:
        spec += [(f"{UNIT}/attn/bq", (L, H, hd), ("zeros",)),
                 (f"{UNIT}/attn/bk", (L, KV, hd), ("zeros",)),
                 (f"{UNIT}/attn/bv", (L, KV, hd), ("zeros",))]
    return spec


def port_fields(c: dict) -> dict:
    """The trained program's model configuration for ``c``."""
    L, d, H, KV, hd, ff, V = sizes(c)
    if c["hidden_act"] != "silu" or c["rms_norm_eps"] != 1e-6:
        raise ValueError("the decoder reference runs SwiGLU and eps 1e-6")
    return dict(name=c["name"], arch_type="dense", num_layers=L, d_model=d,
                num_heads=H, num_kv_heads=KV, head_dim=hd, d_ff=ff,
                vocab_size=V, qkv_bias=c["qkv_bias"], mlp_act="swiglu",
                norm="rmsnorm", rope_theta=float(c["rope_theta"]),
                tie_embeddings=c["tie_word_embeddings"],
                dtype=c["training_dtype"])


def batch_fields(c: dict, b: int, S: int) -> dict:
    """A micro-batch's fields: name -> (shape, what is drawn)."""
    return {"tokens": ((b, S), "tokens")}


def rms(x, scale, eps):
    xf = x.float()
    return xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps) * scale


def rope(S: int, hd: int, theta: float, device):
    half = hd // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freq
    return torch.cos(ang), torch.sin(ang)


def rotate(x, cos, sin):
    """x (b, S, heads, hd): split halves rotated by the angles (S, hd/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[:, None], sin[:, None]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def attention(q, k, v, causal: bool):
    """q (b, Sq, H, hd), k and v (b, Sk, KV, hd) -> (b, Sq, H * hd): query
    head h reads key head h // (H / KV); scores scaled by 1/sqrt(hd) and
    softmaxed in f32, masked keys at NEG_INF."""
    b, Sq, H, hd = q.shape
    G = H // k.shape[2]
    if G > 1:
        k, v = k.repeat_interleave(G, dim=2), v.repeat_interleave(G, dim=2)
    s = P.einsum("bqhd,bkhd->bhqk", q, k) * (1.0 / math.sqrt(hd))
    if causal:
        Sk = k.shape[1]
        mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return P.einsum("bhqk,bkhd->bqhd", p, v).reshape(b, Sq, H * hd)


def proj(x, w, heads: int, hd: int, bias=None):
    y = P.matmul(x, w.reshape(w.shape[0], heads * hd))
    if bias is not None:
        y = y + bias.reshape(heads * hd)
    return y.reshape(x.shape[:-1] + (heads, hd))


def cross_entropy(logits, targets):
    lp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(lp, -1, targets[..., None])[..., 0].mean()


def loss(get, c: dict, batch: dict) -> torch.Tensor:
    """The mean next-token cross-entropy of ``batch["tokens"]`` (b, S)."""
    L, d, H, KV, hd, ff, V = sizes(c)
    eps = c["rms_norm_eps"]
    tok = batch["tokens"]
    b, S = tok.shape
    E = get("embed/embedding", None)
    x = E[tok]
    cos, sin = rope(S, hd, float(c["rope_theta"]), tok.device)
    bias = c["qkv_bias"]
    for l in range(L):
        def g(name):
            return get(f"{UNIT}/{name}", l)
        h = rms(x, g("ln1/scale"), eps)
        q = proj(h, g("attn/wq"), H, hd, g("attn/bq") if bias else None)
        k = proj(h, g("attn/wk"), KV, hd, g("attn/bk") if bias else None)
        v = proj(h, g("attn/wv"), KV, hd, g("attn/bv") if bias else None)
        o = attention(rotate(q, cos, sin), rotate(k, cos, sin), v, True)
        x = x + P.matmul(o, g("attn/wo").reshape(H * hd, d))
        h = rms(x, g("ln2/scale"), eps)
        a = torch.nn.functional.silu(P.matmul(h, g("mlp/wg")))
        x = x + P.matmul(a * P.matmul(h, g("mlp/wi")), g("mlp/wo"))
    x = rms(x, get("final_norm/scale", None), eps)
    logits = P.matmul(x, E.T)
    return cross_entropy(logits[:, :-1], tok[:, 1:])


def causal_pairs(S: int) -> int:
    """(query, key) pairs a causal head computes: key j <= query i."""
    return S * (S + 1) // 2


def model_flops(c: dict, b: int, S: int) -> int:
    """Forward and backward FLOPs of one micro-batch of b sequences of S
    tokens: every matrix product twice more in the backward pass, the
    attention's score and value products over the causal pairs only, no
    recomputation, nothing for norms, softmax or the loss."""
    L, d, H, KV, hd, ff, V = sizes(c)
    tok = b * S
    layer = (2 * tok * d * (H + 2 * KV) * hd + 2 * tok * H * hd * d
             + 6 * tok * d * ff + 4 * b * H * hd * causal_pairs(S))
    return 3 * (L * layer + 2 * tok * d * V)


def masked_flops(c: dict, b: int, S: int) -> int:
    """What a counter of the plain products adds on top of
    :func:`model_flops`: the masked half of each causal score and value
    product, forward and backward."""
    L, d, H, KV, hd, ff, V = sizes(c)
    return 3 * L * 4 * b * H * hd * (S * S - causal_pairs(S))
