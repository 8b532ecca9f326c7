"""Plain PyTorch Whisper (arXiv:2212.04356) behind a stubbed audio frontend:
the parameter tree, the training loss of one node's micro-batch and its
model FLOPs.

The encoder takes the micro-batch's frame embeddings (b, 1500, d) in place of
the two convolutions over the mel spectrogram, adds sinusoidal positions and
runs pre-norm layers of bidirectional attention and a GELU MLP; the decoder
embeds the tokens, adds the same sinusoidal positions and runs pre-norm
layers of causal self attention, cross attention over the encoder's output
and the MLP; a final LayerNorm and the tied unembedding give the logits, and
the loss is the mean next-token cross-entropy.  The configuration file lists
where the run departs from the published model (``reduced``): no attention
biases, sinusoidal decoder positions, GELU's tanh form, LayerNorm eps 1e-6.
"""

from __future__ import annotations

import math

import torch

from . import decoder
from . import precision as P


def sizes(c: dict) -> tuple:
    d, H = c["d_model"], c["decoder_attention_heads"]
    return (c["encoder_layers"], c["decoder_layers"], d, H, d // H,
            c["decoder_ffn_dim"], c["vocab_size"], c["max_source_positions"])


def _attn_spec(prefix: str, L: int, d: int, H: int, hd: int) -> list:
    return [(f"{prefix}/wq", (L, d, H, hd), ("normal", d)),
            (f"{prefix}/wk", (L, d, H, hd), ("normal", d)),
            (f"{prefix}/wv", (L, d, H, hd), ("normal", d)),
            (f"{prefix}/wo", (L, H, hd, d), ("normal", H * hd))]


def _norm_spec(prefix: str, shape: tuple) -> list:
    return [(f"{prefix}/scale", shape, ("ones",)),
            (f"{prefix}/bias", shape, ("zeros",))]


def _mlp_spec(prefix: str, L: int, d: int, ff: int) -> list:
    return [(f"{prefix}/wi", (L, d, ff), ("normal", d)),
            (f"{prefix}/wo", (L, ff, d), ("normal", ff))]


def param_spec(c: dict) -> list:
    Le, Ld, d, H, hd, ff, V, Se = sizes(c)
    spec = [("embed/embedding", (V, d), ("normal", d))]
    spec += _norm_spec("enc_norm", (d,)) + _norm_spec("final_norm", (d,))
    for name in ("ln1", "ln2"):
        spec += _norm_spec(f"enc/{name}", (Le, d))
    spec += _attn_spec("enc/attn", Le, d, H, hd) + _mlp_spec("enc/mlp", Le,
                                                             d, ff)
    for name in ("ln1", "ln_x", "ln2"):
        spec += _norm_spec(f"dec/{name}", (Ld, d))
    spec += _attn_spec("dec/self", Ld, d, H, hd)
    spec += _attn_spec("dec/cross", Ld, d, H, hd)
    spec += _mlp_spec("dec/mlp", Ld, d, ff)
    return spec


def port_fields(c: dict) -> dict:
    Le, Ld, d, H, hd, ff, V, Se = sizes(c)
    if (c["encoder_attention_heads"] != H or c["encoder_ffn_dim"] != ff
            or c["activation_function"] != "gelu_tanh"):
        raise ValueError("the encoder-decoder reference runs one head count, "
                         "one MLP width and GELU's tanh form")
    return dict(name=c["name"], arch_type="audio", num_layers=Ld,
                encoder_layers=Le, encoder_seq=Se, d_model=d, num_heads=H,
                num_kv_heads=H, d_ff=ff, vocab_size=V, norm="layernorm",
                mlp_act="gelu", rope_theta=0.0, frontend="audio",
                dtype=c["training_dtype"])


def batch_fields(c: dict, b: int, S: int) -> dict:
    Se, d = c["max_source_positions"], c["d_model"]
    return {"tokens": ((b, S), "tokens"), "frames": ((b, Se, d), "frames")}


def layernorm(x, scale, bias, eps):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return (xf - mu) * torch.rsqrt(var + eps) * scale + bias


def sinusoids(S: int, d: int, device):
    half = d // 2
    k = torch.arange(half, dtype=torch.float32, device=device)
    freq = torch.exp(-math.log(10_000.0) * k / max(1, half - 1))
    ang = torch.arange(S, dtype=torch.float32, device=device)[:, None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp(h, wi, wo):
    a = torch.nn.functional.gelu(P.matmul(h, wi), approximate="tanh")
    return P.matmul(a, wo)


def attend(g, x, kv, H, hd, causal):
    q = decoder.proj(x, g("wq"), H, hd)
    k = decoder.proj(kv, g("wk"), H, hd)
    v = decoder.proj(kv, g("wv"), H, hd)
    o = decoder.attention(q, k, v, causal)
    return P.matmul(o, g("wo").reshape(H * hd, -1))


def loss(get, c: dict, batch: dict) -> torch.Tensor:
    Le, Ld, d, H, hd, ff, V, Se = sizes(c)
    eps = c["layer_norm_eps"]
    tok, frames = batch["tokens"], batch["frames"]

    def norm(path, l, x):
        return layernorm(x, get(f"{path}/scale", l), get(f"{path}/bias", l),
                         eps)

    x = frames.float() + sinusoids(frames.shape[1], d, frames.device)
    for l in range(Le):
        h = norm("enc/ln1", l, x)
        x = x + attend(lambda n: get(f"enc/attn/{n}", l), h, h, H, hd, False)
        h = norm("enc/ln2", l, x)
        x = x + mlp(h, get("enc/mlp/wi", l), get("enc/mlp/wo", l))
    enc = norm("enc_norm", None, x)
    E = get("embed/embedding", None)
    x = E[tok] + sinusoids(tok.shape[1], d, tok.device)
    for l in range(Ld):
        h = norm("dec/ln1", l, x)
        x = x + attend(lambda n: get(f"dec/self/{n}", l), h, h, H, hd, True)
        h = norm("dec/ln_x", l, x)
        x = x + attend(lambda n: get(f"dec/cross/{n}", l), h, enc, H, hd,
                       False)
        h = norm("dec/ln2", l, x)
        x = x + mlp(h, get("dec/mlp/wi", l), get("dec/mlp/wo", l))
    x = norm("final_norm", None, x)
    logits = P.matmul(x, E.T)
    return decoder.cross_entropy(logits[:, :-1], tok[:, 1:])


def model_flops(c: dict, b: int, S: int) -> int:
    """Forward and backward FLOPs of one micro-batch of b utterances of Se
    frames and S target tokens: every product twice more in the backward
    pass, the decoder's self attention over its causal pairs only, the
    encoder's and the cross attention over every pair."""
    Le, Ld, d, H, hd, ff, V, Se = sizes(c)
    te, td = b * Se, b * S
    hd_all = H * hd
    enc = (8 * te * d * hd_all + 4 * te * d * ff
           + 4 * b * hd_all * Se * Se)
    dec = (8 * td * d * hd_all + 4 * td * d * ff
           + 4 * b * hd_all * decoder.causal_pairs(S)
           + 4 * td * d * hd_all + 4 * te * d * hd_all
           + 4 * b * hd_all * S * Se)
    return 3 * (Le * enc + Ld * dec + 2 * td * d * V)


def masked_flops(c: dict, b: int, S: int) -> int:
    Le, Ld, d, H, hd, ff, V, Se = sizes(c)
    return 3 * Ld * 4 * b * H * hd * (S * S - decoder.causal_pairs(S))
