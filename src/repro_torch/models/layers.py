"""Shared layer primitives: rmsnorm and layernorm, the MLPs (gated swiglu and
geglu, plain gelu and squared-ReLU relu2), the embedding with a tied or
untied unembedding, RoPE and whisper's sinusoidal positions.

Functional like the JAX package's ``models/layers.py``: ``init_*`` builds a
params dict (same leaf names and layouts), the apply functions are plain
functions of tensors.  Numerics follow the reference: both norms run in f32
with eps 1e-6 (layernorm's mean and variance too), RoPE rotates split
halves (not interleaved pairs), a tied unembedding reuses the embedding
matrix (an untied one is its own ``unembed`` (d_model, vocab) leaf), and
every GeLU is the tanh approximation, ``jax.nn.gelu``'s default
(PyTorch's default is the erf form).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# The most values a leaf draws in f32 at once (a multiple of 16); a larger
# leaf is drawn in chunks of whole rows, straight into its destination.
DRAW_CHUNK = 1 << 28


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device, out: torch.Tensor | None = None) -> torch.Tensor:
    """N(0, 1 / in_axis_size) values from ``gen``, cast into ``out`` (a new
    ``dtype`` tensor when None) in chunks of whole rows of the first axis,
    each of a multiple of 16 rows and about DRAW_CHUNK values (the last up
    to twice that), so no more than one chunk exists in f32.  On the CPU the
    chunks draw the bits one ``torch.randn`` of the whole shape would: its
    normal fill turns each 16 uniforms of one stream into 16 values, so
    chunks of a multiple of 16 values continue that stream.  On CUDA a leaf
    drawn in more than one chunk gets other numbers than one draw gives."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    if out is None:
        out = torch.empty(shape, dtype=dtype, device=device)
    rows = out.shape[0]
    step = max(16, DRAW_CHUNK // max(1, out[0].numel()) // 16 * 16)
    r0 = 0
    while r0 < rows:
        r1 = rows if rows - r0 < 2 * step else r0 + step
        out[r0:r1].copy_(torch.randn(out[r0:r1].shape, generator=gen,
                                     device=out.device).mul_(scale))
        r0 = r1
    return out


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, dtype, device) -> dict:
    """rmsnorm's ``scale``; layernorm (``cfg.norm == "layernorm"``) adds a
    zero ``bias``."""
    p = {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((cfg.d_model,), dtype=dtype, device=device)
    return p


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """layernorm where ``p`` has a ``bias``, else rmsnorm; in f32, cast back
    to ``x.dtype``."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    else:
        ms = (xf ** 2).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, act: str, dtype, device) -> dict:
    """wi and wo, and the gate wg for the gated activations (swiglu,
    geglu) only, as in the reference."""
    p = {"wi": _dense_init(gen, (d_model, d_ff), d_model, dtype, device),
         "wo": _dense_init(gen, (d_ff, d_model), d_ff, dtype, device)}
    if act in ("swiglu", "geglu"):
        p["wg"] = _dense_init(gen, (d_model, d_ff), d_model, dtype, device)
    return p


def apply_mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """swiglu: (silu(x wg) * x wi) wo; geglu: (gelu(x wg) * x wi) wo;
    gelu: gelu(x wi) wo; relu2: relu(x wi)² wo (nemotron-4's)."""
    h = x @ p["wi"]
    if act == "swiglu":
        h = F.silu(x @ p["wg"]) * h
    elif act == "geglu":
        h = F.gelu(x @ p["wg"], approximate="tanh") * h
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif act == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown activation {act!r}")
    return h @ p["wo"]


# ---------------------------------------------------------------------------
# Embeddings / unembedding
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device,
               tie: bool = True, out: dict | None = None) -> dict:
    """The (vocab, d_model) embedding, and when untied the (d_model, vocab)
    ``unembed``: drawn straight into ``out``'s leaves when given."""
    out = out or {}
    p = {"embedding": _dense_init(gen, (vocab, d_model), d_model, dtype,
                                  device, out.get("embedding"))}
    if not tie:
        p["unembed"] = _dense_init(gen, (d_model, vocab), d_model, dtype,
                                   device, out.get("unembed"))
    return p


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
    if "unembed" in p:
        return x @ p["unembed"]
    return x @ p["embedding"].T


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """positions: (S,) int -> cos, sin of shape (S, head_dim // 2)."""
    half = head_dim // 2
    idx = torch.arange(half, dtype=torch.float32, device=positions.device)
    freq = theta ** (-idx / half)
    ang = positions[..., None].to(torch.float32) * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, hd); cos/sin: (S, hd//2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # add head axis
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def sinusoidal_positions(seq: int, d_model: int, device="cpu") -> torch.Tensor:
    """Whisper-style fixed sinusoidal embeddings (seq, d_model) f32: sin of
    pos·f_k then cos, f_k = exp(−ln(10⁴)·k / max(1, half − 1)) (the
    reference divides by half − 1, not half)."""
    return sinusoidal_at(torch.arange(seq, dtype=torch.float32,
                                      device=device)[:, None], d_model)


def sinusoidal_at(pos: torch.Tensor, d_model: int) -> torch.Tensor:
    """The table's rows at the f32 positions ``pos`` (..., 1): one row of
    :func:`sinusoidal_positions` for a decode step's position."""
    half = d_model // 2
    k = torch.arange(half, dtype=torch.float32, device=pos.device)
    freq = torch.exp(-math.log(10_000.0) * k / max(1, half - 1))
    ang = pos * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
