"""Shared layer primitives: rmsnorm, the swiglu and geglu MLPs, tied
embedding, RoPE.

Functional like the JAX package's ``models/layers.py``: ``init_*`` builds a
params dict (same leaf names and layouts), the apply functions are plain
functions of tensors.  Numerics follow the reference: the norm runs in f32
with eps 1e-6, RoPE rotates split halves (not interleaved pairs), the
unembedding reuses the embedding matrix, and geglu's GeLU is the tanh
approximation, ``jax.nn.gelu``'s default (PyTorch's default is the erf form).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype,
                device) -> torch.Tensor:
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, dtype, device) -> dict:
    return {"scale": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def apply_norm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """rmsnorm in f32, cast back to ``x.dtype``."""
    xf = x.to(torch.float32)
    ms = (xf ** 2).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(ms + eps) * p["scale"].to(torch.float32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {"wi": _dense_init(gen, (d_model, d_ff), d_model, dtype, device),
            "wo": _dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
            "wg": _dense_init(gen, (d_model, d_ff), d_model, dtype, device)}


def apply_mlp(p: dict, x: torch.Tensor, act: str = "swiglu") -> torch.Tensor:
    """swiglu: (silu(x wg) * x wi) wo; geglu: (gelu(x wg) * x wi) wo."""
    if act == "swiglu":
        g = F.silu(x @ p["wg"])
    elif act == "geglu":
        g = F.gelu(x @ p["wg"], approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act!r}")
    return (g * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# Embeddings / unembedding (tied)
# ---------------------------------------------------------------------------

def init_embed(gen, vocab: int, d_model: int, dtype, device) -> dict:
    return {"embedding": _dense_init(gen, (vocab, d_model), d_model, dtype,
                                     device)}


def embed_tokens(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def unembed(p: dict, x: torch.Tensor) -> torch.Tensor:
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
