"""Mamba-1 selective SSM block (the falcon-mamba-7b family, arXiv:2312.00752
/ 2410.05355), the port of the JAX package's ``models/ssm.py``.

The sequence mixer is the diagonal linear recurrence
``h_t = a_t·h_{t−1} + b_t`` with input-dependent (selective) a, b.
:func:`chunked_linear_scan` routes it as the reference does: with
``cfg.use_pallas`` and a prompt the kernel takes, through the Hopper
``linear_recurrence`` (:mod:`repro_torch.kernels.linear_recurrence`);
otherwise through a scan sequential over chunks and parallel inside a chunk.

Dtypes follow the reference's promotions: in bf16, ``dt`` is f32 (bf16 plus
the f32 bias), ``a`` and ``b`` are f32, the state is f32, and the readout is
cast back to the activations' dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers


# ---------------------------------------------------------------------------
# Chunked diagonal linear recurrence
# ---------------------------------------------------------------------------

def chunked_linear_scan(a: torch.Tensor, b: torch.Tensor,
                        h0: torch.Tensor | None = None, chunk: int = 64,
                        use_pallas: bool = False):
    """h_t = a_t·h_{t−1} + b_t along axis 1.

    a, b: (B, S, ...); h0: (B, ...) initial state (zeros if None).  Returns
    (h_all (B, S, ...), h_last (B, ...)).

    With ``use_pallas``, S > 1 and blocks that tile (B, S, C) as the
    reference's kernel needs them, the inputs go to the kernel as f32
    (B, S, C) with h0 folded into b_0 (b_0 += a_0·h0) and the results come
    back f32.  The fold is made in place: when ``b`` is already a contiguous
    f32 tensor, its first time step holds b_0 + a_0·h0 afterwards (the
    caller's temporary, as in :func:`mamba_forward`; a copy would be the
    size of the whole input).  Otherwise the chunked scan runs in the
    inputs' dtype."""
    B, S = a.shape[:2]
    rest = tuple(a.shape[2:])
    if h0 is None:
        h0 = torch.zeros((B,) + rest, dtype=a.dtype, device=a.device)
    C = math.prod(rest)
    # the reference's condition: its kernel's time blocks of min(128, S) and
    # channel blocks of min(512, C) tile the input exactly
    if use_pallas and S > 1 and S % min(128, S) == 0 and C % min(512, C) == 0:
        af = a.reshape(B, S, C).to(torch.float32)
        bf = b.reshape(B, S, C).to(torch.float32)
        bf[:, 0] += af[:, 0] * h0.reshape(B, C).to(torch.float32)
        h_all, h_last = ops.linear_recurrence(af, bf)
        return h_all.view((B, S) + rest), h_last.view((B,) + rest)
    return _chunked_scan(a, b, h0, min(chunk, S))


def _chunked_scan(a, b, h0, c):
    """The scan sequential over chunks of c steps: within every chunk at
    once the prefix pairs (A_t, B_t) with h_t = A_t·h_start + B_t (a
    log-step scan of combine((a1, b1), (a2, b2)) = (a1·a2, a2·b1 + b2)),
    then the state carried from chunk to chunk.  a is padded with 1 and b
    with 0 to a whole number of chunks."""
    B, S = a.shape[:2]
    rest = tuple(a.shape[2:])
    pad = (-S) % c
    if pad:
        a = torch.cat([a, a.new_ones((B, pad) + rest)], dim=1)
        b = torch.cat([b, b.new_zeros((B, pad) + rest)], dim=1)
    nc = a.shape[1] // c
    A = a.reshape((B, nc, c) + rest)
    Bc = b.reshape((B, nc, c) + rest)
    d = 1
    while d < c:
        A, Bc = (torch.cat([A[:, :, :d], A[:, :, :-d] * A[:, :, d:]], dim=2),
                 torch.cat([Bc[:, :, :d],
                            A[:, :, d:] * Bc[:, :, :-d] + Bc[:, :, d:]],
                           dim=2))
        d *= 2
    h = h0
    chunks = []
    for k in range(nc):
        h_chunk = A[:, k] * h[:, None] + Bc[:, k]           # (B, c, ...)
        h = h_chunk[:, -1]
        chunks.append(h_chunk)
    h_all = torch.cat(chunks, dim=1)
    return h_all[:, :S], h


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  state: torch.Tensor | None = None):
    """Depthwise causal conv.  x: (B, S, C); w: (width, C); state: (B,
    width−1, C) holds the trailing inputs of the previous segment.  Returns
    (y, new_state); the taps are summed in order i = 0 … width−1, as the
    reference's ``sum``."""
    width = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, width):
        y = y + xp[:, i:i + S] * w[i]
    new_state = xp[:, -(width - 1):] if width > 1 else state
    return y + b, new_state


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

def init_mamba(gen, cfg, dtype, device) -> dict:
    """Random parameters from ``gen`` in the reference's leaves and layouts:
    S4D-real A (A_log f32 whatever ``dtype``), dt_bias the inverse softplus
    of a dt drawn log-uniform in [1e-3, 0.1]."""
    D, di, N, dr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank
    w = cfg.conv_width
    A = torch.arange(1, N + 1, dtype=torch.float32,
                     device=device)[None].repeat(di, 1)
    u = torch.rand((di,), generator=gen, device=device)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = torch.log(torch.expm1(torch.clamp(dt, min=1e-4)))
    return {
        "in_proj": layers._dense_init(gen, (D, 2 * di), D, dtype, device),
        "conv_w": layers._dense_init(gen, (w, di), w, dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": layers._dense_init(gen, (di, dr + 2 * N), di, dtype, device),
        "dt_proj": layers._dense_init(gen, (dr, di), dr, dtype, device),
        "dt_bias": dt_bias.to(dtype),
        "A_log": torch.log(A),
        "Dskip": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": layers._dense_init(gen, (di, D), di, dtype, device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _selective_terms(p, xc, cfg):
    """From post-conv activations xc (B, S, di) build the recurrence terms
    a, b (B, S, di, N) f32 and Cmat (B, S, N)."""
    N, dr = cfg.ssm_state, cfg.dt_rank
    dbc = xc @ p["x_proj"]
    dt_low, Bmat, Cmat = torch.split(dbc, [dr, N, N], dim=-1)
    dt = _softplus(dt_low @ p["dt_proj"]
                   + p["dt_bias"].to(torch.float32))          # (B, S, di)
    A = -torch.exp(p["A_log"])                                 # (di, N)
    a = (dt[..., None] * A).exp_()                             # (B, S, di, N)
    b = ((dt * xc.to(torch.float32))[..., None]
         * Bmat[:, :, None, :].to(torch.float32))
    return a, b, Cmat


def mamba_forward(p, x, cfg, *, state=None, chunk: int = 64):
    """x: (B, S, D) -> (y (B, S, D), new_state).  ``state`` is the serve
    cache {'conv': (B, w−1, di), 'h': (B, di, N)} or None for training."""
    xz = x @ p["in_proj"]
    xr, z = xz.chunk(2, dim=-1)
    xc, new_conv = causal_conv1d(xr, p["conv_w"], p["conv_b"],
                                 state["conv"] if state else None)
    xc = F.silu(xc)
    a, b, Cmat = _selective_terms(p, xc, cfg)
    h_all, h_last = chunked_linear_scan(
        a, b, state["h"] if state else None, chunk=chunk,
        use_pallas=cfg.use_pallas)
    del a, b
    y = (h_all @ Cmat.to(torch.float32)[..., None])[..., 0].to(x.dtype)
    del h_all
    y = y + p["Dskip"] * xc
    y = y * F.silu(z)
    return y @ p["out_proj"], {"conv": new_conv, "h": h_last}


def init_mamba_cache(cfg, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                         dtype=torch.float32, device=device),
    }
