"""Plain PyTorch versions of the port's kernels: what each wrapper computes on
a CPU tensor, and what ``chip_smoke.py`` holds each CUDA kernel to on the
card.  They repeat the kernels' arithmetic (f32 accumulation, cast back to
the input dtype) and are no yardstick of speed."""

from __future__ import annotations

import torch


def gossip_mix_ref(ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) -> W_{R-1} ... W_0 x, accumulated in f32 and
    returned in ``x.dtype`` (the JAX package's ``kernels/ref.py``
    ``gossip_mix_ref``)."""
    out = x.to(torch.float32)
    for r in range(ws.shape[0]):
        out = ws[r].to(torch.float32) @ out
    return out.to(x.dtype)


def quantize_dequantize_ref(buf: torch.Tensor, *, scheme: str,
                            group: int = 256):
    """Group-wise quantize -> dequantize of an (n, D) f32 matrix (D % group
    == 0): (dequantized, error = buf - dequantized).  The JAX package's
    ``kernels/ref.py`` ``quantize_dequantize_ref``.

    ``sign``: sign(g)·mean|g| per (node, group), sign(0) = 0, so an all-zero
    group stays zero.  ``int8``: s = max|g| / 127 (a division, as the
    reference: multiplying by 1/127 differs in the last bit), q =
    clip(round(g / s), ±127) with ``torch.round`` rounding half to even
    like ``jnp.round``, deq = q·s; an all-zero group divides by 1 instead
    of 0 and stays zero.

    Both divisors are 0-dim tensors on ``buf``'s device: on a CUDA tensor
    PyTorch turns a division by a Python number into a product by its
    reciprocal, which differs from the division in the last bit."""
    n, D = buf.shape
    if D % group:
        raise ValueError(f"D={D} is not a multiple of group={group}")
    g = buf.reshape(n, D // group, group)
    if scheme == "sign":
        scale = (g.abs().sum(dim=-1, keepdim=True)
                 / torch.full((), float(group), device=g.device))
        deq = torch.sign(g) * scale
    elif scheme == "int8":
        scale = (g.abs().amax(dim=-1, keepdim=True)
                 / torch.full((), 127.0, device=g.device))
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(g / safe), -127.0, 127.0)
        deq = q * scale
    else:
        raise ValueError(f"unknown compression scheme {scheme!r} "
                         "(quantizing schemes: 'sign', 'int8')")
    deq = deq.reshape(n, D)
    return deq, buf - deq


def quantized_gossip_mix_ref(ws: torch.Tensor, x: torch.Tensor,
                             res: torch.Tensor, *, scheme: str,
                             group: int = 256, error_feedback: bool = True):
    """Error-feedback compressed multi-consensus (the JAX package's
    ``quantized_gossip_mix_ref``).  Per round r: buf = x + res; deq =
    dequant(quant(buf)); res <- buf - deq when ``error_feedback``; x <-
    ws[r] @ deq.  ws: (R, n, n); x, res: (n, D), D % group == 0.  Returns
    (mixed x, final residual) in the inputs' dtypes."""
    out = x.to(torch.float32)
    rs = res.to(torch.float32)
    for r in range(ws.shape[0]):
        buf = out + rs
        deq, err = quantize_dequantize_ref(buf, scheme=scheme, group=group)
        if error_feedback:
            rs = err
        out = ws[r].to(torch.float32) @ deq
    return out.to(x.dtype), rs.to(res.dtype)


def sparse_gossip_mix_ref(seg: torch.Tensor, w: torch.Tensor,
                          xs: torch.Tensor, xd: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """Segment sum of weighted edge differences (the JAX package's
    ``sparse_gossip_mix_ref``): delta[s] = sum over e with seg[e] == s of
    w[e]·(xs[e] − xd[e]), in f32.  seg, w: (E,); xs, xd: (E, D) gathered
    endpoint states.  Padded edges carry w = 0 and add nothing.  Returns
    (num_segments, D) f32; ``index_add_`` takes the place of
    ``jax.ops.segment_sum``."""
    contrib = w[:, None].to(torch.float32) * (
        xs.to(torch.float32) - xd.to(torch.float32))
    out = torch.zeros((num_segments, xs.shape[1]), dtype=torch.float32,
                      device=xs.device)
    return out.index_add_(0, seg, contrib)


def linear_recurrence_ref(a: torch.Tensor, b: torch.Tensor):
    """h_t = a_t·h_{t−1} + b_t along axis 1, h_{−1} = 0 (the JAX package's
    ``linear_recurrence_ref``).  a, b: (B, S, C), any float dtype, each step
    read as f32.  Returns (h_all (B, S, C) f32, h_last (B, C) f32).

    The product and the sum are two elementwise ops, each rounded to f32:
    the Hopper kernel rounds them the same way and is bit-equal to this."""
    B, S = a.shape[:2]
    h_all = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    h = torch.zeros((B,) + a.shape[2:], dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t].to(torch.float32) * h + b[:, t].to(torch.float32)
        h_all[:, t] = h
    return h_all, h
