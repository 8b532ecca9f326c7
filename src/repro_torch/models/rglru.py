"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427), the
port of the JAX package's ``models/rglru.py``.

Two branches from the block's input: the recurrent branch (a causal conv,
then the RG-LRU gated diagonal recurrence ``h_t = a_t·h_{t−1} + b_t``) and
the gate branch (GeLU, the tanh form as ``jax.nn.gelu``'s default), merged
by a product and projected back to d_model.  The recurrence is mamba's, so
it goes through :func:`repro_torch.models.ssm.chunked_linear_scan` and, with
``cfg.use_pallas`` and a prompt the kernel takes, the Hopper
``linear_recurrence``.

Dtypes follow the reference's promotions: the gates are cast to f32, so
``a`` and ``b`` are f32, as is the state ``h``; ``lam`` is f32 whatever the
model's dtype (a serve fleet cast to bf16 casts it too, as the reference's
``astype`` does).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers, ssm

_C_EXP = 8.0  # Griffin's fixed exponent scale


def init_rglru(gen, cfg, dtype, device) -> dict:
    """Random parameters from ``gen`` in the reference's leaves and layouts:
    ``lam`` (f32) is the logit of a drawn uniformly in [0.9, 0.999], as
    Griffin initialises a = sigmoid(lam)."""
    D, R, w = cfg.d_model, cfg.lru_width, cfg.conv_width
    u = torch.rand((R,), generator=gen, device=device) * (0.999 - 0.9) + 0.9
    return {
        "wx": layers._dense_init(gen, (D, R), D, dtype, device),
        "wy": layers._dense_init(gen, (D, R), D, dtype, device),
        "conv_w": layers._dense_init(gen, (w, R), w, dtype, device),
        "conv_b": torch.zeros((R,), dtype=dtype, device=device),
        "w_rgate": layers._dense_init(gen, (R, R), R, dtype, device),
        "w_igate": layers._dense_init(gen, (R, R), R, dtype, device),
        "b_rgate": torch.zeros((R,), dtype=dtype, device=device),
        "b_igate": torch.zeros((R,), dtype=dtype, device=device),
        "lam": torch.log(u / (1 - u)),
        "wo": layers._dense_init(gen, (R, D), R, dtype, device),
    }


def rglru_forward(p, x, cfg, *, state=None, chunk: int = 64):
    """x: (B, S, D) -> (y (B, S, D), new_state).  ``state`` is the serve
    cache {'conv': (B, w−1, R), 'h': (B, R) f32} or None for training.
    ``b`` is a fresh f32 tensor, so the scan may fold h0 into it in
    place."""
    xb = x @ p["wx"]
    yb = F.gelu(x @ p["wy"], approximate="tanh")
    xc, new_conv = ssm.causal_conv1d(xb, p["conv_w"], p["conv_b"],
                                     state["conv"] if state else None)
    r = torch.sigmoid(xc @ p["w_rgate"] + p["b_rgate"]).to(torch.float32)
    i = torch.sigmoid(xc @ p["w_igate"] + p["b_igate"]).to(torch.float32)
    log_a_base = -ssm._softplus(-p["lam"])          # log sigmoid(lam) <= 0
    log_a = _C_EXP * r * log_a_base
    a = torch.exp(log_a)
    gated_x = i * xc.to(torch.float32)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * gated_x
    del r, i, log_a, gated_x
    h_all, h_last = ssm.chunked_linear_scan(
        a, b, state["h"] if state else None, chunk=chunk,
        use_pallas=cfg.use_pallas)
    del a, b
    y = h_all.to(x.dtype) * yb
    return y @ p["wo"], {"conv": new_conv, "h": h_last}


def init_rglru_cache(cfg, batch: int, dtype, device) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, cfg.lru_width),
                            dtype=dtype, device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }
