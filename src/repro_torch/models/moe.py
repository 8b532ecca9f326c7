"""Mixture-of-Experts layer (granite-moe-3b-a800m, llama4-maverick), the port
of the JAX package's ``models/moe.py``: top-k routing with capacity-based
einsum dispatch.

Every product is the reference's: a (T, E) router, the (T, k) top-k gates
renormalized, each (token, choice) given a slot of its expert's capacity
buffer by a cumulative sum over the token-major (T·k, E) one-hot, the
dispatch and combine one-hots (T, E, C), the experts' swiglu on the
(E, C, D) buffer, an optional shared swiglu expert, and the Switch-style
load-balance loss.  A (token, choice) past its expert's capacity goes to
slot C, off the buffer, so it adds nothing (the residual stream carries
the token).  None of it is a kernel in the reference: the einsums stay
``torch.einsum``.

Ties among gates (frequent in bf16 among 40 experts) go to the lower expert
index, as ``jax.lax.top_k`` orders them: the top k come from a stable
descending sort, where ``torch.topk`` promises no order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import layers


def _padded_experts(cfg) -> int:
    return getattr(cfg, "moe_pad_experts", 0) or cfg.num_experts


def init_moe(gen, cfg, dtype, device) -> dict:
    """Random parameters from ``gen`` in the reference's leaves and layouts:
    ``router`` (D, E), the experts' ``wi``, ``wg`` (E, D, F) and ``wo``
    (E, F, D), and with ``cfg.shared_expert`` a swiglu MLP ``shared``."""
    D, F_ = cfg.d_model, cfg.moe_d_ff or cfg.d_ff
    E = _padded_experts(cfg)
    p = {"router": layers._dense_init(gen, (D, E), D, dtype, device),
         "wi": layers._dense_init(gen, (E, D, F_), D, dtype, device),
         "wg": layers._dense_init(gen, (E, D, F_), D, dtype, device),
         "wo": layers._dense_init(gen, (E, F_, D), F_, dtype, device)}
    if cfg.shared_expert:
        p["shared"] = layers.init_mlp(gen, D, F_, "swiglu", dtype, device)
    return p


def _capacity(tokens: int, k: int, num_experts: int,
              factor: float = 1.25) -> int:
    return max(4, int(math.ceil(tokens * k * factor / num_experts)))


def top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, largest
    first and, among equal values, the lower index first (the order of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p: dict, xf: torch.Tensor, cfg, capacity_factor=None) -> dict:
    """The router of a (T, D) token stream: ``gates`` (T, E) f32, the top-k
    ``topv`` (renormalized) and ``topi`` (T, k), each choice's slot ``pos``
    in its expert's buffer and whether it is ``keep``-t (pos < C), and the
    capacity ``C``."""
    E, k = _padded_experts(cfg), cfg.experts_per_token
    T = xf.shape[0]
    logits = (xf @ p["router"]).to(torch.float32)
    if E > cfg.num_experts:      # never route to padding experts
        logits = torch.cat([logits[:, :cfg.num_experts],
                            logits.new_full((T, E - cfg.num_experts),
                                            -1e30)], dim=-1)
    gates = torch.softmax(logits, dim=-1)
    topv, topi = top_k(gates, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    cf = (capacity_factor if capacity_factor is not None
          else getattr(cfg, "moe_capacity_factor", 1.25))
    C = _capacity(T, k, E, cf)
    flat = F.one_hot(topi, E).reshape(T * k, E)
    # each (token, choice)'s place in its expert's buffer, token-major: an
    # exact integer scan, run along the rows of the (E, T·k) transpose (a
    # scan down T·k rows of E columns keeps E threads of the card busy and
    # took 3 ms a layer of granite's 1920-token prefill)
    pos = torch.cumsum(flat.t().contiguous(), dim=1).t() - flat
    pos = (pos * flat).sum(-1).reshape(T, k)
    return {"gates": gates, "topv": topv, "topi": topi, "pos": pos,
            "keep": pos < C, "C": C}


def apply_moe(p: dict, x: torch.Tensor, cfg, capacity_factor=None,
              with_aux: bool = True):
    """x: (B, S, D) -> (out (B, S, D), aux f32 scalar, or None without
    ``with_aux``: a serve step never reads it).

    With ``cfg.moe_seq_group`` > 0 dividing B·S (and smaller than it), each
    group of that many tokens is dispatched on its own (the reference vmaps
    them) and aux is the mean over groups."""
    group = getattr(cfg, "moe_seq_group", 0)
    B, S, D = x.shape
    T_all = B * S
    if group and T_all > group and T_all % group == 0:
        outs, auxs = zip(*(
            _moe_dense(p, xg, cfg, capacity_factor, with_aux)
            for xg in x.reshape(T_all // group, 1, group, D)))
        out = torch.cat(outs, dim=0).reshape(B, S, D)
        return out, torch.stack(auxs).mean() if with_aux else None
    return _moe_dense(p, x, cfg, capacity_factor, with_aux)


def _moe_dense(p: dict, x: torch.Tensor, cfg, capacity_factor=None,
               with_aux: bool = True):
    B, S, D = x.shape
    E = _padded_experts(cfg)
    xf = x.reshape(B * S, D)
    r = route(p, xf, cfg, capacity_factor)
    C = r["C"]
    de = F.one_hot(r["topi"], E).to(xf.dtype)                     # (T, k, E)
    # a dropped choice's slot is C: the extra class, cut off the buffer
    dc = F.one_hot(torch.where(r["keep"], r["pos"], C), C + 1)[..., :C].to(
        xf.dtype)                                                 # (T, k, C)
    dispatch = torch.einsum("tke,tkc->tec", de, dc)
    # the reference's "tke,tkc,tk->tec": a token's k experts are distinct,
    # so each (t, e) sums one term and the gate can ride on de exactly
    combine = torch.einsum("tke,tkc->tec",
                           de * r["topv"].to(xf.dtype)[..., None], dc)
    xin = torch.einsum("tec,td->ecd", dispatch, xf)               # (E, C, D)
    h = torch.einsum("ecd,edf->ecf", xin, p["wi"])
    g = torch.einsum("ecd,edf->ecf", xin, p["wg"])
    xout = torch.einsum("ecf,efd->ecd", F.silu(g) * h, p["wo"])
    out = torch.einsum("tec,ecd->td", combine, xout)
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], xf, "swiglu")
    if not with_aux:
        return out.reshape(B, S, D), None
    # Switch-style load-balance loss over each token's first choice
    density = F.one_hot(r["topi"][:, 0], E).to(torch.float32).mean(0)
    aux = E * torch.sum(density * r["gates"].mean(0))
    return out.reshape(B, S, D), aux
