"""Plain MC-DSGT (the paper's Algorithm 1 with R-round multi-consensus,
Algorithm 2) over n model copies, with its oracle, its gossip and its
optional int8 error-feedback compression, in plain PyTorch.

The state is one tensor per parameter leaf, (n, *leaf shape), for x, the
tracker h and the previous oracle sample g⁻ (and the residuals r_x and r_h
when compressing).  A step, with γ the step size and each stream's window of
R matrices W_1 ... W_R (x takes the first R of the step's 2R, h the rest):

    x ← Mix_x(x − γ h)
    g ← the oracle at the new x
    h ← Mix_h(h + g − g⁻),  g⁻ ← g

Mix applies the window's rounds one after the other, ``W @ leaf`` on the leaf
flattened to (n, size).  Compressed, every round quantizes the payload plus
its residual group-wise (groups of ``group`` entries of each leaf, a leaf's
last group padded with zeros), keeps the quantization error as the new
residual and mixes the dequantized payload: int8 with the scale max|v| / 127,
rounded half to even and clipped to ±127.  The oracle of node i averages the
loss gradients of its R micro-batches and scales the average to global norm
at most ``clip``.  The warm start queries the oracle at x⁰ and sets h⁰ to the
node mean of g⁰ on every node, g⁻ = g⁰.

``fault`` plants one of the faults the benchmark must catch, for its control
readings: ``half_batch`` (each node's oracle sees half of its samples, the
mean taken over the rest) or ``no_mix`` (every window is the identity).
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from . import precision as P


def weights_per_step(R: int) -> int:
    """Gossip rounds a step takes: R for x, then R for h."""
    return 2 * R


def leaf_views(spec: list) -> list:
    """(path, layer) of every tensor the loss takes: each layer of a stacked
    leaf (its path's first key ``units``, ``enc`` or ``dec``) on its own."""
    out = []
    for path, shape, _ in spec:
        if path.split("/")[0] in ("units", "enc", "dec"):
            out += [(path, l) for l in range(shape[0])]
        else:
            out.append((path, None))
    return out


def quantize_int8(buf: torch.Tensor, group: int):
    """(dequantized, error) of the (n, size) ``buf``, size % group == 0."""
    n, size = buf.shape
    g = buf.reshape(n, size // group, group)
    scale = g.abs().amax(dim=-1, keepdim=True) / torch.full(
        (), 127.0, device=buf.device)
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    deq = (torch.clamp(torch.round(g / safe), -127.0, 127.0) * scale)
    deq = deq.reshape(n, size)
    return deq, buf - deq


class MCDSGT:
    """The rule over one model's leaves.  ``loss(get, batch)`` is the
    model's micro-batch loss; ``spec`` its parameter spec; ``compression``
    None or {"scheme": "int8", "group": g, "error_feedback": True}."""

    def __init__(self, loss: Callable, spec: list, *, n: int, R: int,
                 gamma: float, clip: Optional[float],
                 compression: Optional[dict] = None,
                 fault: Optional[str] = None):
        if compression is not None and (compression["scheme"] != "int8" or
                                        not compression["error_feedback"] or
                                        compression.get("warmup", 0)):
            raise ValueError("the reference compresses with int8 error "
                             "feedback from the first step only")
        if fault not in (None, "half_batch", "no_mix"):
            raise ValueError(f"unknown fault {fault!r}")
        self.loss, self.spec, self.views = loss, spec, leaf_views(spec)
        self.n, self.R, self.gamma, self.clip = n, R, gamma, clip
        self.comp, self.fault = compression, fault

    # -- state ------------------------------------------------------------

    def init(self, params: dict) -> dict:
        """n copies of ``params`` ({path: tensor}); residuals at zero."""
        st = {"x": {p: params[p][None].expand(self.n, *params[p].shape)
                    .clone() for p, _, _ in self.spec}}
        if self.comp is not None:
            st["res_x"] = {p: self._zeros_padded(params[p])
                           for p, _, _ in self.spec}
            st["res_h"] = {p: self._zeros_padded(params[p])
                           for p, _, _ in self.spec}
        return st

    def _zeros_padded(self, t):
        group = self.comp["group"]
        size = -(-t.numel() // group) * group
        return torch.zeros(self.n, size, dtype=torch.float32, device=t.device)

    # -- oracle -----------------------------------------------------------

    def _samples(self, batch: dict, i: int) -> list:
        """Node i's micro-batches, each a dict of (b, ...) fields: all R, or
        under ``half_batch`` half of its samples (the first half of each
        micro-batch's rows; the first R/2 micro-batches when b is 1)."""
        mbs = [{k: v[i, r] for k, v in batch.items()} for r in range(self.R)]
        if self.fault != "half_batch":
            return mbs
        b = next(iter(batch.values())).shape[2]
        if b > 1:
            return [{k: v[: b // 2] for k, v in mb.items()} for mb in mbs]
        return mbs[: max(1, self.R // 2)]

    def grad(self, x: dict, batch: dict, out: dict) -> torch.Tensor:
        """Each node's clipped oracle sample into ``out`` ({path: (n, ...)},
        overwritten); returns the (n,) mean micro-batch losses."""
        losses = []
        for i in range(self.n):
            leaves = {}
            for path, l in self.views:
                t = x[path][i] if l is None else x[path][i, l]
                leaves[(path, l)] = t.detach().requires_grad_()
            mbs = self._samples(batch, i)
            tot = torch.zeros((), device=next(iter(x.values())).device)
            for mb in mbs:
                micro = self.loss(lambda p, l: leaves[(p, l)], mb)
                micro.backward()
                tot = tot + micro.detach()
            losses.append(tot / len(mbs))
            sq = torch.zeros((), device=tot.device)
            for key, leaf in leaves.items():
                if leaf.grad is None:
                    leaf.grad = torch.zeros_like(leaf)
                leaf.grad.div_(len(mbs))
                sq = sq + leaf.grad.square().sum()
            scale = (torch.clamp(self.clip / (sq.sqrt() + 1e-12), max=1.0)
                     if self.clip is not None else 1.0)
            for (path, l), leaf in leaves.items():
                dst = out[path][i] if l is None else out[path][i, l]
                dst.copy_(leaf.grad * scale)
            del leaves
        return torch.stack(losses)

    # -- gossip -----------------------------------------------------------

    def mix(self, Ws: torch.Tensor, leaves: dict, res: Optional[dict]):
        """The window ``Ws`` (R, n, n) applied to every leaf in place (and
        its residual, compressing)."""
        if self.fault == "no_mix":
            return
        for path, t in leaves.items():
            mat = t.reshape(self.n, -1)
            size = mat.shape[1]
            if res is None:
                for W in Ws:
                    mat = P.matmul(W, mat)
            else:
                rs = res[path]
                mat = torch.nn.functional.pad(mat, (0, rs.shape[1] - size))
                for W in Ws:
                    deq, err = quantize_int8(mat + rs, self.comp["group"])
                    rs.copy_(err)
                    mat = P.matmul(W, deq)
                mat = mat[:, :size]
            t.copy_(mat.reshape(t.shape))

    # -- the rule ---------------------------------------------------------

    def warm_start(self, st: dict, batch: dict) -> None:
        gp = {p: torch.empty_like(t) for p, t in st["x"].items()}
        self.grad(st["x"], batch, gp)
        st["g_prev"] = gp
        st["h"] = {p: g.mean(dim=0, keepdim=True).expand_as(g).clone()
                   for p, g in gp.items()}

    def step(self, st: dict, batch: dict, Ws: torch.Tensor) -> float:
        """One round on the window Ws (2R, n, n); returns the mean loss at
        the new x."""
        R = self.R
        for p, x in st["x"].items():
            x.add_(st["h"][p], alpha=-self.gamma)
        self.mix(Ws[:R], st["x"], st.get("res_x"))
        for p, h in st["h"].items():
            h.sub_(st["g_prev"][p])
        losses = self.grad(st["x"], batch, st["g_prev"])
        for p, h in st["h"].items():
            h.add_(st["g_prev"][p])
        self.mix(Ws[R:2 * R], st["h"], st.get("res_h"))
        return float(losses.mean())


def norms(leaves: dict, views: list, n: int, sub: Optional[dict] = None
          ) -> dict:
    """{(path, layer): (n,) f64 norms} of each leaf view of ``leaves``
    ({path: (n, ...)} or {path: (n, padded size)} residuals), minus ``sub``
    ({path: (...)}, one row for every node) when given."""
    out = {}
    for path, l in views:
        t = leaves[path]
        if sub is not None:
            t = t - sub[path][None]
        if l is not None:
            t = t[:, l]
        out[(path, l)] = torch.linalg.vector_norm(
            t.reshape(n, -1).float(), dim=1).double().cpu()
    return out


def padded_norms(res: dict, spec: list, n: int) -> dict:
    """{(path, None): (n,) norms} of each whole leaf's residual."""
    return {(path, None): torch.linalg.vector_norm(
        res[path][:, :math.prod(shape)], dim=1).double().cpu()
        for path, shape, _ in spec}
