"""The node-stacked flat state and the fused multi-consensus.

The JAX package flattens its stacked parameter pytree into one f32 (n, D)
matrix around every fused mix (``flatten_stacked`` / ``unflatten_stacked``)
and lets XLA fuse the copies away.  Done eagerly at full width that would
cost ~15 GB of copies per mix, so the port keeps the state flat for the
whole run: x, h and g_prev are each one (n, D) f32 tensor, and a node's
parameters are views into its row (:class:`FlatLayout`).  ``gossip_mix``
reads the flat tensor directly and mixes it in place; it treats every
column alone, so the column order inside D is free, and the layout takes
``jax.tree.leaves`` order so that the columns line up with the reference's.
With compression the layout also aligns every leaf to the quantization
group, and ``quantized_gossip_mix`` mixes x and its residual in place.
"""

from __future__ import annotations

import math

import torch

from .. import tree
from ..core import algorithms as alg
from ..kernels import ops


# Subtrees whose leaves carry a leading layer axis (the reference's
# dist/sharding.py _STACKED_COLLECTIONS).
STACKED = ("units", "enc", "dec")


class FlatLayout:
    """Where each parameter leaf lives in a flat (D,) row: leaves in
    ``jax.tree.leaves`` order, each contiguous, the layer-stacked leaves
    (``params["units"]``, or an encoder-decoder's ``enc`` and ``dec``) with
    their leading layer axis.

    ``align`` (the compression group) starts every leaf at a multiple of
    ``align`` and pads D to one, with zero columns that no parameter views:
    the reference's ``compress.flatten_grouped`` layout, kept for the whole
    run instead of built around every mix, so that a quantization group
    never straddles two leaves.  The padding's gradient is zero, and zero
    columns stay zero under mixing and quantization."""

    def __init__(self, shapes: dict, align: int = 1):
        if align < 1:
            raise ValueError(f"align={align}: must be >= 1")
        self.entries = []          # (path, shape, offset)
        off = 0
        for path, shape in tree.items(shapes):
            self.entries.append((path, tuple(shape), off))
            off += -(-math.prod(shape) // align) * align
        self.size = off

    def flatten(self, params: dict) -> torch.Tensor:
        """The (D,) f32 row holding ``params`` (a tree of this layout), zero
        in the padding columns."""
        leaves = dict(tree.items(params))
        first = leaves[self.entries[0][0]]
        row = torch.zeros(self.size, dtype=torch.float32, device=first.device)
        for path, shape, off in self.entries:
            row[off:off + math.prod(shape)] = leaves[path].reshape(-1)
        return row

    def views(self, row: torch.Tensor) -> dict:
        """The parameter tree as views into ``row`` (no copy): a (D,) row,
        or (..., D) rows whose leading axes (e.g. a fleet's) lead every
        leaf."""
        lead = tuple(row.shape[:-1])
        return tree.build(
            (path, row[..., off:off + math.prod(shape)].view(lead + shape))
            for path, shape, off in self.entries)

    def grad_leaves(self, xrow: torch.Tensor, grow: torch.Tensor) -> dict:
        """Parameters for one node's backward pass: every leaf a view into
        ``xrow`` that requires grad, with its ``.grad`` preset to the same
        slice of ``grow``, so ``backward()`` accumulates the node's gradient
        straight into the flat buffer (autograd adds into a defined
        ``.grad`` in place).  Layer-stacked leaves (the STACKED subtrees:
        the decoder's ``units``, the encoder-decoder's ``enc`` and ``dec``)
        are split per layer, and each such subtree becomes the per-layer
        list of dicts the model's forward takes: a leaf per layer keeps each
        layer's gradient in its own slice, where indexing one stacked leaf
        would make every layer's backward write a zero-filled gradient of
        the whole stack."""
        def leaf(off, shape):
            size = math.prod(shape)
            p = xrow[off:off + size].view(shape).detach().requires_grad_()
            p.grad = grow[off:off + size].view(shape)
            return p

        top, stacks = [], {}
        for path, shape, off in self.entries:
            if path[0] not in STACKED:
                top.append((path, leaf(off, shape)))
                continue
            layers = stacks.setdefault(path[0],
                                       [[] for _ in range(shape[0])])
            size = math.prod(shape[1:])
            for u, pairs in enumerate(layers):
                pairs.append((path[1:], leaf(off + u * size, shape[1:])))
        params = tree.build(top)
        for key, layers in stacks.items():
            params[key] = [tree.build(pairs) for pairs in layers]
        return params


def fused_multi_consensus(Ws: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """Algorithm 2 through the Hopper ``gossip_mix`` kernel: one pass over
    the flat (n, D) state applying all R matrices, in place.  No padding:
    the kernel masks a ragged D itself."""
    return ops.gossip_mix(Ws, mat, use_kernel=True, out=mat)


def fused_quantized_consensus(Ws: torch.Tensor, mat: torch.Tensor,
                              res: torch.Tensor, cfg, on: bool):
    """Error-feedback compressed multi-consensus through the Hopper
    ``quantized_gossip_mix`` kernel: quantize, mix and update the residual
    for all R rounds in one pass over the flat (n, D) state, in place.
    ``cfg`` is a :class:`repro_torch.core.compress.CompressionConfig`; the
    layout is aligned to ``cfg.group``, so D needs no padding here.  A
    stream or residual stored in bf16 (``aux_dtype``) is mixed as it is
    stored: the kernel computes in f32 and rounds on store, as the
    reference's unflatten casts back.  ``on`` is the warmup gate, a host
    bool: False runs the plain ``gossip_mix`` kernel and leaves ``res``
    untouched.  Returns (mat, res)."""
    if not on:
        return fused_multi_consensus(Ws, mat), res
    return ops.quantized_gossip_mix(
        Ws, mat, res, scheme=cfg.scheme, group=cfg.group,
        error_feedback=cfg.error_feedback, out=mat, res_out=res)


def tree_cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` in ``dtype`` (a new tensor), or ``t`` itself when ``dtype`` is
    None or already its dtype: the tracker storage cast (``aux_dtype``)."""
    return t if dtype is None else t.to(dtype)


def stage_plan(plan, device="cpu") -> dict:
    """Upload a :class:`repro_torch.core.gossip.GossipPlan`'s (or an edge
    plan's) tensors to ``device`` once; delegates to the one staging path,
    :func:`repro_torch.core.driver.stage_plan`."""
    from ..core import driver

    return driver.stage_plan(plan, device=device)


def consensus_distance(x: torch.Tensor) -> float:
    """||x - x̄||_F of the flat (n, D) state, reduced on the device one row
    at a time: the temporaries are (D,) vectors, never a second (n, D)
    state (7.4 GB at full width).  One scalar crosses to the host.
    Squares and sums, as :func:`repro_torch.sim.telemetry.
    consensus_distance` does."""
    xb = alg.node_mean(x)[0]
    sq = sum((row - xb).square_().sum() for row in x)
    return float(sq) ** 0.5
