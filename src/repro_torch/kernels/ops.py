"""Public kernel entry points, the counterpart of the JAX package's
``kernels/ops.py``.

For ``gossip_mix``, ``use_kernel`` plays the part of ``use_pallas``: True
routes through the kernel wrapper (the Hopper kernel on a CUDA tensor, its
plain version on a CPU tensor), False through the plain version directly.
``quantized_gossip_mix`` is the kernel wrapper itself: error-feedback
compressed multi-consensus on an (n, D) state matrix, the kernel or its
plain version by the tensors' device.  ``sparse_gossip_mix`` is one
edge-list gossip round; its ``use_pallas`` keeps the JAX API's name and
selects the ``sparse_segment_mix`` wrapper for the segment sum.
``linear_recurrence``, ``attention`` (the ``flash_attention`` wrapper) and
``decode_attention`` are the kernel wrappers themselves, the routes the model
takes when ``cfg.use_pallas`` is on; with it off the model takes its own
plain attention (``models/attention.py``).  All six of the JAX package's
kernels are ported.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .decode_attention import decode_attention  # noqa: F401
from .flash_attention import flash_attention as attention  # noqa: F401
from .gossip_matmul import gossip_mix as _gossip
from .linear_recurrence import linear_recurrence  # noqa: F401
from .quantized_gossip import quantized_gossip_mix  # noqa: F401
from .sparse_gossip import SegmentLayout, segment_layout, sparse_segment_mix


def gossip_mix(ws: torch.Tensor, x: torch.Tensor, *, use_kernel: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) -> W_{R-1} ... W_0 x in ``x.dtype``.  With
    ``out`` (``x`` itself allowed) the result is written there."""
    if use_kernel:
        return _gossip(ws, x, out=out)
    res = ref.gossip_mix_ref(ws, x)
    return res if out is None else out.copy_(res)


def sparse_gossip_mix(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                      w: torch.Tensor, seg: Optional[torch.Tensor],
                      slots: torch.Tensor, *, use_pallas: bool = False,
                      layout: Optional[SegmentLayout] = None) -> torch.Tensor:
    """One edge-list gossip round on an (n, ...) state:
    x[slots[s]] += delta[s], delta[s] = sum over e with seg[e] == s of
    w[e]·(x[src[e]] − x[dst[e]]) (Laplacian form, see
    :mod:`repro_torch.sparse.plan`).

    ``slots`` (S,) holds the distinct receiver ids, padded with the
    out-of-range id n, and ``seg[e]`` indexes ``dst[e]`` within it, the
    layout of :meth:`repro_torch.sparse.plan.SparseGossipPlan.tensors`.
    ``use_pallas`` False takes the plain segment sum, True the
    ``sparse_segment_mix`` wrapper, which takes the round laid out by
    :func:`repro_torch.kernels.sparse_gossip.segment_layout`: pass that
    ``layout`` (the mixer lays out each round once per staged plan; src,
    dst, w and seg are then unused), or leave it None and the round is laid
    out here.

    Unlike the JAX op, x is updated IN PLACE and returned: the caller owns
    the state, and a copy would read and write all n rows for the few
    receivers a round has.  Padded slot ids get a zero row added to row 0
    (``index_add_`` refuses the id n, which the JAX scatter drops), so no
    boolean mask has to stop the host."""
    n = x.shape[0]
    flat = x.view(n, -1)
    S = slots.shape[0]
    if not use_pallas:
        delta = ref.sparse_gossip_mix_ref(seg, w, flat[src], flat[dst], S)
    else:
        if layout is None:
            layout = segment_layout(src, dst, w, seg, S)
        delta = sparse_segment_mix(flat, *layout)
    valid = slots < n
    delta = torch.where(valid[:, None], delta, 0.0)
    flat.index_add_(0, torch.where(valid, slots, 0), delta.to(x.dtype))
    return x

