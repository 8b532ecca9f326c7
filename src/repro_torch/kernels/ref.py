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
