"""Public kernel entry points, the counterpart of the JAX package's
``kernels/ops.py``.

``use_kernel`` plays the part of ``use_pallas``: True routes through the
kernel wrapper (the Hopper kernel on a CUDA tensor, its plain version on a
CPU tensor), False through the plain version directly.  Of the JAX package's
six kernels only ``gossip_mix`` is ported; ROADMAP.md Queue 2 lists the rest.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .gossip_matmul import gossip_mix as _gossip


def gossip_mix(ws: torch.Tensor, x: torch.Tensor, *, use_kernel: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) -> W_{R-1} ... W_0 x in ``x.dtype``.  With
    ``out`` (``x`` itself allowed) the result is written there."""
    if use_kernel:
        return _gossip(ws, x, out=out)
    res = ref.gossip_mix_ref(ws, x)
    return res if out is None else out.copy_(res)
