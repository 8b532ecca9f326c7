"""Public kernel entry points, the counterpart of the JAX package's
``kernels/ops.py``.

For ``gossip_mix``, ``use_kernel`` plays the part of ``use_pallas``: True
routes through the kernel wrapper (the Hopper kernel on a CUDA tensor, its
plain version on a CPU tensor), False through the plain version directly.
``quantized_gossip_mix`` is the kernel wrapper itself: error-feedback
compressed multi-consensus on an (n, D) state matrix, the kernel or its
plain version by the tensors' device.  Of the JAX package's six kernels ``gossip_mix`` and ``quantized_gossip_mix`` are ported; ROADMAP.md
Queue 2 lists the rest.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .gossip_matmul import gossip_mix as _gossip
from .quantized_gossip import quantized_gossip_mix  # noqa: F401


def gossip_mix(ws: torch.Tensor, x: torch.Tensor, *, use_kernel: bool = False,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) -> W_{R-1} ... W_0 x in ``x.dtype``.  With
    ``out`` (``x`` itself allowed) the result is written there."""
    if use_kernel:
        return _gossip(ws, x, out=out)
    res = ref.gossip_mix_ref(ws, x)
    return res if out is None else out.copy_(res)

