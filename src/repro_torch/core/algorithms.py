"""Gossip primitives on node-stacked (n, D) matrices, the port of the dense
mixers of the JAX package's ``core/algorithms.py``.

These are the ``gossip_impl="dense"`` path: one matrix product per round.
The ``"pallas"`` path fuses all R rounds into the Hopper ``gossip_mix``
kernel (:func:`repro_torch.dist.collectives.fused_multi_consensus`).
"""

from __future__ import annotations

import torch


def mix(W: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """z_i = sum_j W[i, j] x_j (partial-averaging protocol)."""
    return W.to(x.dtype) @ x


def multi_consensus(Ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Algorithm 2: apply W^{t1}, ..., W^{t2-1} in sequence; ``Ws`` is the
    (R, n, n) stack for the window [t1, t2)."""
    for r in range(Ws.shape[0]):
        x = mix(Ws[r], x)
    return x


def node_mean(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=0, keepdim=True)


def broadcast_nodes(flat: torch.Tensor, n: int) -> torch.Tensor:
    """n identical copies of a flat (D,) model as an (n, D) matrix."""
    return flat[None].expand(n, -1).clone()
