"""Compressed gossip (the spec's ``compression`` axis), the port of the JAX
package's ``core/compress.py``.

Every gossip payload is quantized group-wise, 1-bit (``sign``) or ``int8``,
with a per-node error-feedback residual carried into the next round's
payload.  The port keeps the state flat for the whole run, and its
:class:`repro_torch.dist.collectives.FlatLayout` aligns every leaf to a
multiple of ``group`` (what the reference's ``flatten_grouped`` builds
around each mix), so everything here works on the (n, D) matrix directly
(the host runtime's (n, d) state is padded to the group round by round):

* :class:`CompressionConfig` -- the runtime config a ``CompressionSpec``
  lowers to;
* :func:`make_compressed_mixer` -- wraps a per-round mixer into the
  error-feedback window ``cmix(offset, rounds, mat, res, on)``;
* :func:`init_residual` -- the zeroed residual state;
* :func:`payload_bytes` -- the bytes one node sends in one round.

The quantization math lives in
:func:`repro_torch.kernels.ref.quantize_dequantize_ref`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from ..kernels import ref as kernels_ref

SCHEMES = ("none", "sign", "int8")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """``scheme``: 'sign' (1 bit/entry) or 'int8'; ``error_feedback``: carry
    the per-node quantization error into the next round's payload;
    ``warmup``: driver steps that gossip at full precision before the
    scheme activates; ``group``: entries per quantization scale."""

    scheme: str = "sign"
    error_feedback: bool = True
    warmup: int = 0
    group: int = 256

    def __post_init__(self):
        if self.scheme not in SCHEMES[1:]:
            raise ValueError(f"CompressionConfig.scheme={self.scheme!r}: "
                             f"must be one of {SCHEMES[1:]} ('none' means "
                             "no config at all)")
        if self.group < 1:
            raise ValueError(f"group={self.group}: must be >= 1")
        if self.warmup < 0:
            raise ValueError(f"warmup={self.warmup}: must be >= 0")


def payload_bytes(dim: int, scheme: str, group: int = 256) -> int:
    """Nominal bytes ONE node transmits in ONE gossip round for a
    ``dim``-entry state: the quantized entries plus one f32 scale per group
    ('none' = full f32, the baseline).  On one card the nodes share memory
    and no bytes move: this is the wire format's price, not a measurement."""
    if scheme == "none":
        return 4 * dim
    groups = math.ceil(dim / group)
    if scheme == "sign":
        return math.ceil(dim / 8) + 4 * groups
    if scheme == "int8":
        return dim + 4 * groups
    raise ValueError(f"unknown compression scheme {scheme!r} "
                     f"(have {SCHEMES})")


def make_compressed_mixer(mix_round: Callable[[int, torch.Tensor],
                                              torch.Tensor],
                          cfg: CompressionConfig):
    """Lift a per-round mixer into the error-feedback compressed window
    ``cmix(offset, rounds, mat, res, on) -> (mat, res)``.

    ``mix_round(idx, mat)`` applies ONE gossip round (window index ``idx``
    = offset + r) to an (n, D) matrix.  ``res`` is the (n, D) residual,
    updated in place, so the engine's residual keeps its storage.  ``on``
    is the warmup gate: False mixes at full precision and leaves ``res``
    untouched.

    When D is not a multiple of ``cfg.group`` (the host runtime's d = 784
    or 54 at group 256), each round quantizes ``mat + res`` zero-padded to
    the next multiple, as the reference's ``flatten_grouped`` pads it: the
    pad's zeros count in the last group's scale (sign's mean |g|).  Only the
    D real columns gossip and reach the residual.  The arch trainer's flat
    layout is aligned already and takes no pad and no copy."""

    def quantize(buf: torch.Tensor):
        D = buf.shape[1]
        pad = (-D) % cfg.group
        if not pad:
            return kernels_ref.quantize_dequantize_ref(
                buf, scheme=cfg.scheme, group=cfg.group)
        deq, err = kernels_ref.quantize_dequantize_ref(
            torch.nn.functional.pad(buf, (0, pad)), scheme=cfg.scheme,
            group=cfg.group)
        return deq[:, :D].contiguous(), err[:, :D]

    def cmix(offset: int, rounds: int, mat: torch.Tensor, res: torch.Tensor,
             on: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        # a stream or residual stored in a lower precision (the arch
        # trainer's aux_dtype) runs the window in f32 and is cast back at
        # its end, as the reference's flatten_grouped / unflatten_grouped do
        store, res32 = mat.dtype, res.float()
        mat = mat.float()
        if not on:
            for r in range(rounds):
                mat = mix_round(offset + r, mat)
        else:
            for r in range(rounds):
                deq, err = quantize(mat + res32)
                if cfg.error_feedback:
                    res32.copy_(err)
                mat = mix_round(offset + r, deq)
        if res32 is not res:
            res.copy_(res32)
        return mat.to(store), res

    return cmix


def init_residual(x0: torch.Tensor, uses_tracker: bool, dtype=None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Zeroed (res_x, res_h) error-feedback state shaped like the flat
    (n, D) state ``x0``, in ``dtype`` when given (``res_h`` only for
    tracking rules: the tracker stream gossips too and carries its own
    residual)."""
    def zeros():
        return torch.zeros_like(x0, dtype=dtype or x0.dtype)
    return (zeros(), zeros() if uses_tracker else None)
