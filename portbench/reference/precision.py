"""The precision the plain reference computes its matrix products in.

``float32`` is the configurations' stated precision: every product in full
f32, with TF32 off.  ``tf32`` is the control's, the nearest precision below
it: on a CUDA tensor cuBLAS rounds the operands to TF32 on the tensor cores
(``torch.backends.cuda.matmul.allow_tf32``); on the CPU, which has no TF32,
the forward products' operands are rounded to TF32's 10 mantissa bits
(nearest, ties to even) before an f32 product, as the tensor cores take
them; the gradient passes the rounding straight through, so the CPU's
backward products stay f32 (a milder control than the card's).

Every product of the reference goes through :func:`matmul` or
:func:`einsum`, so one switch moves all of them.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = {"name": "float32"}


def _tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) with its mantissa rounded to 10 bits, ties to even; the
    gradient passes through unchanged."""
    bits = t.detach().contiguous().view(torch.int32)
    keep = (bits >> 13) & 1
    bits = (bits + 0xFFF + keep) & ~0x1FFF
    return t + (bits.view(torch.float32) - t).detach()


def _emulate(t: torch.Tensor) -> bool:
    return (_MODE["name"] == "tf32" and t.device.type != "cuda"
            and t.dtype == torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _emulate(a):
        a, b = _tf32_round(a), _tf32_round(b)
    return a @ b


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _emulate(a):
        a, b = _tf32_round(a), _tf32_round(b)
    return torch.einsum(eq, a, b)


@contextlib.contextmanager
def products(name: str):
    """Compute the reference's products in ``name`` ('float32' or 'tf32')
    inside the block; TF32 is off again after it."""
    if name not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {name!r}")
    old = (_MODE["name"], torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    _MODE["name"] = name
    torch.backends.cuda.matmul.allow_tf32 = name == "tf32"
    torch.backends.cudnn.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        (_MODE["name"], torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
