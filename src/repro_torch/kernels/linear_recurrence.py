"""Diagonal linear recurrence: the Hopper kernel's wrapper.

    h_t = a_t·h_{t−1} + b_t,   h_{−1} = 0,

along the time axis of a, b (B, S, C), for every (batch, channel) on its
own: mamba's selective scan with C = d_inner·N channels (see
:func:`repro_torch.models.ssm.chunked_linear_scan`, which folds a nonzero
initial state into b_0).  The kernel (``csrc/linear_recurrence.cu``) gives
each thread a few channels and walks t in order; see the note at the top of
the source.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version
:func:`repro_torch.kernels.ref.linear_recurrence_ref`.
``linear_recurrence.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65_535            # the batch rides the grid's y dimension


def _lib() -> ctypes.CDLL:
    lib = build.load("linear_recurrence")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.linear_recurrence_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.linear_recurrence_launch.restype = ctypes.c_int
    lib.linear_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.linear_recurrence_error_string.restype = ctypes.c_char_p
    return lib


def linear_recurrence(a: torch.Tensor, b: torch.Tensor):
    """a, b: (B, S, C) -> (h_all (B, S, C) f32, h_last (B, C) f32), zero
    initial state.  The kernel takes contiguous f32 or bf16 inputs of one
    dtype; the plain version on the CPU takes any float dtype."""
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} must be "
                         "(B, S, C) of one shape")
    if a.device != b.device:
        raise ValueError(f"a on {a.device} and b on {b.device}")
    if a.device.type == "cpu":
        return ref.linear_recurrence_ref(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"linear_recurrence takes CPU or CUDA tensors, not "
                         f"{a.device.type}")
    return _launch(a, b)


def _aligned(t: torch.Tensor, nbytes: int) -> bool:
    return t.data_ptr() % nbytes == 0


def _launch(a, b):
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"linear_recurrence kernel takes a and b both f32 or "
                        f"both bf16, not {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_recurrence kernel takes contiguous a and b")
    B, S, C = a.shape
    if B > _MAX_BATCH:
        raise ValueError(f"linear_recurrence kernel takes B <= {_MAX_BATCH}, "
                         f"got {B}")
    h_all = torch.empty((B, S, C), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    if B == 0 or C == 0:
        return h_all, h_last
    if S == 0:
        return h_all, h_last.zero_()
    vec = 4 if C % 4 == 0 and all(
        _aligned(t, 4 * t.element_size()) for t in (a, b, h_all, h_last)) \
        else 1
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.linear_recurrence_launch(
            a.data_ptr(), b.data_ptr(), h_all.data_ptr(), h_last.data_ptr(),
            B, S, C, _DTYPES[a.dtype], vec, stream)
    if err != 0:
        msg = lib.linear_recurrence_error_string(err).decode()
        raise RuntimeError(f"linear_recurrence launch failed: {msg} "
                           f"(cudaError {err})")
    linear_recurrence.launches += 1
    return h_all, h_last


linear_recurrence.launches = 0
