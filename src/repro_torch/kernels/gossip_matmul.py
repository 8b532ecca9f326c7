"""Multi-consensus gossip mixing: the Hopper kernel's wrapper.

Computes  X <- W^{(R-1)} ... W^{(1)} W^{(0)} X  for a stack of R gossip
matrices (Algorithm 2's hot loop on the flattened, node-stacked state).  The
kernel (``csrc/gossip_mix.cu``) keeps the W stack in shared memory and
streams X through once, so device-memory traffic is 2*n*D elements whatever
R is; see the note at the top of the source.

Dispatch is by where the tensor lies, never by a fallback: a CUDA tensor
launches the kernel (and anything the kernel does not take raises), a CPU
tensor takes the plain version :func:`repro_torch.kernels.ref.gossip_mix_ref`.
``gossip_mix.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

MAX_NODES = 64                 # the kernel keeps a column in registers
MAX_SHARED_BYTES = 232_448     # 227 KB: the most one block may use on Hopper
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build.load("gossip_mix")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.gossip_mix_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.gossip_mix_launch.restype = ctypes.c_int
    lib.gossip_mix_error_string.argtypes = [ctypes.c_int]
    lib.gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def gossip_mix(ws: torch.Tensor, x: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) f32 or bf16 -> (n, D) in ``x.dtype`` after R
    chained mixings, accumulated in f32.  ``out`` (n, D), same dtype, may be
    ``x`` itself: the mix then runs in place and allocates no second state."""
    R, n, n2 = ws.shape
    N, D = x.shape
    if n != n2 or N != n:
        raise ValueError(f"ws {tuple(ws.shape)} does not mix x {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")
    if x.device.type == "cpu":
        res = ref.gossip_mix_ref(ws, x)
        return res if out is None else out.copy_(res)
    if x.device.type != "cuda":
        raise ValueError(f"gossip_mix takes CPU or CUDA tensors, not "
                         f"{x.device.type}")
    return _launch(ws, x, out)


def _launch(ws, x, out):
    R, n, _ = ws.shape
    D = x.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"gossip_mix kernel takes f32 or bf16 x, not {x.dtype}")
    if n > MAX_NODES:
        raise ValueError(f"gossip_mix kernel takes n <= {MAX_NODES} nodes, "
                         f"got {n}")
    if R * n * n * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"W stack of {R}x{n}x{n} f32 exceeds the "
                         f"{MAX_SHARED_BYTES}-byte shared-memory limit")
    if not x.is_contiguous():
        raise ValueError("gossip_mix kernel takes a contiguous x")
    if out is None:
        out = torch.empty_like(x)
    elif not out.is_contiguous():
        raise ValueError("gossip_mix kernel takes a contiguous out")
    if D == 0:
        return out
    # the W stack is tiny; its copy to f32 contiguous on x's device is free
    w = ws.to(device=x.device, dtype=torch.float32).contiguous()
    align = 4 * x.element_size()
    vec = 4 if (n <= 16 and D % 4 == 0 and x.data_ptr() % align == 0
                and out.data_ptr() % align == 0) else 1
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gossip_mix_launch(w.data_ptr(), x.data_ptr(),
                                    out.data_ptr(), R, n, D, _DTYPES[x.dtype],
                                    vec, stream)
    if err != 0:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"gossip_mix launch failed: {msg} (cudaError {err})")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0
