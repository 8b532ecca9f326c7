"""Causal / sliding-window GQA attention: the Hopper kernel's wrapper.

    o = softmax(mask(q kᵀ · 1/√hd, causal, window)) v

for q (B, Sq, H, hd) and k, v (B, Sk, KV, hd), query head h reading KV head
h // (H / KV).  The kernel (``csrc/flash_attention.cu``) gives a block one
(batch, head, q-tile) and walks the k-tiles with an online softmax: for bf16
on the tensor cores (wgmma on TMA tiles of 128 rows and 128 keys, 64 and 64
at hd 192 and 256), for f32 with FMAs (64-row tiles); see the note at the
top of the source.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version :func:`repro_torch.kernels.ref.attention_ref`,
meta tensors the shape-only route (the launch's checks, copies and output,
the work charged to :class:`repro_torch.kernels.cost.Recorder`; no launch),
anything else raises.  Every route refuses the shapes the JAX package's kernel asserts on
(``flash_attention.py:83``): Sq and Sk must each be a multiple of their
block, min(128, S).  ``flash_attention.launches`` counts kernel launches,
and only those.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, cost, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)
BLOCK = 128                     # the JAX kernel's default block_q = block_k
_MAX_GRID = 65_535              # B (and, for f32, H) ride the grid's y and z


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library, its argument types set once, at load."""
    lib = build.load("flash_attention")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.flash_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_resources.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.flash_attention_resources.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def resources(hd: int, dtype: torch.dtype) -> dict:
    """The compiled kernel that (hd, dtype) takes: registers and spilled
    (local) bytes per thread, static and dynamic shared bytes and threads
    per block."""
    out = (ctypes.c_int * 5)()
    err = _lib().flash_attention_resources(hd, _DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"flash_attention_resources: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads"), out))


def launch_geometry(B: int, Sq: int, H: int, hd: int,
                    dtype: torch.dtype) -> dict:
    """The grid and block the kernel for ``dtype`` and ``hd`` launches
    with: bf16 (tensor cores) a block of 288 threads per (head, 128-row
    q-tile, batch) walking 128-key tiles, at hd 192 and 256 160 threads per
    64-row q-tile walking 64-key tiles; f32 (SIMT) 128 threads per (64-row
    q-tile, head, batch)."""
    if dtype == torch.bfloat16:
        rows = 64 if hd > 128 else 128
        return {"grid": (H, -(-Sq // rows), B), "block": 2 * rows + 32,
                "cluster": 1, "q_rows": rows, "k_tile": rows}
    return {"grid": (-(-Sq // 64), H, B), "block": 128, "cluster": 1,
            "q_rows": 64, "k_tile": 64}


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise for what neither route takes: ranks, head counts, and the
    tiling the JAX kernel asserts."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, Sq, H, hd) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (B, Sk, KV, "
                         "hd) of one shape")
    B, Sq, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch "
                         "and head_dim must agree and KV divide H")
    Sk = k.shape[1]
    for name, S in (("Sq", Sq), ("Sk", Sk)):
        if S < 1 or S % min(BLOCK, S):
            raise ValueError(f"{name}={S} does not tile: it must be at most "
                             f"{BLOCK} or a multiple of {BLOCK}, as the JAX "
                             "kernel asserts (flash_attention.py:83)")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, KV, hd) -> (B, Sq, H, hd) in q's
    dtype.  The kernel takes f32 or bf16 (all three of one dtype) and hd 32,
    64, 128, 192 or 256; the plain version on the CPU takes any float dtype
    and hd (the JAX kernel takes any)."""
    _check_shapes(q, k, v)
    if window < 0:
        raise ValueError(f"window={window} must be >= 0 (0 = none)")
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, window=window)
    if q.device.type not in ("cuda", "meta"):
        raise ValueError(f"flash_attention takes CPU, CUDA or meta tensors, not "
                         f"{q.device.type}")
    return _launch(q, k, v, causal, window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel reads 16-byte
    vectors): a copy only where it is not both already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, causal, window):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q, k, v all f32 or all "
                        f"bf16, not {q.dtype}, {k.dtype}, {v.dtype}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if B > _MAX_GRID or H > _MAX_GRID:
        raise ValueError(f"flash_attention kernel takes B, H <= {_MAX_GRID}, "
                         f"got {B}, {H}")
    q, k, v = (_aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    if q.device.type == "meta":
        cost.charge("flash_attention", cost.flash_attention(
            B, Sq, Sk, H, KV, hd, q.element_size(), cost.dtype_name(q.dtype),
            bool(causal), int(window)))
        return o
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, Sq, Sk,
            H, KV, hd, int(bool(causal)), int(window), 1.0 / math.sqrt(hd),
            _DTYPES[q.dtype], stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention launch failed: {msg} "
                           f"(cudaError {err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
