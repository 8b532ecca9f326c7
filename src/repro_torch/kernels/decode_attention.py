"""Single-token decode attention over a ring-buffered KV cache: the Hopper
kernel's wrapper.

One query token, q (B, 1, J, G, hd) with G query rows per KV head, attends
to the cache k, v (B, C, J, hd) whose slot c holds absolute position
kpos[c] (-1 = empty).  Slot c is valid when kpos[c] >= 0, kpos[c] <= pos
and, with a window, kpos[c] > pos - window.  The kernel
(``csrc/decode_attention.cu``) splits the cache of each (batch, KV head)
over a cluster of :func:`splits_for` blocks, streams it once and combines
the splits in distributed shared memory, in one launch: with FMAs, or for
bf16 at hd 192 and 256 on the tensor cores (:func:`tensor_cores`); see the
note at the top of the source.  A block takes up to ``ROW_GROUP`` query
rows; a larger G is launched as groups of rows on the grid's z axis, each
reading the cache on its own, so every row has the bits of the same row
launched in a group alone.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version
:func:`repro_torch.kernels.ref.decode_attention_ref`.  Both routes refuse
the cache lengths the JAX package's kernel asserts on
(``decode_attention.py:78``): C must be a multiple of its block, min(256,
C).  ``decode_attention.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128, 192, 256)
ROW_GROUP = 16                  # query rows a block takes
BLOCK = 256                     # the JAX kernel's default block_k
MAX_SPLITS = 8                  # blocks per cluster (the portable most)
_MAX_GRID = 65_535              # B and the row groups ride y and z


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, its argument types set once, at load."""
    lib = build.load("decode_attention")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.decode_attention_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_resources.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.decode_attention_resources.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def tile_for(hd: int) -> int:
    """Cache slots per tile of the kernel for ``hd``: 64, or 32 at hd 192
    and 256 (a stage's k and v then take 24 or 32 KB in bf16)."""
    return 32 if hd > 128 else 64


def splits_for(B: int, J: int, C: int, sms: int, hd: int) -> int:
    """How many blocks (one cluster) share the cache of one (batch, KV
    head): doubled from 1 while B·J·splits stays within ``sms`` (the SMs of
    the card), up to MAX_SPLITS, each split a whole number of tiles.  At
    the serve paths' decode (qwen1.5: B 1, J 16, C 2048, hd 64;
    recurrentgemma: B 1, J 1, C 2048, hd 256; nemotron: B 1, J 8, C 2048,
    hd 192; 132 SMs): 8.  No split count costs shared memory: each block
    keeps its own state.  G does not enter: a row's split, and so its bits,
    is the same in every group of rows."""
    s, tile = 1, tile_for(hd)
    while (2 * s <= MAX_SPLITS and B * J * 2 * s <= sms
           and C % (2 * s * tile) == 0):
        s *= 2
    return s


def tensor_cores(hd: int, dtype: torch.dtype) -> bool:
    """Whether (hd, dtype) takes the tensor-core kernel (bf16 at hd 192 and
    256: a block's query rows as the M = 16 of mma.sync) or the SIMT
    one."""
    return dtype == torch.bfloat16 and hd > 128


def row_groups(G: int) -> int:
    """Groups of at most ROW_GROUP query rows a (b, KV head) launches."""
    return -(-G // ROW_GROUP)


def launch_geometry(B: int, J: int, C: int, hd: int, dtype: torch.dtype,
                    sms: int, G: int = 1) -> dict:
    """The grid, block and cluster the kernel launches with: J·splits x B x
    row_groups(G) blocks of 128 threads, the splits of one (b, j) and row
    group in one cluster."""
    splits = splits_for(B, J, C, sms, hd)
    return {"grid": (J * splits, B, row_groups(G)), "block": 128,
            "cluster": splits, "tile": tile_for(hd),
            "route": "tensor cores" if tensor_cores(hd, dtype) else "simt"}


def resources(hd: int, dtype: torch.dtype) -> dict:
    """The compiled kernel for (hd, dtype): registers and spilled (local)
    bytes per thread, static and dynamic shared bytes and threads per
    block."""
    out = (ctypes.c_int * 5)()
    err = _lib().decode_attention_resources(hd, _DTYPES[dtype], out)
    if err != 0:
        raise RuntimeError(f"decode_attention_resources: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads"), out))


def _check_shapes(q, k, v, kpos) -> None:
    """Raise for what neither route takes: ranks, shapes, and the tiling of
    C the JAX kernel asserts."""
    if q.dim() != 5 or q.shape[1] != 1 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, 1, J, G, hd) and k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (B, C, J, hd) "
                         "of one shape")
    B, _, J, G, hd = q.shape
    C = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, J, hd):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch, "
                         "KV heads and head_dim must agree")
    if kpos.shape != (C,):
        raise ValueError(f"kpos {tuple(kpos.shape)} must be ({C},)")
    if C < 1 or C % min(BLOCK, C):
        raise ValueError(f"C={C} does not tile: it must be at most {BLOCK} or "
                         f"a multiple of {BLOCK}, as the JAX kernel asserts "
                         "(decode_attention.py:78)")
    if len({q.device, k.device, v.device, kpos.device}) != 1:
        raise ValueError(f"q, k, v, kpos on {q.device}, {k.device}, "
                         f"{v.device}, {kpos.device}")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kpos: torch.Tensor, pos: int, *,
                     window: int = 0) -> torch.Tensor:
    """q: (B, 1, J, G, hd); k, v: (B, C, J, hd); kpos: (C,) int32; pos: the
    query's absolute position (a host int) -> (B, 1, J·G, hd) in q's dtype.
    The kernel takes f32 or bf16 (q, k, v of one dtype), hd 32, 64, 128,
    192 or 256 and any G; the plain version on the CPU takes any float
    dtype and hd (the JAX kernel takes any)."""
    _check_shapes(q, k, v, kpos)
    if window < 0:
        raise ValueError(f"window={window} must be >= 0 (0 = none)")
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kpos, pos, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention takes CPU or CUDA tensors, not "
                         f"{q.device.type}")
    return _launch(q, k, v, kpos, int(pos), window)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel reads 16-byte
    vectors): a copy only where it is not both already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q, k, v, kpos, pos, window):
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention kernel takes q, k, v all f32 or "
                        f"all bf16, not {q.dtype}, {k.dtype}, {v.dtype}")
    if kpos.dtype != torch.int32:
        raise TypeError(f"decode_attention kernel takes int32 kpos, not "
                        f"{kpos.dtype}")
    B, _, J, G, hd = q.shape
    C = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if B > _MAX_GRID or row_groups(G) > _MAX_GRID:
        raise ValueError(f"decode_attention kernel takes B and G / "
                         f"{ROW_GROUP} <= {_MAX_GRID}, got {B}, {G}")
    q, k, v, kpos = (_aligned(t) for t in (q, k, v, kpos))
    o = torch.empty((B, 1, J * G, hd), dtype=q.dtype, device=q.device)
    lib = _lib()
    splits = splits_for(B, J, C, _sm_count(q.device.index), hd)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), kpos.data_ptr(),
            o.data_ptr(), B, C, J, G, hd, splits, pos, int(window),
            1.0 / math.sqrt(hd), _DTYPES[q.dtype], stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention launch failed: {msg} "
                           f"(cudaError {err})")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
