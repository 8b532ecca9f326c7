"""Diagonal linear recurrence: the Hopper kernel's wrapper.

    h_t = a_t·h_{t−1} + b_t,   h_{−1} = 0,

along the time axis of a, b (B, S, C), for every (batch, channel) on its
own: mamba's selective scan with C = d_inner·N channels (see
:func:`repro_torch.models.ssm.chunked_linear_scan`, which folds a nonzero
initial state into b_0), and recurrentgemma's RG-LRU with C = lru_width.
The kernel (``csrc/linear_recurrence.cu``) gives each thread a channel (or
four) and walks t in order; :func:`launch_geometry` picks its route from
the shapes: a ring of time tiles in shared memory, filled by TMA or by
cp.async, that spreads the channels over the card, or the
thread-per-channel loop for bf16 rows that neither filler takes.
See the note at the top of the source.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version
:func:`repro_torch.kernels.ref.linear_recurrence_ref`.
``linear_recurrence.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"loop": 0, "tma": 1, "cp.async": 2}
_MAX_BATCH = 65_535            # the batch rides the grid's y dimension
TILE_T = 64                    # steps in a ring tile (kTileT in the source)
CHANNELS = (64, 32, 16)        # channels a ring block may own, widest first
RING_BYTES = 96 * 1024         # a ring block's budget for its stages
MAX_STAGES = 4
LOOP_THREADS = 128
LOOP_AHEAD = 8                 # steps whose loads the loop issues at once
BLOCK_SMEM = 232_448           # dynamic shared memory a block may take


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


@functools.lru_cache(maxsize=1024)
def launch_geometry(B: int, S: int, C: int, dtype: torch.dtype, sms: int,
                    aligned: bool) -> dict:
    """The route and launch of the kernel for a, b (B, S, C) of ``dtype``
    on a card of ``sms`` SMs, from shapes alone; ``aligned``: a and b both
    start on 16 bytes.

    The ring where TMA can take a and b (a 16-byte aligned base and row
    stride C·elem); else the ring filled by 4-byte cp.async where the rows
    are 4-byte aligned (f32, or bf16 of an even C on an aligned base); else
    (bf16 rows on 2 bytes) the first design's loop, a thread a channel in
    blocks of 128 threads.  A ring block owns the widest ``cb`` channels in
    CHANNELS whose grid still puts a block on every SM (the narrowest where
    none does) and holds ``stages`` stages of a, b and h tiles of TILE_T
    steps, as many as RING_BYTES hold (at most MAX_STAGES and the tiles S
    has); ``vec`` 4 (C % 4 == 0) stores each h tile with one TMA store, 1
    with the storer warp's 4-byte stores.  At recurrentgemma-2b's (1, 3968,
    2560) f32 on 132 SMs: TMA, cb 16, 160 blocks, 4 stages; at
    falcon-mamba-7b's (1, 2048, 131072) f32: TMA, cb 64, 2048 blocks, 2
    stages (PERF.md has both against the loop and the other geometries).

    Every route has ``cb`` channels a block (128 for the loop), ``tile_t``
    steps read ahead of the chain (LOOP_AHEAD for the loop) and ``stages``
    (1 for the loop): the CPU model
    :func:`repro_torch.kernels.ref.linear_recurrence_tiled_ref` walks the
    same tiles.  Cached: the wrapper asks on every launch.  The caller must
    not change the dict it returns."""
    elem = dtype.itemsize
    tma = aligned and C * elem % 16 == 0
    words = elem == 4 or (aligned and C % 2 == 0)
    if not (tma or words):
        return {"route": "loop", "vec": 1, "cb": LOOP_THREADS,
                "tile_t": LOOP_AHEAD, "stages": 1,
                "grid": (_cdiv(C, LOOP_THREADS), B), "block": LOOP_THREADS,
                "smem": 0}
    cb = next((c for c in CHANNELS if B * _cdiv(C, c) >= sms), CHANNELS[-1])
    stage_bytes = TILE_T * cb * (2 * elem + 4)     # a, b and h tiles
    stages = max(1, min(MAX_STAGES, _cdiv(S, TILE_T),
                        RING_BYTES // stage_bytes))
    return {"route": "tma" if tma else "cp.async",
            "vec": 4 if C % 4 == 0 else 1, "cb": cb, "tile_t": TILE_T,
            "stages": stages, "grid": (_cdiv(C, cb), B),
            "block": 32 * _cdiv(cb, 32) + 64,
            "smem": 128 + stages * (stage_bytes + 24)}


def _lib() -> ctypes.CDLL:
    lib = build.load("linear_recurrence")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.linear_recurrence_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.linear_recurrence_launch.restype = ctypes.c_int
    lib.linear_recurrence_resources.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.linear_recurrence_resources.restype = ctypes.c_int
    lib.linear_recurrence_error_string.argtypes = [ctypes.c_int]
    lib.linear_recurrence_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def resources(geometry: dict, dtype: torch.dtype) -> dict:
    """The compiled kernel a :func:`launch_geometry` result launches for
    ``dtype``: registers and spilled (local) bytes per thread, static shared
    bytes, dynamic shared bytes and threads per block."""
    out = (ctypes.c_int * 5)()
    err = _lib().linear_recurrence_resources(
        _ROUTES[geometry["route"]], _DTYPES[dtype], geometry["cb"],
        geometry["vec"], geometry["stages"], out)
    if err != 0:
        raise RuntimeError(f"linear_recurrence_resources: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads"), out))


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


def geometry_for(a: torch.Tensor, b: torch.Tensor) -> dict:
    """:func:`launch_geometry` for the kernel's CUDA inputs a and b."""
    B, S, C = a.shape
    return launch_geometry(B, S, C, a.dtype, _sms(a.device.index or 0),
                           a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0)


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
    geo = geometry_for(a, b)
    lib = _lib()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.linear_recurrence_launch(
            a.data_ptr(), b.data_ptr(), h_all.data_ptr(), h_last.data_ptr(),
            B, S, C, _DTYPES[a.dtype], _ROUTES[geo["route"]], geo["cb"],
            geo["stages"], geo["vec"], stream)
    if err != 0:
        msg = lib.linear_recurrence_error_string(err).decode()
        raise RuntimeError(f"linear_recurrence launch failed: {msg} "
                           f"(cudaError {err}; geometry {geo})")
    linear_recurrence.launches += 1
    return h_all, h_last


linear_recurrence.launches = 0
