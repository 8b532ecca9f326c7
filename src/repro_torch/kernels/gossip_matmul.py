"""Multi-consensus gossip mixing: the Hopper kernel's wrapper.

Computes  X <- W^{(R-1)} ... W^{(1)} W^{(0)} X  for a stack of R gossip
matrices (Algorithm 2's hot loop on the flattened, node-stacked state).  The
kernel (``csrc/gossip_mix.cu``) streams X through once, so device-memory
traffic is 2*n*D elements whatever R is.  It takes any n: a small first
kernel collapses the R rounds into one n x n matrix, then a persistent grid
stages column tiles of all n rows in a ring of shared-memory stages, each
thread computing an 8-row x 8- or 4-column micro-tile of the product, with
no block barrier where a warp's micro-tiles hold all n rows, else with W^T
streamed in chunks of its rows; :func:`launch_geometry` lays the launch out
from the shapes alone.  See the note at the top of the source.

Dispatch is by where the tensor lies, never by a fallback: a CUDA tensor
launches the kernel (and anything the kernel does not take raises), a CPU
tensor takes the plain version :func:`repro_torch.kernels.ref.gossip_mix_ref`,
a meta tensor the shape-only route (the launch's checks and allocations,
its scratch included, and its work charged to
:class:`repro_torch.kernels.cost.Recorder`; no launch), anything else
raises.  ``gossip_mix.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
from typing import Optional

import torch

from . import build, cost, ref

MAX_SHARED_BYTES = 232_448     # 227 KB: the most one block may use on Hopper
SM_SHARED_BYTES = 233_472      # 228 KB of an SM, 1 KB of it kept per block
TILE_RM = 8                    # a thread's micro-tile: 8 rows x cm columns,
TILE_CM = {True: 8, False: 4}  # by walk (warp or block)
TILE_THREADS = 256             # the most threads of a tile block, and
TILE_REGS = 128                # registers a thread (launch bounds (256, 2))
# a warp's row groups (lr) x column groups (lc = 32 / lr) of micro-tiles, in
# order of preference among equal row paddings
WARP_ROWS = (4, 2, 8, 1, 16, 32)
CHUNK_ROWS = (64, 32, 16, 8, 4)  # rows of W^T a chunk in the block walk
MAX_STAGES = 4
TMA_BOX = 256                  # a TMA box's most elements a dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_FILLS = {"tma": 0, "elems": 1}  # elems: rows TMA cannot take


def _lib() -> ctypes.CDLL:
    lib = build.load("gossip_mix")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gossip_mix_launch.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, i,
                                      i, p, p]
    lib.gossip_mix_launch.restype = i
    lib.gossip_mix_resources.argtypes = [i, i, p]
    lib.gossip_mix_resources.restype = i
    lib.gossip_mix_tile_grid.argtypes = [ctypes.c_longlong, i, i, i, i, i,
                                         p]
    lib.gossip_mix_tile_grid.restype = i
    lib.gossip_mix_error_string.argtypes = [i]
    lib.gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def _pad(nbytes: int, unit: int) -> int:
    return -(-nbytes // unit) * unit


def _boxes(n: int):
    """(box_rows, boxes) of a stage: the n rows in the fewest TMA boxes of
    at most TMA_BOX rows, all of one height; past one box, a multiple of 32
    rows (so that each box lands 128-byte aligned; the last may reach past
    n, its rows there zero-filled)."""
    boxes = -(-n // TMA_BOX)
    if boxes == 1:
        return n, 1
    return _pad(-(-n // boxes), 32), boxes


def tile_smem(n: int, rows_pad: int, tc: int, stages: int, wp: bool,
              kc: int, x_bytes: int) -> int:
    """The tile kernel's dynamic shared bytes (``tile_smem`` in the source):
    128 of alignment slack, then 128 of mbarriers, W^T (n x rows_pad
    resident in the warp walk ``wp``, else a chunk of kc rows), the block
    walk's f32 buffer of n x tc partial sums, padded to 128 bytes, then the
    stages, each a tile of the box rows x tc as stored, padded to 128
    bytes."""
    w_floats = (n if wp else kc) * rows_pad
    buf = 0 if wp else n * tc
    box_rows, boxes = _boxes(n)
    stage = _pad(box_rows * boxes * tc * x_bytes, 128)
    return 128 + _pad(128 + 4 * (w_floats + buf), 128) + stages * stage


def _tile_layout(n, rows_pad, tc, threads, x_bytes, wp, min_stages):
    """(kc, stages, blocks_per_sm, smem) of a tile with W^T resident (the
    warp walk ``wp``) or in chunks of kc rows, or None: the most chunk rows
    first, then the most blocks an SM (as many as the registers allow)
    whose share of shared memory holds ``min_stages`` or more."""
    max_blocks = min(32, 2048 // threads, 65_536 // (threads * TILE_REGS))
    for kc in (n,) if wp else [k for k in CHUNK_ROWS if k < n]:
        for per_sm in range(max_blocks, 0, -1):
            budget = min(MAX_SHARED_BYTES, SM_SHARED_BYTES // per_sm - 1024)

            def size(s):
                return tile_smem(n, rows_pad, tc, s, wp, kc, x_bytes)
            stages = min(MAX_STAGES, (budget - size(0)) // (size(1) - size(0)))
            if stages >= min_stages:
                return kc, stages, per_sm, size(stages)
    return None


@functools.lru_cache(maxsize=64)
def _tile_geometry(n: int, x_bytes: int) -> dict:
    """The launch: the warp walk (no block barrier, W^T
    resident) where a warp's micro-tiles can hold all n rows and W^T fits,
    else the block walk (W^T in chunks); the warp shape with the least row
    padding (ties by WARP_ROWS), and of its tiles (a multiple of cm lc, at
    most TMA_BOX, whose micro-tiles spread evenly over the walk's most
    threads) the one with the most warps an SM, the widest of those, whose
    layout holds 2 stages; failing all that, 1 stage."""
    rg = -(-n // TILE_RM)
    shapes = sorted(WARP_ROWS, key=lambda lr: -(-rg // lr) * lr)
    for (min_stages, even), wp, lr in itertools.product(
            ((2, True), (1, False)), (True, False), shapes):
        lc, cm = 32 // lr, TILE_CM[wp]
        rows_pad = TILE_RM * (-(-rg // lr) * lr)
        # a warp's micro-tiles hold every row of its columns
        if wp and rows_pad != TILE_RM * lr:
            continue
        most, best = TILE_THREADS, None
        for tc in range(TMA_BOX // (cm * lc) * cm * lc, 0, -cm * lc):
            units = rows_pad // TILE_RM * tc // cm
            if (wp and units > most) or (even and units > most
                                         and units % most):
                continue
            threads = min(most, units)
            layout = _tile_layout(n, rows_pad, tc, threads, x_bytes, wp,
                                  min_stages)
            if layout is not None and (best is None or layout[2] * threads
                                       > best[3] * best[2]):
                best = (tc, units, threads, layout[2], layout)
        if best is None:
            continue
        tc, units, threads, _, (kc, stages, per_sm, smem) = best
        box_rows, boxes = _boxes(n)
        return {"cm": cm, "lr": lr, "lc": lc,
                "rows_pad": rows_pad, "tc": tc, "units": units,
                "threads": threads, "passes": -(-units // threads),
                "kc": kc, "stages": stages, "blocks_per_sm": per_sm,
                "box_rows": box_rows, "boxes": boxes, "wp": wp,
                "smem": smem}
    raise ValueError(f"gossip_mix kernel: a tile of {n} nodes does not fit "
                     f"the {MAX_SHARED_BYTES}-byte shared-memory limit")


def launch_geometry(n: int, D: int, R: int, x_bytes: int = 4) -> dict:
    """The kernel's launch for ws (R, n, n) and x (n, D) of x_bytes a value
    (4 f32, 2 bf16), from the shapes alone (the R rounds are collapsed into
    one matrix first, so it does not depend on R or D): blocks of
    ``threads`` threads, tiles of all n rows x ``tc`` columns cut in
    micro-tiles of 8 x ``cm``, a warp ``lr`` x ``lc`` of them, rows padded
    to ``rows_pad`` (``passes`` of the block over a tile's ``units``),
    ``stages`` of the ring, the warp walk (``wp``: a warp's micro-tiles
    hold all n rows, W^T resident, ``kc`` = n) or the block walk (W^T in
    chunks of ``kc`` rows), sized for ``blocks_per_sm`` blocks an SM;
    ``smem`` is a block's dynamic shared bytes.  At the main path's 4
    nodes: the warp walk, one-warp blocks of 256 columns, 16 an SM; at
    whisper-tiny's 32-node f32 shape: the warp walk, 8 x 8 micro-tiles,
    tiles of 256 columns, 128 threads, 2 stages, 3 blocks an SM, 69,888
    bytes."""
    if n < 1 or D < 1 or R < 1:
        raise ValueError(f"gossip_mix kernel: n={n}, D={D}, R={R} must be "
                         "positive")
    return {"n": n, "D": D, "R": R, "x_bytes": x_bytes,
            **_tile_geometry(n, x_bytes)}


def resources(geometry: dict, dtype: torch.dtype) -> dict:
    """The compiled kernel a :func:`launch_geometry` result launches for x
    of ``dtype``: registers and spilled (local) bytes a thread, static and
    dynamic shared bytes, threads a block, and the blocks a launch runs
    (the resident blocks, capped by the tiles)."""
    g = geometry
    out = (ctypes.c_int * 4)()
    lib = _lib()
    err = lib.gossip_mix_resources(_DTYPES[dtype], int(g["wp"]), out)
    if err != 0:
        raise RuntimeError(f"gossip_mix_resources: cudaError {err}")
    grid = ctypes.c_int(0)
    err = lib.gossip_mix_tile_grid(g["D"], g["tc"], g["threads"], g["smem"],
                                   _DTYPES[dtype], int(g["wp"]),
                                   ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"gossip_mix_tile_grid: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_smem": out[2], "dynamic_smem": g["smem"],
            "threads": g["threads"], "blocks": grid.value}


def gossip_mix(ws: torch.Tensor, x: torch.Tensor, *,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ws: (R, n, n); x: (n, D) f32 or bf16 -> (n, D) in ``x.dtype`` after R
    chained mixings, accumulated in f32.  ``out`` (n, D), same dtype, may be
    ``x`` itself: the mix then runs in place and allocates no second state."""
    _check(ws, x, out)
    if x.device.type == "cpu":
        res = ref.gossip_mix_ref(ws, x)
        return res if out is None else out.copy_(res)
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"gossip_mix takes CPU, CUDA or meta tensors, not "
                         f"{x.device.type}")
    return _launch(ws, x, out)


def _check(ws, x, out):
    R, n, n2 = ws.shape
    N, D = x.shape
    if n != n2 or N != n:
        raise ValueError(f"ws {tuple(ws.shape)} does not mix x {tuple(x.shape)}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device):
        raise ValueError("out must match x in shape, dtype and device")


def _aligned(ptrs, nbytes: int) -> bool:
    return all(p % nbytes == 0 for p in ptrs)


def _launch(ws, x, out):
    R, n, _ = ws.shape
    D = x.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"gossip_mix kernel takes f32 or bf16 x, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("gossip_mix kernel takes a contiguous x")
    if out is None:
        out = torch.empty_like(x)
    elif not out.is_contiguous():
        raise ValueError("gossip_mix kernel takes a contiguous out")
    if D == 0:
        return out
    e = x.element_size()
    geo = launch_geometry(n, D, R, e)
    # the W stack is tiny; its copy to f32 on x's device is free
    w = ws.to(device=x.device, dtype=torch.float32).contiguous()
    # the collapsed W^T, written by the launch's first kernel
    wt = torch.empty(n, geo["rows_pad"], device=x.device)
    if x.device.type == "meta":
        cost.charge("gossip_mix", cost.gossip_mix(n, D, R, e))
        return out
    px, po = x.data_ptr(), out.data_ptr()
    tma = (_aligned((px,), 16) and D * e % 16 == 0 and D < 2**32
           and geo["tc"] * e % 16 == 0)
    vst = D % 4 == 0 and _aligned((po,), 4 * e)
    params = (ctypes.c_int * 11)(
        geo["lr"], geo["tc"], geo["threads"], geo["stages"], geo["kc"],
        geo["rows_pad"], _FILLS["tma" if tma else "elems"], int(vst),
        geo["box_rows"], geo["boxes"], int(geo["wp"]))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.gossip_mix_launch(w.data_ptr(), wt.data_ptr(), px, po, R,
                                    n, D, _DTYPES[x.dtype], geo["smem"],
                                    params, stream)
    if err != 0:
        msg = lib.gossip_mix_error_string(err).decode()
        raise RuntimeError(f"gossip_mix launch failed: {msg} (cudaError {err})")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0
