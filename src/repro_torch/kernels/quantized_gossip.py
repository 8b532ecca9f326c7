"""Error-feedback compressed multi-consensus: the Hopper kernel's wrapper.

For each of R rounds on the flattened, node-stacked state x and its
error-feedback residual res (each (n, D), f32 or bf16, D % group == 0)::

    buf = x + res
    deq = dequant(quant(buf))    # sign or int8, one scale per (node, group)
    res = buf - deq              # only with error feedback
    x   = W_r @ deq

computed in f32 and stored in each input's dtype, as the reference's kernel
does.  The kernel (``csrc/quantized_gossip_mix.cu``) takes any n and any
group dividing D, on one of three routes that :func:`launch_geometry` picks
from the shapes alone: ``regs`` (n <= 16 and a power-of-two group <= 256:
x and res in registers for all R rounds), ``ring`` (a persistent grid of
thread-block clusters, each splitting a group at a time, or lone blocks of
a few groups, fed by a ring of shared-memory stages that TMA copies keep
full) and ``stream`` (where no ring fits: every round streams the block's
group through device memory); see the note at the top of the source.
:func:`_launch_route` launches a route by name, for comparing routes.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version
:func:`repro_torch.kernels.ref.quantized_gossip_mix_ref`, meta tensors the
shape-only route (the launch's checks and allocations, W^T and the stream
route's scratch included, and its work charged to
:class:`repro_torch.kernels.cost.Recorder`; no launch), anything else
raises.
``quantized_gossip_mix.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, cost, ref

REGS_NODES = 16                # the regs route: x and res of every node in
REGS_GROUP = 256               # registers, a group inside one 256-thread block
MAX_SHARED_BYTES = 232_448     # 227 KB: the most one block may use on Hopper
SM_SHARED_BYTES = 233_472      # 228 KB of an SM, 1 KB of it kept per block
RING_THREADS = 256
RING_UNITS = (1, 2)            # units of 4 rows x 4 columns a ring thread
RING_BLOCKS = {1: 2, 2: 1}     # the blocks an SM the registers allow
RING_CLUSTERS = (1, 2, 4, 8)   # blocks of a cluster (8: the portable most)
RING_STAGES = 4                # the most stages a ring is given
STREAM_THREADS = 512
STREAM_CHUNK = 16              # output rows a stream thread accumulates
STREAM_SLABS = (512, 256, 128, 64, 32, 16, 8, 4, 2, 1)
_SCHEMES = {"sign": 0, "int8": 1}
_ROUTES = {"regs": 0, "ring": 1, "stream": 2}
_FILLS = {"tma": 0, "words": 1, "elems": 2}
TMA_BOX = 256                  # a TMA box's most elements a dimension
_DTYPES = {torch.float32: 4, torch.bfloat16: 2}
_WARPS = 8                     # the regs route's per-warp partials, 8 x 16


def _lib() -> ctypes.CDLL:
    lib = build.load("quantized_gossip_mix")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantized_gossip_mix_launch.argtypes = [
        p, p, p, p, p, p, p, i, i, i, ctypes.c_longlong, i, i, i, i, i, i,
        i, i, p, p]
    lib.quantized_gossip_mix_launch.restype = i
    lib.quantized_gossip_mix_resources.argtypes = [i, i, i, p]
    lib.quantized_gossip_mix_resources.restype = i
    lib.quantized_gossip_mix_ring_grid.argtypes = [
        i, i, ctypes.c_longlong, i, i, i, i, i, p, p]
    lib.quantized_gossip_mix_ring_grid.restype = i
    lib.quantized_gossip_mix_error_string.argtypes = [i]
    lib.quantized_gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def _ring_smem(n: int, R: int, cols: int, cluster: int, segs: int,
               stages: int, w_smem: bool, x_bytes: int, res_bytes: int):
    """The ring kernel's dynamic shared bytes (``ring_smem`` in the source):
    128 of alignment slack, then 128 of barriers, W^T (R x n x n4 f32) when
    staged, two f32 buffers of n x cols, two exchange slots of cluster x n
    x segs partials and n row scales, padded to 128 bytes, then the
    stages."""
    n4 = -(-n // 4) * 4
    head = (128 + (R * n * n4 * 4 if w_smem else 0) + 2 * n * cols * 4
            + 2 * cluster * n * segs * 4 + n * 4)
    return (128 + _pad(head, 128)
            + stages * _ring_stage(n, cols, x_bytes, res_bytes))


def _pad(nbytes: int, unit: int) -> int:
    return -(-nbytes // unit) * unit


def _ring_stage(n, cols, x_bytes, res_bytes):
    """A ring stage's bytes: the x rows then the res rows of a tile, each
    part padded to 128 bytes (a TMA box's destination is 128-byte
    aligned)."""
    return _pad(n * cols * x_bytes, 128) + _pad(n * cols * res_bytes, 128)


def _ring_layout(n, R, cols, cluster, segs, x_bytes, res_bytes, max_blocks):
    """(stages, w_smem, smem, blocks an SM it is sized for) of a ring tile,
    or None: the most blocks an SM (up to ``max_blocks``, what the kernel's
    registers allow) whose share of shared memory holds W and 2+ stages,
    else W read from device memory, else one stage."""
    def size(stages, w_smem):
        return _ring_smem(n, R, cols, cluster, segs, stages, w_smem, x_bytes,
                          res_bytes)
    stage = _ring_stage(n, cols, x_bytes, res_bytes)
    for w_smem in (True, False):
        for per_sm in range(max_blocks, 0, -1):
            budget = min(MAX_SHARED_BYTES, SM_SHARED_BYTES // per_sm - 1024)
            stages = min(RING_STAGES, (budget - size(0, w_smem)) // stage)
            if stages >= 2:
                return stages, w_smem, size(stages, w_smem), per_sm
    if size(1, False) <= MAX_SHARED_BYTES:
        return 1, False, size(1, False), 1
    return None


def _ring_tile(n: int, group: int, D: int, R: int):
    """(units a thread, cluster, cols) of the ring route from the shapes
    alone, or None where no ring takes them: the first of U = 1, 2 and
    cluster 1, 2, 4, 8 whose tile of n rows x cols columns has at most 256
    U units of 4 x 4 and fits in shared memory in f32 (so that a bf16
    launch takes the f32 launch's tile and arithmetic).  A cluster of 1
    block takes whole groups (cols a multiple of lcm(group, 4), as many as
    the units allow and D needs); a cluster of C > 1 splits a group into C
    slices of group / C columns, a multiple of 4."""
    n4 = -(-n // 4) * 4
    for units in RING_UNITS:
        max_cols = 16 * RING_THREADS * units // n4
        for cluster in RING_CLUSTERS:
            if cluster == 1:
                step = group * 4 // math.gcd(group, 4)
                k = min(max_cols // step, -(-D // step))
                if k < 1:
                    continue
                cols, segs = k * step, k * step // group
            else:
                cols, segs = group // cluster, 1
                if group % cluster or cols % 4 or cols > max_cols:
                    continue
            if _ring_layout(n, R, cols, cluster, segs, 4, 4,
                            RING_BLOCKS[units]) is not None:
                return units, cluster, cols
    return None


def _stream_geometry(n: int) -> dict:
    """The widest slab of columns whose deq (n x slab f32) and the n scales
    fit half an SM's shared memory (two blocks an SM), else a whole block's;
    W^T's rows padded to ``npad``, a multiple of STREAM_CHUNK."""
    n4 = -(-n // 4) * 4
    for budget in (MAX_SHARED_BYTES // 2, MAX_SHARED_BYTES):
        for slab in STREAM_SLABS:
            smem = (n4 + n * slab) * 4
            if smem <= budget:
                return {"route": "stream", "threads": STREAM_THREADS,
                        "slab": slab, "smem": smem,
                        "npad": -(-n // STREAM_CHUNK) * STREAM_CHUNK}
    raise ValueError(f"quantized_gossip_mix kernel: a column of {n} nodes' "
                     f"deq does not fit the {MAX_SHARED_BYTES}-byte "
                     "shared-memory limit")


def launch_geometry(n: int, group: int, D: int, R: int, x_bytes: int = 4,
                    res_bytes: int = 4) -> dict:
    """The route and launch of the kernel for ws (R, n, n) and x, res (n,
    D) with x_bytes and res_bytes a value (4 f32, 2 bf16), from shapes
    alone: ``regs`` where n <= REGS_NODES, the group is a power of two <=
    REGS_GROUP and the W stack fits; else ``ring`` where a tile fits
    (:func:`_ring_tile`: ``units`` a thread, a ``cluster`` of blocks,
    ``cols`` columns a block, ``stages`` of the ring, W in shared memory or
    not, the ``blocks_per_sm`` it is sized for); else ``stream`` (a
    ``slab`` of columns' deq at a time in shared memory, W^T's rows padded
    to ``npad``).  At n = 32, group 512, R = 2
    (whisper-tiny's 32-node int8 path): ring, clusters of 4 blocks of 128
    columns, 2 stages, 107,904 bytes in f32.  ``smem`` is a block's
    dynamic shared bytes.  The dtypes change only the stages and shared
    bytes, never the tile."""
    return _geometry(n, group, D, R, x_bytes, res_bytes, None)


def _geometry(n: int, group: int, D: int, R: int, x_bytes: int,
              res_bytes: int, route: Optional[str]) -> dict:
    """:func:`launch_geometry`, or with ``route`` named, that route's launch
    (it raises where that route cannot take the shapes)."""
    if n < 1 or group < 1 or D < 1 or R < 1:
        raise ValueError(f"quantized_gossip_mix kernel: n={n}, group="
                         f"{group}, D={D}, R={R} must be positive")
    if route is not None and route not in _ROUTES:
        raise ValueError(f"unknown route {route!r} (have {sorted(_ROUTES)})")
    shape = {"n": n, "group": group, "D": D, "R": R, "x_bytes": x_bytes,
             "res_bytes": res_bytes}
    w_bytes = R * n * n * 4
    regs_smem = w_bytes + _WARPS * REGS_NODES * 4
    regs = (n <= REGS_NODES and group <= REGS_GROUP
            and not group & (group - 1) and regs_smem <= MAX_SHARED_BYTES)
    if route == "regs" or (route is None and regs):
        if not regs:
            raise ValueError(f"the regs route takes n <= {REGS_NODES} and a "
                             f"power-of-two group <= {REGS_GROUP}, not n={n}"
                             f", group={group}")
        return {**shape, "route": "regs", "threads": 256, "smem": regs_smem}
    tile = _ring_tile(n, group, D, R) if route != "stream" else None
    if tile is not None:
        units, cluster, cols = tile
        segs = 1 if cluster > 1 else cols // group
        stages, w_smem, smem, per_sm = _ring_layout(
            n, R, cols, cluster, segs, x_bytes, res_bytes,
            RING_BLOCKS[units])
        return {**shape, "route": "ring", "threads": RING_THREADS,
                "units": units, "cluster": cluster, "cols": cols,
                "stages": stages, "w_smem": w_smem, "n4": -(-n // 4) * 4,
                "blocks_per_sm": per_sm, "smem": smem}
    if route == "ring":
        raise ValueError(f"no ring tile takes n={n}, group={group}")
    return {**shape, **_stream_geometry(n)}


def resources(geometry: dict, scheme: str) -> dict:
    """The compiled ring or stream kernel a :func:`launch_geometry` result
    launches for ``scheme``: registers and spilled (local) bytes a thread,
    static and dynamic shared bytes, threads a block; for the ring also the
    cluster size, stages and the blocks a launch runs (the resident
    clusters' blocks, capped by the tiles)."""
    route = geometry["route"]
    variant = geometry["units"] if route == "ring" else 0
    out = (ctypes.c_int * 4)()
    lib = _lib()
    err = lib.quantized_gossip_mix_resources(
        _ROUTES[route], variant, _SCHEMES[scheme], out)
    if err != 0:
        raise RuntimeError(f"quantized_gossip_mix_resources: cudaError {err}")
    res = {"registers": out[0], "local_bytes": out[1],
           "static_smem": out[2], "dynamic_smem": geometry["smem"],
           "threads": out[3]}
    if route == "ring":
        grid = ctypes.c_int(0)
        g = geometry
        err = lib.quantized_gossip_mix_ring_grid(
            g["R"], g["n"], g["D"], g["group"], _SCHEMES[scheme],
            int(g["x_bytes"] == 2), int(g["res_bytes"] == 2), g["smem"],
            _ring_params(g, "words", True), ctypes.byref(grid))
        if err != 0:
            raise RuntimeError(f"quantized_gossip_mix_ring_grid: cudaError "
                               f"{err}")
        res.update(cluster=g["cluster"], stages=g["stages"],
                   blocks=grid.value)
    return res


def _ring_params(geo: dict, fill: str, vst: bool):
    return (ctypes.c_int * 8)(geo["units"], geo["cols"], geo["cluster"],
                              geo["stages"], _FILLS[fill], int(vst),
                              int(geo["w_smem"]), geo["n4"])


def quantized_gossip_mix(ws: torch.Tensor, x: torch.Tensor, res: torch.Tensor,
                         *, scheme: str, group: int = 256,
                         error_feedback: bool = True,
                         out: Optional[torch.Tensor] = None,
                         res_out: Optional[torch.Tensor] = None):
    """ws: (R, n, n); x, res: (n, D) with D % group == 0 -> (mixed x, final
    residual), each in its input's dtype.  ``out`` / ``res_out`` receive the
    results when given; they may be ``x`` / ``res`` themselves, and the call
    then runs in place."""
    _check(ws, x, res, scheme, group, out, res_out)
    if x.device.type == "cpu":
        o, r = ref.quantized_gossip_mix_ref(ws, x, res, scheme=scheme,
                                            group=group,
                                            error_feedback=error_feedback)
        return (o if out is None else out.copy_(o),
                r if res_out is None else res_out.copy_(r))
    if x.device.type not in ("cuda", "meta"):
        raise ValueError(f"quantized_gossip_mix takes CPU, CUDA or meta "
                         f"tensors, not {x.device.type}")
    return _launch(ws, x, res, scheme, group, error_feedback, out, res_out,
                   None)


def _launch_route(ws: torch.Tensor, x: torch.Tensor, res: torch.Tensor,
                  route: str, *, scheme: str, group: int = 256,
                  error_feedback: bool = True,
                  out: Optional[torch.Tensor] = None,
                  res_out: Optional[torch.Tensor] = None):
    """:func:`quantized_gossip_mix` on CUDA tensors through ``route``
    instead of :func:`launch_geometry`'s pick (it raises where that route
    cannot take the shapes): the card tests and ``chip_smoke.py`` hold the
    routes against one another so."""
    _check(ws, x, res, scheme, group, out, res_out)
    if route not in _ROUTES:
        raise ValueError(f"unknown route {route!r} (have {sorted(_ROUTES)})")
    if x.device.type != "cuda":
        raise ValueError("a route is launched on CUDA tensors only")
    return _launch(ws, x, res, scheme, group, error_feedback, out, res_out,
                   route)


def _check(ws, x, res, scheme, group, out, res_out):
    R, n, n2 = ws.shape
    N, D = x.shape
    if n != n2 or N != n or res.shape != x.shape:
        raise ValueError(f"ws {tuple(ws.shape)} does not mix x "
                         f"{tuple(x.shape)} and res {tuple(res.shape)}")
    if scheme not in _SCHEMES:
        raise ValueError(f"unknown compression scheme {scheme!r} "
                         f"(have {sorted(_SCHEMES)})")
    if group < 1 or D % group:
        raise ValueError(f"D={D} is not a multiple of group={group}")
    for name, t, like in (("out", out, x), ("res_out", res_out, res)):
        if t is not None and (t.shape != like.shape or t.dtype != like.dtype
                              or t.device != like.device):
            raise ValueError(f"{name} must match its input in shape, dtype "
                             "and device")
    if res.device != x.device:
        raise ValueError("x and res must lie on one device")


def _aligned(ptrs, nbytes: int) -> bool:
    return all(p % nbytes == 0 for p in ptrs)


def _transposed(w: torch.Tensor, pad: int) -> torch.Tensor:
    """W_r transposed, each row padded with zeros to ``pad`` (the ring's
    units of 4 rows, the stream route's chunks of STREAM_CHUNK)."""
    R, n, _ = w.shape
    wt = torch.zeros(R, n, pad, device=w.device)
    wt[:, :, :n] = w.transpose(1, 2)
    return wt


def _launch(ws, x, res, scheme, group, error_feedback, out, res_out, route):
    R, n, _ = ws.shape
    D = x.shape[1]
    if x.dtype not in _DTYPES or res.dtype not in _DTYPES:
        raise TypeError(f"quantized_gossip_mix kernel takes f32 or bf16 x "
                        f"and res, not {x.dtype} and {res.dtype}")
    ex, er = _DTYPES[x.dtype], _DTYPES[res.dtype]
    if not (x.is_contiguous() and res.is_contiguous()):
        raise ValueError("quantized_gossip_mix kernel takes contiguous x "
                         "and res")
    out = torch.empty_like(x) if out is None else out
    res_out = torch.empty_like(res) if res_out is None else res_out
    if not (out.is_contiguous() and res_out.is_contiguous()):
        raise ValueError("quantized_gossip_mix kernel takes contiguous out "
                         "and res_out")
    if D == 0:
        return out, res_out
    geo = _geometry(n, group, D, R, ex, er, route)
    # the W stack is tiny; its copy to f32 contiguous on x's device is free
    w = ws.to(device=x.device, dtype=torch.float32).contiguous()
    wt, tmp, slots = None, None, 0
    px, pr, po, pro = (x.data_ptr(), res.data_ptr(), out.data_ptr(),
                       res_out.data_ptr())
    if geo["route"] == "regs":
        vec = 4 if (n <= 8 and group % 4 == 0 and _aligned((px, po), 4 * ex)
                    and _aligned((pr, pro), 4 * er)) else 1
        params = (ctypes.c_int * 8)(vec)
    elif geo["route"] == "ring":
        wt = _transposed(w, geo["n4"])
        cols = geo["cols"]
        if (_aligned((px, pr), 16) and (D * ex) % 16 == 0
                and (D * er) % 16 == 0 and (cols * ex) % 16 == 0
                and (cols * er) % 16 == 0 and cols <= TMA_BOX
                and n <= TMA_BOX and D < 2**31):
            # one 2-D box of x and one of res a stage
            fill = "tma"
        elif (_aligned((px, pr), 4) and (D * ex) % 4 == 0
              and (D * er) % 4 == 0):
            fill = "words"
        else:
            fill = "elems"
        vst = (D % 4 == 0 and _aligned((po,), 4 * ex)
               and _aligned((pro,), 4 * er))
        params = _ring_params(geo, fill, vst)
    else:
        wt = _transposed(w, geo["npad"])
        params = (ctypes.c_int * 8)(geo["slab"], geo["npad"])
        if (ex == 2 or er == 2) and R > 1:
            # a round's state between rounds in f32: a scratch slot for
            # each block that can be resident (512 threads: 4 an SM)
            sms = (cost.SMS if x.device.type == "meta" else
                   torch.cuda.get_device_properties(x.device)
                   .multi_processor_count)
            slots = min(D // group, 4 * sms)
            tmp = torch.empty(slots * 2 * n * group, device=x.device)
    if x.device.type == "meta":
        cost.charge("quantized_gossip_mix",
                    cost.quantized_gossip_mix(n, D, R, ex, er))
        return out, res_out
    # with EF off res passes through: skip its store when it is in place
    write_res = int(error_feedback or pro != pr)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantized_gossip_mix_launch(
            w.data_ptr(), None if wt is None else wt.data_ptr(), px, pr, po,
            pro, None if tmp is None else tmp.data_ptr(), slots, R, n, D,
            group, _SCHEMES[scheme], int(error_feedback), write_res,
            int(ex == 2), int(er == 2), _ROUTES[geo["route"]], geo["smem"],
            params, stream)
    if err != 0:
        msg = lib.quantized_gossip_mix_error_string(err).decode()
        raise RuntimeError(f"quantized_gossip_mix launch failed: {msg} "
                           f"(cudaError {err})")
    quantized_gossip_mix.launches += 1
    return out, res_out


quantized_gossip_mix.launches = 0
