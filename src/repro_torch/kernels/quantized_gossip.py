"""Error-feedback compressed multi-consensus: the Hopper kernel's wrapper.

For each of R rounds on the flattened, node-stacked state x and its
error-feedback residual res (both (n, D) f32, D % group == 0)::

    buf = x + res
    deq = dequant(quant(buf))    # sign or int8, one scale per (node, group)
    res = buf - deq              # only with error feedback
    x   = W_r @ deq

The kernel (``csrc/quantized_gossip_mix.cu``) takes 1 <= n <= 64 and any
group dividing D, on one of three routes that :func:`launch_geometry` picks
from the shapes alone: ``regs`` (n <= 16 and a power-of-two group <= 256:
x and res in registers for all R rounds), ``tile`` (a block's whole groups,
n x group x 8 bytes, in shared memory for all R rounds) and ``stream``
(where that tile does not fit: every round streams the block's group
through device memory, up to 1.5 R times the traffic); see the note at the
top of the source.

Dispatch is by where the tensors lie, never by a fallback: CUDA tensors
launch the kernel (and anything the kernel does not take raises), CPU
tensors take the plain version
:func:`repro_torch.kernels.ref.quantized_gossip_mix_ref`.
``quantized_gossip_mix.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import build, ref

MAX_NODES = 64                 # n accumulators a thread on the wide routes
REGS_NODES = 16                # the regs route: x and res of every node in
REGS_GROUP = 256               # registers, a group inside one 256-thread block
MAX_SHARED_BYTES = 232_448     # 227 KB: the most one block may use on Hopper
WIDE_THREADS = 512             # the tile and stream routes' blocks
_SCHEMES = {"sign": 0, "int8": 1}
_ROUTES = {"regs": 0, "tile": 1, "stream": 2}
_WARPS = 8                     # the regs route's per-warp partials, 8 x 16


def _lib() -> ctypes.CDLL:
    lib = build.load("quantized_gossip_mix")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.quantized_gossip_mix_launch.argtypes = [
        p, p, p, p, p, i, i, ctypes.c_longlong, i, i, i, i, i, i, i, p]
    lib.quantized_gossip_mix_launch.restype = i
    lib.quantized_gossip_mix_resources.argtypes = [i, i, i, p]
    lib.quantized_gossip_mix_resources.restype = i
    lib.quantized_gossip_mix_error_string.argtypes = [i]
    lib.quantized_gossip_mix_error_string.restype = ctypes.c_char_p
    return lib


def launch_geometry(n: int, group: int, D: int, R: int) -> dict:
    """The route and launch of the kernel for ws (R, n, n) and x, res (n,
    D), from shapes alone: ``regs`` where n <= REGS_NODES and the group is
    a power of two <= REGS_GROUP (x and res in registers); else
    ``tile`` where a block's tile of whole groups fits in shared memory
    beside the W stack (n x group x 8 bytes of x and res a group, 4 of scale
    a (node, group)), with ``gpt`` groups a tile: enough for WIDE_THREADS
    columns when groups are narrow, as many as fit; else ``stream``.  At n
    = 32, group 512, R = 2 (whisper-tiny's 32-node int8 path): tile, gpt 1,
    139,392 bytes.  ``smem`` is the block's dynamic shared bytes.  Raises
    where n > MAX_NODES or the W stack leaves no room."""
    if not 1 <= n <= MAX_NODES:
        raise ValueError(f"quantized_gossip_mix kernel takes n <= "
                         f"{MAX_NODES} nodes, got {n}")
    w_bytes = R * n * n * 4
    if n <= REGS_NODES and group <= REGS_GROUP and not group & (group - 1):
        geo = {"route": "regs", "gpt": 1, "threads": 256,
               "smem": w_bytes + _WARPS * REGS_NODES * 4}
    else:
        per_group = n * group * 8 + n * 4
        room = (MAX_SHARED_BYTES - w_bytes) // per_group
        want = min(-(-WIDE_THREADS // group), max(1, D // group))
        if room >= 1:
            gpt = min(room, want)
            geo = {"route": "tile", "gpt": gpt, "threads": WIDE_THREADS,
                   "smem": w_bytes + gpt * per_group}
        else:
            geo = {"route": "stream", "gpt": 1, "threads": WIDE_THREADS,
                   "smem": w_bytes + n * 4}
    if geo["smem"] > MAX_SHARED_BYTES:
        raise ValueError(f"W stack of {R}x{n}x{n} f32 exceeds the "
                         f"{MAX_SHARED_BYTES}-byte shared-memory limit")
    return geo


def resources(geometry: dict, scheme: str, n: int) -> dict:
    """The compiled tile or stream kernel a :func:`launch_geometry` result
    launches for ``scheme`` at n nodes: registers and spilled (local) bytes
    a thread, static and dynamic shared bytes, threads a block."""
    out = (ctypes.c_int * 4)()
    err = _lib().quantized_gossip_mix_resources(
        _ROUTES[geometry["route"]], n, _SCHEMES[scheme], out)
    if err != 0:
        raise RuntimeError(f"quantized_gossip_mix_resources: cudaError {err}")
    return {"registers": out[0], "local_bytes": out[1],
            "static_smem": out[2], "dynamic_smem": geometry["smem"],
            "threads": out[3]}


def quantized_gossip_mix(ws: torch.Tensor, x: torch.Tensor, res: torch.Tensor,
                         *, scheme: str, group: int = 256,
                         error_feedback: bool = True,
                         out: Optional[torch.Tensor] = None,
                         res_out: Optional[torch.Tensor] = None):
    """ws: (R, n, n); x, res: (n, D) with D % group == 0 -> (mixed x, final
    residual).  ``out`` / ``res_out`` receive the results when given; they
    may be ``x`` / ``res`` themselves, and the call then runs in place."""
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
    if x.device.type == "cpu":
        o, r = ref.quantized_gossip_mix_ref(ws, x, res, scheme=scheme,
                                            group=group,
                                            error_feedback=error_feedback)
        return (o if out is None else out.copy_(o),
                r if res_out is None else res_out.copy_(r))
    if x.device.type != "cuda":
        raise ValueError(f"quantized_gossip_mix takes CPU or CUDA tensors, "
                         f"not {x.device.type}")
    return _launch(ws, x, res, scheme, group, error_feedback, out, res_out)


def _launch(ws, x, res, scheme, group, error_feedback, out, res_out):
    R, n, _ = ws.shape
    D = x.shape[1]
    if x.dtype != torch.float32 or res.dtype != torch.float32:
        raise TypeError(f"quantized_gossip_mix kernel takes f32 x and res, "
                        f"not {x.dtype} and {res.dtype}")
    geo = launch_geometry(n, group, D, R)
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
    # the W stack is tiny; its copy to f32 contiguous on x's device is free
    w = ws.to(device=x.device, dtype=torch.float32).contiguous()
    ptrs = (x.data_ptr(), res.data_ptr(), out.data_ptr(), res_out.data_ptr())
    vec = 4 if (geo["route"] == "regs" and n <= 8 and group % 4 == 0
                and all(q % 16 == 0 for q in ptrs)) else 1
    # with EF off res passes through: skip its store when it is in place
    write_res = int(error_feedback or res_out.data_ptr() != res.data_ptr())
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quantized_gossip_mix_launch(
            w.data_ptr(), *ptrs, R, n, D, group, _SCHEMES[scheme],
            int(error_feedback), write_res, _ROUTES[geo["route"]], vec,
            geo["gpt"], stream)
    if err != 0:
        msg = lib.quantized_gossip_mix_error_string(err).decode()
        raise RuntimeError(f"quantized_gossip_mix launch failed: {msg} "
                           f"(cudaError {err})")
    quantized_gossip_mix.launches += 1
    return out, res_out


quantized_gossip_mix.launches = 0
