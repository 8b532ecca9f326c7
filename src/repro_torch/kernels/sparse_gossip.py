"""Sparse gossip segment sum: the Hopper kernel's wrapper.

One edge-list gossip round in Laplacian form (see
:mod:`repro_torch.sparse.plan`) updates each receiver by

    delta[s] = sum_{e in segment s} w[e]·(x[src[e]] − x[dst[e]])

and the caller adds delta[s] to x[slots[s]].  The kernel
(``csrc/sparse_segment_mix.cu``) reads both endpoint rows straight from x
and sums each segment's edges in order in registers; see the note at the top
of the source.  It takes the round's edges grouped by segment:
:func:`segment_layout` sorts them once (the sparse mixer does so once per
staged plan).

Dispatch is by where the tensor lies, never by a fallback: a CUDA tensor
launches the kernel (and anything the kernel does not take raises), a CPU
tensor takes the plain version
:func:`repro_torch.kernels.ref.sparse_gossip_mix_ref`.
``sparse_segment_mix.launches`` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 128                 # the kernel's block: columns per chunk / VEC
_MAX_CHUNKS = 65_535           # column chunks ride the grid's y dimension


def _lib() -> ctypes.CDLL:
    lib = build.load("sparse_segment_mix")
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.sparse_segment_mix_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.sparse_segment_mix_launch.restype = ctypes.c_int
    lib.sparse_segment_mix_error_string.argtypes = [ctypes.c_int]
    lib.sparse_segment_mix_error_string.restype = ctypes.c_char_p
    return lib


def segment_layout(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   seg: torch.Tensor, num_segments: int):
    """The edges grouped by receiver segment, as the kernel takes them:
    ``(src, dst, w)`` in a stable order of ``seg`` and the offsets
    (..., num_segments + 1), segment s owning [offsets[s], offsets[s+1]).
    Works on one round's (E,) arrays or a (P, E) stack of rounds; an edge
    whose seg is >= num_segments sorts last and lies in no segment (the
    mixer marks padding so).  Device ops only: no host sync."""
    seg_sorted, order = torch.sort(seg, dim=-1, stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device,
                          dtype=seg.dtype)
    bounds = bounds.expand(*seg.shape[:-1], -1).contiguous()
    offsets = torch.searchsorted(seg_sorted.contiguous(), bounds)

    def take(a):
        return torch.gather(a, -1, order)

    return take(src), take(dst), take(w), offsets


def sparse_segment_mix(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """x: (n, D) f32 or bf16; src, dst: (E,) node ids; w: (E,) weights;
    offsets: (S + 1,), the edges grouped by segment (:func:`segment_layout`).
    Returns delta (S, D) f32.  The kernel trusts the indices (ids in [0, n),
    offsets non-decreasing within [0, E]); checking them on the card would
    stop the host."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, D), got {tuple(x.shape)}")
    E = src.shape[0]
    if src.dim() != 1 or dst.shape != (E,) or w.shape != (E,) \
            or offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"src {tuple(src.shape)}, dst {tuple(dst.shape)}, "
                         f"w {tuple(w.shape)} must be (E,) and offsets "
                         f"{tuple(offsets.shape)} (S + 1,)")
    if x.device.type == "cpu":
        lo, hi = int(offsets[0]), int(offsets[-1])
        S = offsets.shape[0] - 1
        seg = torch.repeat_interleave(torch.arange(S), offsets.diff())
        s, d = src[lo:hi], dst[lo:hi]
        return ref.sparse_gossip_mix_ref(seg, w[lo:hi], x[s], x[d], S)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_segment_mix takes CPU or CUDA tensors, not "
                         f"{x.device.type}")
    return _launch(x, src, dst, w, offsets)


def _launch(x, src, dst, w, offsets):
    S, D = offsets.shape[0] - 1, x.shape[1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"sparse_segment_mix kernel takes f32 or bf16 x, not "
                        f"{x.dtype}")
    for name, t, dtype in (("src", src, torch.int64), ("dst", dst, torch.int64),
                           ("w", w, torch.float32),
                           ("offsets", offsets, torch.int64)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"sparse_segment_mix kernel takes {name} as a "
                             f"contiguous {dtype} tensor on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise ValueError("sparse_segment_mix kernel takes a contiguous x")
    delta = torch.empty((S, D), dtype=torch.float32, device=x.device)
    if S == 0 or D == 0:
        return delta
    vec = 4 if D % 4 == 0 and x.data_ptr() % (4 * x.element_size()) == 0 \
        else 1
    if -(-D // (_THREADS * vec)) > _MAX_CHUNKS:
        raise ValueError(f"sparse_segment_mix kernel takes D <= "
                         f"{_MAX_CHUNKS * _THREADS * vec} columns, got {D}")
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.sparse_segment_mix_launch(
            x.data_ptr(), src.data_ptr(), dst.data_ptr(), w.data_ptr(),
            offsets.data_ptr(), delta.data_ptr(), S, D, _DTYPES[x.dtype], vec,
            stream)
    if err != 0:
        msg = lib.sparse_segment_mix_error_string(err).decode()
        raise RuntimeError(f"sparse_segment_mix launch failed: {msg} "
                           f"(cudaError {err})")
    sparse_segment_mix.launches += 1
    return delta


sparse_segment_mix.launches = 0
