"""Sparse gossip segment sum: the Hopper kernel's wrapper.

One edge-list gossip round in Laplacian form (see
:mod:`repro_torch.sparse.plan`) updates each receiver by

    delta[s] = sum_{e in segment s} w[e]·(x[src[e]] − x[dst[e]])

and the caller adds delta[s] to x[slots[s]].  The kernel
(``csrc/sparse_segment_mix.cu``) takes the round laid out by
:func:`segment_layout`: the edges grouped by segment, and the round's
distinct rows ``rows`` with each edge's local ids ``lsrc``, ``ldst`` into
them (the sparse mixer lays out each round once per staged plan).  Its
staged variant copies x[rows] one column tile at a time into shared memory
and sums each segment's edges in order from there; its gather variant, for
rounds whose rows do not fit, reads both endpoint rows straight from x.
:func:`launch_geometry` picks the variant from shapes alone; see the note at
the top of the source.

Dispatch is by where the tensor lies, never by a fallback: a CUDA tensor
launches one of the two variants (and anything the kernel does not take
raises), a CPU tensor takes the plain version
:func:`repro_torch.kernels.ref.sparse_gossip_mix_ref` on the rows the staged
variant reads (:func:`repro_torch.kernels.ref.staged_rows_ref`).
``sparse_segment_mix.launches`` counts kernel launches, and only those;
``sparse_segment_mix.variants`` counts them by variant.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build, ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"staged": 0, "gather": 1}
GATHER_THREADS = 128           # the gather variant's block: columns / VEC
_MAX_GRID_Y = 65_535           # gather column chunks, staged segment groups
WARPS = 16                     # warps per block of the staged variant
BLOCK_SMEM = 232_448           # dynamic shared memory of a block (227 KB)
SM_SMEM = 233_472              # shared memory of one SM (228 KB)
_EDGE_BYTES = 16               # one edge in a warp's ring


class SegmentLayout(NamedTuple):
    """One round as the kernel takes it (:func:`segment_layout`): src, dst
    (E,) int64 node ids and w (E,) f32, grouped by segment; offsets (S + 1,)
    int64, segment s owning [offsets[s], offsets[s+1]); rows (U,) int64,
    the distinct ids of the edges in a segment, sorted; lsrc, ldst (E,)
    int32 with rows[lsrc[e]] == src[e] and rows[ldst[e]] == dst[e] (0 past
    offsets[S])."""
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    offsets: torch.Tensor
    rows: torch.Tensor
    lsrc: torch.Tensor
    ldst: torch.Tensor


@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernel's library, its argument types set once, at load."""
    lib = build.load("sparse_segment_mix")
    p, i = ctypes.c_void_p, ctypes.c_int
    # every pointer and the stream as c_void_p: a bare int would be cut to 32 bits
    lib.sparse_segment_mix_staged_launch.argtypes = [
        p, p, i, p, p, p, p, p, i, ctypes.c_longlong, i, i, i, i, i, p]
    lib.sparse_segment_mix_gather_launch.argtypes = [
        p, p, p, p, p, p, i, ctypes.c_longlong, i, i, p]
    lib.sparse_segment_mix_staged_launch.restype = i
    lib.sparse_segment_mix_gather_launch.restype = i
    lib.sparse_segment_mix_resources.argtypes = [i, i, i, i,
                                                 ctypes.POINTER(i)]
    lib.sparse_segment_mix_resources.restype = i
    lib.sparse_segment_mix_error_string.argtypes = [i]
    lib.sparse_segment_mix_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def compact_rows(src: torch.Tensor, dst: torch.Tensor, inside: torch.Tensor):
    """Each round's distinct rows.  src, dst: (P, E) node ids of P rounds;
    inside: (P,) how many leading edges of each round lie in a segment.
    Returns rows, a list of P sorted (U_r,) int64 tensors, and lsrc, ldst
    (P, E) int32 with rows[r][lsrc[r, e]] == src[r, e] (and so for dst) for
    e < inside[r], 0 past it: ``np.unique(..., return_inverse=True)`` on
    each round's src ++ dst.  One sort for all rounds, keyed by (round,
    id); syncs with the host once (U_r are data).  ``compact_rows.calls``
    counts the calls."""
    compact_rows.calls += 1
    P, E = src.shape
    dev = src.device
    keep = torch.arange(E, device=dev)[None] < inside[:, None]
    round_key = torch.arange(P, device=dev)[:, None] << 32
    keys = torch.cat([torch.where(keep, round_key | src, P << 32),
                      torch.where(keep, round_key | dst, P << 32)], 1)
    uniq, inv = torch.unique(keys, sorted=True, return_inverse=True)
    starts = torch.searchsorted(uniq, torch.arange(P + 1, device=dev) << 32)
    local = torch.where(torch.cat([keep, keep], 1), inv - starts[:-1, None],
                        0).to(torch.int32)
    cut = starts.tolist()
    ids = uniq & 0xFFFFFFFF
    rows = [ids[cut[r]:cut[r + 1]] for r in range(P)]
    return rows, local[:, :E], local[:, E:]


compact_rows.calls = 0


def segment_layouts(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                    seg: torch.Tensor, num_segments: int) -> list:
    """P rounds' (P, E) edges as the kernel takes them, one
    :class:`SegmentLayout` a round: ``src``, ``dst``, ``w`` in a stable
    order of ``seg``, the offsets (num_segments + 1,), segment s owning
    [offsets[s], offsets[s+1]), and the round compacted
    (:func:`compact_rows`) over the edges that lie in a segment.  An edge
    whose seg is >= num_segments sorts last, lies in no segment and adds no
    row (its local ids are 0): the sparse mixer marks padding so, and lays
    out all of a staged plan's rounds in one call.  Syncs with the host
    once."""
    P = seg.shape[0]
    seg_sorted, order = torch.sort(seg, dim=-1, stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device,
                          dtype=seg.dtype).expand(P, -1).contiguous()
    offsets = torch.searchsorted(seg_sorted, bounds)
    src, dst, w = (torch.gather(a, -1, order) for a in (src, dst, w))
    rows, lsrc, ldst = compact_rows(src, dst, offsets[:, -1])
    return [SegmentLayout(src[r], dst[r], w[r], offsets[r], rows[r], lsrc[r],
                          ldst[r]) for r in range(P)]


def segment_layout(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   seg: torch.Tensor, num_segments: int) -> SegmentLayout:
    """One round's (E,) edges as the kernel takes them
    (:func:`segment_layouts` of a stack of one)."""
    return segment_layouts(*(a[None] for a in (src, dst, w, seg)),
                           num_segments)[0]


def _staged_smem(U: int, vec: int, elem: int) -> int:
    """Shared bytes of a staged block: U rows of 32·vec values, a 32-edge
    ring per warp, the warps' first segments."""
    return U * 32 * vec * elem + WARPS * 32 * _EDGE_BYTES + (WARPS + 1) * 4


def max_staged_rows(dtype: torch.dtype) -> int:
    """The most rows U the staged variant takes: U rows of its narrowest
    tile (32 columns) in one block's shared memory."""
    elem = dtype.itemsize
    return (BLOCK_SMEM - _staged_smem(0, 1, elem)) // (32 * elem)


@functools.lru_cache(maxsize=4096)
def launch_geometry(U: int, D: int, S: int, dtype: torch.dtype,
                    sms: int) -> dict:
    """The variant and launch of a round with U distinct rows, D columns
    and S segments, from shapes alone.  Staged while U rows of a 32-column
    tile fit in a block's shared memory: the widest tile of 32·vec columns
    (vec 4, 2, 1) whose U rows fit, narrowed while half of it still covers
    D; segment groups enough for a warp a segment (WARPS warps a block), but
    no more than fill the card's ``sms`` SMs once (blocks per SM as shared
    memory and threads allow).  Otherwise the gather variant: S x ceil(D /
    (128·vec)) blocks of 128 threads, vec 4 where D % 4 == 0 and x is
    16-byte aligned (the wrapper looks), else 1.  At the sampled-client
    main path (U <= 256, D 784, S 229-256, f32, 132 SMs): staged, vec 4, 7
    x 15-16 blocks of 512 threads.  Cached: the wrapper asks on every
    launch, and a staged plan's rounds come round again each period.  The
    caller must not change the dict it returns."""
    elem = dtype.itemsize
    fits = [v for v in (4, 2, 1) if _staged_smem(U, v, elem) <= BLOCK_SMEM]
    if not fits:
        return {"variant": "gather", "block": GATHER_THREADS}
    vec = fits[0]
    while vec > 1 and 32 * (vec // 2) >= D:
        vec //= 2
    tiles = -(-D // (32 * vec))
    smem = _staged_smem(U, vec, elem)
    per_sm = max(1, min(SM_SMEM // (smem + 1024), 2048 // (WARPS * 32)))
    groups = max(1, min(sms * per_sm // tiles, -(-S // WARPS), _MAX_GRID_Y))
    return {"variant": "staged", "vec": vec, "tile": 32 * vec,
            "grid": (tiles, groups), "block": WARPS * 32, "smem": smem}


def resources(variant: str, dtype: torch.dtype, vec: int,
              rows: int = 0) -> dict:
    """The compiled kernel of ``variant`` ("staged" or "gather") for (dtype,
    vec): registers and spilled (local) bytes per thread, static shared
    bytes, dynamic shared bytes of a launch staging ``rows`` rows (0 for
    gather) and threads per block."""
    out = (ctypes.c_int * 5)()
    err = _lib().sparse_segment_mix_resources(_VARIANTS[variant],
                                              _DTYPES[dtype], vec, rows, out)
    if err != 0:
        raise RuntimeError(f"sparse_segment_mix_resources: cudaError {err}")
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "dynamic_smem", "threads"), out))


def sparse_segment_mix(x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, offsets: torch.Tensor,
                       rows: torch.Tensor, lsrc: torch.Tensor,
                       ldst: torch.Tensor) -> torch.Tensor:
    """x: (n, D) f32 or bf16; the rest one round as :func:`segment_layout`
    lays it out (``sparse_segment_mix(x, *layout)``).  Returns delta (S, D)
    f32.  The kernel trusts the indices (ids in [0, n), local ids in [0,
    U), rows[lsrc] == src and rows[ldst] == dst, offsets non-decreasing
    within [0, E]); checking them on the card would stop the host."""
    if x.dim() != 2:
        raise ValueError(f"x must be (n, D), got {tuple(x.shape)}")
    E = src.shape[0]
    if src.dim() != 1 or any(t.shape != (E,) for t in (dst, w, lsrc, ldst)) \
            or offsets.dim() != 1 or offsets.shape[0] < 1 or rows.dim() != 1:
        raise ValueError(f"src {tuple(src.shape)}, dst {tuple(dst.shape)}, "
                         f"w {tuple(w.shape)}, lsrc {tuple(lsrc.shape)}, "
                         f"ldst {tuple(ldst.shape)} must be (E,), offsets "
                         f"{tuple(offsets.shape)} (S + 1,) and rows "
                         f"{tuple(rows.shape)} (U,)")
    if x.device.type == "cpu":
        lo, hi = int(offsets[0]), int(offsets[-1])
        S = offsets.shape[0] - 1
        seg = torch.repeat_interleave(torch.arange(S), offsets.diff())
        xs, xd = ref.staged_rows_ref(x, rows, lsrc[lo:hi], ldst[lo:hi])
        return ref.sparse_gossip_mix_ref(seg, w[lo:hi], xs, xd, S)
    if x.device.type != "cuda":
        raise ValueError(f"sparse_segment_mix takes CPU or CUDA tensors, not "
                         f"{x.device.type}")
    return _launch(x, src, dst, w, offsets, rows, lsrc, ldst)


def _check(x, src, dst, w, offsets, rows, lsrc, ldst) -> None:
    """Raise for what neither variant takes."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"sparse_segment_mix kernel takes f32 or bf16 x, not "
                        f"{x.dtype}")
    for name, t, dtype in (("src", src, torch.int64), ("dst", dst, torch.int64),
                           ("w", w, torch.float32),
                           ("offsets", offsets, torch.int64),
                           ("rows", rows, torch.int64),
                           ("lsrc", lsrc, torch.int32),
                           ("ldst", ldst, torch.int32)):
        if t.dtype != dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"sparse_segment_mix kernel takes {name} as a "
                             f"contiguous {dtype} tensor on {x.device}, got "
                             f"{t.dtype} on {t.device}")
    if not x.is_contiguous():
        raise ValueError("sparse_segment_mix kernel takes a contiguous x")
    if src.shape[0] >= 2**31:
        raise ValueError(f"sparse_segment_mix kernel takes E < 2^31 edges, "
                         f"got {src.shape[0]}")


def _launch(x, src, dst, w, offsets, rows, lsrc, ldst):
    _check(x, src, dst, w, offsets, rows, lsrc, ldst)
    S, D = offsets.shape[0] - 1, x.shape[1]
    delta = torch.empty((S, D), dtype=torch.float32, device=x.device)
    if S == 0 or D == 0:
        return delta
    geo = launch_geometry(rows.shape[0], D, S, x.dtype,
                          _sm_count(x.device.index))
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if geo["variant"] == "staged":
            # the widest copy that D's rows and x's address allow
            nbytes = D * x.element_size()
            cb = next(b for b in (16, 8, 4, 2) if nbytes % b == 0
                      and x.data_ptr() % b == 0)
            err = lib.sparse_segment_mix_staged_launch(
                x.data_ptr(), rows.data_ptr(), rows.shape[0],
                lsrc.data_ptr(), ldst.data_ptr(), w.data_ptr(),
                offsets.data_ptr(), delta.data_ptr(), S, D, _DTYPES[x.dtype],
                geo["vec"], geo["grid"][1], WARPS, cb, stream)
        else:
            vec = 4 if D % 4 == 0 and x.data_ptr() % (4 * x.element_size()) \
                == 0 else 1
            if -(-D // (GATHER_THREADS * vec)) > _MAX_GRID_Y:
                raise ValueError(f"sparse_segment_mix kernel takes D <= "
                                 f"{_MAX_GRID_Y * GATHER_THREADS * vec} "
                                 f"columns, got {D}")
            err = lib.sparse_segment_mix_gather_launch(
                x.data_ptr(), src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                offsets.data_ptr(), delta.data_ptr(), S, D, _DTYPES[x.dtype],
                vec, stream)
    if err != 0:
        msg = lib.sparse_segment_mix_error_string(err).decode()
        raise RuntimeError(f"sparse_segment_mix {geo['variant']} launch "
                           f"failed: {msg} (cudaError {err})")
    sparse_segment_mix.launches += 1
    sparse_segment_mix.variants[geo["variant"]] += 1
    return delta


sparse_segment_mix.launches = 0
sparse_segment_mix.variants = {"staged": 0, "gather": 0}
