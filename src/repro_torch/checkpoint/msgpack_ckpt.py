"""msgpack checkpoints in the JAX package's file format, streamed a leaf at
a time, with the port's own codec.

The file is the reference's (``repro/checkpoint/msgpack_ckpt.py``): one
msgpack map ::

    {b"step": int, b"treedef": bytes,
     b"leaves": [{b"dtype": bytes, b"shape": [int, ...], b"data": bytes},
                 ...]}

keys and byte strings as msgpack ``bin``, each leaf's ``data`` its C-order
bytes, ``dtype`` its numpy name (``bfloat16`` by name; a legacy ``'<V2'``
reads as bfloat16).  Neither loader reads ``treedef``: the reference
writes jax's ``str(treedef)``, the port a description of its own.

The card's machine has neither ``msgpack`` nor ``ml_dtypes``, so this
module encodes and decodes the subset of msgpack the format uses (maps,
arrays, bin, str, ints, nil, bools; floats on read) itself, and moves
bfloat16 as its raw 2-byte pattern.  And where the reference builds the
whole payload in host memory (22.3 GB for qwen1.5-0.5b's MC-DSGT state on
4 nodes), the port streams it: :func:`save_checkpoint` writes one leaf at a
time (device to host, header, bytes) to ``path + ".tmp"`` and renames it
over ``path`` when done; :func:`load_checkpoint` reads one leaf at a time
straight into the caller's tensors.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, NamedTuple, Optional, Sequence

import numpy as np
import torch

# numpy names (the file's) <-> torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


class ZeroLeaf(NamedTuple):
    """A leaf of zeros that the port does not store: the reference's zero
    h and g_prev trees of a rule without a tracker.  Saved as zero bytes;
    as a :func:`load_checkpoint` target, the file's leaf must be zeros."""

    shape: tuple
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# The msgpack subset
# ---------------------------------------------------------------------------

def _sized(n: int, fix: Optional[tuple], codes: tuple) -> bytes:
    """A length header: the fix form ``(base, max)`` when n fits, else the
    first of (code8, code16, code32) whose width holds n."""
    if fix is not None and n <= fix[1]:
        return bytes((fix[0] | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack length {n} exceeds 2^32 - 1")


def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if v <= top:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if v >= low:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"int {v} does not fit msgpack's 64 bits")


def _bin_header(n: int) -> bytes:
    return _sized(n, None, (0xC4, 0xC5, 0xC6))


def _array_header(n: int) -> bytes:
    return _sized(n, (0x90, 15), (None, 0xDC, 0xDD))


def _map_header(n: int) -> bytes:
    return _sized(n, (0x80, 15), (None, 0xDE, 0xDF))


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` (default options) for the format's types:
    dict, list/tuple, bytes, str, int, bool, None."""
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        return _bin_header(len(data)) + data
    if isinstance(obj, str):
        data = obj.encode()
        return _sized(len(data), (0xA0, 31), (0xD9, 0xDA, 0xDB)) + data
    if isinstance(obj, (list, tuple)):
        return _array_header(len(obj)) + b"".join(packb(v) for v in obj)
    if isinstance(obj, dict):
        return _map_header(len(obj)) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"cannot msgpack {type(obj).__name__}")


class _Reader:
    """Exact reads from a binary file."""

    def __init__(self, f):
        self.f = f

    def take(self, n: int) -> bytes:
        data = self.f.read(n)
        if len(data) != n:
            raise ValueError("checkpoint file ends inside a msgpack value")
        return data

    def into(self, view) -> None:
        mv = memoryview(view).cast("B")
        got = 0
        while got < len(mv):
            k = self.f.readinto(mv[got:])
            if not k:
                raise ValueError("checkpoint file ends inside a leaf's data")
            got += k

    def unpack(self, bin_sink=None):
        """One msgpack value.  ``bin_sink(n)``, when given, is called with
        the length of the value if it is a bin, and reads its bytes."""
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            n = self._len(b - 0xC4)
            return bin_sink(n) if bin_sink is not None else self.take(n)
        if b in (0xCA, 0xCB):
            return struct.unpack(">f" if b == 0xCA else ">d",
                                 self.take(4 if b == 0xCA else 8))[0]
        if 0xCC <= b <= 0xD3:
            fmt = ">BHIQbhiq"[1 + b - 0xCC]
            return struct.unpack(">" + fmt, self.take(struct.calcsize(
                ">" + fmt)))[0]
        if b in (0xD9, 0xDA, 0xDB):
            return self.take(self._len(b - 0xD9)).decode()
        if b in (0xDC, 0xDD):
            return [self.unpack() for _ in range(self._len(b - 0xDB))]
        if b in (0xDE, 0xDF):
            return self._map(self._len(b - 0xDD))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in the "
                         "checkpoint format")

    def _len(self, width: int) -> int:
        fmt = (">B", ">H", ">I")[width]
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out

    def header(self, codes: tuple, fix: int, fix_mask: int) -> int:
        """The length of a map or array header (fix form or 16/32-bit)."""
        b = self.take(1)[0]
        if b & ~fix_mask & 0xFF == fix:
            return b & fix_mask
        if b in codes:
            return self._len(1 + codes.index(b))
        raise ValueError(f"checkpoint: expected a msgpack map or array, "
                         f"found type byte 0x{b:02x}")


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` (default options) for the format's
    types."""
    import io
    return _Reader(io.BytesIO(data)).unpack()


# ---------------------------------------------------------------------------
# Leaves
# ---------------------------------------------------------------------------

def dtype_from_name(name: str) -> torch.dtype:
    """A saved dtype name (or numpy dtype string) as a torch dtype; a 2-byte
    void (``'<V2'``, the reference's legacy bfloat16) is bfloat16."""
    if name in _DTYPES:
        return _DTYPES[name]
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"unknown checkpoint dtype {name!r}") from None
    if dt.kind == "V":
        if dt.itemsize == 2:
            return torch.bfloat16
        raise ValueError(f"unresolvable void dtype {name!r} in checkpoint")
    if dt.name not in _DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype here")
    return _DTYPES[dt.name]


class _Staging:
    """One host byte buffer, grown to the largest leaf, through which every
    leaf crosses between the device and the file."""

    def __init__(self):
        self.buf = torch.empty(0, dtype=torch.uint8)

    def view(self, nbytes: int, dtype: torch.dtype, shape) -> torch.Tensor:
        if self.buf.numel() < nbytes:
            self.buf = torch.empty(nbytes, dtype=torch.uint8)
        return self.buf[:nbytes].view(dtype).view(tuple(shape))

    def raw(self, nbytes: int) -> np.ndarray:
        return self.buf[:nbytes].numpy()


def _nbytes(shape, dtype: torch.dtype) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n * torch.empty((), dtype=dtype).element_size()


def save_checkpoint(path: str, leaves: Iterable, step: int = 0,
                    treedef: str = "repro_torch leaves") -> None:
    """Write ``leaves`` (torch tensors on any device, of any strides;
    numpy arrays; :class:`ZeroLeaf`) as a checkpoint at ``step``, one leaf
    at a time through one host buffer, to ``path + ".tmp"``, then rename it
    over ``path``."""
    leaves = list(leaves)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    stage = _Staging()
    with open(tmp, "wb") as f:
        f.write(_map_header(3) + packb(b"step") + _int(int(step))
                + packb(b"treedef") + packb(treedef.encode())
                + packb(b"leaves") + _array_header(len(leaves)))
        for leaf in leaves:
            if isinstance(leaf, np.ndarray):
                leaf = torch.from_numpy(np.ascontiguousarray(leaf))
            shape = tuple(int(s) for s in leaf.shape)
            nbytes = _nbytes(shape, leaf.dtype)
            f.write(_map_header(3) + packb(b"dtype")
                    + packb(_NAMES[leaf.dtype].encode()) + packb(b"shape")
                    + packb(list(shape)) + packb(b"data")
                    + _bin_header(nbytes))
            if isinstance(leaf, ZeroLeaf):
                _write_zeros(f, nbytes)
                continue
            stage.view(nbytes, leaf.dtype, shape).copy_(leaf)
            f.write(stage.raw(nbytes))
    os.replace(tmp, path)


def _write_zeros(f, nbytes: int, chunk: int = 1 << 26) -> None:
    zeros = bytes(min(chunk, nbytes))
    while nbytes:
        k = min(len(zeros), nbytes)
        f.write(zeros[:k])
        nbytes -= k


def _read_leaf(r: _Reader, stage: _Staging, target):
    """One leaf map; its data lands in ``target`` (a tensor, written in
    place in its own dtype; a :class:`ZeroLeaf`, which the data must be;
    or None, for a new host tensor).  Returns the filled target."""
    meta = {}
    for _ in range(r.header((0xDE, 0xDF), 0x80, 0x0F)):
        key = r.unpack()
        if key != b"data":
            meta[key] = r.unpack()
            continue
        if b"dtype" not in meta or b"shape" not in meta:
            raise ValueError("checkpoint leaf: data before its dtype/shape")
        dtype = dtype_from_name(meta[b"dtype"].decode())
        shape = tuple(meta[b"shape"])

        def sink(n, dtype=dtype, shape=shape):
            if n != _nbytes(shape, dtype):
                raise ValueError(f"checkpoint leaf of {shape} {dtype}: "
                                 f"{n} data bytes")
            if target is not None and tuple(target.shape) != shape:
                raise ValueError(f"checkpoint leaf shape {shape} != the "
                                 f"state's {tuple(target.shape)}")
            if target is None:
                out = torch.empty(shape, dtype=dtype)
                r.into(out.reshape(-1).view(torch.uint8).numpy())
                return out
            if isinstance(target, ZeroLeaf):
                _expect_zeros(r, n)
                return target
            host = stage.view(n, dtype, shape)
            r.into(stage.raw(n))
            target.copy_(host)
            return target

        meta[key] = r.unpack(bin_sink=sink)
    return meta[b"data"]


def _expect_zeros(r: _Reader, nbytes: int, chunk: int = 1 << 26) -> None:
    while nbytes:
        k = min(chunk, nbytes)
        if any(r.take(k)):
            raise ValueError("checkpoint: a leaf the state keeps as zeros "
                             "(a rule without a tracker) is not zero")
        nbytes -= k


def _read(path: str, like: Optional[Sequence]):
    stage = _Staging()
    with open(path, "rb") as f:
        r = _Reader(f)
        top = {}
        for _ in range(r.header((0xDE, 0xDF), 0x80, 0x0F)):
            key = r.unpack()
            if key != b"leaves":
                top[key] = r.unpack()
                continue
            n = r.header((0xDC, 0xDD), 0x90, 0x0F)
            if like is not None and n != len(like):
                raise ValueError(f"checkpoint holds {n} leaves, the state "
                                 f"{len(like)}")
            top[key] = [_read_leaf(r, stage, None if like is None
                                   else like[i]) for i in range(n)]
    return top[b"leaves"], int(top[b"step"]), top.get(b"treedef", b"")


def load_checkpoint(path: str, like: Sequence):
    """Restore a checkpoint into ``like``, one target per leaf in file
    order: a tensor (on any device; the leaf is copied into it in place,
    cast to its dtype), a :class:`ZeroLeaf` (the leaf must be zeros), or
    None (a new host tensor).  Returns (the filled targets, step)."""
    leaves, step, _ = _read(path, like)
    return leaves, step


def read_checkpoint(path: str):
    """Every leaf of a checkpoint as a host tensor: (leaves, step,
    treedef bytes)."""
    return _read(path, None)
