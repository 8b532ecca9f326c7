"""The work of each Hopper kernel, from its shapes and dtypes.

One function per kernel maps the launch's shapes to :class:`Work`: the
operations it must do and the bytes it must move, each input read once and
each output written once, whatever the kernel reads again.  These are the
counts every kernel's bound divides by the card's peaks
(:func:`bound_ms`: ``chip_smoke.py``'s "bound ms" column) and the counts
the dry run (:mod:`repro_torch.launch.dryrun`) adds for each kernel call
it traces, since ``FlopCounterMode`` sees no kernel.

A wrapper given ``meta`` tensors runs its checks, allocates what its launch
allocates, launches nothing and reports its :class:`Work` to every open
:class:`Recorder` through :func:`charge`; nothing on the card reaches that
route.  Where the work depends on the data, the count is what the kernel
needs for a full input: every decode cache slot valid, every sparse row
distinct.

The card's peaks live here too, since every bound divides by them: those
of the H100 SXM5 80GB HBM3 at its full 700 W power limit (NVIDIA's data
sheet, dense rates): bf16 on the tensor cores, f32 outside them (the port
runs f32 matrix products with TF32 off, as the reference's numerics need),
HBM bandwidth and capacity.  :mod:`repro_torch.launch.mesh` re-exports
them under the reference's names.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS_BF16 = 989e12      # FLOP/s, tensor cores, dense
PEAK_FLOPS_F32 = 67e12        # FLOP/s, FMAs outside the tensor cores
HBM_BW = 3.35e12              # bytes/s
HBM_BYTES = 80e9              # bytes
SMS = 132                     # streaming multiprocessors

# the peak each dtype's operations run at (f32 without TF32)
PEAK_FLOPS = {"float32": PEAK_FLOPS_F32, "bfloat16": PEAK_FLOPS_BF16}


class Work(NamedTuple):
    flops: int
    bytes: int
    dtype: str     # the peak the operations run at (PEAK_FLOPS' keys)


def gossip_mix(n: int, D: int, R: int, x_bytes: int) -> Work:
    """ws (R, n, n) f32 read once, x (n, D) read and out written once; the
    R rounds collapsed into one n x n matrix, 2(R-1)n^3 operations, then
    2n^2 D for its product with x, in f32 FMAs whatever x's dtype."""
    return Work(2 * n * n * D + 2 * (R - 1) * n ** 3,
                R * n * n * 4 + 2 * n * D * x_bytes, "float32")


def quantized_gossip_mix(n: int, D: int, R: int, x_bytes: int,
                         res_bytes: int) -> Work:
    """x and res (n, D) each read once and written once in their dtypes, W
    once; per column and round 2n^2 operations of mixing and ~8n of
    quantization (add, abs, reduce, divide, round, clip, multiply,
    subtract), in f32."""
    return Work(2 * R * n * n * D + 8 * R * n * D,
                R * n * n * 4 + 2 * n * D * (x_bytes + res_bytes), "float32")


def sparse_segment_mix(U: int, S: int, E: int, D: int, x_bytes: int) -> Work:
    """One round's data: the U distinct rows of x read, delta (S, D) f32
    written, the edge arrays (two 8-byte ids and a 4-byte weight an edge)
    and the S + 1 offsets; 3·E·D operations (a difference, a multiply, an
    add an edge and column) in f32."""
    return Work(3 * E * D, U * D * x_bytes + S * D * 4 + E * (8 + 8 + 4)
                + (S + 1) * 8, "float32")


def linear_recurrence(B: int, S: int, C: int, in_bytes: int) -> Work:
    """a and b (B, S, C) read once, h_all (B, S, C) and h_last (B, C)
    written once in f32; a multiply and an add an element, in f32."""
    return Work(2 * B * S * C,
                B * S * C * (2 * in_bytes + 4) + B * C * 4, "float32")


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """Unmasked (query, key) pairs of one head: query i (of Sq) reads keys
    j (of Sk) with j <= i when ``causal`` and j > i - ``window`` when a
    window is set."""
    def tri(m):  # 1 + 2 + ... + m
        return m * (m + 1) // 2 if m > 0 else 0

    if not causal:
        hi = Sq * Sk
    else:
        m = min(Sq, Sk)
        hi = tri(m) + (Sq - m) * Sk
    if not window:
        return hi
    if causal and Sq > Sk + window:
        raise ValueError(f"Sq={Sq} past Sk + window={Sk + window}: rows "
                         "with no key are not counted here")
    # keys j <= i - window are masked: row i loses i - window + 1 of them
    return hi - tri(Sq - window)


def flash_attention(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int,
                    elem: int, dtype: str, causal: bool = True,
                    window: int = 0) -> Work:
    """q read and o written once (B, Sq, H, hd), k and v read once (B, Sk,
    KV, hd); two products of 2·hd operations for every unmasked (query,
    key) pair and head, at ``dtype``'s rate (bf16 on the tensor cores)."""
    return Work(4 * B * H * hd * attention_pairs(Sq, Sk, causal, window),
                2 * B * (Sq * H + Sk * KV) * hd * elem, dtype)


def decode_attention(B: int, C: int, J: int, G: int, hd: int, elem: int,
                     dtype: str) -> Work:
    """Every cache slot valid: k and v (B, C, J, hd) read once, q read and
    o written once (B, J·G, hd), kpos (C,) int32 read; 4·G·hd operations a
    slot and KV head, at ``dtype``'s rate."""
    return Work(4 * B * J * G * C * hd,
                2 * B * C * J * hd * elem + 2 * B * J * G * hd * elem
                + C * 4, dtype)


def bound_ms(work: Work) -> tuple:
    """(the least ms the H100 takes for ``work``, "bytes" or "operations":
    which of bytes over HBM bandwidth and operations over the dtype's peak
    is the larger)."""
    t_bytes = work.bytes / HBM_BW
    t_ops = work.flops / PEAK_FLOPS[work.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def dtype_name(dtype) -> str:
    """A torch dtype's name as :data:`PEAK_FLOPS` keys it."""
    return str(dtype).rsplit(".", 1)[-1]


class Recorder:
    """Every kernel call a meta-route wrapper charges while the recorder is
    open, as (name, :class:`Work`) in call order.  Opened by the dry run;
    recorders nest, and each open one sees every charge."""

    _open: list = []

    def __init__(self):
        self.calls = []

    def __enter__(self) -> "Recorder":
        Recorder._open.append(self)
        return self

    def __exit__(self, *exc) -> None:
        Recorder._open.remove(self)

    def charge(self, name: str, work: Work) -> None:
        self.calls.append((name, work))


def charge(name: str, work: Work) -> None:
    """Report a meta-route call of kernel ``name`` to the open recorders."""
    for rec in Recorder._open:
        rec.charge(name, work)
