"""The yardstick: the H100's peaks and the work of each measured kernel.

Frozen copies of the program's ``kernels/cost.py`` counts for the gossip
kernels and of its peaks (the H100 SXM5 80GB HBM3 at its 700 W limit,
NVIDIA's data sheet, dense rates), so that a change to the program's copy
moves no benchmark number.  A kernel's work is counted from its shapes and
dtypes: each input byte read once and each output byte written once,
whatever the kernel reads again, and the operations the algorithm needs,
whatever implements it.  Its least time is the larger of operations over
the dtype's peak and bytes over HBM bandwidth.
"""

from __future__ import annotations

from typing import NamedTuple

PEAK_FLOPS = {"float32": 67e12,     # FLOP/s, FMAs outside the tensor cores
              "bfloat16": 989e12}   # FLOP/s, tensor cores
HBM_BW = 3.35e12                    # bytes/s
HBM_BYTES = 80e9


class Work(NamedTuple):
    flops: int
    bytes: int
    dtype: str


def gossip_mix(n: int, D: int, R: int, x_bytes: int) -> Work:
    """R rounds of an (n, n) f32 window on an (n, D) state: the window read
    once, the rounds collapsed into one matrix (2(R−1)n³ operations), then
    2n²D for its product with the state, read once and written once."""
    return Work(2 * n * n * D + 2 * (R - 1) * n ** 3,
                R * n * n * 4 + 2 * n * D * x_bytes, "float32")


def quantized_gossip_mix(n: int, D: int, R: int, x_bytes: int,
                         res_bytes: int) -> Work:
    """R compressed rounds: the state and its residual each read once and
    written once, the window once; per column and round 2n² operations of
    mixing and 8n of quantization (add, abs, reduce, divide, round, clip,
    multiply, subtract), in f32."""
    return Work(2 * R * n * n * D + 8 * R * n * D,
                R * n * n * 4 + 2 * n * D * (x_bytes + res_bytes), "float32")


def least_seconds(work: Work) -> float:
    return max(work.flops / PEAK_FLOPS[work.dtype], work.bytes / HBM_BW)
