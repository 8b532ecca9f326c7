"""Counter-based random streams for edge-list scenario code.

The dense channel/fault models draw from ``np.random.SeedSequence((seed,
TAG, t))`` generator streams, which is pure in ``(seed, t)`` but only
*sequentially* accessible: materializing a draw for one link requires
drawing the whole (n, n) matrix.  The sparse scenario engine operates on
edge lists where n can be 10^5-10^6 and only O(edges) work is allowed per
round, so it needs *random access*: "the uniform for link (i, j) at round
t" as a pure function of ``(seed, tag, t, i, j)`` with no per-round state.

This module provides that: a vectorized splitmix64-style counter hash
mapping integer key tuples to iid U[0,1) / N(0,1) draws.  Streams here are
equal *in distribution* to the dense generator streams but NOT bitwise
equal to them — each edge-level model method documents that it is a
distinct stream keyed by a distinct tag.
"""

from __future__ import annotations

import numpy as np

_MASK = np.uint64(0xFFFFFFFFFFFFFFFF)
_GOLDEN = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)
_INV_2_53 = 1.0 / float(1 << 53)


def _splitmix(z: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer, vectorized over uint64 arrays."""
    z = (z ^ (z >> np.uint64(30))) * _MIX1
    z = (z ^ (z >> np.uint64(27))) * _MIX2
    return z ^ (z >> np.uint64(31))


def counter_hash(seed: int, tag: int, *keys) -> np.ndarray:
    """Hash ``(seed, tag, *keys)`` to uint64; keys broadcast as arrays."""
    with np.errstate(over="ignore"):
        h = _splitmix(np.uint64(int(seed) & 0xFFFFFFFFFFFFFFFF)
                      ^ (np.uint64(int(tag)) * _GOLDEN))
        for k in keys:
            k64 = np.asarray(k).astype(np.uint64)
            h = _splitmix(h ^ (k64 * _GOLDEN + _MIX1))
    return h


def counter_uniform(seed: int, tag: int, *keys) -> np.ndarray:
    """iid U[0, 1) draws, one per broadcast element of ``keys``."""
    return (counter_hash(seed, tag, *keys) >> np.uint64(11)).astype(
        np.float64) * _INV_2_53


def counter_normal(seed: int, tag: int, *keys) -> np.ndarray:
    """iid N(0, 1) via Box-Muller on two sub-streams of the same keys."""
    u1 = counter_uniform(seed, tag, *keys, 0)
    u2 = counter_uniform(seed, tag, *keys, 1)
    u1 = np.maximum(u1, 1e-300)  # log(0) guard; probability ~2^-53
    return np.sqrt(-2.0 * np.log(u1)) * np.cos(2.0 * np.pi * u2)


def edge_canonical(src, dst):
    """Canonical (lo, hi) endpoint order so undirected-link draws are
    symmetric: both directed entries of an edge hash to the same keys."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    return np.minimum(src, dst), np.maximum(src, dst)
