"""The gossip windows of a cell: the paper's Theorem 3 schedule in numpy.

A frozen copy of the program's ``core/gossip.theorem3_weight_schedule`` (with
no avoided nodes), kept here so that the benchmark's inputs do not move when
the program does.  At contraction β over n nodes, k = ⌈n(1 − β)⌉ centers a
round: round q's graph is the sun S_{n,C_q} on the centers C_q (the q-th run
of k nodes; ⌊n / k⌋ rounds a period), whose centers link to every node, and
its matrix is W_q = I − (δ/n) L(S_{n,C_q}) with δ = n(1 − β)/k, so that
‖W_q − 11ᵀ/n‖₂ = β.  With k ≥ n the one round is βI + (1 − β)11ᵀ/n.

The seed relabels the nodes (one permutation for the whole run), so each
seed has its own order of centers and every seed the same contraction.
"""

from __future__ import annotations

import math

import numpy as np


def laplacian(adj: np.ndarray) -> np.ndarray:
    a = adj.astype(float)
    np.fill_diagonal(a, 0.0)
    return np.diag(a.sum(axis=1)) - a


def theorem3(n: int, beta: float) -> np.ndarray:
    """(period, n, n) float64: one period of the schedule."""
    if not 0.0 <= beta <= 1.0 - 1.0 / n + 1e-12:
        raise ValueError(f"Theorem 3 needs beta in [0, 1 - 1/n], got {beta}")
    k = min(max(int(math.ceil(n * (1.0 - beta))), 1), n)
    if k >= n:
        return (beta * np.eye(n) + (1.0 - beta) / n)[None]
    delta = n * (1.0 - beta) / k
    mats = []
    for q in range(n // k):
        adj = np.zeros((n, n), dtype=bool)
        center = np.arange(q * k, (q + 1) * k)
        adj[center, :] = True
        adj[:, center] = True
        np.fill_diagonal(adj, True)
        mats.append(np.eye(n) - (delta / n) * laplacian(adj))
    return np.stack(mats)


def windows(n: int, beta: float, seed: int) -> np.ndarray:
    """(period, n, n) float32: the schedule with its nodes relabelled by the
    seed's permutation."""
    from .weights import generator_seed

    perm = np.random.default_rng(generator_seed(seed, "schedule")) \
        .permutation(n)
    mats = theorem3(n, beta)
    return mats[:, perm][:, :, perm].astype(np.float32)


def window_at(mats: np.ndarray, t: int, wps: int) -> np.ndarray:
    """The (wps, n, n) rounds a step starting at round t takes."""
    return mats[(t + np.arange(wps)) % mats.shape[0]]
