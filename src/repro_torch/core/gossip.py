"""Gossip weight matrices and multi-consensus (paper §2 Assumption 3, Alg. 2).

Weight-matrix schedules are host-side numpy objects (tiny, n <= 64); the
values are fed into jitted distributed steps as regular array arguments so a
single compiled step serves the whole time-varying schedule.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import numpy as np

from . import topology as topo

WeightMatrix = np.ndarray  # (n, n) float64
MatrixSchedule = Callable[[int], WeightMatrix]


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def graph_laplacian(adj: topo.Adjacency) -> np.ndarray:
    a = adj.copy().astype(float)
    np.fill_diagonal(a, 0.0)
    deg = a.sum(axis=1)
    return np.diag(deg) - a


def laplacian_weights(adj: topo.Adjacency, delta_over_n: float) -> WeightMatrix:
    """W = I - (delta/n) * L(G) — the Theorem 3 rule (with delta_over_n =
    delta/n) and, with delta_over_n = 1/d_max, the classic Laplacian rule of
    Remark 5."""
    n = adj.shape[0]
    return np.eye(n) - delta_over_n * graph_laplacian(adj)


def laplacian_rule(adj: topo.Adjacency) -> WeightMatrix:
    """W = I - L / d_max (Remark 5)."""
    L = graph_laplacian(adj)
    dmax = float(np.max(np.diag(L)))
    if dmax == 0:
        return np.eye(adj.shape[0])
    return np.eye(adj.shape[0]) - L / dmax


def metropolis_weights(adj: topo.Adjacency) -> WeightMatrix:
    """Metropolis-Hastings doubly-stochastic weights for an undirected graph."""
    n = adj.shape[0]
    a = adj.copy()
    np.fill_diagonal(a, False)
    deg = a.sum(axis=1)
    W = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            if a[i, j]:
                W[i, j] = 1.0 / (1.0 + max(deg[i], deg[j]))
        W[i, i] = 1.0 - W[i].sum()
    return W


def mixing_beta(W: WeightMatrix) -> float:
    """beta = ||W - (1/n) 11^T||_2 (Assumption 3.3)."""
    n = W.shape[0]
    return float(np.linalg.norm(W - np.ones((n, n)) / n, ord=2))


def check_assumption3(W: WeightMatrix, adj: topo.Adjacency | None = None,
                      beta: float | None = None, atol: float = 1e-9) -> None:
    """Raise AssertionError unless W satisfies Assumption 3 (sparsity pattern,
    double stochasticity, spectral bound)."""
    n = W.shape[0]
    ones = np.ones(n)
    if adj is not None:
        off = ~adj & ~np.eye(n, dtype=bool)
        assert np.allclose(W[off], 0.0, atol=atol), "W has weight on inactive links"
    assert np.allclose(W @ ones, ones, atol=atol), "W 1 != 1 (row sums)"
    assert np.allclose(ones @ W, ones, atol=atol), "1^T W != 1^T (col sums)"
    b = mixing_beta(W)
    if beta is not None:
        assert b <= beta + 1e-7, f"beta(W)={b} exceeds required {beta}"
    assert b <= 1.0 + 1e-9, f"beta(W)={b} > 1"


# ---------------------------------------------------------------------------
# GossipPlan: per-round structured lowerings (the planning layer)
# ---------------------------------------------------------------------------

# Threshold policy for the automatic sparse lowering (``sparse="auto"``):
# a round that no structured lowering accepts is kept as an edge list
# instead of a dense matrix when the network is large AND the round is
# actually sparse.  Below the node floor the dense einsum is cheap and the
# historical lowering stays bit-exact; above it, a low-density round costs
# O(edges) instead of O(n^2) per mix (see README "Sparse plans & client
# sampling").
SPARSE_MIN_NODES = 128
SPARSE_MAX_DENSITY = 0.25


@dataclasses.dataclass(frozen=True)
class GossipRound:
    """One round of a :class:`GossipPlan`: the dense matrix plus, when the
    round is structured, the parameters of its cheap lowering.

    kind → lowering (see :mod:`repro.core.algorithms`):

    * ``empty``     — z = x (no-op; ``perm`` = identity, ``w_peer`` = 0);
    * ``matching``  — :func:`one_peer_mix`: z_i = (1-w_i) x_i + w_i x_{perm(i)};
    * ``sun``       — :func:`sun_mix` with W = I - (delta/n) L(S_{n,C});
    * ``complete``  — :func:`complete_mix`: z = (1-a) x + a x̄;
    * ``two_level`` — :func:`two_level_mix`: W = B ⊗ J_p factors into an
      intra-pod average (p nodes/pod, one allreduce per pod) composed with
      the (m, m) inter-pod exchange ``pod_B`` on pod means;
    * ``sparse``    — :func:`repro.core.algorithms.sparse_mix`: COO edge
      scatter in Laplacian form, z = x + Σ_e w_e (x_src - x_dst) → dst
      (diagonal implied by row-stochasticity; see :mod:`repro.sparse.plan`);
    * ``personalized`` — per-node weight rows staged as-is: the round's
      base support/weights, row-stochastic only (NOT Assumption 3), whose
      rows the personalized engine reweights in-jit by loss-proximity
      similarity (:func:`repro.core.engine.personalized_weights`) before
      mixing.  Kept first-class so non-uniform, data-dependent weights are
      a real plan path instead of a silent dense fallback;
    * ``dense``     — generic mix(W, ·) einsum.  A dense round that only
      got here because every cheaper lowering was rejected carries
      ``fallback_reason`` naming why (surfaced per window as the
      ``dense_fallback`` count in :mod:`repro.sim.telemetry`).
    """

    kind: str
    W: np.ndarray                              # (n, n) dense reference
    center_mask: np.ndarray | None = None      # (n,) float32, sun
    delta: float | None = None                 # sun: W = I - (delta/n) L
    perm: np.ndarray | None = None             # (n,) int32, matching/empty
    w_peer: np.ndarray | None = None           # (n,) float32, matching/empty
    avg_weight: float | None = None            # complete: z = (1-a) x + a x̄
    pod_B: np.ndarray | None = None            # (m, m) inter-pod, two_level
    pods: int | None = None                    # p = nodes per pod, two_level
    edge_src: np.ndarray | None = None         # (E,) int32, sparse
    edge_dst: np.ndarray | None = None         # (E,) int32, sparse
    edge_w: np.ndarray | None = None           # (E,) float64, sparse
    fallback_reason: str | None = None         # dense: why lowerings skipped

    @property
    def n(self) -> int:
        return self.W.shape[0]

    def as_dense(self) -> np.ndarray:
        """Reconstruct the dense matrix implied by the structured lowering
        (== ``W`` for a valid plan; the planner asserts this)."""
        n = self.n
        if self.kind == "empty":
            return np.eye(n)
        if self.kind == "complete":
            a = self.avg_weight
            return (1.0 - a) * np.eye(n) + a * np.ones((n, n)) / n
        if self.kind == "matching":
            W = np.diag(1.0 - self.w_peer.astype(np.float64))
            W[np.arange(n), self.perm] += self.w_peer
            return W
        if self.kind == "sun":
            adj = topo.sun_shaped_graph(n, np.flatnonzero(self.center_mask))
            return laplacian_weights(adj, self.delta / n)
        if self.kind == "two_level":
            p = self.pods
            return np.kron(np.asarray(self.pod_B, np.float64),
                           np.ones((p, p)) / p)
        if self.kind == "sparse":
            W = np.zeros((n, n))
            W[self.edge_dst, self.edge_src] = self.edge_w
            rowsum = np.bincount(self.edge_dst, weights=self.edge_w,
                                 minlength=n)
            W[np.arange(n), np.arange(n)] = 1.0 - rowsum
            return W
        return np.asarray(self.W, np.float64)


def plan_round(W: WeightMatrix,
               structure: "topo.RoundStructure | None" = None,
               atol: float = 1e-9, pods: int | None = None,
               sparse: "bool | str" = "auto",
               personalized: bool = False) -> GossipRound:
    """Lower one weight matrix to its cheapest structured form.

    ``structure`` is the topology-level tag when the schedule declares one;
    otherwise the sparsity pattern of ``W`` is classified.  The structured
    parameters are extracted from ``W`` and accepted only if they reproduce
    ``W`` exactly (within ``atol``); any mismatch — e.g. non-uniform weights
    on a sun graph — falls back to the always-correct dense lowering.

    ``pods`` (p nodes per pod, pod-major order — the ``pod|data|model``
    mesh layout) enables the hierarchical fallback: a round none of the
    flat lowerings accept is tested for the two-level factorization
    W = B ⊗ J_p and, when it factors exactly across pod boundaries,
    lowered to ``two_level`` instead of dense.

    ``sparse`` controls the edge-list fallback for rounds no structured
    (or hierarchical) lowering accepts: ``"auto"`` (default) keeps such a
    round as COO edges instead of a dense matrix when
    ``n >= SPARSE_MIN_NODES`` and its off-diagonal density is at most
    ``SPARSE_MAX_DENSITY`` — below the threshold the historical dense
    lowering is bit-exact-preserved; ``True``/``False`` force/disable the
    sparse path regardless of size (tests use ``True`` for small-n
    equivalence).

    ``personalized`` marks the round as the base support of a personalized
    (loss-proximity reweighted) rule: the row-stochastic ``W`` is staged
    as-is under ``kind="personalized"`` — its n per-node weight rows are
    the similarity prior the engine renormalizes in-jit — instead of being
    classified.  This is never a dense fallback: the weights are
    data-dependent at run time, so no static structured lowering can
    reproduce the realized mix.
    """
    W = np.asarray(W, np.float64)
    n = W.shape[0]
    if personalized:
        assert np.allclose(W.sum(axis=1), 1.0, atol=1e-6), \
            "personalized base weights must be row-stochastic"
        return GossipRound("personalized", W)
    if n == 1:  # single node: any valid W is [[1]] — no communication
        rd = GossipRound("empty", W, perm=np.zeros(1, np.int32),
                         w_peer=np.zeros(1, np.float32))
        return rd if np.allclose(W, 1.0) else GossipRound(
            "dense", W, fallback_reason="single-node matrix is not [[1]]")
    if structure is None or structure.kind == "dense":
        adj = np.abs(W) > atol
        np.fill_diagonal(adj, True)
        structure = topo.classify_adjacency(adj)
    eye = np.eye(n)

    def _accept(rd: GossipRound) -> GossipRound | None:
        return rd if np.allclose(rd.as_dense(), W, atol=1e-8) else None

    rd = None
    if structure.kind == "empty":
        rd = _accept(GossipRound(
            "empty", W, perm=np.arange(n, dtype=np.int32),
            w_peer=np.zeros(n, np.float32)))
    elif structure.kind == "complete":
        a = float(W[~eye.astype(bool)].mean() * n)
        rd = _accept(GossipRound("complete", W, avg_weight=a))
    elif structure.kind == "matching":
        perm = np.asarray(structure.perm, np.int32)
        idx = np.arange(n)
        # fixed points (unmatched nodes of a partial matching) exchange
        # nothing: their peer weight is 0, not the diagonal entry
        w = np.where(perm == idx, 0.0, W[idx, perm]).astype(np.float32)
        rd = _accept(GossipRound("matching", W, perm=perm, w_peer=w))
    elif structure.kind == "sun":
        center = np.asarray(structure.center, int)
        mask = np.zeros(n, np.float32)
        mask[center] = 1.0
        rim = np.setdiff1d(np.arange(n), center)
        probe = rim[0] if rim.size else 1  # any edge weight; all must agree
        delta = float(W[probe, center[0]] * n)
        rd = _accept(GossipRound("sun", W, center_mask=mask, delta=delta))
    if rd is None and pods is not None and 1 < pods < n and n % pods == 0:
        # hierarchical fallback: does the round factor as B ⊗ J_p?  Each
        # p×p block of W must be constant (= B[I,J]/p); the block means
        # give the candidate B and _accept checks the exact kron.
        B = W.reshape(n // pods, pods, n // pods, pods).mean(axis=(1, 3)) * pods
        rd = _accept(GossipRound("two_level", W, pod_B=B, pods=pods))
    if rd is None and sparse is not False:
        off = np.abs(W) > atol
        np.fill_diagonal(off, False)
        nnz = int(off.sum())
        density = nnz / max(1, n * (n - 1))
        if sparse is True or (n >= SPARSE_MIN_NODES
                              and density <= SPARSE_MAX_DENSITY):
            dst, src = np.nonzero(off)
            rd = _accept(GossipRound(
                "sparse", W, edge_src=src.astype(np.int32),
                edge_dst=dst.astype(np.int32), edge_w=W[dst, src]))
    if rd is not None:
        return rd
    # Every cheaper lowering was rejected: fall back to the dense einsum,
    # but say why — callers surface this per window (sim.telemetry's
    # dense_fallback count) instead of silently paying O(n^2) per mix.
    rows_ok = np.allclose(W.sum(axis=1), 1.0, atol=1e-6)
    cols_ok = np.allclose(W.sum(axis=0), 1.0, atol=1e-6)
    if rows_ok and not cols_ok:
        reason = ("row-stochastic-only weights (outside Assumption 3); "
                  "plan with personalized=True to stage per-node rows")
    elif structure.kind in ("empty", "complete", "matching", "sun"):
        reason = f"non-uniform weights on {structure.kind} support"
    elif n < SPARSE_MIN_NODES:
        reason = (f"unstructured round below the sparse floor "
                  f"(n={n} < {SPARSE_MIN_NODES})")
    else:
        reason = "unstructured round too dense for the edge-list lowering"
    return GossipRound("dense", W, fallback_reason=reason)


@dataclasses.dataclass(frozen=True)
class GossipPlan:
    """A window of structured gossip rounds, device-stageable in one shot.

    ``tensors()`` packs every round's lowering parameters into dense
    ``(period, ...)`` arrays; drivers upload them **once** and the jitted
    step indexes them by ``t % period`` (see
    :func:`repro.core.algorithms.make_plan_mixer`) — no per-step host
    re-stacking or transfer."""

    rounds: tuple  # tuple[GossipRound]

    @property
    def period(self) -> int:
        return len(self.rounds)

    @property
    def n(self) -> int:
        return self.rounds[0].n

    @property
    def kinds(self) -> tuple:
        return tuple(r.kind for r in self.rounds)

    @property
    def pods(self) -> int | None:
        """Pod size p shared by the plan's ``two_level`` rounds (None when
        the plan has none).  Mixed pod sizes in one plan are rejected —
        the mixer bakes p in statically."""
        ps = {r.pods for r in self.rounds if r.kind == "two_level"}
        if not ps:
            return None
        if len(ps) != 1:
            raise ValueError(f"two_level rounds disagree on pod size: {ps}")
        return ps.pop()

    @property
    def dispatch(self) -> str:
        """'dynamic' when one lowering serves every round (a single
        compilation with a traced round index), else 'static' (the step
        specializes per start phase; empty rounds then cost nothing)."""
        return "dynamic" if len(set(self.kinds)) == 1 else "static"

    def tensors(self) -> dict:
        """Device-stageable plan arrays, keyed by lowering family.  Rounds
        of other kinds hold identity defaults at their index (unused)."""
        P, n = self.period, self.n
        kinds = set(self.kinds)
        out = {}
        if "dense" in kinds:
            out["W"] = np.stack([r.W for r in self.rounds]).astype(np.float32)
        if "personalized" in kinds:
            # n per-node base weight rows per round, staged once; the engine
            # reweights + renormalizes the rows in-jit from this step's
            # per-node losses (engine.personalized_weights).
            out["pW"] = np.stack(
                [r.W if r.kind == "personalized" else np.eye(n)
                 for r in self.rounds]).astype(np.float32)
        if "sun" in kinds:
            out["center_mask"] = np.stack(
                [r.center_mask if r.kind == "sun" else np.zeros(n, np.float32)
                 for r in self.rounds])
            out["delta"] = np.asarray(
                [r.delta if r.kind == "sun" else 0.0 for r in self.rounds],
                np.float32)
        if kinds & {"matching", "empty"}:
            ident = np.arange(n, dtype=np.int32)
            out["perm"] = np.stack(
                [r.perm if r.perm is not None else ident
                 for r in self.rounds])
            out["w_peer"] = np.stack(
                [r.w_peer if r.w_peer is not None else np.zeros(n, np.float32)
                 for r in self.rounds])
        if "complete" in kinds:
            out["avg_w"] = np.asarray(
                [r.avg_weight if r.kind == "complete" else 0.0
                 for r in self.rounds], np.float32)
        if "two_level" in kinds:
            m = n // self.pods
            out["pod_B"] = np.stack(
                [r.pod_B if r.kind == "two_level" else np.eye(m)
                 for r in self.rounds]).astype(np.float32)
        if "sparse" in kinds:
            # per-round edge arrays padded to the widest round; pad edges
            # carry w = 0, so they contribute exactly nothing to the mix
            emax = max(1, max(r.edge_src.size for r in self.rounds
                              if r.kind == "sparse"))
            esrc = np.zeros((P, emax), np.int32)
            edst = np.zeros((P, emax), np.int32)
            ew = np.zeros((P, emax), np.float32)
            for i, r in enumerate(self.rounds):
                if r.kind == "sparse":
                    e = r.edge_src.size
                    esrc[i, :e] = r.edge_src
                    edst[i, :e] = r.edge_dst
                    ew[i, :e] = r.edge_w
            out.update(esrc=esrc, edst=edst, ew=ew)
        return out

    def validate(self) -> None:
        """Assert every structured lowering equals its dense matrix and is a
        valid gossip matrix (Assumption 3).  ``personalized`` rounds live
        outside Assumption 3 by design (row-stochastic only, column sums
        free) — they are checked for row-stochasticity instead."""
        for t, rd in enumerate(self.rounds):
            rec = rd.as_dense()
            assert np.allclose(rec, rd.W, atol=1e-8), \
                f"round {t}: {rd.kind} lowering != dense matrix"
            if rd.kind == "personalized":
                n = rd.n
                assert np.allclose(rec @ np.ones(n), np.ones(n), atol=1e-6), \
                    f"round {t}: personalized base weights not row-stochastic"
            else:
                check_assumption3(rec)


# ---------------------------------------------------------------------------
# Matrix schedules built from topology schedules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WeightSchedule:
    """A periodic sequence of weight matrices W^t, optionally annotated with
    the topology-level :class:`repro.core.topology.RoundStructure` of each
    round (attached by :func:`schedule_from_topology`; the planner falls
    back to sparsity classification when absent)."""

    matrices: tuple  # tuple[np.ndarray]
    structures: tuple | None = None  # tuple[RoundStructure] | None

    @property
    def n(self) -> int:
        return self.matrices[0].shape[0]

    @property
    def period(self) -> int:
        return len(self.matrices)

    @property
    def beta(self) -> float:
        return max(mixing_beta(W) for W in self.matrices)

    def __call__(self, t: int) -> WeightMatrix:
        return self.matrices[t % len(self.matrices)]

    def structure(self, t: int):
        if self.structures is None:
            return None
        return self.structures[t % len(self.structures)]

    def stacked(self, t0: int, rounds: int, dtype=np.float32) -> np.ndarray:
        """(rounds, n, n) array W^{t0}, ..., W^{t0+rounds-1} — the dense
        form of the schedule window."""
        return np.stack([self(t0 + r) for r in range(rounds)]).astype(dtype)

    def plan(self, t0: int = 0, rounds: int | None = None,
             validate: bool = True, pods: int | None = None,
             sparse: "bool | str" = "auto",
             personalized: bool = False) -> GossipPlan:
        """Lower rounds [t0, t0+rounds) (default: one full period) to a
        :class:`GossipPlan`; with ``validate`` each structured lowering is
        checked against its dense matrix via :func:`check_assumption3` and
        exact reconstruction.  ``pods`` enables the hierarchical two-level
        lowering for rounds that factor across pod boundaries, ``sparse``
        the edge-list fallback above the node/density threshold, and
        ``personalized`` stages every round's row-stochastic base weights
        as per-node rows for in-jit loss-proximity reweighting (see
        :func:`plan_round`)."""
        rounds = self.period if rounds is None else rounds
        plan = GossipPlan(tuple(
            plan_round(self(t0 + r), self.structure(t0 + r), pods=pods,
                       sparse=sparse, personalized=personalized)
            for r in range(rounds)))
        if validate:
            plan.validate()
        return plan


def schedule_from_topology(schedule, rule: str = "metropolis",
                           horizon: int | None = None) -> WeightSchedule:
    """Build a weight schedule from a topology schedule.

    Default rule is Metropolis-Hastings: unlike I - L/d_max it stays a
    strict average on degree-1 graphs (matchings), where the Laplacian rule
    degenerates to a pure swap with no contraction.

    Periodic schedules materialize one period; non-periodic ones (``period
    is None``, e.g. :func:`repro.core.topology.resampled_matching_schedule`)
    require ``horizon`` — the number of rounds the run will consume — and
    materialize exactly that window."""
    period = getattr(schedule, "period", 1)
    if period is None:
        if horizon is None:
            raise ValueError(
                "non-periodic topology schedule requires horizon=<rounds>")
        period = horizon
    mats, structs = [], []
    for t in range(period):
        adj = schedule(t)
        if rule == "laplacian_dmax":
            W = laplacian_rule(adj)
        elif rule == "metropolis":
            W = metropolis_weights(adj)
        else:
            raise ValueError(f"unknown rule {rule!r}")
        mats.append(W)
        structs.append(schedule.structure(t) if hasattr(schedule, "structure")
                       else topo.classify_adjacency(adj))
    return WeightSchedule(tuple(mats), tuple(structs))


def theorem3_weight_schedule(n: int, beta: float, avoid: Sequence[int] = ()) -> WeightSchedule:
    """The exact Theorem 3 matrices: W^t = I - (delta/n) L(S_{n,C^t}) with
    delta = n(1-beta)/ceil(n(1-beta)), giving ||W - 11^T/n||_2 = beta."""
    graphs = topo.sun_shaped_schedule(n, beta, avoid=avoid)
    k = int(math.ceil(n * (1.0 - beta)))
    if k >= n:
        W = beta * np.eye(n) + (1.0 - beta) * np.ones((n, n)) / n
        return WeightSchedule((W,), (topo.RoundStructure("complete"),))
    delta = n * (1.0 - beta) / k
    mats = tuple(
        laplacian_weights(graphs(t), delta / n) for t in range(graphs.period)
    )
    structs = tuple(graphs.structure(t) for t in range(graphs.period))
    return WeightSchedule(mats, structs)


# ---------------------------------------------------------------------------
# Multi-consensus (Algorithm 2) — host/matrix form
# ---------------------------------------------------------------------------

def multi_consensus(z: np.ndarray, schedule: MatrixSchedule, t1: int, t2: int) -> np.ndarray:
    """z^{(t2)} = W^{t2-1} ... W^{t1} z^{(t1)}  (Algorithm 2)."""
    out = z
    for t in range(t1, t2):
        out = schedule(t) @ out
    return out


def consensus_contraction(schedule: WeightSchedule, rounds: int) -> float:
    """||prod_{t<rounds} W^t - 11^T/n||_2 — should be <= beta^rounds (eq. 21)."""
    n = schedule.n
    P = np.eye(n)
    for t in range(rounds):
        P = schedule(t) @ P
    return float(np.linalg.norm(P - np.ones((n, n)) / n, ord=2))
