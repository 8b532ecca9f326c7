"""Edge-list gossip rounds and plans (the sparse scenario representation).

A gossip matrix under Assumption 3 is row-stochastic, so its diagonal is
redundant: storing only the off-diagonal entries as COO edges pins the
whole matrix.  We keep rounds in *Laplacian form*,

    W = I - diag(rowsum(w)) + scatter(w),      w[e] = W[dst[e], src[e]] > 0,

and mix as ``z = x + sum_e w[e] * (x[src[e]] - x[dst[e]]) -> dst[e]``.
This buys three O(edges) properties the dense (n, n) representation
cannot offer past a few hundred nodes:

* **realize** — a round is just its edge arrays; no n x n materialization;
* **repair**  — dropping an edge returns its weight to both endpoints'
  diagonals *by construction* (exactly the lazy repair of
  :func:`repro.sim.faults.repair_weights`), so fault realization is a
  boolean filter over edges;
* **classify** — empty/matching/sparse kinds fall out of degree counts.

Symmetric edge weights (both directed entries stored, equal weights) make
the round doubly stochastic, i.e. Assumption 3 minus the spectral bound.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np

# Above this node count, materializing dense (n, n) matrices from a sparse
# round is considered a bug; as_dense()/stacked() raise instead of thrashing.
DENSE_GUARD = 8192


def _as_edge_arrays(src, dst, w):
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    w = np.asarray(w, dtype=np.float64)
    order = np.lexsort((src, dst))  # canonical: sorted by (dst, src)
    return src[order], dst[order], w[order]


@dataclasses.dataclass(frozen=True)
class SparseRound:
    """One gossip round as directed COO edges in Laplacian form.

    ``w[e]`` is the off-diagonal weight ``W[dst[e], src[e]]``; the diagonal
    is implied by row-stochasticity (``W[i, i] = 1 - sum_j W[i, j]``).
    ``diag`` optionally pins the exact diagonal of a round extracted from a
    dense matrix so ``as_dense()`` reconstructs it bit-exactly; native
    sparse rounds leave it ``None`` (implied diagonal).
    """

    n: int
    src: np.ndarray            # (E,) int32 — sender j of entry W[dst, src]
    dst: np.ndarray            # (E,) int32 — receiver i
    w: np.ndarray              # (E,) float64 — off-diagonal weight
    diag: np.ndarray | None = None  # (n,) float64, only for dense-extracted rounds

    @property
    def edges(self) -> int:
        return int(self.src.size)

    @functools.cached_property
    def participants(self) -> np.ndarray:
        """Sorted unique node ids touched by any edge this round."""
        return np.unique(np.concatenate([self.src, self.dst])) \
            if self.src.size else np.empty(0, dtype=np.int32)

    @functools.cached_property
    def senders(self) -> int:
        """Number of distinct transmitting nodes (unique ``src``)."""
        return int(np.unique(self.src).size)

    @functools.cached_property
    def kind(self) -> str:
        """empty | matching | sparse — O(E log E) classification."""
        if self.src.size == 0:
            return "empty"
        recv, counts = np.unique(self.dst, return_counts=True)
        if (counts == 1).all():
            # degree <= 1 everywhere: matching iff the peer map is an
            # involution (i <-> j both present)
            order = np.argsort(self.dst)
            d, s = self.dst[order], self.src[order]
            back = np.searchsorted(d, s)
            ok = (back < d.size) & (d[np.minimum(back, d.size - 1)] == s)
            if ok.all() and np.array_equal(s[back], d):
                return "matching"
        return "sparse"

    def filter(self, keep: np.ndarray) -> "SparseRound":
        """Drop edges where ``keep`` is False — O(E) fault repair.

        In Laplacian form a dropped edge's weight returns to both
        endpoints' diagonals automatically, which is exactly
        :func:`repro.sim.faults.repair_weights` without densification.
        The pinned ``diag`` is discarded: the repaired diagonal is the
        implied one.
        """
        keep = np.asarray(keep, dtype=bool)
        return SparseRound(self.n, self.src[keep], self.dst[keep],
                           self.w[keep])

    def as_dense(self) -> np.ndarray:
        if self.n > DENSE_GUARD:
            raise ValueError(
                f"refusing to densify a SparseRound with n={self.n} "
                f"(> {DENSE_GUARD}); use the edge-list operations instead")
        W = np.zeros((self.n, self.n), dtype=np.float64)
        W[self.dst, self.src] = self.w
        if self.diag is not None:
            W[np.arange(self.n), np.arange(self.n)] = self.diag
        else:
            rowsum = np.bincount(self.dst, weights=self.w, minlength=self.n)
            W[np.arange(self.n), np.arange(self.n)] = 1.0 - rowsum
        return W

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Host-side numpy mix ``W @ x`` in O(edges * dim)."""
        x = np.asarray(x, dtype=np.float64)
        if self.src.size == 0:
            return x.copy()
        contrib = self.w[:, None] * (x[self.src] - x[self.dst])
        out = x.copy()
        np.add.at(out, self.dst, contrib)
        return out

    def check(self, atol: float = 1e-8) -> None:
        """Assumption-3 invariants that are checkable in O(E log E):
        nonnegative weights, symmetric weight pairs (=> doubly stochastic),
        implied diagonal in [0, 1], and a consistent pinned diagonal."""
        if self.src.size == 0:
            return
        if (self.w < -atol).any():
            raise ValueError("negative edge weight")
        if (self.src == self.dst).any():
            raise ValueError("self-loop stored as an edge (diagonal is implied)")
        order_f = np.lexsort((self.src, self.dst))
        order_b = np.lexsort((self.dst, self.src))
        if not (np.array_equal(self.dst[order_f], self.src[order_b])
                and np.array_equal(self.src[order_f], self.dst[order_b])
                and np.allclose(self.w[order_f], self.w[order_b], atol=atol)):
            raise ValueError("edge weights are not symmetric "
                             "(round would not be doubly stochastic)")
        parts = self.participants
        rowsum = np.bincount(self.dst, weights=self.w,
                             minlength=int(parts[-1]) + 1)[parts]
        if (rowsum > 1.0 + atol).any():
            raise ValueError("implied diagonal negative (row sum > 1)")
        if self.diag is not None:
            implied = 1.0 - np.bincount(self.dst, weights=self.w,
                                        minlength=self.n)
            if not np.allclose(self.diag, implied, atol=max(atol, 1e-7)):
                raise ValueError("pinned diagonal inconsistent with row sums")


def round_from_dense(W: np.ndarray, atol: float = 1e-12) -> SparseRound:
    """Extract the off-diagonal edges of a dense gossip matrix.

    Pins the exact diagonal so ``as_dense()`` round-trips bit-exactly.
    """
    W = np.asarray(W, dtype=np.float64)
    n = W.shape[0]
    off = np.abs(W) > atol
    np.fill_diagonal(off, False)
    dst, src = np.nonzero(off)
    s, d, w = _as_edge_arrays(src, dst, W[dst, src])
    return SparseRound(n, s, d, w, diag=np.ascontiguousarray(np.diag(W)))


@dataclasses.dataclass(frozen=True)
class SparseGossipPlan:
    """A window of sparse rounds as one concatenated COO edge list.

    ``offsets`` has ``period + 1`` entries; round r owns the slice
    ``[offsets[r], offsets[r+1])`` of ``src``/``dst``/``w`` (the "per-round
    segment offsets" of the representation).  ``tensors()`` stages the plan
    as padded per-round device arrays; :meth:`make_mixer` returns the same
    ``mix_fn(tensors, t0, rounds, tree)`` interface the dense
    :func:`repro.core.algorithms.make_plan_mixer` exposes, so
    ``plan_step``/``run_algorithm`` consume either plan via duck typing.
    """

    n: int
    src: np.ndarray       # (Etot,) int32
    dst: np.ndarray       # (Etot,) int32
    w: np.ndarray         # (Etot,) float64
    offsets: np.ndarray   # (period + 1,) int64
    diags: tuple = ()     # per-round pinned diagonals (or None), optional

    is_edge_plan = True

    @classmethod
    def from_rounds(cls, rounds) -> "SparseGossipPlan":
        rounds = tuple(rounds)
        if not rounds:
            raise ValueError("plan needs at least one round")
        n = rounds[0].n
        offsets = np.zeros(len(rounds) + 1, dtype=np.int64)
        np.cumsum([r.edges for r in rounds], out=offsets[1:])
        cat = lambda xs, dt: (np.concatenate(xs).astype(dt) if offsets[-1]
                              else np.empty(0, dtype=dt))
        return cls(
            n=n,
            src=cat([r.src for r in rounds], np.int32),
            dst=cat([r.dst for r in rounds], np.int32),
            w=cat([r.w for r in rounds], np.float64),
            offsets=offsets,
            diags=tuple(r.diag for r in rounds),
        )

    @property
    def period(self) -> int:
        return int(self.offsets.size - 1)

    @functools.cached_property
    def edges_per_round(self) -> np.ndarray:
        return np.diff(self.offsets)

    def round(self, r: int) -> SparseRound:
        lo, hi = int(self.offsets[r]), int(self.offsets[r + 1])
        diag = self.diags[r] if self.diags else None
        return SparseRound(self.n, self.src[lo:hi], self.dst[lo:hi],
                           self.w[lo:hi], diag=diag)

    @functools.cached_property
    def kinds(self) -> tuple:
        return tuple(self.round(r).kind for r in range(self.period))

    # run_algorithm/bind_step read this to pick jit static args; the sparse
    # plan always stages uniform padded rounds -> traced-t dispatch.
    dispatch = "dynamic"

    def validate(self) -> "SparseGossipPlan":
        for r in range(self.period):
            self.round(r).check()
        return self

    def as_dense(self, validate: bool = False):
        """Reconstruct the dense :class:`repro.core.gossip.GossipPlan` this
        plan represents (small-n equivalence checks; raises past the
        dense guard)."""
        from ..core import gossip as _gossip
        mats = [self.round(r).as_dense() for r in range(self.period)]
        rounds = tuple(_gossip.plan_round(W, sparse=False) for W in mats)
        plan = _gossip.GossipPlan(rounds)
        if validate:
            plan.validate()
        return plan

    def tensors(self) -> dict:
        """Stage as padded per-round numpy arrays (one jnp.asarray away
        from device).  Padding is inert by construction: pad edges carry
        ``w = 0`` (zero contribution) and pad slots carry ``n`` (dropped by
        the out-of-bounds scatter mode).

        Keys: ``esrc``/``edst``/``ew`` — (P, Emax) edge arrays for the
        scatter mixer; ``seg``/``slots`` — (P, Emax)/(P, Smax) compacted
        destination segments for the Pallas segment-sum path.
        """
        P = self.period
        emax = max(1, int(self.edges_per_round.max()) if P else 1)
        esrc = np.zeros((P, emax), dtype=np.int32)
        edst = np.zeros((P, emax), dtype=np.int32)
        ew = np.zeros((P, emax), dtype=np.float32)
        seg = np.zeros((P, emax), dtype=np.int32)
        smax = 1
        slot_rows = []
        for r in range(P):
            rd = self.round(r)
            e = rd.edges
            esrc[r, :e] = rd.src
            edst[r, :e] = rd.dst
            ew[r, :e] = rd.w
            slots = np.unique(rd.dst) if e else np.empty(0, np.int32)
            seg[r, :e] = np.searchsorted(slots, rd.dst) if e else 0
            slot_rows.append(slots)
            smax = max(smax, slots.size)
        slots_arr = np.full((P, smax), self.n, dtype=np.int32)
        for r, s in enumerate(slot_rows):
            slots_arr[r, :s.size] = s
        return {"esrc": esrc, "edst": edst, "ew": ew,
                "seg": seg, "slots": slots_arr}

    def make_mixer(self, *, use_pallas=False):
        """Build ``mix_fn(tensors, t0, rounds, x)`` for this plan, in torch:
        ``tensors`` is :meth:`tensors` staged on the device
        (:func:`repro_torch.core.driver.stage_plan`), ``t0`` the host start
        round and ``x`` an (n, ...) state tensor, mixed IN PLACE and
        returned (the JAX mixer is pure; here the engine owns its state,
        and a copy per round would cost a read and a write of all of it).

        The default path scatter-adds edge contributions per round
        (:func:`repro_torch.core.algorithms.sparse_mix`); ``use_pallas=True``
        (the JAX API's name) routes each round through
        :func:`repro_torch.kernels.ops.sparse_gossip_mix`, whose segment sum
        is the hand-written Hopper ``sparse_segment_mix`` on a CUDA tensor.
        Each round is cut to its realized edges and receivers, counted on
        the host, so padding is never read.  The first call with a staged
        plan turns its int32 indices to int64 and, for the kernel, lays out
        all its rounds in one call (:func:`repro_torch.kernels.
        sparse_gossip.segment_layouts`: edges grouped by receiver segment,
        each round's distinct rows compacted): once per staged plan, not
        per round.  The reference's mesh, axis, mode and interpret
        arguments have no meaning on one device and are not taken.
        """
        import torch

        from ..core.algorithms import sparse_mix
        from ..kernels import ops as kops, sparse_gossip

        edges = [int(e) for e in self.edges_per_round]
        receivers = [int(np.unique(self.round(r).dst).size)
                     for r in range(self.period)]
        staged = {"tensors": None, "rounds": None}

        def prepare(tensors):
            src, dst = tensors["esrc"].long(), tensors["edst"].long()
            w, slots = tensors["ew"], tensors["slots"].long()
            layouts = [None] * self.period
            if use_pallas:
                smax = slots.shape[1]
                pad = (torch.arange(src.shape[1], device=src.device)[None]
                       >= torch.tensor(edges, device=src.device)[:, None])
                seg = tensors["seg"].long().masked_fill(pad, smax)
                layouts = [
                    lay._replace(src=lay.src[:e], dst=lay.dst[:e],
                                 w=lay.w[:e], offsets=lay.offsets[:s + 1],
                                 lsrc=lay.lsrc[:e], ldst=lay.ldst[:e])
                    for lay, e, s in zip(sparse_gossip.segment_layouts(
                        src, dst, w, seg, smax), edges, receivers)]
            return [(src[r, :e], dst[r, :e], w[r, :e], slots[r, :s],
                     layouts[r])
                    for r, (e, s) in enumerate(zip(edges, receivers))]

        def mix_fn(tensors, t0, rounds, x):
            if staged["tensors"] is not tensors:
                staged["tensors"], staged["rounds"] = tensors, prepare(tensors)
            for i in range(rounds):
                src, dst, w, slots, layout = \
                    staged["rounds"][(t0 + i) % self.period]
                if use_pallas:
                    x = kops.sparse_gossip_mix(x, src, dst, w, None, slots,
                                               use_pallas=True, layout=layout)
                else:
                    x = sparse_mix(src, dst, w, x)
            return x

        return mix_fn
