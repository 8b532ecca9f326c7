"""Plan-only scale smoke: prove realize -> degrade -> lower -> restage
cost scales with *edges*, not nodes.

The sparse engine's contract is that no stage of the plan path touches an
(n, n) object, so running the identical pipeline at 10k and 100k nodes
with the same per-round cohort ``k`` must cost about the same wall time
(the work is O(rounds * k^2) realization + O(edges) staging at both
sizes).  CI runs this as a fast lane cell:

    PYTHONPATH=src python -m repro.sparse.smoke

No mixing happens — this is the staging half only, so it stays in the
seconds range even at 100k nodes.
"""

from __future__ import annotations

import time

from ..sim import channel as sim_channel
from .realize import realize_sparse_schedule
from .sampled import sampled_weight_schedule


def _stage(n: int, k: int, rounds: int, seed: int) -> tuple[float, int]:
    """One full staging pass at ``n`` nodes; returns (seconds, edges)."""
    t0 = time.perf_counter()
    sched = sampled_weight_schedule(n, k, horizon=rounds, seed=seed)
    real = realize_sparse_schedule(
        sched, [sim_channel.BernoulliDropChannel(0.2, seed=7)])
    plan = real.plan()
    plan.tensors()
    return time.perf_counter() - t0, int(plan.edges_per_round.sum())


def plan_scale_smoke(n_small: int = 10_000, n_big: int = 100_000,
                     k: int = 256, rounds: int = 16, seed: int = 0,
                     factor: float = 5.0) -> dict:
    """Stage the same sampled scenario at ``n_small`` and ``n_big`` nodes
    and assert the wall-time ratio stays below ``factor`` (a 10x node
    count would be ~100x under any O(n^2) dependence; ``factor`` leaves
    generous room for timer noise while still catching densification)."""
    _stage(256, 16, 2, seed)  # warm imports/caches out of the measurement
    t_small, e_small = _stage(n_small, k, rounds, seed)
    t_big, e_big = _stage(n_big, k, rounds, seed)
    ratio = t_big / max(t_small, 1e-9)
    out = {"n_small": n_small, "n_big": n_big, "k": k, "rounds": rounds,
           "sec_small": round(t_small, 3), "sec_big": round(t_big, 3),
           "edges_small": e_small, "edges_big": e_big,
           "ratio": round(ratio, 2)}
    assert ratio < factor, (
        f"staging {n_big} nodes took {ratio:.1f}x the {n_small}-node time "
        f"(limit {factor}x): some stage is scaling with n, not edges "
        f"— {out}")
    return out


if __name__ == "__main__":
    res = plan_scale_smoke()
    print(f"ok   sparse plan restage scales with edges: "
          f"{res['n_big']:,} nodes in {res['sec_big']}s vs "
          f"{res['n_small']:,} in {res['sec_small']}s "
          f"(ratio {res['ratio']}x, edges {res['edges_big']:,} vs "
          f"{res['edges_small']:,})")
