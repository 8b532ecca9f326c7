"""Personalized fleet, trained to served, on the port: the train->serve loop
end to end.  The twin of ``examples/personalized_fleet.py``.

16 nodes with strongly non-iid data (Dirichlet(0.1) token marginals) move
through the unit square (random-waypoint mobility, unit-disk links) while
the channel drops 20% of links per round — the paper's wireless scenario.
Two fleets train on the SAME realized scenario and gossip budget (the
reference's specs):

* ``personalized`` — loss-proximity neighbor averaging (similarity-gated
  row-stochastic mixing, outside Assumption 3): nodes with similar losses
  share aggressively, dissimilar nodes mostly keep their own model, so the
  fleet converges to genuinely distinct per-node models;
* ``mc_dsgt``      — the paper's uniform consensus baseline: every node is
  driven toward ONE shared model, which under non-iid data is a compromise
  no node's own distribution prefers.

The example evaluates both fleets per node on held-out batches from each
node's OWN stream (the metric a personalized deployment cares about), then
serves the personalized fleet behind one continuously batched endpoint:
64 synthetic requests, each user pinned to one node's personalization
(``user-affinity`` routing), decoded slot-wise against that node's
parameters (:mod:`repro_torch.serve`).  The node marginals are the
reference's draw; the tokens drawn from them and the initial parameters
come from torch generators, so the losses differ from the reference's by
sampling.

    PYTHONPATH=src python examples/torch/personalized_fleet.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch import exp
from repro_torch.dist import steps as dsteps
from repro_torch.obs import Console

N = 16
T = 60                     # gossip/oracle budget per training run
ALPHA = 0.1                # Dirichlet token-marginal heterogeneity

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="arch", arch="qwen1.5-0.5b", preset="reduced"),
    data=exp.DataSpec(batch=8, seq=32, active_vocab=64, hetero_alpha=ALPHA),
    topology=exp.TopologySpec(kind="waypoint-mobility", radius=0.45),
    channel=exp.ChannelSpec(link_drop=0.2),
    run=exp.RunSpec(nodes=N, log_every=10),
)

_ALGOS = {          # name -> extra algorithm fields
    "personalized": {"algorithm.gamma": 0.3, "algorithm.tau": 8.0},
    "mc_dsgt": {"algorithm.gamma": 0.3, "algorithm.R": 2},
}


def _spec(algo: str, requests: int = 0) -> exp.ExperimentSpec:
    spec = exp.with_overrides(_BASE, {"algorithm.name": algo,
                                      **_ALGOS[algo]})
    # equal budget T: rounds per step come from the engine rule itself
    steps = max(2, T // exp.weights_per_step(spec.algorithm))
    return exp.with_overrides(spec, {
        "run.steps": steps,
        "serve.requests": requests, "serve.batch": 8,
        "serve.prompt_len": 16, "serve.max_new": 16,
        "serve.routing": "user-affinity"})


# the CI spec-smoke pool: the serve-phase cell (exp.validate --only serve)
SPECS = {"personalized_serve": _spec("personalized", requests=64)}


def per_node_eval_loss(res: exp.Result, batches: int = 4) -> np.ndarray:
    """(n,) mean held-out loss of each node's model on ITS OWN stream:
    batches drawn past the training horizon (same Dirichlet marginals,
    never trained on).  Node by node, each model a view of its row of the
    flat trained state."""
    built = res.built
    layout = dsteps.flat_layout(built.model, built.rule.compression)
    n = res.state.x.shape[0]
    total = torch.zeros(n, dtype=torch.float64)
    with torch.no_grad():
        for j in range(batches):
            toks = built.stream.batch_at(res.spec.run.steps + 2 + j)["tokens"]
            for i in range(n):
                total[i] += float(built.model.train_loss(
                    layout.views(res.state.x[i]), {"tokens": toks[i, 0]}))
    return (total / batches).numpy()


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N}  waypoint mobility + 20% link drop  "
              f"Dirichlet({ALPHA}) non-iid token streams  budget T={T}")

    # -- uniform consensus baseline ----------------------------------------
    base = exp.run(_spec("mc_dsgt"), device=args.device, quiet=True)
    base_pn = per_node_eval_loss(base)
    con.event("result", algo="mc_dsgt", per_node_loss=float(base_pn.mean()),
              worst_node=float(base_pn.max()))

    # -- personalized fleet, trained then served ---------------------------
    res = exp.run(_spec("personalized", requests=64), device=args.device,
                  quiet=con.quiet)
    pers_pn = per_node_eval_loss(res)
    con.event("result", algo="personalized",
              per_node_loss=float(pers_pn.mean()),
              worst_node=float(pers_pn.max()))

    sv = res.serve
    tp = sv.throughput
    nodes_hit = sorted({c["node"] for c in sv.completed})
    users = {}
    for c in sv.completed:
        users.setdefault(c["user"], set()).add(c["node"])
    con.event("served", requests=tp["requests"], fleet=sv.fleet,
              batch=tp["batch"], decode_tok_s=tp["decode_tok_s"],
              p50_ms=tp["latency_p50_ms"], p95_ms=tp["latency_p95_ms"],
              nodes_hit=len(nodes_hit))

    con.print("\nPersonalization pays exactly where consensus cannot: under "
              "Dirichlet non-iid streams each node's own-data loss is lower "
              "for the loss-proximity fleet than for the single consensus "
              "model, and the serve phase routes every user to the one node "
              "whose personalization they pinned.")
    assert float(pers_pn.mean()) < float(base_pn.mean()), \
        (f"personalized per-node loss {pers_pn.mean():.4f} should beat "
         f"uniform mc_dsgt {base_pn.mean():.4f} on non-iid data")
    assert tp["requests"] == 64, f"served {tp['requests']}/64 requests"
    assert all(len(v) == 1 for v in users.values()), \
        "user-affinity routing must pin each user to exactly one node"
    return {"personalized": float(pers_pn.mean()),
            "mc_dsgt": float(base_pn.mean()), "throughput": tp}


if __name__ == "__main__":
    main()
