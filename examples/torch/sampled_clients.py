"""Client sampling at 100k nodes on the port: the sparse scenario engine end
to end, the twin of ``examples/sampled_clients.py``.

``n = 100_000`` devices of which a ``sample_k = 256`` cohort wakes up each
round, gossips over the unit-disk graph among the cohort with Metropolis
weights, and loses links to an iid drop channel plus node churn.
Everything stays in edge-list form — the schedule is a
:class:`repro_torch.sparse.SparseWeightSchedule`, the plan a
:class:`repro_torch.sparse.SparseGossipPlan`, faults are per-edge hash
streams, and telemetry (consensus, windowed spectral-gap proxy,
bytes/round over participating senders) never materializes a matrix.
Per-round cost is O(edges) ~ O(sample_k^2), independent of n; the fleet's
data and state live on ``--device``.

    PYTHONPATH=src python examples/torch/sampled_clients.py [--device cpu]

The run writes mixing telemetry plus a reproducibility manifest
(``sampled_clients_100k.telemetry.json{,.spec.json}``, in the working
directory, as the reference's spec names it); the schedule is the
reference's numpy, so the manifest equals the checked-in
``experiments/manifests/sampled_clients_100k.json``.
"""

import argparse

import numpy as np

from repro_torch import exp
from repro_torch.obs import Console

N = 100_000               # devices in the fleet
K = 256                   # cohort sampled per round
STEPS = 5
TELEMETRY = "sampled_clients_100k.telemetry.json"

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="logreg", d=8, m=8, rho=0.1),
    data=exp.DataSpec(batch=4),
    algorithm=exp.AlgorithmSpec(name="mc_dsgt", gamma=0.3, R=2),
    topology=exp.TopologySpec(kind="random-sampled", sample_k=K,
                              radius=0.45),
    channel=exp.ChannelSpec(link_drop=0.2, churn=0.02),
    run=exp.RunSpec(steps=STEPS, nodes=N, gossip_impl="auto",
                    eval_every=STEPS, telemetry=TELEMETRY),
)

# the reference's spec-smoke pool: a 1k-node cohort-sampled cell on both
# host paths — 'auto' stays in edge form, 'dense' materializes the same
# rounds and must agree
SPECS = {
    "sampled_auto": exp.with_overrides(_BASE, {
        "run.nodes": 1000, "run.telemetry": None,
        "topology.sample_k": 32}),
    "sampled_host_dense": exp.with_overrides(_BASE, {
        "run.nodes": 1000, "run.telemetry": None,
        "run.gossip_impl": "dense", "topology.sample_k": 32}),
}


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N:,}  sample_k={K}  waypoint mobility (radius=0.45)  "
              f"20% link drop + 2% churn  mc_dsgt R=2")
    res = exp.run(_BASE, device=args.device, quiet=True)
    realized = res.built.realized
    epr = realized["edges_per_round"]
    con.event("realized", nodes=N, sample_k=K,
              edges_per_round=epr, senders_per_round=
              realized["senders_per_round"], period=realized["period"])
    last = res.telemetry.history[-1]
    g = float(res.history[-1][1])
    con.event("result", grad_sq=g, consensus=last["consensus"],
              spectral_gap=last["spectral_gap"],
              bytes_total=res.telemetry.bytes_total)

    # the point of the engine: realized work is O(edges), not O(n^2) —
    # the densest round touches ~k(k-1) directed edges, 6 orders of
    # magnitude below the n^2 a dense round would carry
    assert epr["max"] <= K * (K - 1), epr
    assert epr["max"] < N, epr
    assert np.isfinite(g), g
    con.print(f"\n{N:,} nodes mixed through edge lists only: the densest "
              f"round carried {epr['max']:,} directed edges "
              f"({epr['max'] / (N * (N - 1)):.2e} of dense n^2), telemetry "
              f"counted bytes over participating senders, and the manifest "
              f"({TELEMETRY}.spec.json) records the realized edge counts.")
    return res


if __name__ == "__main__":
    main()
