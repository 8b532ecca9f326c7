"""Federated learning as decentralized optimization over a time-varying
network (paper §1: FedAvg = alternating local updates and global averaging)
on the port, the twin of ``examples/federated.py``.

The federated schedule is `local_steps` rounds of the self-loop-only graph
followed by one complete-graph round; running DSGD over it IS local-SGD /
FedAvg.  Every scenario here is one :class:`repro_torch.exp.ExperimentSpec`
literal (the reference's): the schedule choice, the Dirichlet heterogeneity
and the update rule are all spec fields, and ``repro_torch.exp.build``
exposes the gossip plan that shows where FedAvg's communication savings
come from.  The minibatch indices come from a ``torch.Generator``, so the
numbers differ from the reference's by sampling.

    PYTHONPATH=src python examples/torch/federated.py [--device cpu]
"""

import argparse

from repro_torch import exp
from repro_torch.obs import Console

N = 16
T = 480

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="logreg", d=64, m=256, rho=0.1),
    data=exp.DataSpec(batch=16),
    algorithm=exp.AlgorithmSpec(name="dsgd", gamma=0.4),
    run=exp.RunSpec(nodes=N, steps=T, eval_every=T - 1),
)

# one DSGD run per schedule family, at equal total round budget
SCHEDULE_SPECS = {
    "fedavg(local=4)": exp.with_overrides(_BASE, {
        "topology.kind": "federated", "topology.local_steps": 4}),
    "fedavg(local=16)": exp.with_overrides(_BASE, {
        "topology.kind": "federated", "topology.local_steps": 16}),
    "complete": exp.with_field(_BASE, "topology.kind", "complete"),
    "sun(beta=1-1/n)": exp.with_overrides(_BASE, {
        "topology.kind": "sun", "topology.beta": 1 - 1 / N}),
}

# the engine's federated rule family on Dirichlet(0.1) non-iid data
_FED = exp.with_overrides(_BASE, {
    "topology.kind": "federated", "topology.local_steps": 4,
    "data.hetero_alpha": 0.1})
RULE_SPECS = {
    "local_sgd": exp.with_overrides(_FED, {
        "algorithm.name": "local_sgd", "algorithm.gamma": 0.4}),
    "gt_local": exp.with_overrides(_FED, {
        "algorithm.name": "gt_local", "algorithm.gamma": 0.2}),
    "dsgd": _FED,
}

# the reference's CI spec-smoke pool
SPECS = {"fedavg4_dsgd": SCHEDULE_SPECS["fedavg(local=4)"],
         "dirichlet_local_sgd": RULE_SPECS["local_sgd"],
         "dirichlet_gt_local": RULE_SPECS["gt_local"]}


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N}  budget T={T}  DSGD with gamma=0.4 over each schedule")
    results = {"schedules": {}, "rules": {}}
    for name, spec in SCHEDULE_SPECS.items():
        res = exp.run(spec, device=args.device, quiet=True)
        # the gossip plan names each round's lowering; `empty` rounds are
        # the local steps — the auto dispatcher skips them entirely, so
        # FedAvg's saved communication is visible in the plan itself
        plan = res.built.schedule.plan()
        comm = sum(1 for rd in plan.rounds if rd.kind != "empty") \
            * (T // plan.period)
        kinds = "+".join(f"{plan.kinds.count(k)}x{k}"
                         for k in dict.fromkeys(plan.kinds))
        grad_sq = float(res.history[-1][1])
        con.event("schedule_result", schedule=name, grad_sq=grad_sq,
                  comm_rounds=comm, plan=kinds)
        results["schedules"][name] = {"grad_sq": grad_sq,
                                      "comm_rounds": comm, "plan": kinds}
    con.print("\nFedAvg trades convergence for (local_steps+1)x less "
              "communication — the time-varying-network view makes that a "
              "topology choice, not a different algorithm, and the gossip "
              "plan lowers each phase to its cheapest collective (empty "
              "rounds: none; the averaging round: one all-reduce).")

    # local_sgd is FedAvg proper (mix, then local step); gt_local adds a
    # gradient tracker that keeps tracking through the local-only rounds —
    # the heterogeneity correction FedAvg lacks.
    con.print(f"\nDirichlet(alpha=0.1) label-skew partition, "
              f"fedavg(local=4), budget T={T}:")
    for name, spec in RULE_SPECS.items():
        res = exp.run(spec, device=args.device, quiet=True)
        grad_sq = float(res.history[-1][1])
        con.event("rule_result", rule=name, grad_sq=grad_sq)
        results["rules"][name] = grad_sq
    return results


if __name__ == "__main__":
    main()
