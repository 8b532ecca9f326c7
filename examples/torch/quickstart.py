"""Quickstart on the port: decentralized non-convex optimization over a
time-varying sun-shaped network — DSGD vs DSGT vs MC-DSGT (paper Table 1 in
miniature), the twin of ``examples/quickstart.py``.

Each run is ONE declarative :class:`repro_torch.exp.ExperimentSpec` literal
(the paper's §6 objective on synthetic heterogeneous data, sun-shaped
schedule at the worst connectivity Theorem 3 allows) executed through
``repro_torch.exp.run`` — the same entry point as the training CLI.  Prints
the global gradient norm ||∇f(x̄)||² per oracle/communication budget T.  The
specs are the reference's; the minibatch indices come from a
``torch.Generator``, so the numbers differ from the reference's by sampling
and what is held is the example's claim.

    PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
"""

import argparse
import dataclasses

from repro_torch import exp
from repro_torch.obs import Console

N = 16
BETA = 1 - 1 / N          # worst connectivity Theorem 3 allows
R = 4                     # MC-DSGT consensus/accumulation rounds
T_BUDGET = 960            # total gossip+oracle rounds per node
GAMMA = 0.4

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="logreg", d=64, m=256, rho=0.1),
    data=exp.DataSpec(batch=16),
    topology=exp.TopologySpec(kind="sun", beta=BETA),
)


def _spec(algo: str, steps: int, R: int = 1) -> exp.ExperimentSpec:
    return dataclasses.replace(
        _BASE,
        algorithm=exp.AlgorithmSpec(name=algo, gamma=GAMMA, R=R),
        run=exp.RunSpec(nodes=N, steps=steps,
                        eval_every=max(1, steps // 8)))


# Equal budget T: each algorithm gets T / weights_per_step steps.
SPECS = {
    "dsgd": _spec("dsgd", T_BUDGET),
    "dsgt": _spec("dsgt", T_BUDGET // 2),
    "mc_dsgt": _spec("mc_dsgt", T_BUDGET // (2 * R), R=R),
}


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N} beta={BETA:.4f} (sun-shaped, rotating centers, "
              f"|C|={max(1, int(N * (1 - BETA)))})  budget T={T_BUDGET}")
    results = {}
    for name, spec in SPECS.items():
        res = exp.run(spec, device=args.device, quiet=True)
        t, g = res.history[-1]
        con.event("result", algo=name, T=int(t), grad_sq=float(g))
        results[name] = float(g)

    assert results["mc_dsgt"] <= results["dsgd"], \
        "MC-DSGT should dominate DSGD on a poorly-connected graph"
    con.print("\nMC-DSGT <= DSGD at equal budget: paper Table 1 "
              "ordering holds.")
    return results


if __name__ == "__main__":
    main()
