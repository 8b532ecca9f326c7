"""Wireless mobility + lossy channels, the paper's motivating scenario, on
the port: the twin of ``examples/wireless_mobility.py``.

"Decentralized algorithms are more robust in wireless scenarios especially
when nodes are moving": 16 nodes move through the unit square
(random-waypoint mobility, unit-disk links), the channel drops an
increasing fraction of links per round (iid Bernoulli), the surviving links
are repaired into a valid mixing matrix, and MC-DSGT / DSGD / gt_local run
over the *realized* schedule.  The {algorithm} x {drop rate} matrix is one
base :class:`repro_torch.exp.ExperimentSpec` (the reference's), run through
``repro_torch.exp.run``, which wires the mobility, channel, repair and
telemetry.  The minibatch indices come from a ``torch.Generator``, so the
numbers differ from the reference's by sampling; what is held is the
example's claim.

    PYTHONPATH=src python examples/torch/wireless_mobility.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch import exp
from repro_torch.obs import Console

N = 16
T = 320                    # gossip/oracle budget per run
R = 2                      # MC-DSGT consensus/accumulation rounds
DROPS = (0.0, 0.2, 0.4)

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="logreg", d=64, m=256, rho=0.1),
    data=exp.DataSpec(batch=16, hetero_alpha=0.3),
    topology=exp.TopologySpec(kind="waypoint-mobility", radius=0.45),
    run=exp.RunSpec(nodes=N),
)

_ALGOS = {          # name -> (gamma, R)
    "mc_dsgt": (0.3, R),
    "gt_local": (0.2, 1),
    "dsgd": (0.3, 1),
}


def _spec(algo: str, drop: float) -> exp.ExperimentSpec:
    gamma, rr = _ALGOS[algo]
    spec = exp.with_overrides(_BASE, {
        "algorithm.name": algo, "algorithm.gamma": gamma, "algorithm.R": rr,
        "channel.link_drop": drop})
    # equal budget T: rounds per step come from the engine rule itself
    steps = max(2, T // exp.weights_per_step(spec.algorithm))
    return exp.with_overrides(spec, {
        "run.steps": steps, "run.eval_every": max(1, steps - 1)})


# the reference's CI spec-smoke pool
SPECS = {"mc_dsgt_drop20": _spec("mc_dsgt", 0.2),
         "dsgd_ideal": _spec("dsgd", 0.0)}


def median(vals):
    vals = [v for v in vals if v is not None]
    return float(np.median(vals)) if vals else None


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N}  random-waypoint mobility (radius=0.45)  "
              f"non-iid Dirichlet(0.3) data  budget T={T}")
    final = {}
    for drop in DROPS:
        for name in _ALGOS:
            res = exp.run(_spec(name, drop), device=args.device, quiet=True)
            telem = res.telemetry  # created by run(): mobility => recorder
            g = float(res.history[-1][1])
            gap = median([e["spectral_gap"] for e in telem.history])
            diam = median([e["eff_diameter"] for e in telem.history])
            last = telem.history[-1]
            empty = last["kinds"].get("empty", 0)
            con.event("result", algo=name, drop=drop, grad_sq=g,
                      consensus=last["consensus"], spectral_gap=gap,
                      eff_diameter=(diam if diam is not None
                                    else float("nan")),
                      dropped=empty,
                      window=last["window"][1] - last["window"][0])
            final[(name, drop)] = g

    con.print("\nGradient tracking survives the lossy channel: at 20% and "
              "40% link drop the tracked runs (mc_dsgt, gt_local) keep "
              "converging while plain DSGD pays the full heterogeneity "
              "bias; the realized effective diameter and spectral gap "
              "quantify exactly how much mixing the channel destroyed.")
    assert final[("mc_dsgt", 0.4)] < final[("mc_dsgt", 0.0)] * 50, \
        "MC-DSGT should degrade gracefully under 40% loss"
    return final


if __name__ == "__main__":
    main()
