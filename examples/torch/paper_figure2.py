"""Reproduce paper Figure 2 on the port: DSGD / DSGT / MC-DSGT on
non-convex-regularized logistic regression over random time-varying
sun-shaped graphs, the twin of ``examples/paper_figure2.py``.

Left plot protocol:  (n, |C|) = (16, 1), R = 2, MNIST-like  (d = 784)
Right plot protocol: (n, |C|) = (32, 4), R = 4, COVTYPE-like (d = 54)

Heterogeneous partition: half the nodes hold 80% positive labels, the other
half 80% negative (§6).  Datasets are synthetic stand-ins with the same
shapes; the *algorithmic* comparison — the figure's actual claim — is
preserved.  Each (protocol, algorithm, stepsize) cell is one
:class:`repro_torch.exp.ExperimentSpec` (the §6 randomized sun schedule is
the registered ``random-sun`` topology) run through ``repro_torch.exp.run``
on ``--device``.  The specs are the reference's; the minibatch indices come
from a ``torch.Generator``, so the curves differ from the reference's by
sampling and what is held is each protocol's verdict.  Writes CSV curves to
<out>/figure2_<name>.csv.

    PYTHONPATH=src python examples/torch/paper_figure2.py [--steps 400] \
        [--device cpu]
"""

import argparse
import os

from repro_torch import exp
from repro_torch.configs.logreg_paper import COVTYPE, MNIST
from repro_torch.obs import Console


def base_spec(lc, seed: int = 0) -> exp.ExperimentSpec:
    """The protocol's scenario literal — everything but the algorithm cell."""
    return exp.ExperimentSpec(
        model=exp.ModelRef(kind="logreg", d=lc.d, m=lc.m, rho=lc.rho),
        data=exp.DataSpec(batch=lc.batch),
        topology=exp.TopologySpec(kind="random-sun", centers=lc.center_size),
        run=exp.RunSpec(nodes=lc.n_nodes, seed=seed))


# the reference's spec-smoke pool
SPECS = {
    "mnist_mc_dsgt": exp.with_overrides(base_spec(MNIST), {
        "algorithm.name": "mc_dsgt", "algorithm.R": MNIST.R,
        "algorithm.gamma": 0.5, "run.steps": 4}),
}


def run_setup(lc, T_budget: int, gamma: float, seed: int = 0,
              con: Console = None, device: str = "cuda"):
    con = con or Console.from_argv()
    base = base_spec(lc, seed)

    # per-algorithm step-size tuning over a small grid (the paper reports
    # tuned curves): MC-DSGT's R-fold gradient accumulation cuts oracle
    # noise by R, admitting up to ~R x larger steps at equal stability.
    def tuned(algo, R, steps, gammas):
        best = None
        for g in gammas:
            spec = exp.with_overrides(base, {
                "algorithm.name": algo, "algorithm.gamma": g,
                "algorithm.R": R, "run.steps": steps,
                "run.eval_every": max(1, steps // 40)})
            res = exp.run(spec, device=device, quiet=True)
            pts = [(t, float(v)) for t, v in res.history]
            if best is None or pts[-1][1] < best[-1][1]:
                best = pts
        return best

    curves = {}
    grid = [gamma, 2 * gamma]
    mc_grid = sorted({gamma, gamma * lc.R / 2, gamma * lc.R})
    curves["dsgd"] = tuned("dsgd", 1, T_budget, grid)
    curves["dsgt"] = tuned("dsgt", 1, T_budget // 2, grid)
    curves[f"mc_dsgt(R={lc.R})"] = tuned(
        "mc_dsgt", lc.R, T_budget // (2 * lc.R), mc_grid)
    for name, pts in curves.items():
        con.event("curve", setup=lc.name, algo=name, grad_sq=pts[-1][1])
    return curves


def verdict(curves: dict) -> tuple:
    """(verdict, MC-DSGT's final, DSGD's final): the figure's claim —
    MC-DSGT converges lower at equal budget (or to parity when the random
    schedule mixes fast and both sit at the gradient-noise floor, as for
    the |C|=4 covtype protocol)."""
    final = {k: v[-1][1] for k, v in curves.items()}
    mc = min(v for k, v in final.items() if k.startswith("mc"))
    if mc <= final["dsgd"]:
        word = "beats"
    elif mc < 1e-4 and final["dsgd"] < 1e-4:
        word = "matches (both at the noise floor)"
    else:
        word = "LOSES to"
    return word, mc, final["dsgd"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=400,
                    help="total per-node round budget T")
    ap.add_argument("--out", default="experiments")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = Console(quiet=args.quiet)

    os.makedirs(args.out, exist_ok=True)
    all_results = {}
    for lc, gamma in [(MNIST, 0.5), (COVTYPE, 0.5)]:
        con.print(f"setup {lc.name}: n={lc.n_nodes} |C|={lc.center_size} "
                  f"R={lc.R} rho={lc.rho}")
        curves = run_setup(lc, args.steps, gamma, con=con,
                           device=args.device)
        all_results[lc.name] = curves
        path = os.path.join(args.out, f"figure2_{lc.name}.csv")
        with open(path, "w") as f:
            f.write("algo,T,grad_norm_sq\n")
            for name, pts in curves.items():
                for t, g in pts:
                    f.write(f"{name},{t},{g}\n")
        con.event("wrote", path=path)

    for name, curves in all_results.items():
        word, mc, dsgd = verdict(curves)
        con.print(f"{name}: MC-DSGT {word} DSGD ({mc:.6f} vs {dsgd:.6f})")
    return all_results


if __name__ == "__main__":
    main()
