"""Lower-bound demo on the port (Theorem 4, Instance 2), the twin of
``examples/lower_bound_demo.py``: on the adversarial sun-shaped schedule
with the odd/even zero-chain split, ANY gossip algorithm's progress
prog(x) is capped at ~ C (1-beta) T — watch DSGT hit the wall.

The instance, the schedule and the DSGT run are the reference's (the
port's host ``dsgt`` / ``warm_start`` / ``step`` with the full-batch
gradients of :mod:`repro_torch.core.lower_bound`), so the printed
``progress`` events are the reference's, integer for integer.

    PYTHONPATH=src python examples/torch/lower_bound_demo.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core import algorithms as alg
from repro_torch.core import gossip, lower_bound as lb, topology as topo
from repro_torch.obs import Console


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    dev = torch.device(args.device)
    n, beta, T = 16, 1 - 1 / 16, 96
    inst = lb.make_instance2(L=1.0, Delta=10.0, n=n, beta=beta, T=T)
    I1, I2 = inst.set1, inst.set2
    sched_graphs = topo.sun_shaped_schedule(n, beta, avoid=I1 + I2)
    dist = topo.effective_distance(sched_graphs, I1, I2,
                                   period=sched_graphs.period)
    wsched = gossip.theorem3_weight_schedule(n, beta, avoid=I1 + I2)

    con.print(f"n={n} beta={beta:.4f}  effective distance(I1, I2) = {dist}")
    con.print(f"zero-chain dim d = {inst.d}; theory cap on prog ~ "
              f"T/dist + 1 = {T // dist + 1}")

    def grad_fn(xs, gen):
        return inst.grad_stacked(xs)  # lossless oracle (full gradients)

    algo = alg.dsgt(gamma=0.3)
    gen = torch.Generator(device=dev)
    state = algo.init(torch.zeros((n, inst.d), device=dev))
    state = alg.warm_start(algo, state, grad_fn, gen)
    t = 0
    progress = []
    for k in range(T // 2):
        Ws = torch.from_numpy(wsched.stacked(t, 2)).to(dev)
        state = algo.step(state, grad_fn, Ws, gen)
        t += 2
        if (k + 1) % 8 == 0:
            max_prog = int(lb.prog(state.x).max())
            cap = t // dist + 1
            con.event("progress", round=k + 1, T=t, max_prog=max_prog,
                      cap=cap)
            progress.append((k + 1, t, max_prog, cap))
            assert max_prog <= cap + 1, \
                "progress exceeded the lower-bound cap!"
    con.print("\nprog(x) stayed within the Theorem 4 "
              "information-propagation cap.")
    return progress


if __name__ == "__main__":
    main()
