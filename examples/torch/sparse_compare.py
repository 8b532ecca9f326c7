"""Time the port's ``sparse_segment_mix`` from one source tree, for comparing
two versions of it on one card.

    python3 examples/torch/sparse_compare.py [--src DIR] [--rounds N]

imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its ``sparse_segment_mix`` there, realizes the sampled-client main path's
scenario (``chip_smoke.SAMPLED_ARGV``: 256 of 100,000 clients per round,
link drop and churn, MC-DSGT R=2; the schedule and its edge plan only, no
dataset) and, on a random (100,000, 784) f32 state, times the first N
rounds (default 20, the rounds ``chip_smoke.py``'s path A mixes), each laid
out by that tree's ``segment_layout``: the kernel's device time and that of
``torch.sparse.mm`` on the round's CSR matrix (``chip_smoke.device_ms``, 20
calls each; kernel, library, library, kernel), that of the plain version
(5 calls), and the wrapper's host microseconds per call
(``chip_smoke.host_us``, 200 calls).  Prints one JSON line of the means,
the per-round kernel and library times and edge counts, the launches
the profiler did not record in each timing and the profiler sessions that
recorded none and were run again; ``chip_smoke.py`` takes its times from
it.  To compare an earlier
commit with this one, unpack it with ``git archive`` into a directory git
ignores and run the two in turns in one process each: earlier, this, this,
earlier.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def sampled_plan(spec):
    """The spec's realized sampled schedule and its edge plan, built as
    ``exp.build`` builds them (``repro_torch`` already on the path)."""
    from repro_torch import sparse
    from repro_torch.core import engine
    from repro_torch.exp import registry
    rs, al = spec.run, spec.algorithm
    wps = engine.make_rule(al.name, gamma=al.gamma, R=al.R).weights_per_step
    sched = registry.build_topology(spec.topology, rs.nodes,
                                    horizon=(rs.steps + 1) * wps * 4,
                                    seed=rs.seed)
    sched = sparse.realize_sparse_schedule(
        sched, registry.build_channel_models(spec.channel, rs.seed))
    return sched.plan(0, sched.period)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to time")
    ap.add_argument("--rounds", type=int, default=20,
                    help="rounds of the plan to time, from round 0")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("sparse_compare: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import driver
    from repro_torch.kernels import build, ref, sparse_gossip
    from repro_torch.launch import train
    build.build_all(("sparse_segment_mix",))
    mix = sparse_gossip.sparse_segment_mix

    spec = train.spec_from_args(train.build_parser().parse_args(
        cs.SAMPLED_ARGV))
    plan = sampled_plan(spec)
    tensors = driver.stage_plan(plan, device="cuda")
    n, D = spec.run.nodes, 784
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, D, device="cuda", generator=gen)
    per = {"ms": [], "library_ms": [], "plain_ms": [], "host_us": []}
    lost, edges = [], []
    for r in range(args.rounds):
        src, dst, w, seg, S = cs.round_arrays(torch, plan, tensors, r)
        layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
        A = cs.round_csr(torch, src, dst, w, seg, S, n)

        def kernel():
            return mix(x, *layout)

        def library():
            return torch.sparse.mm(A, x)

        times = []
        for fn in (kernel, library, library, kernel):
            times.append(cs.device_ms(torch, fn, 20))
            lost.append(cs.device_ms.lost)
        k1, l1, l2, k2 = times
        per["ms"].append((k1 + k2) / 2)
        per["library_ms"].append((l1 + l2) / 2)
        per["plain_ms"].append(cs.device_ms(
            torch, lambda: ref.sparse_gossip_mix_ref(seg, w, x[src], x[dst],
                                                     S), 5))
        per["host_us"].append(cs.host_us(torch, kernel, 200))
        edges.append(src.numel())
    res = {"src": args.src, **{k: sum(v) / len(v) for k, v in per.items()},
           "per_round_ms": per["ms"],
           "per_round_library_ms": per["library_ms"], "edges": edges,
           "lost": lost, "empty_sessions": cs.device_ms.empty_sessions}
    res["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
