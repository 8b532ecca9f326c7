"""The readings a cell's limits are set from, on the chip, at the cell's size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--variants tf32,half_batch,no_mix]

For each seed: the plain reference's readings of the first steps in float32
(what the benchmark compares the program with), then those of each variant
put in the program's place, and each variant's numbers against the float32
reference, one JSON line a seed and variant.  ``tf32`` is the control, the
reference computed in the nearest precision below the configuration's;
``half_batch`` and ``no_mix`` are faults planted in the reference: each
node's oracle on half of its samples, and every gossip window left out.  A
state left unchanged reads 1 on ``change_gap`` by the comparison's measure
and needs no run.  The benchmark's own runs run none of this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(cell: dict, seed: int, variants, device: str = "cuda"):
    """Yield (variant, {number: value}, lines on where each gap comes
    from) for ``seed``."""
    import importlib

    import torch

    from portbench import compare, schedule, traffic as tr
    from portbench.kinds import decentralized_train as dt
    from portbench.reference import mcdsgt

    family = importlib.import_module(
        f"portbench.reference.{cell['config']['family']}")
    config, traffic = cell["config"], cell["traffic"]
    dev = torch.device(device)
    wps = mcdsgt.weights_per_step(traffic["R"])
    mats = schedule.windows(traffic["nodes"], traffic["schedule"]["beta"],
                            seed)
    pool = tr.make_pool(family, config, traffic, seed, dev)
    base = dt.reference_readings(family, config, traffic, seed, dev, pool,
                                 mats, wps)
    for v in variants:
        kw = ({"products": "tf32"} if v == "tf32" else {"fault": v})
        other = dt.reference_readings(family, config, traffic, seed, dev,
                                      pool, mats, wps, **kw)
        yield v, compare.gaps(other, base), compare.describe(other, base)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--variants", default="tf32,half_batch,no_mix")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench import run

    run._setup_paths()
    cell = run.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for v, gaps, where in readings(cell, seed, args.variants.split(",")):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": v, "gaps": gaps, "where": where,
                              "s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
