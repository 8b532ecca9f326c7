"""Compressed gossip under wireless mobility on the port: same convergence,
a fraction of the wire.  The twin of ``examples/compressed_gossip.py``.

The compression axis is one spec section: ``exp.sweep`` expands the base
wireless scenario (16 moving nodes, unit-disk links, 20% per-link drop,
non-iid Dirichlet data; the reference's spec) over ``compression.scheme``
in {none, sign, int8} and runs MC-DSGT with error feedback over each, on
the host runtime (one matrix product per round, the quantization padded to
the group).  The mobility model, channel repair, the error-feedback window
and the bytes/round telemetry printed here all come from
``repro_torch.exp.run``.  The minibatch indices come from a
``torch.Generator``, so the numbers differ from the reference's by
sampling; the wire volumes do not.

    PYTHONPATH=src python examples/torch/compressed_gossip.py [--device cpu]
"""

import argparse

from repro_torch import exp
from repro_torch.obs import Console

N = 16
T = 240                    # gossip/oracle budget per run
SCHEMES = exp.COMPRESSIONS  # ("none", "sign", "int8")

_BASE = exp.ExperimentSpec(
    model=exp.ModelRef(kind="logreg", d=64, m=256, rho=0.1),
    data=exp.DataSpec(batch=16, hetero_alpha=0.3),
    topology=exp.TopologySpec(kind="waypoint-mobility", radius=0.45),
    algorithm=exp.AlgorithmSpec(name="mc_dsgt", gamma=0.3, R=2),
    channel=exp.ChannelSpec(link_drop=0.2),
    compression=exp.CompressionSpec(warmup=4, group=64),
    run=exp.RunSpec(nodes=N),
)


def _specs() -> dict:
    steps = max(2, T // exp.weights_per_step(_BASE.algorithm))
    base = exp.with_overrides(_BASE, {
        "run.steps": steps, "run.eval_every": max(1, steps - 1)})
    return dict(zip(SCHEMES,
                    exp.sweep(base, {"compression.scheme": list(SCHEMES)})))


# the reference's CI spec-smoke pool
SPECS = {f"compressed_{s}": spec for s, spec in _specs().items()
         if s != "none"}


def main(argv=None, con: Console = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = con or Console(quiet=args.quiet)
    con.print(f"n={N}  waypoint mobility (radius=0.45)  20% link drop  "
              f"non-iid Dirichlet(0.3)  mc_dsgt R=2 + error feedback  "
              f"budget T={T}")
    results = {}
    for scheme, spec in _specs().items():
        res = exp.run(spec, device=args.device, quiet=True)
        telem = res.telemetry  # created by run(): mobility/compression
        grad_sq = float(res.history[-1][1])
        mb = telem.bytes_total / 1e6
        rc = res.built.realized["compression"]
        con.event("result", scheme=scheme, grad_sq=grad_sq, wire_mb=mb,
                  bytes_per_round=rc["bytes_per_round"],
                  consensus=telem.history[-1]["consensus"])
        results[scheme] = (grad_sq, mb)

    mb_none = results["none"][1]
    con.print("\nSame recipe, a fraction of the traffic: sign sends "
              f"{results['sign'][1] / mb_none:.1%} and int8 "
              f"{results['int8'][1] / mb_none:.1%} of the uncompressed "
              "volume, and the error-feedback residual keeps the quantized "
              "runs converging through the lossy, time-varying links.")
    assert results["sign"][1] < 0.2 * mb_none, \
        "sign compression should cut wire volume by >5x"
    assert results["int8"][1] < 0.5 * mb_none, \
        "int8 compression should cut wire volume by >2x"
    return results


if __name__ == "__main__":
    main()
