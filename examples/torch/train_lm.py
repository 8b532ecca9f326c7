"""End-to-end driver on the port: decentralized training of a transformer
LM with MC-DSGT over a time-varying sun-shaped network, the twin of
``examples/train_lm.py`` (the same flags, plus ``--device``), with a
checkpoint and, given ``--metrics``, the event log.

Default: the reduced qwen-family model, 8 nodes, 200 steps; pass
``--preset full`` for the ~0.5B config.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 200 [--device cpu]
"""

import argparse

from repro_torch.launch.train import main as train_main
from repro_torch.obs import Console


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--preset", default="reduced")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--checkpoint", default="experiments/lm_ckpt.msgpack")
    ap.add_argument("--metrics", default=None,
                    help="repro_torch.obs JSONL event-log path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)
    con = Console(quiet=args.quiet)

    flags = [
        "--arch", args.arch, "--preset", args.preset,
        "--steps", str(args.steps), "--nodes", str(args.nodes),
        "--beta", "0.875", "--topology", "sun", "--algo", "mc_dsgt",
        "--R", "2", "--gamma", "0.1", "--batch", "4", "--seq", "64",
        "--checkpoint", args.checkpoint, "--log-every", "10",
        "--device", args.device,
    ]
    if args.metrics:
        flags += ["--metrics", args.metrics]
    if args.quiet:
        flags += ["--quiet"]
    history = train_main(flags)
    first, last = history[0]["loss"], history[-1]["loss"]
    con.event("trained", loss_first=first, loss_last=last,
              steps=args.steps,
              improved=str(last < first).lower())
    return history


if __name__ == "__main__":
    main()
