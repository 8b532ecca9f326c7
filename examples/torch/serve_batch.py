"""Batched serving on the port: train a small fleet, then continuously
batch decode on a reduced SSM model (a state-space decode is O(1) in the
context length), the twin of ``examples/serve_batch.py`` (the same flags,
plus ``--device``).

A reduced falcon-mamba-7b trained 3 MC-DSGT steps on 4 nodes, then 16
requests of 48 prompt and 16 new tokens on 8 slots, through
``repro_torch.launch.serve.main``.

    PYTHONPATH=src python examples/torch/serve_batch.py --arch falcon-mamba-7b [--device cpu]
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="falcon-mamba-7b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    args = ap.parse_args(argv)
    return serve_main(["--arch", args.arch, "--preset", "reduced",
                       "--nodes", "4", "--steps", "3",
                       "--requests", "16", "--serve-batch", str(args.batch),
                       "--prompt-len", "48", "--max-new", "16",
                       "--device", args.device])


if __name__ == "__main__":
    main()
