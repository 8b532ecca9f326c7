"""Time the port's gossip_mix kernel from one source tree, for comparing two
versions of it on one card.

    python3 examples/torch/gossip_compare.py [--src DIR]

imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its ``gossip_mix`` kernel there, holds it to its plain version row by row
(f32 rtol = atol = 1e-5, ``chip_smoke.check_rows``), and prints one JSON
line: the kernel's device milliseconds per call (CUDA events over 10
back-to-back calls, the best of two rounds, as ``chip_smoke.time_kernel``
times it) at the main path's shape (n = 4, R = 2, qwen1.5-0.5b's D =
463,987,712), whisper-tiny's 32-node f32 shape (n = 32, D = 36,448,128)
and n = 128 at the same bytes (D = 9,112,064), each with its route where
the tree's ``launch_geometry`` gives one; a shape the tree's kernel refuses is
reported as refused.  To compare an earlier commit with this one, unpack
it with ``git archive`` into a directory git ignores and run the two in
turns in one process each: earlier, this, this, earlier.  Needs an NVIDIA
GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = (("main", 4, 463_987_712), ("whisper32", 32, 36_448_128),
          ("n128", 128, 9_112_064))
R = 2


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def inputs(torch, gossip, n, D, seed=1):
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(
        n, 0.75 if n == 4 else 1 - 1 / n).stacked(0, R)).cuda()
    x = torch.randn(n, D, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed))
    return ws, x


def held(torch, cs, ref, fn, ws, x, what):
    """``fn(out)`` writes the mix of x into out: held to the plain version
    row by row, out of place; returns the largest absolute error."""
    want = ref.gossip_mix_ref(ws, x)
    out = torch.empty_like(x)
    fn(out)
    err = cs.check_rows(torch, out, want, what)
    del want, out
    torch.cuda.empty_cache()
    return err


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("gossip_compare: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.core import gossip
    from repro_torch.kernels import build, gossip_matmul as gm, ref
    build.build_all(("gossip_mix",))
    res = {"src": args.src}
    for name, n, D in SHAPES:
        ws, x = inputs(torch, gossip, n, D)
        out = torch.empty_like(x)
        try:
            res[f"{name}_err"] = held(
                torch, cs, ref, lambda o: gm.gossip_mix(ws, x, out=o), ws, x,
                f"{name} shape")
        except ValueError as e:
            res[f"{name}_ms"] = f"refused: {e}"
            continue
        res[f"{name}_ms"] = min(
            cs.timed(lambda: gm.gossip_mix(ws, x, out=out), 10)
            for _ in range(2))
        res[f"{name}_multi_dot_ms"] = min(
            cs.timed(lambda: torch.linalg.multi_dot([*ws.flip(0), x]), 3)
            for _ in range(2))
        geo = gm.launch_geometry(n, D, R) if hasattr(
            gm, "launch_geometry") else {}
        if "route" in geo or "wp" in geo:
            res[f"{name}_route"] = geo.get(
                "route", "warp walk" if geo.get("wp") else "block walk")
        del ws, x, out
        torch.cuda.empty_cache()
    res["device"] = smi()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
