"""Time the port's two attention kernels from one source tree, for
comparing two versions of them on one card.

    python3 examples/torch/attention_compare.py [--src DIR]

imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its attention kernels there, and prints one JSON line: each wrapper's host
microseconds per call (1,000 calls, ``chip_smoke.host_us``) and each
kernel's device milliseconds with its inputs cold in L2
(``chip_smoke.device_ms_cold``), at the qwen1.5-0.5b serve path's shapes
(``chip_smoke.FLASH_MAIN``, ``chip_smoke.DECODE_MAIN``, bf16).  To compare
an earlier commit with this one, unpack it with ``git archive`` into a
directory git ignores and run the two in turns in one process each:
earlier, this, this, earlier.  Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the directory that holds the repro_torch to time")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("attention_compare: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import (build, decode_attention,
                                     flash_attention)
    build.build_all(("flash_attention", "decode_attention"))
    fa, da = flash_attention.flash_attention, decode_attention.decode_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    B, S, H, hd = cs.FLASH_MAIN
    q, k, v = (torch.randn(B, S, H, hd, device="cuda", generator=gen
                           ).bfloat16() for _ in range(3))
    small = tuple(t[:, :128] for t in (q, k, v))
    res = {"src": args.src,
           "flash_host_us": cs.host_us(torch, lambda: fa(*small)),
           "flash_ms": cs.device_ms_cold(torch, fa, (q, k, v), 20)}
    B, C, J, G, hd = cs.DECODE_MAIN
    q = torch.randn(B, 1, J, G, hd, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(B, C, J, hd, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    kpos = torch.arange(C, device="cuda", dtype=torch.int32)
    res["decode_host_us"] = cs.host_us(torch, lambda: da(q, k, v, kpos, C - 1))
    res["decode_ms"] = cs.device_ms_cold(
        torch, lambda k_, v_: da(q, k_, v_, kpos, C - 1), (k, v), 100)
    res["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
