"""Time the port's linear_recurrence kernel from one source tree, for
comparing two versions of it on one card.

    python3 examples/torch/linrec_compare.py [--src DIR]

imports ``repro_torch`` from DIR (default: this checkout's ``src``), builds
its ``linear_recurrence`` kernel there, checks it bit-equal to its plain
version, and prints one JSON line: the kernel's device milliseconds per
call (CUDA events over 20 back-to-back calls, the best of two rounds, as
``chip_smoke.time_lkernel`` times it) at falcon-mamba-7b's prefill
(``chip_smoke.LINREC_MAIN``, (1, 2048, 131072) f32) and recurrentgemma-2b's
rglru layer (``chip_smoke.LINREC_RG``, (1, 3968, 2560) f32), and the route
the tree picks where it has ``geometry_for``.  To compare an earlier commit
with this one, unpack it with ``git archive`` into a directory git ignores
and run the two in turns in one process each: earlier, this, this,
earlier.  Needs an NVIDIA GPU.

    python3 examples/torch/linrec_compare.py --sweep

times this checkout's kernel through its C entry point at other launch
geometries than ``launch_geometry`` picks, each checked bit-equal first:
at both shapes the loop and both ring fillers at every channel count and
stage count that fits, and at S = 3968 the wrapper's own geometry for C
from 160 to 5120 (a time that does not grow with C is the serial
chain's).
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
    ap.add_argument("--sweep", action="store_true",
                    help="time this checkout's kernel at other geometries")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        sys.exit("linrec_compare: torch finds no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.kernels import build, linear_recurrence as lr, ref
    build.build_all(("linear_recurrence",))
    if args.sweep:
        return sweep(torch, cs, lr, ref)

    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {"src": args.src}
    for name, (B, S, C) in (("falcon", cs.LINREC_MAIN),
                            ("recurrentgemma", cs.LINREC_RG)):
        a = torch.rand(B, S, C, device="cuda", generator=gen)
        b = torch.randn(B, S, C, device="cuda", generator=gen)
        got = lr.linear_recurrence(a, b)
        cs.lequal(torch, f"{name} shape", got, ref.linear_recurrence_ref(a, b))
        del got
        res[f"{name}_ms"] = min(
            cs.timed(lambda: lr.linear_recurrence(a, b), 20)
            for _ in range(2))
        if hasattr(lr, "geometry_for"):
            res[f"{name}_route"] = lr.geometry_for(a, b)["route"]
        del a, b
        torch.cuda.empty_cache()
    res["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(res), flush=True)
    return res


def launch(torch, lr, a, b, geometry):
    """One launch of the kernel at ``geometry`` (a launch_geometry dict)
    through the C entry point, bypassing the wrapper's choice."""
    B, S, C = a.shape
    h_all = torch.empty((B, S, C), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, C), dtype=torch.float32, device=a.device)
    err = lr._lib().linear_recurrence_launch(
        a.data_ptr(), b.data_ptr(), h_all.data_ptr(), h_last.data_ptr(), B,
        S, C, lr._DTYPES[a.dtype], lr._ROUTES[geometry["route"]],
        geometry["cb"], geometry["stages"], geometry["vec"],
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"linear_recurrence at {geometry}: cudaError {err}")
    return h_all, h_last


def sweep(torch, cs, lr, ref) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(7)
    res = {"geometries": [], "chain": []}
    for name, (B, S, C) in (("falcon", cs.LINREC_MAIN),
                            ("recurrentgemma", cs.LINREC_RG)):
        a = torch.rand(B, S, C, device="cuda", generator=gen)
        b = torch.randn(B, S, C, device="cuda", generator=gen)
        want = ref.linear_recurrence_ref(a, b)
        picked = lr.geometry_for(a, b)
        geos = [{"route": "loop", "vec": 1, "cb": lr.LOOP_THREADS,
                 "stages": 1}]
        for route in ("tma", "cp.async"):
            for cb in lr.CHANNELS:
                stage = lr.TILE_T * cb * (2 * 4 + 4)
                for stages in range(1, lr.MAX_STAGES + 1):
                    if 128 + stages * (stage + 24) <= lr.BLOCK_SMEM:
                        geos.append({"route": route, "vec": 4, "cb": cb,
                                     "stages": stages})
        for geo in geos:
            cs.lequal(torch, f"{name} at {geo}", launch(torch, lr, a, b, geo),
                      want)
            ms = min(cs.timed(lambda: launch(torch, lr, a, b, geo), 20)
                     for _ in range(2))
            picks = all(picked[k] == geo[k] for k in geo)
            res["geometries"].append({"shape": name, **geo, "ms": ms,
                                      "picked": picks})
            print(f"{name} {geo}: {ms:.4f} ms{'  (picked)' if picks else ''}",
                  flush=True)
        del a, b, want
        torch.cuda.empty_cache()
    S = cs.LINREC_RG[1]
    for C in (160, 640, 1280, 2560, 5120):
        a = torch.rand(1, S, C, device="cuda", generator=gen)
        b = torch.randn(1, S, C, device="cuda", generator=gen)
        ms = min(cs.timed(lambda: lr.linear_recurrence(a, b), 20)
                 for _ in range(2))
        geo = lr.geometry_for(a, b)
        res["chain"].append({"S": S, "C": C, "cb": geo["cb"],
                             "blocks": geo["grid"][0], "ms": ms,
                             "ns_per_step": ms * 1e6 / S})
        print(f"S {S} C {C}: {geo['grid'][0]} blocks of {geo['cb']}, "
              f"{ms:.4f} ms, {ms * 1e6 / S:.2f} ns a step", flush=True)
    res["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
