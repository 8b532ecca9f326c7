"""Where the time of quantized_gossip_mix's ring route goes, on the card.

    python3 examples/torch/qgossip_profile.py [--shape N GROUP D] [--reps 10]

The card's profilers that split a kernel's time (ncu, nsys) do not run on
the machine with the card, so this script takes the kernel apart itself,
from edited copies of ``src/repro_torch/kernels/csrc/quantized_gossip_mix.cu``
built beside the port's own build (``build/qgossip_profile/``, git-ignored):

* phases: every block's thread 0 reads ``clock64()`` at the ring's phase
  boundaries and the script prints each phase's cycles a block (summed over
  tiles, averaged over blocks) and share.  Thread 0 is one warp's view: a
  phase's cycles hold the waits of that warp, and the issue slots the SM
  gave the other warps meanwhile.
* ablations: the kernel timed (CUDA events, mean of --reps launches, int8,
  error feedback, R = 2, in place) with one part cut out at a time, the
  base first and last; the cut kernels' results are wrong by design (each
  still sends and awaits every partial, so none hangs).

Each edit names the source text it replaces and fails if the text is gone,
so a change to the kernel shows here as an error, not as a wrong profile.
By default the shape is whisper-tiny's 32-node state (n = 32, group 512, D
= 36,448,768, f32).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "src"))

OUT = ROOT / "build" / "qgossip_profile"
PHASES = ("wait_full", "stage_read", "buf_reduce_send", "exchange_wait",
          "refill", "scales", "quantize", "barrier", "mix", "store")


def mark(i: int) -> str:
    return (f"if (t == 0) {{ const long long now_ = clock64(); "
            f"prof_[{i}] += now_ - tp_; tp_ = now_; }}\n")


# (source text, replacement) edits that put a phase mark after (or before)
# each boundary of the ring kernel's tile loop
PHASE_EDITS = [
    ("namespace {\n\nconstexpr int kThreads = 256;",
     "__device__ unsigned long long g_prof[16];\n"
     "namespace {\n\nconstexpr int kThreads = 256;"),
    ("  for (long long k = 0; k < my_tiles; ++k) {\n"
     "    const int s = (int)(k % a.stages);",
     "  long long prof_[16] = {0}; long long tp_ = clock64();\n"
     "  for (long long k = 0; k < my_tiles; ++k) {\n"
     "    const int s = (int)(k % a.stages);"),
    ("    mbar_wait(&sm.full[s], (uint32_t)((k / a.stages) & 1));\n",
     "    mbar_wait(&sm.full[s], (uint32_t)((k / a.stages) & 1));\n"
     + mark(0)),
    ("    for (int r = 0; r < a.R; ++r, ++q) {\n",
     mark(1) + "    for (int r = 0; r < a.R; ++r, ++q) {\n"),
    ("      if (t == 0) mbar_arrive_expect_tx(&sm.xbar[q & 1], xbytes);\n",
     mark(2) + "      if (t == 0) mbar_arrive_expect_tx(&sm.xbar[q & 1], "
     "xbytes);\n"),
    ("      mbar_wait(&sm.xbar[q & 1], (q >> 1) & 1);\n",
     "      mbar_wait(&sm.xbar[q & 1], (q >> 1) & 1);\n" + mark(3)),
    ("      // quantize -> dequantize (the error into rr), deq into the "
     "buffer\n",
     mark(4) + "      // quantize -> dequantize (the error into rr), deq into "
     "the buffer\n"),
    ("        __syncwarp();\n      }\n",
     "        __syncwarp();\n      }\n" + mark(5)),
    ("      __syncthreads();\n      // x = W_r @ deq\n",
     mark(6) + "      __syncthreads();\n" + mark(7) + "      // x = W_r @ "
     "deq\n"),
    ("    // store the unit's rows of x and res, once\n",
     mark(8) + "    // store the unit's rows of x and res, once\n"),
    ("  // nothing is in flight: every filled stage was waited on, and every",
     "  if (t == 0) { for (int i_ = 0; i_ < 16; ++i_) "
     "atomicAdd(&g_prof[i_], (unsigned long long)prof_[i_]); "
     "atomicAdd(&g_prof[15], 1ull); }\n"
     "  // nothing is in flight: every filled stage was waited on, and every"),
]
PHASE_TAIL = (
    '\nextern "C" int prof_read(unsigned long long* o) { return (int)'
    "cudaMemcpyFromSymbol(o, g_prof, sizeof(g_prof)); }\n"
    'extern "C" int prof_reset() { unsigned long long z[16] = {0}; return '
    "(int)cudaMemcpyToSymbol(g_prof, z, sizeof(z)); }\n")
# the store phase ends where the tile loop goes round
STORE_END = ("          }\n        }\n      }\n    }\n  }\n  if (t == 0) { "
             "for (int i_")

MIX = "          ring_mix<true>(wt + ui0[v], wb + uc0[v], n, a.n4, cols, xr[v]);"
ABLATIONS = {
    "no mix": [(MIX, "          (void)0;")],
    "no element division": [
        ("const float d = dequant<SCHEME>(b, sc[c]);",
         "const float d = b * sc[c];")],
    "no scales": [
        ("                ring_scale<SCHEME>(ex_slot + ui0[v] + k, n, csize, "
         "count);", "                ex_slot[ui0[v] + k];")],
    "no butterfly": [
        ("#pragma unroll\n          for (int p = 0; p < 4; ++p)\n"
         "            for (int off = CG >> 1; off > 0; off >>= 1)\n"
         "              pr[p] = combine<SCHEME>(\n"
         "                  pr[p], __shfl_xor_sync(0xffffffffu, pr[p], off));"
         "\n", "")],
    "exchange with self only": [
        ("for (int li = lane & (CG - 1); li < 4 * csize; li += CG) {\n"
         "            const int p = li & 3, rk = li >> 2;",
         "for (int li = lane & (CG - 1); li < 4; li += CG) {\n"
         "            const int p = li & 3, rk = rank;"),
        ("const uint32_t xbytes = (uint32_t)sm.exch_floats * 4u;",
         "const uint32_t xbytes = (uint32_t)n * segs * 4u;"),
        ("ring_scale<SCHEME>(ex_slot + ui0[v] + k, n, csize, count)",
         "ring_scale<SCHEME>(ex_slot + ui0[v] + k, n, 1, count)")],
    "no stores": [
        ("        const long long g = (long long)(ui0[v] + p) * a.D + col0 "
         "+ uc0[v];",
         "        if (a.D > 0) continue;\n        const long long g = "
         "(long long)(ui0[v] + p) * a.D + col0 + uc0[v];")],
}


def edited(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"qgossip_profile: the kernel source no longer "
                             f"has {old[:70]!r}: update the edit")
        src = src.replace(old, new, 1)
    return src


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", type=int, nargs=3,
                    default=(32, 512, 36_448_768),
                    metavar=("N", "GROUP", "D"))
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args(argv)

    import torch
    from repro_torch.core import gossip
    from repro_torch.kernels import build, quantized_gossip as qg
    if not torch.cuda.is_available():
        raise SystemExit("qgossip_profile: no CUDA device")
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "hopper_common.cuh").write_text(
        (build.CSRC / "hopper_common.cuh").read_text())
    base = (build.CSRC / "quantized_gossip_mix.cu").read_text()
    phase_src = edited(base, PHASE_EDITS + [(STORE_END, STORE_END.replace(
        "  }\n  if (t == 0) { for (int i_",
        mark(9) + "  }\n  if (t == 0) { for (int i_"))]) + PHASE_TAIL
    sources = {"base": base, "phases": phase_src}
    sources.update({k: edited(base, v) for k, v in ABLATIONS.items()})
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        (OUT / f"v{i}.cu").write_text(src)
        procs[name] = (i, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"libv{i}.so"),
             str(OUT / f"v{i}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"qgossip_profile: nvcc failed for {name}:\n"
                             f"{out[-3000:]}")
        libs[name] = ctypes.CDLL(str(OUT / f"libv{i}.so"))

    n, group, D = args.shape
    R = 2
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(
        n, 1 - 1 / n).stacked(0, R)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(n, D, device="cuda", generator=gen)
    res = 0.1 * torch.randn(n, D, device="cuda", generator=gen)
    kw = dict(scheme="int8", group=group, error_feedback=True)
    geo = qg.launch_geometry(n, group, D, R)
    if geo["route"] != "ring":
        raise SystemExit(f"qgossip_profile: {args.shape} takes the "
                         f"{geo['route']} route, not the ring")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{smi}; shape n={n} group={group} D={D} f32, int8, EF on, R=2; "
          f"geometry {geo}", flush=True)
    real_load = build.load

    def run(name):
        build.load = lambda stem: libs[name]
        try:
            return qg.quantized_gossip_mix(ws, x, res, out=x, res_out=res,
                                           **kw)
        finally:
            build.load = real_load

    def timed(name):
        run(name)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            run(name)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.reps

    lib = libs["phases"]
    run("phases")
    torch.cuda.synchronize()
    lib.prof_reset()
    ms = timed("phases")
    buf = (ctypes.c_ulonglong * 16)()
    lib.prof_read(buf)
    blocks = buf[15] / (args.reps + 1)
    total = sum(buf[i] for i in range(len(PHASES)))
    print(f"phases (thread 0 of each of {blocks:.0f} blocks; instrumented "
          f"kernel {ms:.3f} ms):", flush=True)
    for i, name in enumerate(PHASES):
        print(f"  {name:16s} {buf[i] / blocks / (args.reps + 1) / 1e3:10.1f}"
              f" kcycles a block a launch  {100 * buf[i] / total:5.1f}%",
              flush=True)
    order = ["base", *ABLATIONS, "base"]
    print("ablations (ms a launch, mean of --reps):", flush=True)
    for name in order:
        print(f"  {name:24s} {timed(name):.3f}", flush=True)


if __name__ == "__main__":
    main()
