"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's Hopper kernels from
``src/repro_torch/kernels/csrc`` with nvcc, holds each against its plain
PyTorch version on the card, times it at the main path's shape beside its
bound, the plain version and one PyTorch library call, and then drives the
main path through the train CLI: MC-DSGT (R=2) on qwen1.5-0.5b at full width,
4 nodes stacked on the card, 3 steps through the ``gossip_mix`` kernel.  The
kernel's launch count over that run must be 2 per step.  It prints the
card, one JSON line of per-kernel numbers, and last
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero; so does a
machine without a CUDA device or a directory without the repository.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and float32
# outside the tensor cores (the kernel's FMA).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN = dict(n=4, R=2, D=463_987_712)   # qwen1.5-0.5b flat state, 4 nodes
STEPS = 3
MAIN_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "4",
             "--algo", "mc_dsgt", "--R", "2", "--gossip-impl", "pallas",
             "--steps", str(STEPS), "--device", "cuda"]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # rtol = atol, see check_kernel


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernel(torch, gossip_matmul, ref, gossip):
    """gossip_mix against its plain version over node counts, rounds, both
    dtypes, a ragged D (odd: the one-column path) and a D divisible by 4
    (the 16-byte path), and in place.  f32: rtol = atol = 1e-5 (sums of n
    products in another order); bf16: 1e-2 (one bf16 rounding of the
    output, 2^-8 relative, on values of order 1-4)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = 0
    for n in (4, 16, 64):
        for R in (1, 2, 4):
            ws = torch.from_numpy(gossip.theorem3_weight_schedule(
                n, 1 - 1 / n).stacked(0, R)).cuda()
            for D in (1_000_003, 1_000_004):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(n, D, device="cuda", generator=gen).to(dtype)
                    want = ref.gossip_mix_ref(ws, x)
                    got = gossip_matmul.gossip_mix(ws, x)
                    torch.cuda.synchronize()
                    tol = TOL[str(dtype).split(".")[1]]
                    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
                    if n == 4 and dtype == torch.float32:
                        gossip_matmul.gossip_mix(ws, x, out=x)  # in place
                        torch.cuda.synchronize()
                        torch.testing.assert_close(x, want, rtol=tol, atol=tol)
                    cases += 1
    print(f"kernel check: gossip_mix == plain on {cases} cases "
          f"(n 4/16/64, R 1/2/4, D 1,000,003/1,000,004, f32 rtol=atol="
          f"{TOL['float32']}, bf16 rtol=atol={TOL['bfloat16']}, in place)",
          flush=True)


def check_rows(torch, got, want, what: str) -> float:
    """``got`` against ``want`` at f32 rtol = atol = 1e-5, one row at a time
    (a whole-tensor comparison at the main shape would need several 7.4 GB
    temporaries); returns the largest absolute error."""
    torch.cuda.synchronize()
    tol = TOL["float32"]
    err = 0.0
    for i in range(got.shape[0]):
        torch.testing.assert_close(got[i], want[i], rtol=tol, atol=tol,
                                   msg=lambda m: f"{what}, row {i}: {m}")
        err = max(err, float((got[i] - want[i]).abs().max()))
    return err


def time_kernel(torch, gossip_matmul, ref, gossip) -> dict:
    """The kernel at the main path's shape, held to its plain version out of
    place and in place (the main path mixes in place), then timed beside its
    bound, the plain version and torch.linalg.multi_dot (the library
    yardstick)."""
    n, R, D = MAIN["n"], MAIN["R"], MAIN["D"]
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(n, 0.75)
                          .stacked(0, R)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, D, device="cuda", generator=gen)
    want = ref.gossip_mix_ref(ws, x)
    out = torch.empty_like(x)
    gossip_matmul.gossip_mix(ws, x, out=out)
    max_err = check_rows(torch, out, want, "main shape, out of place")
    x2 = x.clone()
    gossip_matmul.gossip_mix(ws, x2, out=x2)
    max_err = max(max_err, check_rows(torch, x2, want, "main shape, in place"))
    del want, x2
    rounds = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(2):   # alternate, so a drift in clocks hits all three
        rounds["ms"].append(timed(
            lambda: gossip_matmul.gossip_mix(ws, x, out=out), 10))
        rounds["plain_ms"].append(timed(lambda: ref.gossip_mix_ref(ws, x), 3))
        rounds["library_ms"].append(timed(
            lambda: torch.linalg.multi_dot([ws[1], ws[0], x]), 3))
    del x, out
    torch.cuda.empty_cache()
    nbytes = R * n * n * 4 + 2 * n * D * 4     # W once, X read, out written
    flops = 2 * R * n * n * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    res = {k: min(v) for k, v in rounds.items()}
    res.update(max_abs_err=max_err, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               shape=f"ws ({R},{n},{n}) f32, x ({n},{D}) f32")
    print(f"gossip_mix at {res['shape']}: == plain out of place and in place "
          f"(f32 rtol=atol={TOL['float32']}, row by row)", flush=True)
    print(f"gossip_mix at {res['shape']}: kernel {res['ms']:.4f} ms  plain "
          f"{res['plain_ms']:.4f} ms  multi_dot {res['library_ms']:.4f} ms  "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})  "
          f"max_abs_err {max_err:.3e}  rounds {rounds}", flush=True)
    return res


def check_small_run(torch, exp):
    """A reduced run on the card two ways: the fused kernel path against
    the dense path (one plain matmul per round).  Same init, same data."""
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "run.steps": 2, "run.nodes": 4, "algorithm.R": 2})
    fused = exp.run(exp.with_field(spec, "run.gossip_impl", "pallas"),
                    device="cuda", quiet=True)
    dense = exp.run(exp.with_field(spec, "run.gossip_impl", "dense"),
                    device="cuda", quiet=True)
    lf = [h["loss"] for h in fused.history]
    ld = [h["loss"] for h in dense.history]
    if not all(math.isfinite(v) for v in lf):
        fail(f"reduced run losses not finite: {lf}")
    torch.testing.assert_close(torch.tensor(lf), torch.tensor(ld),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fused.state.x, dense.state.x, rtol=1e-4,
                               atol=1e-5)
    print(f"reduced run on the card: pallas losses {lf} == dense {ld}",
          flush=True)


def profile_step(torch, exp, steps):
    """Where one full-width MC-DSGT step's device time goes: torch.profiler
    over one step after a warm-up step; device time summed by kernel."""
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "model.preset": "full", "run.nodes": 4, "algorithm.R": 2,
        "run.gossip_impl": "pallas"})
    built = exp.build(spec, device="cuda")
    init, warm, step = steps.make_train_step(
        built.model, built.cfg, algo="mc_dsgt", gamma=spec.algorithm.gamma,
        R=2, gossip_impl="pallas")
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = warm(init(built.model.init(gen, torch.float32, "cuda"), 4),
                 built.stream.batch_at(0))
    W = torch.from_numpy(built.schedule.stacked(0, built.wps)).cuda()
    state, _ = step(state, built.stream.batch_at(1), W)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, out = step(state, built.stream.batch_at(2), W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    mix = sum(ms for k, ms, _ in kernels if "gossip_mix" in k)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    print(f"profile of one step: wall {wall_ms:.3f} ms  device busy "
          f"{busy:.3f} ms (idle share {1 - busy / wall_ms:.4f})  gossip_mix "
          f"{mix:.3f} ms  top kernels (ms, calls): "
          + "; ".join(f"{k[:60]} {ms:.3f} x{c}" for k, ms, c in top),
          flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import exp
    from repro_torch.core import gossip
    from repro_torch.dist import steps
    from repro_torch.kernels import build, gossip_matmul, ref
    from repro_torch.launch import train

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source: {build.BUILD_SECONDS})", flush=True)

    check_kernel(torch, gossip_matmul, ref, gossip)
    kern = time_kernel(torch, gossip_matmul, ref, gossip)
    check_small_run(torch, exp)

    # the main path: counts from 0 just before it, read just after
    gossip_matmul.gossip_mix.launches = 0
    torch.cuda.reset_peak_memory_stats()
    history = train.main(MAIN_ARGV)
    launches = gossip_matmul.gossip_mix.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    if len(history) != STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["consensus"])
            for h in history):
        fail(f"main path history not {STEPS} finite steps: {history}")
    if launches != 2 * STEPS:
        fail(f"gossip_mix launched {launches} times over {STEPS} MC-DSGT "
             f"steps; the x and h windows need 2 per step")
    secs = [h["sec"] for h in history]
    print(f"main path: {' '.join(MAIN_ARGV)}", flush=True)
    print(f"main path: losses {losses}  step s {secs}  peak device memory "
          f"{peak_gb:.3f} GB  gossip_mix launches {launches}", flush=True)
    profile_step(torch, exp, steps)

    row = {"name": "gossip_mix", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
           "replaces": "src/repro/kernels/gossip_matmul.py:36",
           "launches": launches, "launches_per_step": launches / STEPS,
           "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
           "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
           "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
           "shape": kern["shape"]}
    print(json.dumps({"kernels": [row]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
