"""A training cell: ``repro_torch``'s decentralized training step, timed.

Set-up builds the one training step the window runs, as the program's own
trainer (``exp/build.py``'s ``_run_arch``) builds it: the rule, its oracle
and its gossip from :func:`repro_torch.dist.steps.make_train_step`, the
windows staged on the device once and bound to the step by
:func:`repro_torch.core.driver.stage` and :func:`~repro_torch.core.driver.
bind_step`, the state from ``init_state`` and ``warm_start``.  The weights,
the batches and the windows are the benchmark's, made from the seed.  Set-up
then drives that step through its first ``SETUP_STEPS`` steps, each on rows
of its own, and reads what the comparison needs of them before the window
overwrites it; these steps also warm every shape the window uses.

The window runs the same step on the pool's batches in turn until
``seconds`` have passed, with no host sync inside it but the traced steps'.
Once it has closed and the peak memory has been read, the program's state
is freed and the plain reference follows the first steps from the same
inputs (:mod:`portbench.reference.mcdsgt`).
"""

from __future__ import annotations

import contextlib
import gc
import math
import sys
import time

import numpy as np
import torch

from portbench import compare, devtrace, schedule, traffic as tr, weights
from portbench.reference import mcdsgt, precision

SETUP_STEPS = 2
TRACED_STEPS = 2


class _Windows:
    """The cell's schedule as the program's ``driver.stage`` takes it."""

    def __init__(self, mats: np.ndarray):
        self.mats = mats
        self.period = mats.shape[0]

    def stacked(self, t0: int, rounds: int, dtype=np.float32) -> np.ndarray:
        return schedule.window_at(self.mats, t0, rounds).astype(dtype)


def _log(t_start: float, what: str) -> None:
    print(f"[{time.perf_counter() - t_start:8.2f} s] {what}", file=sys.stderr,
          flush=True)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _flat_norms(mat, entries, n) -> dict:
    """{(path, layer): (n,) norms} of the (n, D) flat ``mat``, one entry a
    layer of each stacked leaf, read through the program's layout."""
    out = {}
    for path, shape, off in entries:
        key = "/".join(path)
        view = mat[:, off:off + math.prod(shape)]
        if path[0] in ("units", "enc", "dec"):
            per = torch.linalg.vector_norm(view.reshape(n, shape[0], -1),
                                           dim=-1).double().cpu()
            out.update({(key, l): per[:, l] for l in range(shape[0])})
        else:
            out[(key, None)] = torch.linalg.vector_norm(
                view, dim=1).double().cpu()
    return out


def _change_norms(x, entries, params, n) -> dict:
    out = {}
    for path, shape, off in entries:
        key = "/".join(path)
        d = x[:, off:off + math.prod(shape)].view((n,) + shape) \
            - params[key][None]
        if path[0] in ("units", "enc", "dec"):
            per = torch.linalg.vector_norm(d.reshape(n, shape[0], -1),
                                           dim=-1).double().cpu()
            out.update({(key, l): per[:, l] for l in range(shape[0])})
        else:
            out[(key, None)] = torch.linalg.vector_norm(
                d.reshape(n, -1), dim=1).double().cpu()
        del d
    return out


def _res_norms(res, entries, n) -> dict:
    out = {}
    for stream, mat in zip(("res_x", "res_h"), res):
        for path, shape, off in entries:
            out[(stream, "/".join(path))] = torch.linalg.vector_norm(
                mat[:, off:off + math.prod(shape)], dim=1).double().cpu()
    return out


def cell_info(family, config: dict, traffic: dict, D: int) -> dict:
    """The sizes the per-layer readers count work from: the state's n, D
    and R, its entries' bytes in the configuration's dtype (the residuals
    are kept in it too), and the model FLOPs of a step."""
    comp = traffic.get("compression")
    x_bytes = getattr(torch, config["training_dtype"]).itemsize
    return {"n": traffic["nodes"], "R": traffic["R"], "D": D,
            "x_bytes": x_bytes, "res_bytes": x_bytes, "compression": comp,
            "precision": config["training_dtype"],
            "model_flops_per_step": traffic["nodes"] * traffic["R"]
            * family.model_flops(config, traffic["batch"], traffic["seq"])}


def run(family, config: dict, traffic: dict, limits: dict, *, seed: int,
        seconds: float, trace: bool, device, t_start: float,
        plant=None) -> dict:
    """One run of the cell.  ``plant`` (tests only) wraps the bound step,
    ``plant(step_fn) -> step_fn``, to break the timed path underneath."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core import compress, driver, engine
    from repro_torch.dist import steps as dsteps
    from repro_torch.models import build

    dev = torch.device(device)
    if config["training_dtype"] != "float32":
        raise ValueError("the plain reference computes in float32, not "
                         f"{config['training_dtype']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, R, P = traffic["nodes"], traffic["R"], traffic["pool"]
    spec = family.param_spec(config)
    comp = traffic.get("compression")
    ccfg = compress.CompressionConfig(**comp) if comp else None
    cfg = ModelConfig(**family.port_fields(config))
    model = build(cfg)
    init_state, warm_start, train_step = dsteps.make_train_step(
        model, cfg, algo=traffic["algorithm"], gamma=traffic["gamma"], R=R,
        gossip_impl=traffic["gossip_impl"], clip=traffic["clip"],
        compression=ccfg)
    wps = engine.make_rule(traffic["algorithm"], gamma=traffic["gamma"],
                           R=R, compression=ccfg).weights_per_step
    if traffic["algorithm"] != "mc_dsgt" or wps != mcdsgt.weights_per_step(R):
        raise ValueError("the reference follows MC-DSGT's 2R rounds a step")
    layout = dsteps.flat_layout(model, ccfg)
    entries = layout.entries
    mats = schedule.windows(n, traffic["schedule"]["beta"], seed)
    staged = driver.stage(_Windows(mats), wps=wps, device=dev)
    step_fn = driver.bind_step(
        staged, lambda state, batch, W, t: train_step(state, batch, W))
    if plant is not None:
        step_fn = plant(step_fn)
    pool = tr.make_pool(family, config, traffic, seed, dev)
    _log(t_start, "step built, windows staged, batches drawn")

    params = weights.draw(spec, seed, dev)
    state = init_state(weights.nested(params), n)
    del params
    if state.x.dtype != getattr(torch, config["training_dtype"]):
        raise ValueError(f"the program holds its state in {state.x.dtype}, "
                         f"not the configuration's {config['training_dtype']}")
    _sync(dev)
    _log(t_start, "weights drawn, state made")
    state = warm_start(state, pool[0])
    _sync(dev)
    _log(t_start, "warm start done")
    prog = {"loss": []}
    t, t_steps = 0, []
    for k in range(1, SETUP_STEPS + 1):
        _sync(dev)
        t0 = time.perf_counter()
        state, out = step_fn(state, pool[k % P], t)
        prog["loss"].append(float(out["loss"]))
        t_steps.append(time.perf_counter() - t0)
        _log(t_start, f"set-up step {k}: loss {prog['loss'][-1]!r}, "
             f"{t_steps[-1]:.4f} s")
        t += wps
        if k == 1:
            prog["grad"] = _flat_norms(state.g_prev, entries, n)
            prog["tracker"] = _flat_norms(state.h, entries, n)
            if state.res is not None:
                prog["res"] = _res_norms(state.res, entries, n)
    x0 = weights.draw(spec, seed, dev)
    prog["change"] = _change_norms(state.x, entries, x0, n)
    del x0
    _sync(dev)
    setup_s = time.perf_counter() - t_start

    # ---- the window ----
    k, losses, prof = 0, [], None
    step_est = min(t_steps)
    t0 = time.perf_counter()
    while True:
        if trace and prof is None and (
                time.perf_counter() - t0 + TRACED_STEPS * step_est
                >= seconds):
            _sync(dev)
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
            window_range = torch.profiler.record_function(devtrace.WINDOW)
            window_range.__enter__()
            traced = 0
        rng = (torch.profiler.record_function(devtrace.STEP) if prof
               else contextlib.nullcontext())
        with rng:
            state, out = step_fn(state, pool[(SETUP_STEPS + 1 + k) % P], t)
        losses.append(out["loss"])
        t += wps
        k += 1
        if prof is not None:
            traced += 1
            if traced == TRACED_STEPS:
                _sync(dev)
                window_range.__exit__(None, None, None)
                break
        elif not trace and time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    elapsed = time.perf_counter() - t0
    _log(t_start, f"window: {k} steps in {elapsed:.4f} s")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    summary = None
    if prof is not None:
        prof.__exit__(None, None, None)
        summary = devtrace.summarize(devtrace.events(prof))
        del prof
        _log(t_start, "profile read")

    # ---- the reference, on the program's inputs, after the window ----
    del state, out, step_fn, staged, losses
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_readings(family, config, traffic, seed, dev, pool, mats,
                             wps)
    _log(t_start, "reference done")
    for line in compare.describe(prog, ref):
        print(line, file=sys.stderr)
    values = compare.gaps(prog, ref)
    correct, checks = compare.verdict(values, limits)
    tokens = tr.tokens_per_step(traffic)
    return {
        "correct": correct and failed == 0, "attempted": k,
        "failed": failed, "checks": checks, "trace": summary,
        "cell": cell_info(family, config, traffic, layout.size),
        "end_to_end": {"tokens_per_s": k * tokens / elapsed,
                       "peak_mem_gb": peak / 1e9, "setup_s": setup_s},
        "peak_bytes": peak,
    }


def reference_readings(family, config, traffic, seed, dev, pool, mats, wps,
                       *, products="float32", fault=None) -> dict:
    """The plain reference's readings of the first steps, from the seed's
    weights, the pool's batches and the schedule's windows."""
    spec = family.param_spec(config)
    n, R, P = traffic["nodes"], traffic["R"], traffic["pool"]
    with precision.products(products):
        rule = mcdsgt.MCDSGT(lambda get, b: family.loss(get, config, b),
                             spec, n=n, R=R, gamma=traffic["gamma"],
                             clip=traffic["clip"],
                             compression=traffic.get("compression"),
                             fault=fault)
        params = weights.draw(spec, seed, dev)
        st = rule.init(params)
        rule.warm_start(st, pool[0])
        ref = {"loss": []}
        t = 0
        for k in range(1, SETUP_STEPS + 1):
            Ws = torch.from_numpy(schedule.window_at(mats, t, wps)).to(dev)
            ref["loss"].append(rule.step(st, pool[k % P], Ws))
            t += wps
            if k == 1:
                ref["grad"] = mcdsgt.norms(st["g_prev"], rule.views, n)
                ref["tracker"] = mcdsgt.norms(st["h"], rule.views, n)
                if "res_x" in st:
                    ref["res"] = {
                        (s, p): v for s in ("res_x", "res_h")
                        for (p, _), v in mcdsgt.padded_norms(
                            st[s], spec, n).items()}
        ref["change"] = mcdsgt.norms(st["x"], rule.views, n, sub=params)
    del st, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref
