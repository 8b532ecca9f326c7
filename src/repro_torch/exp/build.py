"""Lowering: realize an :class:`ExperimentSpec` into runnable pieces, and
``run(spec)`` — the one entry point, the port of the JAX package's
``exp/build.py`` for the ``arch`` runtime.

``build(spec, device=...)`` resolves the spec's string-keyed fields through
:mod:`repro_torch.exp.registry` and materializes the weight schedule, the
update rule, the model and the token stream.  ``run`` trains.  The device
is a runtime argument, not a spec field, so a spec hashes the same in both
packages.  It defaults to ``"cuda"``; without a GPU that raises unless the
caller asked for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from .. import configs
from ..core import driver, engine
from ..data import token_stream_for
from ..dist import collectives as coll, steps as dsteps
from ..models import build as build_model
from . import registry
from .spec import ExperimentSpec


class Result(NamedTuple):
    """``history``: one dict per logged step (loss, consensus, sec)."""

    state: Any
    history: list
    spec: ExperimentSpec
    built: "Built" = None


@dataclasses.dataclass
class Built:
    """Everything ``build(spec)`` realized."""

    spec: ExperimentSpec
    rule: engine.UpdateRule
    wps: int
    schedule: Any                 # realized WeightSchedule
    device: torch.device
    cfg: Any = None
    model: Any = None
    stream: Any = None


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a GPU raises
    (never a quiet fall-back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "device; pass device='cpu' (--device cpu) to run "
                           "on the CPU")
    return dev


def _validate(spec: ExperimentSpec) -> None:
    """Every string-keyed field must name a registered entry (the
    reference's vocabulary, so the errors match)."""
    vocab = [("topology.kind", spec.topology.kind, registry.TOPOLOGIES),
             ("algorithm.name", spec.algorithm.name, registry.ALGORITHMS),
             ("algorithm.local_opt", spec.algorithm.local_opt,
              registry.LOCAL_OPTS),
             ("run.gossip_impl", spec.run.gossip_impl, registry.GOSSIP_IMPLS),
             ("model.kind", spec.model.kind, registry.MODEL_KINDS),
             ("compression.scheme", spec.compression.scheme,
              registry.COMPRESSIONS),
             ("obs.sink", spec.obs.sink, registry.SINKS),
             ("obs.bound", spec.obs.bound, registry.OBS_BOUNDS),
             ("serve.routing", spec.serve.routing, registry.ROUTING_POLICIES),
             ("serve.dtype", spec.serve.dtype, registry.SERVE_DTYPES)]
    for field, value, legal in vocab:
        if value not in legal:
            raise ValueError(f"{field}={value!r}: unknown "
                             f"(have {sorted(legal)})")
    c = spec.compression
    if c.group < 1:
        raise ValueError(f"compression.group={c.group}: must be >= 1")
    if c.warmup < 0:
        raise ValueError(f"compression.warmup={c.warmup}: must be >= 0")


def _check_ported(spec: ExperimentSpec) -> None:
    """Raise NotImplementedError, naming its ROADMAP.md Queue 1 item, for
    the first scenario axis the spec uses that the port does not run yet."""
    a, r, c = spec.algorithm, spec.run, spec.channel
    unported = [
        (spec.model.kind == "logreg", "model.kind='logreg'", 1),
        (a.local_opt != "sgd", f"algorithm.local_opt={a.local_opt!r}", 2),
        (r.gossip_impl == "auto", "run.gossip_impl='auto'", 3),
        (spec.obs.enabled, "obs (metrics / profile_dir)", 4),
        (r.telemetry is not None, "run.telemetry", 5),
        (any(getattr(c, f) > 0 for f in registry.CHANNELS),
         "channel faults", 5),
        (a.delay != 0 or a.comm_interval != 1,
         "algorithm.delay / comm_interval", 7),
        (spec.data.hetero_alpha is not None, "data.hetero_alpha", 9),
        (bool(r.checkpoint or r.restore), "run.checkpoint / restore", 10),
        (spec.serve.enabled, "serve", 11),
    ]
    for used, what, item in unported:
        if used:
            raise NotImplementedError(f"{what} is not ported yet "
                                      f"(ROADMAP.md Queue 1 item {item})")


def build(spec: ExperimentSpec, *, device="cuda") -> Built:
    """Realize ``spec`` for the ``arch`` runtime on ``device``."""
    _validate(spec)
    _check_ported(spec)
    dev = resolve_device(device)
    rs, al = spec.run, spec.algorithm
    n = rs.nodes
    # R is mc_dsgt's knob; every other rule is defined at R=1
    R = al.R if al.name == "mc_dsgt" else 1
    rule = engine.make_rule(al.name, gamma=al.gamma, R=R,
                            compression=registry.build_compression(
                                spec.compression))
    wps = rule.weights_per_step
    # horizon only matters for the non-periodic schedules (resampled matching)
    horizon = (rs.steps + 1) * wps * 4
    sched = registry.build_topology(spec.topology, n, horizon=horizon,
                                    seed=rs.seed)
    cfg = configs.get(spec.model.arch)
    if spec.model.preset == "reduced":
        cfg = cfg.reduced()
    model = build_model(cfg)
    stream = token_stream_for(cfg, n, R, spec.data.batch, spec.data.seq,
                              seed=rs.seed, active_vocab=spec.data.active_vocab,
                              device=dev)
    return Built(spec=spec, rule=rule, wps=wps, schedule=sched, device=dev,
                 cfg=cfg, model=model, stream=stream)


def run(spec: ExperimentSpec, *, device="cuda", quiet: bool = False) -> Result:
    """Build and train ``spec`` end to end on ``device``.  Float32 matrix
    products run in full f32 (TF32 off), as the reference's numerics need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return _run_arch(build(spec, device=device), quiet=quiet)


def _run_arch(built: Built, *, quiet: bool = False) -> Result:
    spec, rs, dev = built.spec, built.spec.run, built.device
    init_state, warm_start, train_step = dsteps.make_train_step(
        built.model, built.cfg, algo=spec.algorithm.name,
        gamma=spec.algorithm.gamma, R=built.rule.R, gossip_impl=rs.gossip_impl,
        compression=built.rule.compression)
    gen = torch.Generator(device=dev).manual_seed(rs.seed)
    state = init_state(built.model.init(gen, torch.float32, dev), rs.nodes)
    state, start_step = driver.restore_or_warm(
        state, restore=rs.restore,
        warm=lambda s: warm_start(s, built.stream.batch_at(0)))

    # the whole period's gossip stack crosses to the device once
    staged = driver.stage(built.schedule, wps=built.wps, device=dev)
    step_fn = driver.bind_step(
        staged, lambda state, batch, W, t: train_step(state, batch, W))

    def record(k, t, state, out, dt):
        if k % rs.log_every != 0:
            return None
        loss = float(out["loss"])
        ce = coll.consensus_distance(state.x)
        if not quiet:
            print(f"step {k:5d}  T={t:6d}  loss {loss:.4f}  "
                  f"consensus {ce:.3e}  {dt:.2f}s", flush=True)
        return {"step": k, "loss": loss, "consensus": ce, "sec": dt}

    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    state, history = driver.run_loop(
        step_fn, state, steps=rs.steps, wps=built.wps, period=staged.period,
        start_step=start_step,
        extra_fn=lambda k: built.stream.batch_at(k + 1), record=record,
        sync=sync)
    return Result(state=state, history=history, spec=spec, built=built)
