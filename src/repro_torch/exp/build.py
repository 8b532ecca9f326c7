"""Lowering: realize an :class:`ExperimentSpec` into runnable pieces, and
``run(spec)`` — the one entry point, the port of the JAX package's
``exp/build.py``.

``build(spec, device=...)`` resolves the spec's string-keyed fields through
:mod:`repro_torch.exp.registry` and materializes the realized scenario (the
post-fault weight schedule, the update rule, the edge plan and its
telemetry recorder) and the pieces of the runtime ``model.kind`` selects:

* ``arch``   — a registered architecture of any family
  :func:`repro_torch.models.build` runs (dense, mamba, the RG-LRU hybrid,
  MoE, the VLM backbone with its ``prefix_embeds``) trained by
  :func:`repro_torch.dist.steps.make_train_step` on the driver's loop (what
  ``launch/train.py`` runs), ``use_pallas`` off as in the reference: no
  kernel has a backward;
* ``logreg`` — the host runtime: the paper's §6 non-convex logistic
  regression driven by :func:`repro_torch.core.driver.run_algorithm`, on
  the dense topologies (one matrix product per round, or with
  ``gossip_impl='auto'`` each round of the gossip plan through its
  structured lowering) and on the sampled-client ``random-sampled`` family
  (an edge plan), with or without compression, on the 80/20 or the
  Dirichlet partition.

Channel faults degrade the ideal schedule and repair it into the realized
one that both runtimes mix over (the dense ``realize_weight_schedule``, or
the edge-list realization for the sampled family), and every rule takes
the stale window (``algorithm.delay``) and the mixing cadence
(``algorithm.comm_interval``), as in the reference.

Every rule of the reference runs on both runtimes, with its local
optimizer (``algorithm.local_opt``): the gossip plan is built here with
the spec's pods and the rule's personalized flag, as in the reference.

Observability (``spec.obs``, :mod:`repro_torch.obs`) and checkpoints
(``run.checkpoint`` / ``run.restore``, the arch runtime,
:mod:`repro_torch.checkpoint`) are the reference's: the in-step scalars
into a JSONL event log through an :class:`~repro_torch.obs.metrics.
ObsRecorder` chained in front of the telemetry recorder, phase spans, the
optimality gap of the spec's cell, an opt-in ``torch.profiler`` trace, and
checkpoints in the reference's file format (one written by either package
restores in the other).

``run`` writes the reproducibility manifest next to the telemetry file and
the event log when the spec names them (next to the checkpoint after the
restore check), trains, then, when ``spec.serve`` enables it, serves the
first ``serve.fleet`` trained node models with continuous batching
(:func:`repro_torch.serve.serve_fleet`, what ``launch/serve.py`` runs).
The device is a runtime argument, not a spec field, so a spec hashes the
same in both packages.  It defaults to ``"cuda"``; without a GPU that
raises unless the caller asked for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, NamedTuple, Optional

import torch

from .. import configs, tree
from ..core import algorithms as alg, compress, driver, engine, gossip
from ..data import (logreg_dataset, logreg_dataset_dirichlet,
                    logreg_loss_and_grad, token_stream_for)
from ..dist import collectives as coll, steps as dsteps
from ..models import build as build_model
from ..obs import console as obs_console, metrics as obs_metrics, \
    optimality as obs_optimality, trace as obs_trace
from ..sim import faults as sim_faults, telemetry as sim_telemetry
from . import manifest as mf, registry
from .spec import ExperimentSpec


class Result(NamedTuple):
    """``history``: one dict per logged step (loss, consensus, sec) for
    ``arch``; ``(T, eval)`` pairs for ``logreg``.  ``built`` is the realized
    scenario; ``telemetry`` the mixing-telemetry recorder when the scenario
    has one (faults, mobility, the edge-list family, compression, a delay,
    or ``run.telemetry`` set).
    ``serve`` is the :class:`repro_torch.serve.ServeResult` of the
    post-training serve phase when ``spec.serve`` enables one, else
    None."""

    state: Any
    history: list
    spec: ExperimentSpec
    built: "Built" = None
    telemetry: Any = None
    serve: Any = None


@dataclasses.dataclass
class Built:
    """Everything ``build(spec)`` realized.  Scenario pieces (rule, schedule,
    plan, faults, telemetry) for every model kind; ``cfg``/``model``/
    ``stream`` only for ``arch``; ``grad_fn``/``eval_fn``/``x0`` only for
    ``logreg``.  ``seconds`` times the host's realization phases; ``obs``,
    ``obs_names`` and ``tracer`` are the spec's observability bundle when
    ``spec.obs`` enables it."""

    spec: ExperimentSpec
    rule: engine.UpdateRule
    wps: int
    schedule: Any                 # realized WeightSchedule (post-fault)
    device: torch.device
    horizon: int = 0
    plan: Any = None              # GossipPlan | edge plan (auto) | None
    local_opt: Any = None         # repro_torch.optim.Optimizer | None
    telemetry: Any = None
    cfg: Any = None
    model: Any = None
    stream: Any = None
    grad_fn: Any = None
    eval_fn: Any = None
    x0: Any = None
    state_dim: Optional[int] = None   # per-node state entries (when known)
    seconds: dict = dataclasses.field(default_factory=dict)
    obs: Optional[obs_metrics.ObsRecorder] = None
    obs_names: tuple = ()
    tracer: Optional[obs_trace.Tracer] = None

    @property
    def realized(self) -> dict:
        """The manifest's ``realized`` section (the JAX package's):
        quantities a reader cannot derive from the spec alone."""
        out = {
            "period": int(self.schedule.period),
            "weights_per_step": int(self.wps),
            "horizon": int(self.horizon),
            "seed": int(self.spec.run.seed),
            "plan_kinds": (None if self.plan is None
                           else sorted(set(self.plan.kinds))),
        }
        c = self.spec.compression
        comp = {"scheme": c.scheme, "state_dim": self.state_dim}
        if c.enabled:
            comp.update(error_feedback=c.error_feedback, warmup=c.warmup,
                        group=c.group)
        if self.state_dim is not None:
            comp["bytes_per_round"] = compress.payload_bytes(
                self.state_dim, c.scheme, c.group)
            comp["baseline_bytes_per_round"] = compress.payload_bytes(
                self.state_dim, "none")
        out["compression"] = comp
        if getattr(self.schedule, "is_sparse", False):
            e = self.schedule.edges_per_round
            snd = self.schedule.senders_per_round
            out["edges_per_round"] = {
                "min": int(e.min()), "max": int(e.max()),
                "mean": round(float(e.mean()), 1)}
            out["senders_per_round"] = {
                "min": int(snd.min()), "max": int(snd.max()),
                "mean": round(float(snd.mean()), 1)}
        if self.spec.obs.metrics:
            out["event_log"] = self.spec.obs.metrics
            out["obs_names"] = list(self.obs_names)
        sv = self.spec.serve
        if sv.enabled:
            out["serve"] = {"requests": sv.requests,
                            "fleet": sv.fleet or self.spec.run.nodes,
                            "batch": sv.batch, "routing": sv.routing}
        return out


def weights_per_step(algorithm) -> int:
    """Gossip rounds one step of this :class:`AlgorithmSpec` consumes (the
    paper's budget accounting), derived from the engine rule, so ``steps =
    T // weights_per_step(a)`` stays right if a rule's round structure
    changes."""
    R = algorithm.R if algorithm.name == "mc_dsgt" else 1
    return engine.make_rule(algorithm.name, gamma=algorithm.gamma,
                            R=R).weights_per_step


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
    reference's vocabulary, so the errors match), and the reference's
    checks of the sampled-client family and the logreg runtime hold."""
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
    t, a, r, m = spec.topology, spec.algorithm, spec.run, spec.model
    if a.delay < 0:
        raise ValueError(f"algorithm.delay={a.delay}: must be >= 0")
    if a.comm_interval < 1:
        raise ValueError(f"algorithm.comm_interval={a.comm_interval}: "
                         "must be >= 1")
    if t.pods < 1:
        raise ValueError(f"topology.pods={t.pods}: must be >= 1")
    if t.pods > 1 and r.nodes % t.pods:
        raise ValueError(f"topology.pods={t.pods} must divide "
                         f"run.nodes={r.nodes}")
    if t.kind in registry.SPARSE_TOPOLOGIES:
        if not 2 <= t.sample_k <= r.nodes:
            raise ValueError(f"topology.sample_k={t.sample_k}: the "
                             f"{t.kind!r} family samples a per-round "
                             f"cohort and needs 2 <= sample_k <= "
                             f"run.nodes={r.nodes}")
        if m.kind != "logreg":
            raise ValueError(f"topology.kind={t.kind!r} runs the host "
                             "reference runtime: model.kind must be "
                             "'logreg'")
        if a.name == "personalized":
            raise ValueError(
                f"algorithm.name='personalized' stages per-node dense "
                f"weight rows, which the edge-form {t.kind!r} family "
                "never materializes — use a dense topology")
        from ..sparse import DENSE_GUARD
        if r.nodes > DENSE_GUARD and r.gossip_impl != "auto":
            raise ValueError(
                f"run.nodes={r.nodes} exceeds the {DENSE_GUARD}-node dense "
                "guard: the dense host path would materialize (n, n) "
                "matrices — set run.gossip_impl='auto'")
    if m.kind == "logreg":
        if r.gossip_impl == "pallas":
            raise ValueError("model.kind='logreg' runs the host runtime: "
                             "gossip_impl must be 'dense' or 'auto'")
        if r.checkpoint or r.restore:
            raise ValueError("model.kind='logreg' does not support "
                             "checkpoint/restore (use the 'arch' runtime)")
    c = spec.compression
    if c.group < 1:
        raise ValueError(f"compression.group={c.group}: must be >= 1")
    if c.warmup < 0:
        raise ValueError(f"compression.warmup={c.warmup}: must be >= 0")
    if spec.obs.every < 1:
        raise ValueError(f"obs.every={spec.obs.every}: must be >= 1")
    registry.resolve_obs_names(spec.obs.names)  # raises on unknown names
    s = spec.serve
    if s.requests < 0:
        raise ValueError(f"serve.requests={s.requests}: must be >= 0")
    if s.enabled:
        if m.kind != "arch":
            raise ValueError("serve.requests > 0 needs the 'arch' runtime: "
                             "serving decodes a trained transformer fleet "
                             f"(model.kind={m.kind!r})")
        if s.batch < 1 or s.max_new < 1 or s.prompt_len < 1:
            raise ValueError("serve.batch/max_new/prompt_len must be >= 1 "
                             f"(got {s.batch}/{s.max_new}/{s.prompt_len})")
        if not 0 <= s.fleet <= r.nodes:
            raise ValueError(f"serve.fleet={s.fleet}: must be 0 (= all "
                             f"run.nodes) or <= run.nodes={r.nodes}")


def build(spec: ExperimentSpec, *, device="cuda") -> Built:
    """Realize ``spec`` on ``device``: the (possibly fault-degraded) weight
    schedule, the edge plan, the telemetry recorder and the runtime's
    model and data."""
    _validate(spec)
    dev = resolve_device(device)
    rs, al = spec.run, spec.algorithm
    n = rs.nodes
    # R is mc_dsgt's knob; every other rule is defined at R=1
    R = al.R if al.name == "mc_dsgt" else 1
    comp = registry.build_compression(spec.compression)
    rule = engine.make_rule(al.name, gamma=al.gamma, R=R, compression=comp,
                            delay=al.delay, comm_interval=al.comm_interval,
                            tau=al.tau)
    wps = rule.weights_per_step
    seconds = {}
    t0 = time.perf_counter()
    # horizon only matters for the non-periodic schedules (resampled
    # matching, mobility, sampled clients) and realized fault windows; the
    # x4 cushion is the reference's
    horizon = (rs.steps + 1) * wps * 4
    sched = registry.build_topology(spec.topology, n, horizon=horizon,
                                    seed=rs.seed)
    fault_models = registry.build_channel_models(spec.channel, rs.seed)
    is_sparse = getattr(sched, "is_sparse", False)
    if fault_models:
        # ideal schedule -> channel degradation -> repair: the realized
        # window replaces the schedule, so every gossip impl mixes the same
        # post-fault matrices; the edge-list family is degraded edge list
        # by edge list (per-edge hash streams, never densified)
        if is_sparse:
            from .. import sparse
            sched = sparse.realize_sparse_schedule(sched, fault_models)
        else:
            sched = sim_faults.realize_weight_schedule(sched, fault_models,
                                                       rounds=horizon)
    seconds["schedule"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pods = spec.topology.pods if spec.topology.pods > 1 else None
    plan = (sched.plan(0, sched.period, pods=pods,
                       personalized=rule.personalized)
            if rs.gossip_impl == "auto" else None)
    seconds["plan"] = time.perf_counter() - t0
    telem = None
    if fault_models or rs.telemetry or comp is not None or rule.delay or \
            is_sparse or spec.topology.kind in registry.MOBILITY_TOPOLOGIES:
        if is_sparse:
            from ..sparse import SparseTelemetryRecorder as _Recorder
        else:
            _Recorder = sim_telemetry.TelemetryRecorder
        telem = _Recorder(sched, wps=wps, every=rs.log_every,
                          compression=comp, delay=rule.delay)
    built = Built(spec=spec, rule=rule, wps=wps, schedule=sched, device=dev,
                  horizon=horizon, plan=plan,
                  local_opt=registry.build_local_opt(al.local_opt),
                  telemetry=telem, seconds=seconds)
    if spec.obs.enabled:
        _build_obs(built)
    t0 = time.perf_counter()
    if spec.model.kind == "arch":
        cfg = configs.get(spec.model.arch)
        if spec.model.preset == "reduced":
            cfg = cfg.reduced()
        built.cfg, built.model = cfg, build_model(cfg)
        built.state_dim = sum(math.prod(shape)
                              for _, shape in tree.items(built.model.shapes))
        built.stream = token_stream_for(
            cfg, n, R, spec.data.batch, spec.data.seq, seed=rs.seed,
            active_vocab=spec.data.active_vocab,
            hetero_alpha=spec.data.hetero_alpha, device=dev)
    else:
        mr = spec.model
        if spec.data.hetero_alpha is not None:
            H, y = logreg_dataset_dirichlet(n, mr.m, mr.d,
                                            alpha=spec.data.hetero_alpha,
                                            seed=rs.seed, device=dev)
        else:
            H, y = logreg_dataset(n, mr.m, mr.d, seed=rs.seed, device=dev)
        _, _, stoch, _, gnorm2 = logreg_loss_and_grad(rho=mr.rho)
        batch = spec.data.batch
        built.grad_fn = lambda xs, gen: stoch(xs, H, y, gen, batch)
        built.eval_fn = lambda xb: gnorm2(xb, H, y)
        built.x0 = torch.zeros((n, mr.d), device=dev)
        built.state_dim = mr.d
    seconds["data"] = time.perf_counter() - t0
    return built


def _effective_beta(sched, period: int, cap: int = 64) -> float:
    """Measured per-round mixing parameter of the realized schedule: the
    window contraction over (up to ``cap`` rounds of) one period, taken to
    the per-round geometric mean — what the lower-bound floor's network
    term is evaluated at."""
    rounds = max(1, min(int(period), cap))
    if getattr(sched, "is_sparse", False):
        # edge-list schedules never densify: the window contraction comes
        # from power iteration on the participant subspace
        from .. import sparse
        c = 1.0 - sparse.sparse_windowed_gap(
            [sched.round(t) for t in range(rounds)])
    else:
        c = gossip.consensus_contraction(sched, rounds)
    c = min(max(float(c), 0.0), 1.0 - 1e-9)
    return c ** (1.0 / rounds)


def _build_obs(built: Built) -> None:
    """Attach the observability bundle to a Built: the event sink, the
    phase tracer, the optimality-gap tracker of this spec's cell, the
    optional profiler, and the :class:`~repro_torch.obs.metrics.
    ObsRecorder` tying them together (chaining the scenario's
    TelemetryRecorder, when it has one, instead of replacing it)."""
    spec = built.spec
    rs, al, o = spec.run, spec.algorithm, spec.obs
    built.obs_names = registry.resolve_obs_names(o.names, built.rule)
    built.tracer = obs_trace.Tracer(annotate=bool(o.profile_dir))
    channel = registry.channel_label(spec.channel)
    cell = obs_optimality.cell_key(al.name, spec.topology.kind, channel)
    gap = obs_optimality.GapTracker(
        cell=cell, n=rs.nodes,
        beta=_effective_beta(built.schedule, built.schedule.period),
        bound=o.bound)
    profiler = (obs_trace.Profiler(o.profile_dir, o.profile_steps)
                if o.profile_dir else None)
    from .spec import spec_hash
    meta = {"name": f"{al.name} on {spec.topology.kind}",
            "spec_hash": spec_hash(spec), "cell": cell,
            "algo": al.name, "topology": spec.topology.kind,
            "channel": channel, "model": spec.model.kind, "n": rs.nodes,
            "steps": rs.steps, "weights_per_step": built.wps,
            "gossip_impl": rs.gossip_impl, "every": o.every,
            "obs_names": list(built.obs_names)}
    # a profile-only run (profile_dir set, no metrics path) still needs a
    # sink for the recorder's meta/summary events: an in-memory one
    sink = (obs_metrics.MemorySink() if o.sink == "jsonl" and not o.metrics
            else registry.build_sink(o))
    built.obs = obs_metrics.ObsRecorder(
        sink, every=o.every, telemetry=built.telemetry,
        tracer=built.tracer, gap=gap, profiler=profiler, meta=meta)


def run(spec: ExperimentSpec, *, device="cuda", quiet: bool = False) -> Result:
    """Build and train ``spec`` end to end on ``device``, then serve the
    trained fleet when ``spec.serve`` enables a serve phase.  The manifest
    (:mod:`repro_torch.exp.manifest`) is written next to the telemetry file
    and the event log before the run, so an interrupted run stays
    attributable; the checkpoint's is written only after the restore check,
    so resuming in place (checkpoint == restore) still compares against the
    original run's manifest before overwriting it.  The profiler starts
    before the run, and the recorder closes after it (its summary event)
    whether or not the run raised.  Float32 matrix products run in full
    f32 (TF32 off), as the reference's numerics need."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    built = build(spec, device=device)
    if spec.run.telemetry:
        mf.write_manifest(spec.run.telemetry, spec, realized=built.realized)
    if spec.obs.metrics:
        mf.write_manifest(spec.obs.metrics, spec, realized=built.realized)
    if built.obs is not None and built.obs.profiler is not None:
        built.obs.profiler.start()
    try:
        if spec.model.kind == "arch":
            res = _run_arch(built, quiet=quiet)
        else:
            res = _run_logreg(built, quiet=quiet)
        if spec.serve.enabled:
            # inside the try, so that the serve events land before the
            # sink closes
            res = res._replace(serve=_run_serve(built, res.state,
                                                quiet=quiet))
        return res
    finally:
        if built.obs is not None:
            built.obs.close()


def _run_logreg(built: Built, *, quiet: bool = False) -> Result:
    """The host runtime: the engine rule bound to the dense window or the
    plan's mixer, driven by :func:`repro_torch.core.driver.run_algorithm`.
    The oracle's generator is seeded by ``run.seed`` on the device.  The
    logreg oracle returns gradients only, so a personalized rule (whose
    oracle must also return per-node losses) raises ValueError here, where
    the reference's raises on unpacking them."""
    spec, rs = built.spec, built.spec.run
    if built.rule.personalized:
        raise ValueError("algorithm.name='personalized' needs an oracle "
                         "returning (per-node losses, grads); the logreg "
                         "runtime's returns grads only (drive "
                         "algorithms.personalized through "
                         "driver.run_algorithm with such an oracle)")
    gen = torch.Generator(device=built.device).manual_seed(rs.seed)
    state, history = driver.run_algorithm(
        alg.from_rule(built.rule, built.local_opt), built.x0, built.grad_fn, built.schedule,
        rs.steps, gen, eval_fn=built.eval_fn, eval_every=rs.eval_every,
        gossip_impl=rs.gossip_impl, plan=built.plan,
        telemetry=built.obs if built.obs is not None else built.telemetry,
        obs=built.obs_names, tracer=built.tracer)
    if rs.telemetry:
        built.telemetry.dump(rs.telemetry)
    if not quiet:
        for tl in (built.telemetry.history if built.telemetry else []):
            gap = tl["spectral_gap"]
            print(f"step {tl['step']:5d}  T={tl['t']:6d}  consensus "
                  f"{tl['consensus']:.3e}  gap "
                  f"{gap if gap is not None else float('nan'):.3f}  "
                  f"{tl['sec']:.3f}s", flush=True)
        for t, val in history:
            print(f"T={t:6d}  grad_norm2 {val:.6e}", flush=True)
    return Result(state=state, history=history, spec=spec, built=built,
                  telemetry=built.telemetry)


def _run_arch(built: Built, *, quiet: bool = False) -> Result:
    """The arch trainer: the engine rule bound by
    :func:`repro_torch.dist.steps.make_train_step` to the dense window, the
    fused kernel or (``auto``) the staged plan, on the driver's loop."""
    spec, rs, dev = built.spec, built.spec.run, built.device
    init_state, warm_start, train_step = dsteps.make_train_step(
        built.model, built.cfg, algo=spec.algorithm.name,
        gamma=spec.algorithm.gamma, R=built.rule.R, gossip_impl=rs.gossip_impl,
        plan=built.plan, local_opt=built.local_opt,
        compression=built.rule.compression, delay=built.rule.delay,
        comm_interval=built.rule.comm_interval, tau=built.rule.tau,
        obs=built.obs_names)
    con = obs_console.Console(quiet=quiet)
    gen = torch.Generator(device=dev).manual_seed(rs.seed)
    state = init_state(built.model.init(gen, torch.float32, dev), rs.nodes)
    state, start_step = driver.restore_or_warm(
        state, restore=rs.restore, load_fn=train_step.load_checkpoint,
        warm=lambda s: warm_start(s, built.stream.batch_at(0)), spec=spec)
    if rs.restore:
        con.print(f"restored step {start_step} from {rs.restore}")
    if rs.checkpoint:
        # after the restore check (resuming in place must be compared
        # against the original manifest first) but before the loop, so even
        # an interrupted run stays attributable
        mf.write_manifest(rs.checkpoint, spec, realized=built.realized)

    # the whole period's gossip stack (or the plan's tensors) crosses to
    # the device once
    auto = rs.gossip_impl == "auto"
    staged = driver.stage(built.schedule, wps=built.wps, device=dev,
                          impl="auto" if auto else "dense", plan=built.plan)
    step_fn = driver.bind_step(staged, train_step if auto else (
        lambda state, batch, W, t: train_step(state, batch, W)))

    telem = built.telemetry

    def record(k, t, state, out, dt):
        if built.obs is not None:
            tl = built.obs.record(k, t, state, out, dt)
        else:
            tl = (telem.record(k, t, state, out, dt)
                  if telem is not None else None)
        if k % rs.log_every != 0:
            return None
        loss = float(out["loss"])
        ce = (tl["consensus"] if tl is not None
              else coll.consensus_distance(state.x))
        extra = ""
        if tl is not None:
            ed, gap = tl["eff_diameter"], tl["spectral_gap"]
            extra = (f"  gap {gap if gap is not None else float('nan'):.3f}"
                     f"  eff_diam {ed if ed is not None else '-'}")
        con.print(f"step {k:5d}  T={t:6d}  loss {loss:.4f}  "
                  f"consensus {ce:.3e}{extra}  {dt:.2f}s", flush=True)
        return {"step": k, "loss": loss, "consensus": ce, "sec": dt}

    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    state, history = driver.run_loop(
        step_fn, state, steps=rs.steps, wps=built.wps, period=staged.period,
        start_step=start_step,
        extra_fn=lambda k: built.stream.batch_at(k + 1), record=record,
        sync=sync, checkpoint=rs.checkpoint,
        save_fn=train_step.save_checkpoint, tracer=built.tracer)
    if rs.checkpoint:
        con.event("saved", path=rs.checkpoint)
    if rs.telemetry:
        telem.dump(rs.telemetry)
        con.event("wrote_telemetry", path=rs.telemetry)
    return Result(state=state, history=history, spec=spec, built=built,
                  telemetry=telem)


def _run_serve(built: Built, state, *, quiet: bool = False):
    """The post-training serve phase: the first ``serve.fleet`` node copies
    of the trained flat state, as views of its rows (no copy), served with
    continuous batching (:func:`repro_torch.serve.serve_fleet`), its
    per-request events through the run's recorder.  As in the reference,
    the model's kernel policy is the trained config's: ``use_pallas`` is
    not set for serving."""
    from ..serve import serve_fleet

    sv = built.spec.serve
    F = sv.fleet or built.spec.run.nodes
    layout = dsteps.flat_layout(built.model, built.rule.compression)
    res = serve_fleet(built.model, layout.views(state.x[:F]), sv,
                      obs=built.obs)
    con = obs_console.Console(quiet=quiet)
    tp = res.throughput
    con.print(f"served {tp['requests']} requests over fleet {res.fleet}  "
              f"decode {tp['decode_tok_s']:.0f} tok/s  "
              f"p50 {tp['latency_p50_ms']:.1f}ms  "
              f"p95 {tp['latency_p95_ms']:.1f}ms")
    return res
