"""The declarative experiment spec tree — one frozen dataclass per scenario
axis, composing into :class:`ExperimentSpec`, the single description of a
run that every runtime, example, benchmark and CLI entry point consumes.

The paper's contribution is a complexity statement over *scenarios* —
algorithm x time-varying topology x channel x heterogeneity — and this
module is that grid made first-class: a spec is a value (hashable,
comparable, `dataclasses.replace`-able), serializes to strict JSON
(`to_dict`/`from_dict`: unknown keys error, defaults are elided), and
`sweep` expands a base spec plus per-field override lists into the full
scenario grid.  Realization (weight schedules, fault models, update rules,
data streams) lives in :mod:`repro_torch.exp.build`; legal values for the
string-keyed fields live in :mod:`repro_torch.exp.registry`.

A copy of the JAX package's ``repro/exp/spec.py``: the same fields, defaults
and JSON, so a spec file means the same run in both packages and
``spec_hash`` agrees.  The device is a runtime argument of
:func:`repro_torch.exp.run`, never a spec field, for that reason.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
from typing import Any, Mapping, Optional, Sequence

# The reproducibility-manifest format both packages read (the JAX package's
# ``repro.exp.manifest.MANIFEST_FORMAT``).
MANIFEST_FORMAT = "repro.exp/manifest/v1"

# ---------------------------------------------------------------------------
# The spec tree
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TopologySpec:
    """The time-varying network: which schedule family and its parameters.

    ``kind`` is a :data:`repro.exp.registry.TOPOLOGIES` key.  Family
    parameters: ``beta`` (sun: Assumption 3 spectral bound), ``er_p``
    (erdos-renyi edge probability), ``radius`` (unit-disk range of the
    mobility models), ``local_steps`` (federated: local rounds between
    averaging rounds), ``centers``/``resample_period`` (random-sun: |C| and
    the number of independent center draws materialized, the §6 Figure 2
    protocol), ``pods`` (nodes per pod, pod-major order — matching the
    ``pod|data|model`` mesh layout; when > 1, rounds that factor as
    B ⊗ J_p across pod boundaries take the hierarchical two-level lowering
    under ``gossip_impl='auto'``, and the ``hierarchical`` family builds
    such schedules: ``local_steps`` intra-pod averaging rounds then one
    inter-pod matching round), ``sample_k`` (random-sampled: clients
    gossiping per round — the sparse edge-list family, where per-round
    cost is O(edges) and ``n`` can reach 10^5..10^6)."""

    kind: str = "sun"
    beta: float = 0.75
    er_p: float = 0.5
    radius: float = 0.45
    local_steps: int = 4
    centers: int = 1
    resample_period: int = 16
    pods: int = 1
    sample_k: int = 0


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """Channel/fault degradation applied to the ideal schedule (all rates
    are per-round probabilities; 0 everywhere = ideal channel).  Realized
    via :mod:`repro.sim`: mask -> repair -> re-classified lowering."""

    link_drop: float = 0.0    # iid per-link Bernoulli loss
    burst_loss: float = 0.0   # Gilbert-Elliott good->bad transition prob
    churn: float = 0.0        # per-node failure prob (all links down)
    straggler: float = 0.0    # per-node deadline-miss prob


@dataclasses.dataclass(frozen=True)
class AlgorithmSpec:
    """Which update rule and its scalars.  ``name`` is an
    :data:`repro.exp.registry.ALGORITHMS` entry; ``R`` (consensus/
    accumulation rounds) only applies to ``mc_dsgt`` — every other rule is
    defined at R=1 and the builder normalizes; ``local_opt`` is a
    :data:`repro.exp.registry.LOCAL_OPTS` key.

    ``delay`` is the stale-window (overlapped-gossip) axis: each step's
    gossip window is applied to the payload from ``delay`` steps ago and
    only the correction is folded into the fresh payload, so the mix
    collectives carry no data dependence on the current gradient (see
    :class:`repro.core.engine.UpdateRule`); ``delay=0`` is today's
    synchronous path, bit-exact.  ``comm_interval`` mixes every k driver
    steps with pure local updates in between (identity mix on skipped
    steps; incompatible with compression)."""

    name: str = "mc_dsgt"
    gamma: float = 0.05
    R: int = 2
    local_opt: str = "sgd"
    delay: int = 0
    comm_interval: int = 1
    tau: float = 4.0   # personalized: loss-proximity similarity temperature


@dataclasses.dataclass(frozen=True)
class DataSpec:
    """Per-node data stream.  For ``arch`` models: synthetic LM token
    batches (``seq``, ``active_vocab``).  For ``logreg``: the §6 protocol
    (``batch`` = stochastic-oracle minibatch).  ``hetero_alpha`` is the
    Dirichlet(alpha) non-iid knob on both (None = the model family's
    default partition: iid tokens / the paper's 80-20 label split)."""

    batch: int = 2
    seq: int = 64
    active_vocab: int = 64
    hetero_alpha: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class ModelRef:
    """What is being optimized.  ``kind='arch'``: a registered architecture
    (:mod:`repro.configs`) trained by the distributed runtime
    (:mod:`repro.dist.steps`).  ``kind='logreg'``: the paper's non-convex
    logistic regression driven by the host reference runtime
    (:func:`repro.core.driver.run_algorithm`)."""

    kind: str = "arch"
    arch: str = "qwen1.5-0.5b"
    preset: str = "reduced"
    d: int = 64        # logreg: feature dim
    m: int = 256       # logreg: samples per node
    rho: float = 0.1   # logreg: non-convex regularizer weight


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """Gossip payload compression (:mod:`repro.core.compress`).  ``scheme``
    is a :data:`repro.exp.registry.COMPRESSIONS` key (``'none'`` = full
    f32, the default); ``error_feedback`` carries each round's
    quantization error into the next payload; ``warmup`` gossips at full
    precision for the first N driver steps; ``group`` is entries per
    quantization scale (one f32 scale transmitted per group)."""

    scheme: str = "none"
    error_feedback: bool = True
    warmup: int = 0
    group: int = 256

    @property
    def enabled(self) -> bool:
        return self.scheme != "none"


@dataclasses.dataclass(frozen=True)
class RunSpec:
    """Run shape and I/O: everything that is not the scenario itself."""

    steps: int = 20
    nodes: int = 4
    seed: int = 0
    gossip_impl: str = "dense"    # repro.exp.registry.GOSSIP_IMPLS
    log_every: int = 1
    eval_every: int = 1           # logreg runtime: eval_fn cadence
    checkpoint: Optional[str] = None
    restore: Optional[str] = None
    telemetry: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ObsSpec:
    """Observability (:mod:`repro.obs`): in-jit step metrics into an event
    log, phase tracing, and optimality-gap tracking.  Off by default —
    enabled when ``metrics`` (the JSONL event-log path) or ``profile_dir``
    is set.  ``names`` selects engine metrics (``'auto'`` = the update
    rule's default set, or a comma-separated subset of
    :data:`repro.obs.metrics.OBS_METRICS`); ``every`` is the host flush
    batch (device scalars cross the host boundary once per ``every``
    steps); ``sink`` is a :data:`repro.exp.registry.SINKS` key;
    ``profile_dir``/``profile_steps`` dump a jax profiler trace of the
    first N steps; ``bound`` names the lower-bound reference the gap is
    measured against (:data:`repro.obs.optimality.BOUNDS`)."""

    metrics: Optional[str] = None
    every: int = 10
    names: str = "auto"
    sink: str = "jsonl"
    bound: str = "paper"
    profile_dir: Optional[str] = None
    profile_steps: int = 8

    @property
    def enabled(self) -> bool:
        return bool(self.metrics or self.profile_dir)


@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Fleet serving (:mod:`repro.serve`): serve the trained per-node model
    fleet behind one continuously-batched endpoint.  Off by default —
    enabled when ``requests > 0``, in which case :func:`repro.exp.run`
    follows training with a serve phase and attaches a
    :class:`repro.serve.ServeResult` to the run result.

    ``fleet`` is the number of personalized models served (0 = the trained
    fleet, ``run.nodes``); ``batch`` caps concurrently-decoding request
    slots (the continuous-batching window); ``max_new`` / ``prompt_len``
    shape each synthetic request; ``routing`` is a
    :data:`repro.exp.registry.ROUTING_POLICIES` key mapping a user id to
    its node's personalization; ``dtype`` selects the serve-side param /
    KV-cache precision (``'bf16'`` or ``'f32'``)."""

    requests: int = 0
    batch: int = 8
    max_new: int = 16
    prompt_len: int = 16
    fleet: int = 0
    routing: str = "user-affinity"
    dtype: str = "bf16"
    seed: int = 0

    @property
    def enabled(self) -> bool:
        return self.requests > 0


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """One experiment = one point of the scenario grid.  The default value
    of every field matches the historical ``launch/train.py`` flag default,
    so an empty spec is the CLI's zero-flag run."""

    model: ModelRef = ModelRef()
    data: DataSpec = DataSpec()
    algorithm: AlgorithmSpec = AlgorithmSpec()
    topology: TopologySpec = TopologySpec()
    channel: ChannelSpec = ChannelSpec()
    compression: CompressionSpec = CompressionSpec()
    run: RunSpec = RunSpec()
    serve: ServeSpec = ServeSpec()
    obs: ObsSpec = ObsSpec()


_SECTION_TYPES = {"model": ModelRef, "data": DataSpec,
                  "algorithm": AlgorithmSpec, "topology": TopologySpec,
                  "channel": ChannelSpec, "compression": CompressionSpec,
                  "run": RunSpec, "serve": ServeSpec, "obs": ObsSpec}


# ---------------------------------------------------------------------------
# Strict serialization
# ---------------------------------------------------------------------------

def _leaf_to_dict(sub, elide_defaults: bool) -> dict:
    out = {}
    for f in dataclasses.fields(sub):
        v = getattr(sub, f.name)
        if elide_defaults and v == f.default:
            continue
        out[f.name] = v
    return out


def to_dict(spec: ExperimentSpec, *, elide_defaults: bool = True) -> dict:
    """Nested plain-dict form.  With ``elide_defaults`` (the default) every
    field equal to its dataclass default is dropped — the dict names only
    what the experiment *chose*, so diffs and manifests stay readable and
    old manifests keep loading when new defaulted fields appear."""
    out = {}
    for name in _SECTION_TYPES:
        d = _leaf_to_dict(getattr(spec, name), elide_defaults)
        if d or not elide_defaults:
            out[name] = d
    return out


def _leaf_from_dict(cls, d: Mapping, where: str):
    if not isinstance(d, Mapping):
        raise TypeError(f"{where}: expected a mapping, got {type(d).__name__}")
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise KeyError(f"{where}: unknown key(s) {sorted(unknown)} "
                       f"(known: {sorted(known)})")
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        # JSON round-trips ints for float fields (e.g. beta: 1) — normalize
        # so from_dict(to_dict(s)) == s holds through a json.dumps cycle.
        if f.type in ("float", "Optional[float]", float) \
                and isinstance(v, int) and not isinstance(v, bool):
            v = float(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def from_dict(d: Mapping) -> ExperimentSpec:
    """Strict inverse of :func:`to_dict`: unknown keys raise (at every
    level), missing keys take the dataclass default."""
    if not isinstance(d, Mapping):
        raise TypeError(f"spec: expected a mapping, got {type(d).__name__}")
    unknown = set(d) - set(_SECTION_TYPES)
    if unknown:
        raise KeyError(f"spec: unknown section(s) {sorted(unknown)} "
                       f"(known: {sorted(_SECTION_TYPES)})")
    kwargs = {name: _leaf_from_dict(cls, d[name], name)
              for name, cls in _SECTION_TYPES.items() if name in d}
    return ExperimentSpec(**kwargs)


def to_json(spec: ExperimentSpec, *, elide_defaults: bool = True,
            indent: int | None = 1) -> str:
    return json.dumps(to_dict(spec, elide_defaults=elide_defaults),
                      indent=indent, sort_keys=True)


def from_json(text: str) -> ExperimentSpec:
    return from_dict(json.loads(text))


def load(path: str) -> ExperimentSpec:
    """Load a spec (or a manifest wrapping one under a ``"spec"`` key —
    only the known manifest format is unwrapped; anything else errors)."""
    with open(path) as f:
        d = json.load(f)
    if isinstance(d, Mapping) and "format" in d:
        if d["format"] != MANIFEST_FORMAT:
            raise ValueError(f"{path}: unsupported manifest format "
                             f"{d['format']!r} (want {MANIFEST_FORMAT!r})")
        d = d.get("spec", {})
    return from_dict(d)


def spec_hash(spec: ExperimentSpec) -> str:
    """Short stable content hash of the fully-resolved spec — the scenario
    identity used by BENCH rows and manifests.  The spec is normalized
    through ``from_dict`` first so equal specs hash equally even when a
    float field was populated with a Python int (json would emit ``1`` vs
    ``1.0`` and split the hash)."""
    canon_spec = from_dict(to_dict(spec, elide_defaults=False))
    canon = json.dumps(to_dict(canon_spec, elide_defaults=False),
                       sort_keys=True)
    return hashlib.sha256(canon.encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# Dotted-path overrides and grid expansion
# ---------------------------------------------------------------------------

def with_field(spec: ExperimentSpec, path: str, value) -> ExperimentSpec:
    """Return ``spec`` with one dotted-path field replaced, e.g.
    ``with_field(s, "algorithm.name", "dsgd")``."""
    section, _, field = path.partition(".")
    if section not in _SECTION_TYPES or not field:
        raise KeyError(f"bad override path {path!r} (want "
                       f"'<section>.<field>', sections: "
                       f"{sorted(_SECTION_TYPES)})")
    sub = getattr(spec, section)
    if field not in {f.name for f in dataclasses.fields(sub)}:
        raise KeyError(f"unknown field {field!r} in section {section!r}")
    return dataclasses.replace(spec, **{
        section: dataclasses.replace(sub, **{field: value})})


def with_overrides(spec: ExperimentSpec,
                   overrides: Mapping[str, Any]) -> ExperimentSpec:
    for path, value in overrides.items():
        spec = with_field(spec, path, value)
    return spec


def sweep(base: ExperimentSpec,
          overrides: Mapping[str, Sequence]) -> list[ExperimentSpec]:
    """Grid-expand ``base`` over per-field value lists: the cartesian
    product of every ``{"section.field": [v0, v1, ...]}`` axis, in
    deterministic (insertion x value) order.

        sweep(base, {"algorithm.name": ["dsgd", "mc_dsgt"],
                     "channel.link_drop": [0.0, 0.2]})   # 4 specs
    """
    paths = list(overrides)
    grids = [list(overrides[p]) for p in paths]
    out = []
    for combo in itertools.product(*grids):
        out.append(with_overrides(base, dict(zip(paths, combo))))
    return out
