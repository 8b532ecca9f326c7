"""String-keyed registries for every scenario vocabulary, the port of the
JAX package's ``exp/registry.py``.

The vocabularies are the reference's, word for word, so a spec JSON or a
manifest means the same thing in both packages (``gossip_impl="pallas"``
still selects the fused gossip kernel, here the Hopper one).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from .. import optim
from ..core import compress, engine, gossip, topology as topo
from ..obs import metrics as obs_metrics
from ..sim import channel as sim_channel, faults as sim_faults, \
    mobility as sim_mobility
from .spec import ChannelSpec, CompressionSpec, TopologySpec

# ---------------------------------------------------------------------------
# Topologies: name -> builder(spec, n, *, horizon, seed) -> WeightSchedule
# ---------------------------------------------------------------------------

TOPOLOGIES: Dict[str, Callable] = {}


def register_topology(name: str):
    """Register a topology builder under ``name`` (a legal
    ``TopologySpec.kind`` and a CLI ``--topology`` choice)."""
    def deco(fn):
        TOPOLOGIES[name] = fn
        return fn
    return deco


@register_topology("sun")
def _sun(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.theorem3_weight_schedule(n, s.beta)


@register_topology("ring")
def _ring(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(topo.StaticSchedule(topo.ring_graph(n)))


@register_topology("one-peer-exp")
def _one_peer_exp(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(topo.one_peer_exponential_schedule(n))


@register_topology("static-exp")
def _static_exp(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        topo.StaticSchedule(topo.static_exponential_graph(n)))


@register_topology("federated")
def _federated(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        topo.federated_schedule(n, s.local_steps))


@register_topology("complete")
def _complete(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.WeightSchedule((np.ones((n, n)) / n,),
                                 (topo.RoundStructure("complete"),))


@register_topology("random-matching")
def _random_matching(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(topo.random_matching_schedule(n))


@register_topology("resampled-matching")
def _resampled_matching(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        topo.resampled_matching_schedule(n, seed=seed), horizon=horizon)


@register_topology("erdos-renyi")
def _erdos_renyi(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        topo.erdos_renyi_schedule(n, s.er_p, seed=seed))


@register_topology("geometric-mobility")
def _geometric_mobility(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        sim_mobility.random_geometric_schedule(n, s.radius, seed=seed),
        horizon=horizon)


@register_topology("waypoint-mobility")
def _waypoint_mobility(s: TopologySpec, n: int, *, horizon=None, seed=0):
    return gossip.schedule_from_topology(
        sim_mobility.random_waypoint_schedule(n, s.radius, seed=seed),
        horizon=horizon)


@register_topology("random-sun")
def _random_sun(s: TopologySpec, n: int, *, horizon=None, seed=0):
    """The §6 Figure 2 protocol: sun-shaped graphs whose |C| = ``centers``
    center set is re-drawn randomly for each of ``resample_period`` rounds,
    with the I - L/d_max Laplacian weights the paper's experiments use."""
    rng = np.random.default_rng(seed)
    mats, structs = [], []
    for _ in range(s.resample_period):
        center = rng.choice(n, size=s.centers, replace=False)
        adj = topo.sun_shaped_graph(n, center)
        mats.append(gossip.laplacian_rule(adj))
        structs.append(topo.classify_adjacency(adj))
    return gossip.WeightSchedule(tuple(mats), tuple(structs))


@register_topology("hierarchical")
def _hierarchical(s: TopologySpec, n: int, *, horizon=None, seed=0):
    """Two-level pod schedule: ``local_steps`` rounds of intra-pod averaging
    (W = I_m ⊗ J_p) followed by one inter-pod round where pods pair up
    round-robin (W = B ⊗ J_p with B = ½I + ½P a matching over pod means).
    ``pods`` is the pod size p (must divide n, pod-major node order)."""
    p = s.pods
    if p < 1 or n % p:
        raise ValueError(f"hierarchical topology needs pods | nodes, got "
                         f"pods={p}, nodes={n}")
    m = n // p
    Jp = np.ones((p, p)) / p
    intra = np.kron(np.eye(m), Jp)
    mats, structs = [], []
    if m > 1 and not (m & (m - 1)):
        # hypercube matchings over pods: log2(m) distinct pairings/period
        pod_sched = topo.one_peer_exponential_schedule(m)
        inters = [0.5 * np.eye(m) + 0.5 * pod_sched(t).astype(float)
                  * ~np.eye(m, dtype=bool) for t in range(pod_sched.period)]
    else:
        # non-power-of-two pod count: one global pod average per period
        inters = [np.ones((m, m)) / m]
    for B in inters:
        for _ in range(max(0, s.local_steps)):
            mats.append(intra)
            structs.append(topo.classify_adjacency(intra > 0))
        mats.append(np.kron(B, Jp))
        structs.append(topo.classify_adjacency(mats[-1] > 0))
    return gossip.WeightSchedule(tuple(mats), tuple(structs))


@register_topology("random-sampled")
def _random_sampled(s: TopologySpec, n: int, *, horizon=None, seed=0):
    """Client sampling at scale: each round draws ``sample_k`` of the ``n``
    nodes, places them by hashed waypoint mobility, and gossips over the
    unit-disk graph among the sampled cohort with Metropolis weights.  The
    schedule is an edge-list :class:`repro_torch.sparse.SparseWeightSchedule`
    (never a dense matrix), so ``n`` can reach 10^5..10^6: per-round cost is
    O(sample_k^2) to realize and O(edges) to mix."""
    from .. import sparse
    if horizon is None:
        raise ValueError("random-sampled topology needs a horizon")
    return sparse.sampled_weight_schedule(n, s.sample_k, radius=s.radius,
                                          seed=seed, horizon=horizon)


MOBILITY_TOPOLOGIES = ("geometric-mobility", "waypoint-mobility")

# Families whose builder returns an edge-list SparseWeightSchedule
# (is_sparse = True): faults realize via repro_torch.sparse.
# realize_sparse_schedule and telemetry via SparseTelemetryRecorder, never
# densifying.
SPARSE_TOPOLOGIES = ("random-sampled",)


def build_topology(s: TopologySpec, n: int, *, horizon: int | None = None,
                   seed: int = 0) -> gossip.WeightSchedule:
    """Realize a :class:`TopologySpec` into a ``WeightSchedule`` for ``n``
    nodes."""
    if s.kind not in TOPOLOGIES:
        raise ValueError(f"unknown topology {s.kind!r} "
                         f"(have {sorted(TOPOLOGIES)})")
    return TOPOLOGIES[s.kind](s, n, horizon=horizon, seed=seed)


# ---------------------------------------------------------------------------
# The other vocabularies (the reference's, word for word)
# ---------------------------------------------------------------------------

# ChannelSpec field -> factory(rate, seed).  Per-stream seed offsets keep
# one seed moving every stream together without correlating them (the
# reference's constants, so both packages realize the same faults).
CHANNEL_MODELS: Dict[str, Callable] = {
    "link_drop": lambda p, seed: sim_channel.BernoulliDropChannel(
        p, seed=seed + 101),
    "burst_loss": lambda p, seed: sim_channel.GilbertElliottChannel(
        p, seed=seed + 202),
    "churn": lambda p, seed: sim_faults.NodeChurn(p, seed=seed + 303),
    "straggler": lambda p, seed: sim_faults.StragglerInjection(
        p, seed=seed + 404),
}
CHANNELS = tuple(CHANNEL_MODELS)
ALGORITHMS = engine.ALGORITHMS
LOCAL_OPTS: Dict[str, Callable | None] = {
    "sgd": None,  # the paper-pure update: no transform
    "momentum": optim.momentum,
    "adam": optim.adam,
}
GOSSIP_IMPLS = ("dense", "pallas", "auto")
MODEL_KINDS = ("arch", "logreg")
ROUTING_POLICIES = ("user-affinity", "round-robin")
SERVE_DTYPES = ("bf16", "f32")
COMPRESSIONS = compress.SCHEMES       # core.compress owns the vocabulary
OBS_METRICS = engine.OBS_METRICS     # described in repro_torch.obs.metrics
SINKS = ("jsonl", "memory")
OBS_BOUNDS = ("paper", "centralized")  # repro_torch.obs.optimality.BOUNDS


def build_sink(obs_spec):
    """The event sink an :class:`repro_torch.exp.spec.ObsSpec` selects
    (``jsonl`` needs ``obs_spec.metrics`` as the path; ``memory`` keeps
    events in process)."""
    if obs_spec.sink not in SINKS:
        raise ValueError(f"unknown obs sink {obs_spec.sink!r} "
                         f"(have {sorted(SINKS)})")
    if obs_spec.sink == "jsonl":
        if not obs_spec.metrics:
            raise ValueError("obs.sink='jsonl' requires obs.metrics "
                             "(the event-log path)")
        return obs_metrics.EventLog(obs_spec.metrics)
    return obs_metrics.MemorySink()


def resolve_obs_names(names, rule=None) -> tuple:
    """Validate and normalize an obs metric selection
    (:func:`repro_torch.obs.metrics.resolve_names`)."""
    return obs_metrics.resolve_names(names, rule)


def channel_label(s: ChannelSpec) -> str:
    """Short label of the active degradations ("ideal" for none) — the
    channel leg of the optimality-gap cell key."""
    active = [name for name in ("link_drop", "burst_loss", "churn",
                                "straggler") if getattr(s, name) > 0]
    return "+".join(active) if active else "ideal"


def build_compression(s: CompressionSpec
                      ) -> compress.CompressionConfig | None:
    """Lower a :class:`CompressionSpec` to the runtime
    :class:`repro_torch.core.compress.CompressionConfig` (None when the
    scheme is 'none': the uncompressed path)."""
    if s.scheme not in COMPRESSIONS:
        raise ValueError(f"unknown compression scheme {s.scheme!r} "
                         f"(have {sorted(COMPRESSIONS)})")
    if s.scheme == "none":
        return None
    return compress.CompressionConfig(scheme=s.scheme,
                                      error_feedback=s.error_feedback,
                                      warmup=s.warmup, group=s.group)


def build_local_opt(name: str):
    """Instantiate a local-optimizer transform (None for plain sgd)."""
    if name not in LOCAL_OPTS:
        raise ValueError(f"unknown local_opt {name!r} "
                         f"(have {sorted(LOCAL_OPTS)})")
    factory = LOCAL_OPTS[name]
    return factory() if factory is not None else None


def build_channel_models(s: ChannelSpec, seed: int = 0) -> list:
    """Fault-model instances for every non-zero rate in ``s`` (empty list =
    ideal channel), in deterministic field order."""
    return [CHANNEL_MODELS[name](rate, seed) for name in CHANNELS
            if (rate := getattr(s, name)) > 0]

