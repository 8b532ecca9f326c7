"""Wireless mobility and channel faults on dense schedules against the JAX
package: the mobility module (a verbatim copy) and its schedules at
out-of-order (seed, t) queries, the registry's mobility topologies,
``build(spec)``'s realized (degraded, repaired) dense matrices under every
channel model, the telemetry of such a scenario, the train CLI on a
delayed mobility run, and the twins of ``examples/wireless_mobility.py``
and ``examples/compressed_gossip.py``.
Every draw comes from a fixed seed; numpy code must match bit for bit."""

import dataclasses
import importlib
import importlib.util
import random
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sim import mobility as jmobility  # noqa: E402
from repro_torch import exp, sim, tree  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.sim import mobility  # noqa: E402

# the module (the package exports its ``build`` function under that name)
tbuild = importlib.import_module("repro_torch.exp.build")

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
N, SEED = 8, 3
CHANNELS = ("link_drop", "burst_loss", "churn", "straggler")
# The slices' step tolerance: the two packages reach their states (and the
# losses and consensus distances over them) by a few reordered f32 sums.
RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_mobility_copy_is_verbatim_and_exported():
    assert (SRC / "repro_torch/sim/mobility.py").read_text() == \
        (SRC / "repro/sim/mobility.py").read_text()
    for name in ("RandomGeometricSchedule", "RandomWaypointSchedule",
                 "random_geometric_schedule", "random_waypoint_schedule",
                 "unit_disk_adjacency"):
        assert getattr(sim, name) is getattr(mobility, name)


@pytest.mark.parametrize("factory,kw", [
    ("random_geometric_schedule", {}),
    ("random_waypoint_schedule", {}),
    ("random_waypoint_schedule", {"leg_rounds": 3}),
])
@pytest.mark.parametrize("radius", [0.3, 0.45])
def test_schedules_bit_equal_at_out_of_order_queries(factory, kw, radius):
    """Positions, adjacency and round structure of both packages'
    schedules at shuffled and repeated t (the reference's determinism
    test, held across the packages)."""
    a = getattr(jmobility, factory)(N, radius, seed=9, **kw)
    b = getattr(mobility, factory)(N, radius, seed=9, **kw)
    ts = list(range(24))
    order = ts[:]
    random.Random(7).shuffle(order)
    want = {t: (a.positions(t), np.array(a(t)), a.structure(t).kind)
            for t in ts}
    for t in order + order:
        pos, adj, kind = want[t]
        assert np.array_equal(b.positions(t), pos), t
        assert np.array_equal(b(t), adj), t
        assert b.structure(t).kind == kind, t


def test_factories_refuse_what_the_reference_refuses():
    for mod in (jmobility, mobility):
        with pytest.raises(ValueError, match="radius must be positive"):
            mod.random_geometric_schedule(N, 0.0)
        with pytest.raises(ValueError, match="leg_rounds"):
            mod.random_waypoint_schedule(N, 0.45, leg_rounds=0)


@pytest.mark.parametrize("kind", ["geometric-mobility", "waypoint-mobility"])
def test_registry_mobility_schedules_bit_identical(kind):
    assert registry.MOBILITY_TOPOLOGIES == jregistry.MOBILITY_TOPOLOGIES
    a = jregistry.build_topology(jspec.TopologySpec(kind=kind, radius=0.4),
                                 N, horizon=40, seed=SEED)
    b = registry.build_topology(tspec.TopologySpec(kind=kind, radius=0.4),
                                N, horizon=40, seed=SEED)
    assert a.period == b.period
    assert np.array_equal(a.stacked(0, a.period), b.stacked(0, b.period))
    assert [s.kind for s in a.structures] == [s.kind for s in b.structures]


def _faulty_spec(kind, channel, **extra):
    return {"model.kind": "logreg", "model.d": 6, "model.m": 8,
            "run.nodes": N, "run.steps": 4, "run.seed": SEED,
            "topology.kind": kind, "topology.radius": 0.45,
            "algorithm.name": "mc_dsgt", "algorithm.R": 2,
            f"channel.{channel}": 0.3, **extra}


@pytest.mark.parametrize("channel", CHANNELS)
@pytest.mark.parametrize("kind", ["ring", "sun", "waypoint-mobility"])
def test_build_realizes_the_references_matrices(kind, channel):
    """``build(spec)`` with a channel model on a dense topology: the
    realized (degraded, repaired) matrices of the whole horizon, their
    round kinds, the plan under 'auto' and the realized section equal the
    reference build's, bit for bit; the scenario gets a telemetry
    recorder, as in the reference."""
    over = _faulty_spec(kind, channel, **{"run.gossip_impl": "auto"})
    spec = exp.with_overrides(exp.ExperimentSpec(), over)
    jb = jexp.build(jexp.with_overrides(jexp.ExperimentSpec(), over))
    b = exp.build(spec, device="cpu")
    assert b.schedule.period == jb.schedule.period == b.horizon
    a, w = b.schedule.stacked(0, b.horizon), jb.schedule.stacked(0, jb.horizon)
    assert a.dtype == w.dtype and np.array_equal(a, w)
    assert b.plan.kinds == jb.plan.kinds
    for key, val in jb.plan.tensors().items():
        assert np.array_equal(b.plan.tensors()[key], val), key
    assert b.realized == jb.realized
    assert b.telemetry is not None and jb.telemetry is not None
    assert b.telemetry.delay == jb.telemetry.delay == 0


@pytest.mark.parametrize("impl", ["dense", "auto"])
def test_faulty_mobility_run_telemetry_matches_reference(impl):
    """``exp.run`` on waypoint mobility with 20% link drop and a delay of 1
    through both packages: every telemetry field of every step but the
    state's (the windows, spectral and stale gaps, effective diameters,
    round kinds and bytes) equals the reference's.  The two packages draw
    different minibatches, so the consensus distance is held (at RTOL) only
    at step 0, whose correction is zero in both (x⁰'s rows are equal)."""
    over = _faulty_spec("waypoint-mobility", "link_drop", **{
        "run.gossip_impl": impl, "algorithm.delay": 1, "run.steps": 6})
    res = exp.run(exp.with_overrides(exp.ExperimentSpec(), over),
                  device="cpu", quiet=True)
    jres = jexp.run(jexp.with_overrides(jexp.ExperimentSpec(), over),
                    quiet=True)
    got, want = res.telemetry.history, jres.telemetry.history
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        for key in ("consensus", "sec", "loss"):
            g.pop(key, None)
            w.pop(key, None)
        assert g == w
        assert "stale_gap" in g
    np.testing.assert_allclose(got[0]["consensus"], want[0]["consensus"],
                               rtol=RTOL, atol=1e-7)


def _twin_specs(name):
    """(reference SPECS, twin SPECS) of ``examples/<name>.py``."""
    return (_module(REPO / "examples" / f"{name}.py").SPECS,
            _module(REPO / "examples" / "torch" / f"{name}.py").SPECS)


@pytest.mark.parametrize("example,key", [
    ("wireless_mobility", "mc_dsgt_drop20"),
    ("wireless_mobility", "dsgd_ideal"),
    ("compressed_gossip", "compressed_sign"),
    ("compressed_gossip", "compressed_int8")])
def test_twin_specs_run_like_the_references(example, key):
    """Each twin's spec is the reference's (same hash and JSON); 2 steps of
    it through both ``exp.run``s: finite evals at the same budgets T, the
    same realized section, and the same telemetry window metrics and wire
    bytes (the realized schedule is the same; the minibatches differ)."""
    jspecs, specs = _twin_specs(example)
    assert sorted(specs) == sorted(jspecs)
    spec, jspec_ = specs[key], jspecs[key]
    assert exp.spec_hash(spec) == jexp.spec_hash(jspec_)
    assert exp.to_json(spec) == jexp.to_json(jspec_)
    spec = exp.with_overrides(spec, {"run.steps": 2, "run.eval_every": 1})
    jspec_ = jexp.with_overrides(jspec_, {"run.steps": 2,
                                          "run.eval_every": 1})
    res = exp.run(spec, device="cpu", quiet=True)
    jres = jexp.run(jspec_, quiet=True)
    assert [t for t, _ in res.history] == [t for t, _ in jres.history]
    assert all(np.isfinite(v) for _, v in res.history)
    assert res.built.realized == jres.built.realized
    assert res.telemetry.bytes_total == jres.telemetry.bytes_total
    for g, w in zip(res.telemetry.history, jres.telemetry.history):
        for field in ("t", "window", "spectral_gap", "eff_diameter",
                      "kinds", "bytes"):
            assert g[field] == w[field], field


class _ReferenceStream:
    """The reference's token stream for the same spec, as torch batches."""

    def __init__(self, jstream):
        self.jstream = jstream

    def batch_at(self, step):
        tokens = np.array(self.jstream.batch_at(step)["tokens"])
        return {"tokens": torch.from_numpy(tokens).long()}


CLI_ARGV = ["--topology", "waypoint-mobility", "--link-drop", "0.2",
            "--delay", "1", "--gossip-impl", "pallas", "--nodes", "4",
            "--algo", "mc_dsgt", "--R", "2", "--steps", "3", "--batch", "1",
            "--seq", "16"]


def test_cli_delayed_mobility_run_matches_reference(monkeypatch, capsys):
    """The train CLI on waypoint mobility with 20% link drop and a delay of
    1 through the pallas impl (reduced qwen1.5), against the reference
    CLI's losses on the same argv at RTOL.  The packages draw their initial
    parameters and token batches from their own generators, so the port's
    run takes the reference's (its init from jax.random.key(run.seed) and
    its stream's batches); everything else is the port's own."""
    want = jtrain.main(list(CLI_ARGV))
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced()
    init = params_from_jax(jax.device_get(
        jbuild(jcfg).init(jax.random.key(0), jnp.float32)))
    real = tbuild.build_model

    def with_reference_init(cfg):
        model = real(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        return model._replace(init=lambda gen, dtype, device, out=None:
                              tree.map(lambda t: t.to(device, dtype).clone(),
                                       init))

    def reference_stream(cfg, n, R, batch, seq, seed=0, active_vocab=0,
                         hetero_alpha=None, device="cpu"):
        return _ReferenceStream(jtoken_stream_for(
            jcfg, n, R, batch, seq, seed=seed, active_vocab=active_vocab,
            hetero_alpha=hetero_alpha))

    monkeypatch.setattr(tbuild, "build_model", with_reference_init)
    monkeypatch.setattr(tbuild, "token_stream_for", reference_stream)
    got = train.main(CLI_ARGV + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert "gap" in out and "eff_diam" in out
    assert [h["step"] for h in got] == [h["step"] for h in want] == [0, 1, 2]
    np.testing.assert_allclose([h["loss"] for h in got],
                               [h["loss"] for h in want], rtol=RTOL)
    np.testing.assert_allclose([h["consensus"] for h in got],
                               [h["consensus"] for h in want], rtol=1e-3,
                               atol=1e-6)


def test_the_smokes_wireless_scenario_drops_links_and_varies():
    """``chip_smoke.py``'s wireless phase runs its legs on the argv it
    names: that spec (waypoint mobility, radius 0.45, 20% link drop, a
    delay of 1, 4 nodes) realizes a schedule that varies over the rounds
    its runs consume and drops at least one link the ideal schedule has;
    the reference builds the same realized matrices."""
    smoke = _module(REPO / "chip_smoke.py")
    for argv in (smoke.DELAYED_ARGV, smoke.DSGD_DELAYED_ARGV,
                 smoke.INTERVAL_ARGV):
        spec = train.spec_from_args(train.build_parser().parse_args(argv))
        assert (spec.topology.kind, spec.topology.radius, spec.run.nodes,
                spec.channel.link_drop, spec.algorithm.delay) == \
            ("waypoint-mobility", 0.45, 4, 0.2, 1)
    spec = train.spec_from_args(train.build_parser().parse_args(
        smoke.DELAYED_ARGV))
    b = exp.build(spec, device="cpu")
    jb = jexp.build(jexp.from_dict(exp.to_dict(spec)))
    rounds = smoke.STEPS * b.wps
    got = b.schedule.stacked(0, rounds)
    assert np.array_equal(got, jb.schedule.stacked(0, rounds))
    ideal = registry.build_topology(spec.topology, 4, horizon=b.horizon,
                                    seed=spec.run.seed).stacked(0, rounds)
    assert len({m.tobytes() for m in got}) > 1
    assert ((ideal > 0) & (got == 0)).any()
