"""The port's observability against the JAX package: the engine's four
in-step scalars on the host runtime and in the arch trainer (dense, and
the fused kernels' plain versions under int8 compression and a stale
window), the event vocabulary, the recorder's batched flush, the gap
tracker, the report, the tracer and profiler, and an obs spec's manifest.
Every input is made with numpy from a fixed seed; oracles are full-batch
where the two packages must agree step for step."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.core import algorithms as jalg, compress as jcompress  # noqa: E402
from repro.core import driver as jdriver, engine as jengine  # noqa: E402
from repro.data import logreg_dataset as jlogreg_dataset  # noqa: E402
from repro.data import logreg_loss_and_grad as jlogreg_loss  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.exp import manifest as jmanifest  # noqa: E402
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.obs import metrics as jmetrics, optimality as joptimality  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro_torch import configs, exp  # noqa: E402
from repro_torch.core import algorithms as alg, compress, driver  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import logreg_dataset, logreg_loss_and_grad  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402
from repro_torch.obs import metrics, optimality, report, trace  # noqa: E402

# grad_norm and consensus: the same f32 sums in other orders (XLA vs ATen,
# whole leaves vs column chunks).  mix_residual differences two states
# that each carry those roundings.  The atol covers the scalars that are
# rounding noise themselves (a first step from identical rows: ~1e-8).
RTOL, ATOL, MIX_RTOL = 1e-5, 1e-6, 1e-4
# tracker_residual is rounding noise on an uncompressed run (h̄ = ḡ holds
# exactly in real arithmetic): both packages' readings must stay below
# this fraction of ||g|| (readings: 1.4e-8 to 4.2e-8 of it).
TRACKER_NOISE = 2.0 ** -20
# The arch trainer's step tolerance (slices 1-3), and the share of a
# compressed window's entries that may round to the other int8 step
# (tests/test_torch_slice.py).
STEP_RTOL, STEP_ATOL, MAX_FLIPS = 1e-4, 1e-5, 2e-3
N, M, D, SEED, STEPS = 8, 16, 12, 3, 3
NAMES = engine.OBS_METRICS


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class _Keep:
    """A record hook keeping each step's obs scalars as floats."""

    def __init__(self):
        self.obs = []

    def record(self, k, t, state, out, dt):
        self.obs.append({m: float(v) for m, v in out["obs"].items()})


def _hold(got, want, what):
    """The four scalars of each step, port against reference."""
    assert len(got) == len(want)
    for k, (a, b) in enumerate(zip(got, want)):
        assert list(a) == list(NAMES) and sorted(b) == sorted(NAMES)
        for m in ("grad_norm", "consensus"):
            np.testing.assert_allclose(a[m], b[m], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what} step {k}: {m}")
        np.testing.assert_allclose(a["mix_residual"], b["mix_residual"],
                                   rtol=MIX_RTOL, atol=ATOL,
                                   err_msg=f"{what} step {k}: mix_residual")


def _hold_tracker(got, want, tracking: bool, what):
    for k, (a, b) in enumerate(zip(got, want)):
        if not tracking:
            assert a["tracker_residual"] == b["tracker_residual"] == 0.0
            continue
        for side, o in (("port", a), ("reference", b)):
            assert o["tracker_residual"] <= TRACKER_NOISE * o["grad_norm"], (
                f"{what} step {k}: {side}'s tracker residual "
                f"{o['tracker_residual']} past the rounding bound")


# ---------------------------------------------------------------------------
# The host runtime
# ---------------------------------------------------------------------------

HOST_RULES = {"dsgd": (0.2,), "dsgt": (0.2,), "mc_dsgt": (0.2, 2),
              "d2": (0.2,), "local_sgd": (0.3,), "personalized": (0.3, 2.0)}


def _host_run(name, args):
    topo = jspec.TopologySpec(kind="random-sun")
    jsched = jregistry.build_topology(topo, N, horizon=64, seed=SEED)
    sched = registry.build_topology(tspec.TopologySpec(kind="random-sun"), N,
                                    horizon=64, seed=SEED)
    jH, jy = jlogreg_dataset(N, M, D, seed=SEED)
    H, y = logreg_dataset(N, M, D, seed=SEED)
    jloss, jfull, _, _, _ = jlogreg_loss(0.1)
    loss, full, _, _, _ = logreg_loss_and_grad(0.1)
    jgrad = lambda xs, key: jfull(xs, jH, jy)  # noqa: E731
    grad = lambda xs, gen: full(xs, H, y)  # noqa: E731
    if name == "personalized":
        jgrad = lambda xs, key: (jax.vmap(jloss)(xs, jH, jy),  # noqa: E731
                                 jfull(xs, jH, jy))
        grad = lambda xs, gen: (torch.stack(  # noqa: E731
            [loss(xs[i], H[i], y[i]) for i in range(N)]), full(xs, H, y))
    jk, k = _Keep(), _Keep()
    jdriver.run_algorithm(getattr(jalg, name)(*args), jnp.zeros((N, D)),
                          jgrad, jsched, STEPS, jax.random.key(0),
                          obs=jengine.OBS_METRICS, telemetry=jk)
    driver.run_algorithm(getattr(alg, name)(*args), torch.zeros((N, D)),
                         grad, sched, STEPS, torch.Generator(), obs=NAMES,
                         telemetry=k)
    return k.obs, jk.obs


@pytest.fixture(scope="module")
def host_runs():
    """Each rule's 3 steps through both packages' dense host runtime from
    x = 0, every scalar requested."""
    return {name: _host_run(name, args) for name, args in HOST_RULES.items()}


@pytest.mark.parametrize("name", list(HOST_RULES))
def test_host_scalars_match_reference(host_runs, name):
    got, want = host_runs[name]
    _hold(got, want, name)
    _hold_tracker(got, want, name in ("dsgt", "mc_dsgt"), name)


# ---------------------------------------------------------------------------
# The arch trainer
# ---------------------------------------------------------------------------

CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
NA, B, S, GAMMA, R = 4, 2, 16, 0.05, 2
# (gossip impl, compression scheme, delay): the fused paths run the Hopper
# kernels' plain versions here and the JAX Pallas kernels in interpret mode
ARCH_CASES = {"dense": ("dense", None, 0),
              "pallas-int8": ("pallas", "int8", 0),
              "pallas-delay1": ("pallas", None, 1)}


def _arch_run(impl, scheme, delay):
    """Warm start + 2 MC-DSGT steps of a reduced qwen1.5 through both
    packages' ``make_train_step`` with every scalar requested, from the
    same parameters and tokens.  Returns each step's scalars of both, and
    each step's (h, res_h, g⁻) of both as (n, D) float64 arrays in the
    port's layout (the port's copied: its step updates them in place)."""
    jsched = jregistry.build_topology(jspec.TopologySpec(kind="sun"), NA,
                                      horizon=64, seed=SEED)
    wps = 2 * R
    jcomp = comp = None
    if scheme is not None:
        jcomp = jcompress.CompressionConfig(scheme=scheme, group=256)
        comp = compress.CompressionConfig(scheme=scheme, group=256)
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo="mc_dsgt", gamma=GAMMA, R=R,
        gossip_impl=impl, pallas_interpret=True, pallas_block_d=16_384,
        compression=jcomp, delay=delay, obs=jengine.OBS_METRICS)
    jstep = jax.jit(jstep)
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=GAMMA, R=R, gossip_impl=impl,
        compression=comp, delay=delay, obs=NAMES)
    js = jinit(jax.random.key(0), NA, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda l: l[0], js.x))), NA)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 128, (NA, R, B, S)).astype(np.int32)
               for _ in range(3)]
    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    got, want, states = [], [], []
    layout = steps.flat_layout(model, comp)

    def flat(mat):
        return np.asarray(mat, np.float64) if mat is not None else 0.0

    def jflat(tree_):
        if tree_ is None:
            return 0.0
        leaves = {tuple(k.key for k in p): np.asarray(l, np.float64)
                  for p, l in jax.tree_util.tree_leaves_with_path(tree_)}
        mat = np.zeros((NA, layout.size))
        for path, shape, off in layout.entries:
            mat[:, off:off + int(np.prod(shape))] = \
                leaves[path].reshape(NA, -1)
        return mat

    for k in (1, 2):
        W = jsched.stacked((k - 1) * wps, wps)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, out = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                       torch.from_numpy(W))
        np.testing.assert_allclose(float(out["loss"]), float(jout["loss"]),
                                   rtol=1e-4)
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in out["obs"].values())
        got.append({m: float(v) for m, v in out["obs"].items()})
        want.append({m: float(v) for m, v in jout["obs"].items()})
        res_h = ts.res[1] if ts.res is not None else None
        jres_h = js.res[1] if js.res is not None else None
        states.append({
            "port": (flat(ts.h.clone()), flat(res_h), flat(ts.g_prev)),
            "reference": (jflat(js.h), jflat(jres_h), jflat(js.g_prev))})
    return got, want, states


@pytest.fixture(scope="module")
def arch_runs():
    return {case: _arch_run(*args) for case, args in ARCH_CASES.items()}


@pytest.mark.parametrize("case", list(ARCH_CASES))
def test_arch_scalars_match_reference(arch_runs, case):
    """The four scalars after each of 2 steps at the stated tolerances.
    Without compression the tracker residual is rounding noise, held below
    TRACKER_NOISE.  Under int8 the quantization moves the tracker's node
    mean for real, by the node mean of the residual res_h (error feedback
    returns it over later rounds): a signal of ~2e-3 of ||g|| whose value
    turns on which entries of the h window round to the other int8 step
    in each package (tens of its 1.5M; the flips move mass between h and
    res_h, which the node sum of h + res_h does not see).  So under int8
    each package's tracker residual is held to what it names on its own
    state, ||h̄ − ḡ||, at RTOL; h to the reference's up to MAX_FLIPS of its
    entries and g⁻ entry for entry at the step tolerance; and the
    flip-free ||mean(h + res_h) − ḡ|| is rounding noise in both."""
    got, want, states = arch_runs[case]
    _hold(got, want, case)
    if ARCH_CASES[case][1] is None:
        _hold_tracker(got, want, True, case)
        return
    for k, (a, b, st) in enumerate(zip(got, want, states)):
        for side, o in (("port", a), ("reference", b)):
            h, res_h, g = st[side]
            named = np.linalg.norm(h.mean(0) - g.mean(0))
            np.testing.assert_allclose(o["tracker_residual"], named,
                                       rtol=RTOL, err_msg=f"step {k} {side}")
            flip_free = np.linalg.norm((h + res_h).mean(0) - g.mean(0))
            assert flip_free <= TRACKER_NOISE * o["grad_norm"], (
                f"step {k} {side}: ||mean(h + res_h) - mean(g)|| "
                f"{flip_free} past the rounding bound")
        (h, _, g), (jh, _, jg) = st["port"], st["reference"]
        np.testing.assert_allclose(g, jg, rtol=STEP_RTOL, atol=STEP_ATOL,
                                   err_msg=f"step {k}: g_prev")
        bad = np.abs(h - jh) > STEP_ATOL + STEP_RTOL * np.abs(jh)
        assert bad.sum() <= MAX_FLIPS * bad.size, (
            f"step {k}: {int(bad.sum())} of {bad.size} entries of h beyond "
            "the step tolerance")


def test_scalars_are_what_they_name(monkeypatch):
    """On a hand-made host step: grad_norm is ||g||_F, consensus ||x − x̄||_F
    of the new iterate, mix_residual ||Mix(z) − z||_F, in float64 sums of
    the same tensors (the column chunks are exercised by shrinking them to
    a few columns)."""
    rng = np.random.default_rng(4)
    x0 = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    G = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    W = torch.from_numpy(
        registry.build_topology(tspec.TopologySpec(kind="random-sun"), N,
                                horizon=8, seed=SEED).stacked(0, 1))
    rule = engine.make_rule("dsgd", 0.1)
    ops = engine.EngineOps(mix=lambda off, r, m: W[0] @ m,
                           grad=lambda x, out=None: (None, G.clone()))
    monkeypatch.setattr(engine, "OBS_CHUNK_BYTES", 4 * N * 5)  # 5 columns
    state, (_, obs) = engine.step(rule, engine.init_state(rule, x0.clone()),
                                  ops, obs=NAMES)
    z = x0.double() - 0.1 * G.double()
    x = W[0].double() @ z
    want = {"grad_norm": G.double().norm(),
            "consensus": (x - x.mean(0)).norm(),
            "mix_residual": (x - z).norm(), "tracker_residual": 0.0}
    for m in NAMES:
        np.testing.assert_allclose(float(obs[m]), float(want[m]), rtol=1e-5,
                                   atol=1e-6, err_msg=m)
    np.testing.assert_allclose(state.x.numpy(), x.numpy(), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown obs metric"):
        engine.step(rule, engine.init_state(rule, x0.clone()), ops,
                    obs=("nope",))


def test_tracker_residual_of_bf16_trackers():
    """With trackers stored in bf16 the tracker's node mean drifts from the
    sample's by the storage rounding, and ``tracker_residual`` reads it:
    taken before the storage cast, from the sample's node mean kept before
    its buffer is reused (complete-graph mixing, 1/N exact in f32)."""
    rng = np.random.default_rng(5)
    G0, G1 = (torch.from_numpy(rng.standard_normal((N, D)).astype(
        np.float32)) for _ in range(2))
    W = torch.full((2, N, N), 1.0 / N)
    samples = iter((G0, G1))
    rule = engine.make_rule("dsgt", 0.1)
    ops = engine.EngineOps(
        mix=lambda off, r, m: alg.multi_consensus(W[off:off + r], m),
        grad=lambda x, out=None: (None, next(samples).clone()),
        cast_aux=lambda t: t.to(torch.bfloat16))
    state = engine.warm_start(rule, engine.init_state(
        rule, torch.zeros((N, D))), ops)
    assert state.h.dtype == state.g_prev.dtype == torch.bfloat16
    h64, gp64 = state.h.double(), state.g_prev.double()
    state, (_, obs) = engine.step(rule, state, ops, obs=NAMES)
    want = ((h64 + G1.double() - gp64).mean(0) - G1.double().mean(0)).norm()
    assert float(want) > 1e-4          # the bf16 rounding of h⁰ and g⁰
    np.testing.assert_allclose(float(obs["tracker_residual"]), float(want),
                               rtol=1e-4)
    np.testing.assert_allclose(float(obs["grad_norm"]),
                               float(G1.double().norm()), rtol=1e-5)


def test_default_obs_is_the_references():
    for name in engine.ALGORITHMS:
        assert engine.default_obs(engine.make_rule(name, 0.1)) == \
            jengine.default_obs(jengine.make_rule(name, 0.1))
    assert metrics.resolve_names("grad_norm, consensus") == \
        jmetrics.resolve_names("grad_norm, consensus")
    with pytest.raises(ValueError, match="unknown obs metric"):
        metrics.resolve_names("nope")


# ---------------------------------------------------------------------------
# Host side: vocabulary, recorder, gap tracker, report, tracer, profiler
# ---------------------------------------------------------------------------

def test_vocabulary_is_the_references():
    assert metrics.EVENT_FIELDS == jmetrics.EVENT_FIELDS
    assert metrics.OBS_METRICS == jmetrics.OBS_METRICS
    assert list(metrics.OBS_METRICS) == list(jmetrics.OBS_METRICS)
    assert engine.OBS_METRICS == jengine.OBS_METRICS
    assert trace.PHASES == ("data", "step", "telemetry", "checkpoint")
    assert list(registry.SINKS) == list(jregistry.SINKS)
    assert list(registry.OBS_BOUNDS) == list(jregistry.OBS_BOUNDS)
    assert list(optimality.BOUNDS) == list(joptimality.BOUNDS)
    assert optimality.INSTANCE_CONSTANTS == joptimality.INSTANCE_CONSTANTS


def _feed(rec, steps=10):
    """``steps`` step records of device-side scalars and two evals."""
    for k in range(steps):
        out = {"loss": torch.tensor(2.0 - 0.1 * k),
               "obs": {m: torch.tensor(float(k + i), dtype=torch.float32)
                       for i, m in enumerate(NAMES)}}
        rec.record(k, 4 * (k + 1), None, out, 0.01 * k)
        if k in (3, 7):
            rec.eval_event(k, 4 * (k + 1), 1.0 / (k + 1))
    rec.close()


@pytest.mark.parametrize("every", [1, 3])
def test_recorder_batches_without_losing_events(every):
    """The background flusher under ``every`` = 3 emits every event of the
    synchronous drain, in order, then the summary, and closes its sink."""
    got, want = metrics.MemorySink(), metrics.MemorySink()
    gap = optimality.GapTracker(cell="c", n=4, beta=0.5)
    _feed(metrics.ObsRecorder(got, every=every, gap=gap,
                              tracer=trace.Tracer()))
    _feed(metrics.ObsRecorder(want, every=1, background=False,
                              tracer=trace.Tracer()))
    assert got.closed and want.closed
    kinds = [e["event"] for e in got.events]
    assert kinds == ["step"] * 4 + ["eval"] + ["step"] * 4 + ["eval"] + \
        ["step"] * 2 + ["summary"]
    assert got.events[:-1] == want.events[:-1]
    step = got.events[2]
    assert step == {"event": "step", "step": 2, "t": 12, "sec": 0.02,
                    "loss": pytest.approx(1.8), "consensus": 3.0,
                    "grad_norm": 2.0, "mix_residual": 4.0,
                    "tracker_residual": 5.0}
    assert list(step)[5:] == sorted(NAMES)   # the reference's key order
    summary = got.events[-1]
    assert summary["optimality"]["T"] == 40
    assert summary["optimality"]["best_grad_sq"] == 0.0


def test_flusher_errors_surface_on_close():
    class Broken(metrics.MemorySink):
        def emit(self, event):
            if event.get("event") == "step":
                raise RuntimeError("sink is down")
            super().emit(event)

    rec = metrics.ObsRecorder(Broken(), every=2)
    with pytest.raises(RuntimeError, match="sink is down"):
        _feed(rec, steps=4)
    try:     # raised by a flush before close: close joins the flusher
        rec.close()
    except RuntimeError:
        pass
    assert rec._worker is None


def test_gap_tracker_summary_is_the_references():
    rng = np.random.default_rng(2)
    vals = np.exp(-np.linspace(0, 3, 700)) + 0.05 * rng.random(700)
    for bound, beta in (("paper", 0.9375), ("centralized", 0.5)):
        a = optimality.GapTracker(cell=optimality.cell_key("mc_dsgt", "sun"),
                                  n=16, beta=beta, sigma=0.3, bound=bound,
                                  max_points=64)
        b = joptimality.GapTracker(cell=joptimality.cell_key("mc_dsgt",
                                                             "sun"),
                                   n=16, beta=beta, sigma=0.3, bound=bound,
                                   max_points=64)
        for t, v in enumerate(vals, start=1):
            a.update(4 * t, float(v))
            b.update(4 * t, float(v))
        a.update(9999, float("nan"))
        b.update(9999, float("nan"))
        assert a.summary() == b.summary()
    for T in (1, 10, 1000):
        assert optimality.theoretical_floor(T, n=8, beta=0.9) == \
            joptimality.theoretical_floor(T, n=8, beta=0.9)
        assert optimality.statistical_term(T, n=8) == \
            joptimality.statistical_term(T, n=8)


@pytest.fixture(scope="module")
def logreg_log(tmp_path_factory):
    """An event log the port wrote: MC-DSGT on the logreg host runtime,
    every step recorded, flushed every 2."""
    d = tmp_path_factory.mktemp("obs")
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "model.kind": "logreg", "model.d": 8, "model.m": 16,
        "run.nodes": 8, "run.steps": 5, "algorithm.name": "mc_dsgt",
        "algorithm.R": 2, "obs.metrics": str(d / "run.jsonl"),
        "obs.every": 2, "channel.link_drop": 0.2})
    res = exp.run(spec, device="cpu", quiet=True)
    return spec, res, str(d / "run.jsonl")


def test_port_log_renders_the_same_in_both_packages(logreg_log):
    spec, res, path = logreg_log
    events = metrics.read_events(path)
    assert [e["event"] for e in events] == \
        ["meta"] + ["step", "eval"] * 5 + ["summary"]
    assert events[0]["cell"] == "mc_dsgt/sun/link_drop"
    for e in events:
        if e["event"] == "step":
            assert set(NAMES) <= set(e) and "spectral_gap" in e
    assert events[-1]["optimality"]["floor"] > 0
    assert set(events[-1]["phases"]) == {"data", "step", "telemetry"}
    text = report.render(events)
    assert text == jreport.render(jmetrics.read_events(path))
    assert "-- optimality gap" in text and "tracker_residual" in text
    assert report.main([path]) == 0


def test_obs_manifest_is_the_references(logreg_log, tmp_path):
    """The event log's manifest (written before the run) equals the one
    the reference writes for the same spec; the meta event too."""
    spec, res, path = logreg_log
    jpath = str(tmp_path / "jrun.jsonl")
    jspec_ = jexp.from_dict(exp.to_dict(exp.with_field(
        spec, "obs.metrics", jpath)))
    jbuilt = jexp.build(jspec_)
    jmanifest.write_manifest(jpath, jspec_, realized=jbuilt.realized)
    jbuilt.obs.close()
    got = json.load(open(path + ".spec.json"))
    want = json.load(open(jpath + ".spec.json"))
    got["spec"]["obs"]["metrics"] = want["spec"]["obs"]["metrics"]
    got["realized"]["event_log"] = want["realized"]["event_log"]
    got.pop("spec_hash"), want.pop("spec_hash")   # hashes of the paths
    assert got == want
    assert res.built.realized["obs_names"] == list(NAMES)
    meta = metrics.read_events(path, "meta")[0]
    jmeta = jmetrics.read_events(jpath, "meta")[0]
    for e in (meta, jmeta):
        e.pop("spec_hash")
    assert meta == jmeta


def test_tracer_spans_and_drain():
    tr = trace.Tracer()
    for _ in range(3):
        with tr.span("data"):
            pass
        with tr.span("step"):
            sum(range(1000))
    assert set(tr.drain()) == {"data", "step"} and tr.drain() == {}
    s = tr.summary()
    assert s["step"]["count"] == 3 and s["data"]["count"] == 3
    assert s["step"]["total_sec"] >= 0 and s["step"]["mean_ms"] >= 0
    with pytest.raises(ZeroDivisionError):
        with tr.span("checkpoint"):
            1 / 0
    assert tr.counts["checkpoint"] == 1


def test_profiler_writes_a_trace_with_the_grad_and_mix_ranges(tmp_path):
    """An obs step on the host runtime under the Profiler: the Chrome trace
    holds the engine's obs_grad/obs_mix ranges and the tracer's
    obs:step span."""
    prof = trace.Profiler(str(tmp_path / "prof"), steps=1).start()
    tr = trace.Tracer(annotate=True)
    rule = engine.make_rule("mc_dsgt", 0.1, R=2)
    W = torch.full((4, N, N), 1.0 / N)
    ops = engine.EngineOps(mix=lambda off, r, m: alg.multi_consensus(
        W[off:off + r], m), grad=lambda x, out=None: (None, x * 0.5))
    state = engine.warm_start(rule, engine.init_state(
        rule, torch.ones((N, D))), ops)
    with tr.span("step"):
        engine.step(rule, state, ops, obs=NAMES)
    assert prof.maybe_stop(0) and not prof.maybe_stop(1)
    names = {e.get("name") for e in json.load(open(prof.path))["traceEvents"]}
    assert {"obs_grad", "obs_mix", "obs:step"} <= names
