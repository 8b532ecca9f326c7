"""The async axis (stale-window gossip ``delay`` and the mixing cadence
``comm_interval``) against the JAX package: the rule's fields and refusals,
``delay=0`` bit-exact with the synchronous path on every runtime, delayed
runs of the host runtime (dense and plan mixers) and of the arch trainer
(``dense``, ``pallas`` on the kernel's plain CPU path, ``auto``) on a
realized waypoint-mobility schedule with link drop, compressed and delayed
runs under slice 2's flip and node-sum rules, ``comm_interval`` (and no mix
on a skipped step), the tracker mean under delay, the telemetry's stale
window, and the train CLI.  Every input is made with numpy from a fixed
seed; oracles are full-batch where the packages must agree step for step."""


import functools

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
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sim import faults as jfaults, telemetry as jtelemetry  # noqa: E402
from repro_torch import configs, exp  # noqa: E402
from repro_torch.core import algorithms as alg, compress, driver  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data import logreg_dataset, logreg_loss_and_grad  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402
from repro_torch.sim import faults, telemetry  # noqa: E402

# The slices' step tolerances: a few steps carry reordered f32 sums
# (XLA vs ATen) through clipping, tracking and mixing.
RTOL, ATOL = 1e-4, 1e-5
# Entries of a compressed state allowed past RTOL/ATOL (slice 2's bound): a
# few-ulp difference between the packages can flip an int8 rounding (or the
# sign of a value at 0), which moves that entry by one quantization step.
MAX_FLIPS = 2e-3
N, M, D, SEED = 8, 16, 12, 3
CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
NA, B, S, GAMMA = 4, 2, 16, 0.05
GROUP = 256


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _schedules(n, horizon=64):
    """Both packages' realized waypoint-mobility schedule (radius 0.45)
    under 20% link drop: a time-varying, sometimes degraded schedule, bit
    equal (tests/test_torch_mobility.py).  Read only, so made once."""
    jtop = jregistry.build_topology(jspec.TopologySpec(
        kind="waypoint-mobility"), n, horizon=horizon, seed=SEED)
    top = registry.build_topology(tspec.TopologySpec(
        kind="waypoint-mobility"), n, horizon=horizon, seed=SEED)
    jm = jregistry.build_channel_models(jspec.ChannelSpec(link_drop=0.2),
                                        SEED)
    tm = registry.build_channel_models(tspec.ChannelSpec(link_drop=0.2), SEED)
    return (jfaults.realize_weight_schedule(jtop, jm, rounds=horizon),
            faults.realize_weight_schedule(top, tm, rounds=horizon))


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

RULE_FIELDS = ("name", "kind", "gamma", "R", "delay", "comm_interval",
               "weights_per_step", "uses_tracker")


@pytest.mark.parametrize("delay,interval", [(0, 1), (1, 1), (3, 1), (0, 4),
                                            (2, 2)])
@pytest.mark.parametrize("name", ["dsgd", "dsgt", "mc_dsgt", "gt_local",
                                  "d2", "local_sgd"])
def test_rule_fields_are_the_references(name, delay, interval):
    R = 2 if name == "mc_dsgt" else 1
    a = engine.make_rule(name, 0.1, R, delay=delay, comm_interval=interval)
    b = jengine.make_rule(name, 0.1, R, delay=delay, comm_interval=interval)
    assert {f: getattr(a, f) for f in RULE_FIELDS} == \
        {f: getattr(b, f) for f in RULE_FIELDS}


INT8 = dict(scheme="int8", group=GROUP)


@pytest.mark.parametrize("kw", [
    dict(name="dsgd", kind="sgd", gamma=0.1, delay=-1),
    dict(name="dsgd", kind="sgd", gamma=0.1, comm_interval=0),
    dict(name="dsgd", kind="sgd", gamma=0.1, comm_interval=2,
         compression=INT8),
    dict(name="p", kind="sgd", gamma=0.1, personalized=True, delay=1),
    dict(name="p", kind="sgd", gamma=0.1, personalized=True,
         comm_interval=3)])
def test_rule_refuses_what_the_reference_refuses(kw):
    """The same ValueError, message for message."""
    msgs = []
    for rule_cls, comp_cls in ((jengine.UpdateRule,
                                jcompress.CompressionConfig),
                               (engine.UpdateRule,
                                compress.CompressionConfig)):
        args = dict(kw)
        if "compression" in args:
            args["compression"] = comp_cls(**args["compression"])
        with pytest.raises(ValueError) as err:
            rule_cls(**args)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("overrides", [
    {"algorithm.delay": -1}, {"algorithm.comm_interval": 0},
    {"algorithm.comm_interval": 2, "compression.scheme": "int8"}])
def test_build_refuses_what_the_reference_refuses(overrides):
    """``build(spec)`` (and so the CLI) raises the reference's ValueError
    for a bad delay or interval, and for comm_interval with compression."""
    base = {"model.kind": "logreg", "model.d": 6, "model.m": 8,
            "run.nodes": 4, "run.steps": 1, **overrides}
    with pytest.raises(ValueError) as want:
        jexp.build(jexp.with_overrides(jexp.ExperimentSpec(), base))
    with pytest.raises(ValueError) as got:
        exp.build(exp.with_overrides(exp.ExperimentSpec(), base),
                  device="cpu")
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The host runtime
# ---------------------------------------------------------------------------

def _oracles(n=N, d=D):
    """Both packages' full-batch logreg oracles on the same data."""
    jH, jy = jlogreg_dataset(n, M, d, seed=SEED)
    _, jfull, _, _, jgn = jlogreg_loss(0.1)
    H, y = logreg_dataset(n, M, d, seed=SEED)
    _, full, _, _, gn = logreg_loss_and_grad(0.1)
    return ((lambda xs, key: jfull(xs, jH, jy), lambda xb: jgn(xb, jH, jy)),
            (lambda xs, gen: full(xs, H, y), lambda xb: gn(xb, H, y)))


def _host_runs(name, impl, steps=4, **rule_kw):
    """``steps`` steps of ``name`` through both packages' host runtime from
    x = 0 on the realized schedule; evals held at RTOL on the way."""
    R = 2 if name == "mc_dsgt" else 1
    jsched, sched = _schedules(N)
    (jgrad, jeval), (grad, evl) = _oracles()
    comp = rule_kw.pop("compression", None)
    jrule = jengine.make_rule(name, 0.2, R, compression=None if comp is None
                              else jcompress.CompressionConfig(**comp),
                              **rule_kw)
    rule = engine.make_rule(name, 0.2, R, compression=None if comp is None
                            else compress.CompressionConfig(**comp),
                            **rule_kw)
    js, jhist = jdriver.run_algorithm(
        jalg.from_rule(jrule), jnp.zeros((N, D)), jgrad, jsched, steps,
        jax.random.key(0), eval_fn=jeval, gossip_impl=impl)
    state, hist = driver.run_algorithm(
        alg.from_rule(rule), torch.zeros((N, D)), grad, sched, steps,
        torch.Generator(), eval_fn=evl, gossip_impl=impl)
    assert state.k == steps
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL)
    return state, js


def _hold_host(state, js):
    """x, h, g_prev and every stale slot at RTOL/ATOL (None where the
    reference holds None)."""
    pairs = [(f, getattr(state, f), getattr(js, f))
             for f in ("x", "h", "g_prev")]
    if js.buf is not None:
        for stream, q, jq in zip(("buf_x", "buf_h"), state.buf, js.buf):
            if jq is None:
                assert q is None, stream
                continue
            assert len(q) == len(jq), stream
            pairs += [(f"{stream}[{i}]", a, b)
                      for i, (a, b) in enumerate(zip(q, jq))]
    else:
        assert state.buf is None
    for what, got, want in pairs:
        if want is None:
            assert got is None, what
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("impl", ["dense", "auto"])
@pytest.mark.parametrize("delay", [1, 2])
@pytest.mark.parametrize("name", ["dsgd", "dsgt", "mc_dsgt", "gt_local",
                                  "d2", "local_sgd"])
def test_host_delayed_runs_match_reference(name, delay, impl):
    """4 delayed steps of each rule on the host runtime, through the dense
    window and through the plan's mixers: evals, x, h, g_prev and the stale
    slots (the FIFO, oldest first) at RTOL/ATOL."""
    _hold_host(*_host_runs(name, impl, delay=delay))


@pytest.mark.parametrize("impl", ["dense", "auto"])
@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("name", ["dsgd", "mc_dsgt"])
def test_host_comm_interval_matches_reference(name, delay, impl):
    """comm_interval=2 (mix on even steps only), with and without a stale
    window: 5 steps held as above."""
    _hold_host(*_host_runs(name, impl, steps=5, delay=delay,
                           comm_interval=2))


@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("name", ["dsgd", "mc_dsgt"])
def test_host_compressed_delayed_runs_match_reference(name, scheme):
    """Compressed (group 4: D = 12 takes three groups) and delayed by 1 on
    the host runtime: x, h and the residuals within RTOL/ATOL up to
    MAX_FLIPS flipped entries (none at this size), and the node sums of
    x + res_x held tightly, no entry excused."""
    state, js = _host_runs(name, "dense", delay=1,
                           compression=dict(scheme=scheme, group=4))
    streams = [("x", state.x, js.x), ("res_x", state.res[0], js.res[0])]
    if name == "mc_dsgt":
        streams += [("h", state.h, js.h), ("res_h", state.res[1], js.res[1])]
    for what, got, want in streams:
        _close_up_to_flips(got.numpy(), np.asarray(want), what)
    np.testing.assert_allclose((state.x + state.res[0]).sum(0).numpy(),
                               np.asarray(js.x + js.res[0]).sum(0),
                               rtol=RTOL, atol=ATOL)


def _close_up_to_flips(got, want, what):
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert bad.sum() <= MAX_FLIPS * bad.size, (
        f"{what}: {int(bad.sum())} of {bad.size} entries beyond rtol={RTOL} "
        f"atol={ATOL}")


@pytest.mark.parametrize("runtime", ["host-dense", "host-auto", "dist-dense",
                                     "dist-auto"])
def test_delay0_is_bit_exact(runtime):
    """delay=0 (and comm_interval=1) given explicitly runs the synchronous
    path: the same bits as the default rule after 3 MC-DSGT steps, and no
    stale state."""
    _, sched = _schedules(NA if runtime.startswith("dist") else N)
    states = []
    for kw in ({}, {"delay": 0, "comm_interval": 1}):
        if runtime.startswith("host"):
            (_, _), (grad, _) = _oracles()
            st, _ = driver.run_algorithm(
                alg.from_rule(engine.make_rule("mc_dsgt", 0.2, 2, **kw)),
                torch.zeros((N, D)), grad, sched, 3, torch.Generator(),
                gossip_impl=runtime.split("-")[1])
        else:
            st = _arch_port(_arch_inputs("mc_dsgt", 2), "mc_dsgt", 2,
                            runtime.split("-")[1], sched, **kw)
        states.append(st)
    a, b = states
    assert a.buf is None and b.buf is None
    for f in ("x", "h", "g_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_tracker_mean_is_kept_under_delay():
    """Doubly-stochastic windows make every stale correction mean-free, so
    h̄ = ḡ survives a delay: after each of 6 delayed (d = 1, 2) MC-DSGT
    steps on the realized schedule, the float64 node means of h and g_prev
    agree within 1e-6 (f32 rounding of entries of size ~0.1 over a few
    steps; the reference's bound is 1e-5)."""
    _, sched = _schedules(N)
    (_, _), (grad, _) = _oracles()
    for delay in (1, 2):
        algo = alg.from_rule(engine.make_rule("mc_dsgt", 0.2, 2, delay=delay))
        gen = torch.Generator()
        state = algo.warm(algo.init(torch.zeros((N, D))), grad, gen)
        Ws = torch.from_numpy(sched.stacked(0, 6 * algo.weights_per_step))
        for k in range(6):
            w = algo.weights_per_step
            state = algo.step(state, grad, Ws[k * w:(k + 1) * w], gen)
            gap = (state.h.double().mean(0)
                   - state.g_prev.double().mean(0)).abs().max()
            assert float(gap) < 1e-6, (delay, k, float(gap))


@pytest.mark.parametrize("delay", [0, 1])
def test_skipped_steps_mix_nothing(delay):
    """Under comm_interval=3 the engine calls the runtime's mixer only on
    steps 0 and 3 (x and h windows: 2 calls each); a skipped step under a
    stale window still advances the slots and applies (t + s) − s."""
    calls = []

    def mix(off, r, mat):
        calls.append(k)
        return mat.mul_(0.5).add_(mat.mean(0, keepdim=True), alpha=1.0)

    rule = engine.make_rule("mc_dsgt", 0.1, 2, delay=delay, comm_interval=3)
    g = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 6)).astype(np.float32))
    ops = engine.EngineOps(mix=mix, grad=lambda x, out=None: (
        None, (x + g) if out is None else out.copy_(x + g)))
    state = engine.warm_start(rule, engine.init_state(rule, g.clone()), ops)
    for k in range(5):
        slots = None if state.buf is None else state.buf[0][0].clone()
        z = None
        if k % 3 and delay:
            z = torch.add(state.x, state.h, alpha=-0.1)   # x − γ·h
        state, _ = engine.step(rule, state, ops)
        if z is not None:
            want = (z + slots) - slots
            assert torch.equal(state.x, want), k
            assert torch.equal(state.buf[0][-1], z), k
    assert calls == [0, 0, 3, 3]


@pytest.mark.parametrize("name", ["mc_dsgt", "gt_local"])
def test_bf16_tracker_slots_match_reference(name):
    """Trackers stored in bf16 (the runtime's ``cast_aux``, the arch
    trainer's ``aux_dtype``) under a delay of 1: the tracker's stale slots
    are stored through the cast, the stale bf16 payload is mixed in bf16
    and the correction formed in f32 then cast, as in the reference.  The
    engine against the reference's engine on the same ops (a dense mix and
    a quadratic oracle), 4 steps: x at RTOL/ATOL, h, g_prev and the slots
    within one bf16 ulp (2^-8) of the value, the rounding a few f32 ulps
    between the packages can flip."""
    n, d = 6, 32
    rng = np.random.default_rng(7)
    x0, c = (rng.standard_normal((n, d)).astype(np.float32)
             for _ in range(2))
    _, sched = _schedules(n, horizon=16)
    R = 2 if name == "mc_dsgt" else 1
    jrule = jengine.make_rule(name, 0.1, R, delay=1)
    rule = engine.make_rule(name, 0.1, R, delay=1)
    wps = rule.weights_per_step
    W = sched.stacked(0, 4 * wps).astype(np.float32)
    jc, tc = jnp.asarray(c), torch.from_numpy(c)

    def jmix(k):
        return lambda off, r, t: jalg.multi_consensus(
            jnp.asarray(W[k * wps + off:k * wps + off + r]), t)

    def tmix(k):
        return lambda off, r, t: alg.multi_consensus(
            torch.from_numpy(W[k * wps + off:k * wps + off + r]), t)

    def jops(k):
        return jengine.EngineOps(
            mix=jmix(k), grad=lambda x: (None, x - jc),
            local_update=lambda g, s: (g, s),
            cast_aux=lambda t: t.astype(jnp.bfloat16))

    def tops(k):
        return engine.EngineOps(
            mix=tmix(k), grad=lambda x, out=None: (None, x - tc),
            cast_aux=lambda t: t.to(torch.bfloat16))

    js = jengine.warm_start(jrule, jengine.init_state(
        jrule, jnp.asarray(x0)), jops(0))
    ts = engine.warm_start(rule, engine.init_state(
        rule, torch.from_numpy(x0.copy())), tops(0))
    for k in range(4):
        js, _ = jengine.step(jrule, js, jops(k))
        ts, _ = engine.step(rule, ts, tops(k))
    assert ts.h.dtype == ts.buf[1][0].dtype == torch.bfloat16
    np.testing.assert_allclose(ts.x.numpy(), np.asarray(js.x), rtol=RTOL,
                               atol=ATOL)
    for what, got, want in (("h", ts.h, js.h), ("g_prev", ts.g_prev,
                                                 js.g_prev),
                            ("buf_h", ts.buf[1][0], js.buf[1][0])):
        want = np.asarray(want.astype(jnp.float32))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -8,
                                   atol=ATOL, err_msg=what)


@pytest.mark.parametrize("delay", [0, 1, 2, 3])
@pytest.mark.parametrize("wps", [1, 4])
def test_telemetry_stale_window_matches_reference(delay, wps):
    """The recorder on the realized schedule: window, spectral and stale
    gaps, effective diameter, kinds and bytes of 8 steps equal the
    reference's (stale_gap only under a delay)."""
    jsched, sched = _schedules(N, horizon=8 * wps)
    jrec = jtelemetry.TelemetryRecorder(jsched, wps=wps, delay=delay)
    rec = telemetry.TelemetryRecorder(sched, wps=wps, delay=delay)
    x = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    for k in range(8):
        a = jrec.record(k, wps * (k + 1),
                        jalg.AlgoState(jnp.asarray(x), None, None, None, k),
                        {"loss": 1.0}, 0.1)
        b = rec.record(k, wps * (k + 1), alg.state_from_arrays(x),
                       {"loss": torch.tensor(1.0)}, 0.1)
        np.testing.assert_allclose(b.pop("consensus"), a.pop("consensus"),
                                   rtol=1e-5)
        assert a == b
        assert ("stale_gap" in b) == (delay > 0)


# ---------------------------------------------------------------------------
# The arch trainer
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _arch_inputs(algo, R):
    """The reference's initial parameters (as the port's tree) and 4
    token batches (numpy, seeded); read only, so made once."""
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    p0 = params_from_jax(jax.device_get(
        jbuild(jcfg).init(jax.random.key(0), jnp.float32)))
    rng = np.random.default_rng(1)
    return p0, [rng.integers(0, 128, (NA, R, B, S)).astype(np.int32)
                for _ in range(4)]


def _arch_port(inputs, algo, R, impl, sched, n_steps=3, **kw):
    """Warm start + ``n_steps`` steps of the port's ``make_train_step``."""
    p0, batches = inputs
    plan = sched.plan(0, sched.period)
    wps = engine.make_rule(algo, GAMMA, R).weights_per_step
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    init, warm, step = steps.make_train_step(
        model, None, algo=algo, gamma=GAMMA, R=R, gossip_impl=impl,
        plan=plan, **kw)
    ts = warm(init(p0, NA), {"tokens": torch.from_numpy(batches[0]).long()})
    tensors = driver.stage_plan(plan)
    for k in range(1, n_steps + 1):
        batch = {"tokens": torch.from_numpy(batches[k]).long()}
        t = (k - 1) * wps
        if impl == "auto":
            ts, _ = step(ts, batch, tensors, t % plan.period)
        else:
            ts, _ = step(ts, batch, torch.from_numpy(sched.stacked(t, wps)))
    return ts


def _arch_reference(algo, R, impl, jsched, n_steps=3, **kw):
    """The same run through the reference's jitted ``make_train_step``
    (its Pallas kernels interpreted under 'pallas')."""
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    comp = kw.pop("compression", None)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo=algo, gamma=GAMMA, R=R, gossip_impl=impl,
        pallas_interpret=True, pallas_block_d=16_384,
        compression=None if comp is None else jcompress.CompressionConfig(
            **comp), **kw)
    jstep = jax.jit(jstep)
    _, batches = _arch_inputs(algo, R)
    wps = jengine.make_rule(algo, GAMMA, R).weights_per_step
    js = jwarm(jinit(jax.random.key(0), NA, jnp.float32),
               {"tokens": jnp.asarray(batches[0])})
    for k in range(1, n_steps + 1):
        W = jsched.stacked((k - 1) * wps, wps)
        js, _ = jstep(js, {"tokens": jnp.asarray(batches[k])}, jnp.asarray(W))
    return js


def _in_layout(jtree, layout):
    """A JAX state tree as the port's (NA, D) matrix, zero in any padding."""
    want = {tuple(k.key for k in p): np.asarray(l, np.float32) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    mat = np.zeros((NA, layout.size), np.float32)
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        mat[:, off:off + size] = want[path].reshape(NA, size)
    return mat


def _arch_pairs(ts, js, layout):
    """(name, port matrix, reference matrix) of x, h, g_prev and every
    stale slot."""
    pairs = [(f, getattr(ts, f), _in_layout(getattr(js, f), layout))
             for f in ("x", "h", "g_prev") if getattr(ts, f) is not None]
    if js.buf is not None:
        for stream, q, jq in zip(("buf_x", "buf_h"), ts.buf, js.buf):
            if jq is None:
                assert q is None
                continue
            pairs += [(f"{stream}[{i}]", a, _in_layout(b, layout))
                      for i, (a, b) in enumerate(zip(q, jq))]
    return pairs


@pytest.fixture(scope="module")
def arch_reference():
    """The reference's delayed runs, one per (algo, delay), shared by the
    port's three impls."""
    cache = {}

    def get(algo, R, delay):
        if (algo, delay) not in cache:
            jsched, _ = _schedules(NA)
            cache[algo, delay] = _arch_reference(algo, R, "dense", jsched,
                                                 delay=delay)
        return cache[algo, delay]
    return get


@pytest.mark.parametrize("impl", ["dense", "pallas", "auto"])
@pytest.mark.parametrize("delay", [1, 2])
@pytest.mark.parametrize("algo,R", [("dsgd", 1), ("dsgt", 1), ("mc_dsgt", 2)])
def test_arch_delayed_steps_match_reference(algo, R, delay, impl,
                                            arch_reference):
    """Warm start + 3 delayed steps of a reduced qwen1.5 on the realized
    schedule through the port's dense, pallas (the gossip_mix kernel's
    plain CPU path) and auto (the plan's mixers) impls, against the
    reference's dense run: x, h, g_prev and every stale slot at
    RTOL/ATOL."""
    _, sched = _schedules(NA)
    ts = _arch_port(_arch_inputs(algo, R), algo, R, impl, sched, delay=delay)
    js = arch_reference(algo, R, delay)
    assert ts.step == int(js.step) == 3
    layout = steps.flat_layout(build(configs.get("qwen1.5-0.5b").reduced(
        **CUT)))
    for what, got, want in _arch_pairs(ts, js, layout):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


def test_arch_comm_interval_matches_reference():
    """comm_interval=2 inside a stale window of 1 in the arch trainer
    (MC-DSGT through the pallas impl, 3 steps: the middle one local, its
    correction (t + s) − s), against the reference's dense run: x, h,
    g_prev and the stale slots at RTOL/ATOL.  (The host runtime holds
    comm_interval without a delay.)"""
    jsched, sched = _schedules(NA)
    ts = _arch_port(_arch_inputs("mc_dsgt", 2), "mc_dsgt", 2, "pallas",
                    sched, delay=1, comm_interval=2)
    js = _arch_reference("mc_dsgt", 2, "dense", jsched, delay=1,
                         comm_interval=2)
    layout = steps.flat_layout(build(configs.get("qwen1.5-0.5b").reduced(
        **CUT)))
    for what, got, want in _arch_pairs(ts, js, layout):
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL,
                                   err_msg=what)


@pytest.mark.parametrize("algo,R,scheme", [("mc_dsgt", 2, "int8"),
                                           ("dsgd", 1, "sign")])
def test_arch_compressed_delayed_steps_match_reference(algo, R, scheme):
    """Compressed (group 256) and delayed by 1 through the fused window
    (the quantized_gossip_mix kernel's plain CPU path; the reference's
    Pallas kernel interpreted), warm start + 2 steps, slice 2's horizon:
    the second step mixes the first one's quantized stale payloads.  Every
    state tensor, stale slot and residual within RTOL/ATOL up to MAX_FLIPS
    flipped entries, and the node sums of x + res_x (and h + res_h) at
    RTOL/ATOL, no entry excused.  Not 3 steps: a flipped x entry moves its
    node's whole next gradient, so from the third step on the trackers
    differ wherever the gradients do (on this schedule also without a
    delay: 1,892 of g_prev's 366,592 entries past RTOL/ATOL after 2
    undelayed int8 steps, against 0 after one)."""
    jsched, sched = _schedules(NA)
    comp = compress.CompressionConfig(scheme=scheme, group=GROUP)
    ts = _arch_port(_arch_inputs(algo, R), algo, R, "pallas", sched,
                    n_steps=2, delay=1, compression=comp)
    js = _arch_reference(algo, R, "pallas", jsched, n_steps=2, delay=1,
                         compression=dict(scheme=scheme, group=GROUP))
    layout = steps.flat_layout(build(configs.get("qwen1.5-0.5b").reduced(
        **CUT)), comp)
    pairs = _arch_pairs(ts, js, layout)
    pairs.append(("res_x", ts.res[0], _in_layout(js.res[0], layout)))
    if algo != "dsgd":
        pairs.append(("res_h", ts.res[1], _in_layout(js.res[1], layout)))
    want = {}
    for what, got, w in pairs:
        want[what] = w
        _close_up_to_flips(got.numpy(), w, what)
    for a, b, r in (("x", "res_x", 0), ("h", "res_h", 1)):
        if b in want:
            got = (getattr(ts, a) + ts.res[r]).sum(0).numpy()
            np.testing.assert_allclose(got, (want[a] + want[b]).sum(0),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"node sum of {a} + {b}")
