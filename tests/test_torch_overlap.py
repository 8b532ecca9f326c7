"""The overlap proof against the JAX package: ``repro_torch.obs.
overlap_report`` (a taint analysis of the ops a PyTorch step dispatches)
gives the reference's verdict on every rule of the host runtime (delay 0,
1, 2; int8; a mixing cadence) and on the arch trainer's step (bench_async's
reduced-qwen scenario) on CPU and meta tensors; and ``chip_smoke.py``'s
reading of a profile of the stale window (``profile_split``,
``side_stream_gate``) on a synthetic trace.

The reference's ``overlap_report`` reads ``jax.core.Literal``, which jax 0.9
no longer has (its own test fails here, ROADMAP.md Queue 3), so the
reference's verdict comes from a copy of its loop (``repro/obs/trace.py``
``mix_depends_on_grad`` and the counts of ``overlap_report``) that differs in
one place only: ``jax.extend.core.Literal``.  The copy is first held to the
reference's own expectations.  Every input is drawn from seeded numpy."""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.extend.core import Literal  # noqa: E402

from repro import exp as jexp  # noqa: E402
from repro.core import algorithms as jalg, compress as jcompress  # noqa: E402
from repro.core import engine as jengine, gossip as jgossip  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.obs.trace import _eqn_scopes  # noqa: E402
from repro_torch import exp  # noqa: E402
from repro_torch.core import algorithms as alg, compress, engine  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.obs import mix_depends_on_grad, overlap_report  # noqa: E402

N, DIM, GAMMA = 6, 4, 0.2
RULES = ("dsgd", "local_sgd", "dsgt", "mc_dsgt", "gt_local", "d2")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The reference's verdict
# ---------------------------------------------------------------------------

def _ref_depends(jaxpr) -> bool:
    """``repro.obs.trace.mix_depends_on_grad``, ``jax.extend.core.Literal``
    in place of ``jax.core.Literal``."""
    closed = getattr(jaxpr, "jaxpr", jaxpr)
    tainted: set = set()
    for eqn in closed.eqns:
        scopes = _eqn_scopes(eqn)
        consumes = any(not isinstance(v, Literal) and v in tainted
                       for v in eqn.invars)
        if "obs_mix" in scopes and consumes:
            return True
        if "obs_grad" in scopes or consumes:
            tainted.update(eqn.outvars)
    return False


def _ref_report(fn, *args) -> dict:
    """``repro.obs.trace.overlap_report`` over :func:`_ref_depends`."""
    jaxpr = jax.make_jaxpr(fn)(*args)
    closed = jaxpr.jaxpr
    return {"overlapped": not _ref_depends(jaxpr),
            "mix_eqns": sum(1 for e in closed.eqns
                            if "obs_mix" in _eqn_scopes(e)),
            "grad_eqns": sum(1 for e in closed.eqns
                             if "obs_grad" in _eqn_scopes(e))}


def _centers():
    """``tests/test_async.py``'s quadratic: per-node centers, seed 0."""
    return np.random.default_rng(0).normal(size=(N, DIM)) * 2.0


def _comp(mod, compressed):
    return mod.CompressionConfig(scheme="int8", group=DIM) \
        if compressed else None


@functools.lru_cache(maxsize=None)
def _host_reference(name, delay, compressed=False, interval=1):
    """The reference's verdict on one host-runtime step of ``name`` from
    its warm start (the setup of ``tests/test_async.py:171-183``)."""
    centers = jnp.asarray(_centers())
    grad_fn = lambda xs, key: xs - centers  # noqa: E731
    algo = jalg.from_rule(jengine.make_rule(
        name, GAMMA, R=2 if name == "mc_dsgt" else 1, delay=delay,
        compression=_comp(jcompress, compressed), comm_interval=interval))
    key = jax.random.key(0)
    state = algo.warm(algo.init(jnp.zeros((N, DIM))), grad_fn, key)
    Ws = jnp.asarray(jgossip.theorem3_weight_schedule(N, 0.5).stacked(
        0, algo.weights_per_step))
    return _ref_report(lambda s: algo.step(s, grad_fn, Ws, key), state)


@pytest.mark.parametrize("delay,expect", [(0, False), (1, True)])
def test_reference_copy_keeps_the_references_expectations(delay, expect):
    """The copy of the reference's loop answers what the reference's own
    test (``test_overlap_report_proves_mix_grad_independence``) expects of
    it on the same step: mc_dsgt R = 2 is overlap-eligible only under a
    stale window."""
    rep = _host_reference("mc_dsgt", delay)
    assert rep["mix_eqns"] > 0 and rep["grad_eqns"] > 0
    assert rep["overlapped"] is expect


# ---------------------------------------------------------------------------
# The host runtime
# ---------------------------------------------------------------------------

def _host_port(name, delay, compressed=False, interval=1, k=0):
    """The port's verdict on its host runtime's step ``k`` of the same
    rule (the steps before it run outside the analysis)."""
    centers = torch.from_numpy(_centers()).float()
    grad_fn = lambda xs, gen: xs - centers  # noqa: E731
    algo = alg.from_rule(engine.make_rule(
        name, GAMMA, R=2 if name == "mc_dsgt" else 1, delay=delay,
        compression=_comp(compress, compressed), comm_interval=interval))
    gen = torch.Generator().manual_seed(0)
    state = algo.warm(algo.init(torch.zeros((N, DIM))), grad_fn, gen)
    wps = algo.weights_per_step
    sched = gossip.theorem3_weight_schedule(N, 0.5)
    for j in range(k):
        state = algo.step(state, grad_fn, torch.from_numpy(
            sched.stacked(j * wps, wps)), gen)
    Ws = torch.from_numpy(sched.stacked(k * wps, wps))
    return overlap_report(lambda s: algo.step(s, grad_fn, Ws, gen), state)


@pytest.mark.parametrize("compressed", [False, True])
@pytest.mark.parametrize("delay", [0, 1, 2])
@pytest.mark.parametrize("name", RULES)
def test_host_verdict_is_the_references(name, delay, compressed):
    """Every rule of the host runtime, full precision and int8 (groups of
    4), under delay 0, 1 and 2: the same verdict, each step entering at
    least one mix and one grad range.  The federated placements (local_sgd,
    gt_local) mix before their oracle and are eligible at delay 0 too."""
    want = _host_reference(name, delay, compressed)
    got = _host_port(name, delay, compressed)
    assert got["mix_eqns"] > 0 and got["grad_eqns"] > 0
    assert want["mix_eqns"] > 0 and want["grad_eqns"] > 0
    assert got["overlapped"] is want["overlapped"]


@pytest.mark.parametrize("delay", [0, 1, 2])
def test_host_verdict_under_comm_interval(delay):
    """mc_dsgt with comm_interval 2.  The reference gates the window in a
    ``lax.cond``, whose top-level equation carries no ``obs_mix`` tag, so
    its analysis counts no mix there and answers True vacuously.  The port
    gates on the host: a mixing step (k = 0) runs the ungated rule's mix
    and is held to the reference's verdict on that rule (comm_interval 1);
    a skipped step (k = 1) enters no mix range, vacuous as the
    reference's."""
    want = _host_reference("mc_dsgt", delay)
    got = _host_port("mc_dsgt", delay, interval=2)
    assert got["mix_eqns"] > 0 and got["grad_eqns"] > 0
    assert got["overlapped"] is want["overlapped"]
    skipped = _host_port("mc_dsgt", delay, interval=2, k=1)
    gated = _host_reference("mc_dsgt", delay, interval=2)
    assert skipped["mix_eqns"] == gated["mix_eqns"] == 0
    assert skipped["overlapped"] is gated["overlapped"] is True


def test_mix_depends_on_grad_is_the_negation():
    """``mix_depends_on_grad`` answers the report's question the other way
    round, on the same step."""
    for delay, want in ((0, True), (1, False)):
        centers = torch.from_numpy(_centers()).float()
        grad_fn = lambda xs, gen: xs - centers  # noqa: E731
        algo = alg.from_rule(engine.make_rule("dsgd", GAMMA, delay=delay))
        gen = torch.Generator()
        state = algo.init(torch.zeros((N, DIM)))
        Ws = torch.from_numpy(gossip.theorem3_weight_schedule(N, 0.5)
                              .stacked(0, 1))
        assert mix_depends_on_grad(
            lambda s: algo.step(s, grad_fn, Ws, gen), state) is want


def test_report_does_not_nest_and_leaves_no_analysis_open():
    """A report inside a report is refused; after either, no analysis is
    left for the engine's ranges to call."""
    with pytest.raises(RuntimeError, match="nest"):
        overlap_report(lambda: overlap_report(lambda: None))
    assert engine._analysis is None
    rep = overlap_report(lambda: torch.ones(3).add_(1))
    assert rep == {"overlapped": True, "mix_eqns": 0, "grad_eqns": 0}
    assert engine._analysis is None


# ---------------------------------------------------------------------------
# The arch trainer (bench_async's reduced-qwen scenario)
# ---------------------------------------------------------------------------

NODES = 4
LM = {"data.batch": 1, "data.seq": 16, "data.active_vocab": 16,
      "topology.kind": "sun", "topology.beta": 0.5, "run.nodes": NODES}


def _lm_overrides(algo, delay):
    return dict(LM, **{"algorithm.name": algo, "algorithm.delay": delay,
                       "algorithm.R": 2 if algo == "mc_dsgt" else 1})


@functools.lru_cache(maxsize=None)
def _lm_inputs(algo):
    """Two token batches (n, R, 1, 16) below the active vocab, seeded."""
    R = 2 if algo == "mc_dsgt" else 1
    rng = np.random.default_rng(5)
    return [rng.integers(0, 16, (NODES, R, 1, 16)).astype(np.int32)
            for _ in range(2)]


@functools.lru_cache(maxsize=None)
def _lm_reference(algo, delay):
    """``benchmarks/run.py`` ``bench_async``'s verdict: the reference's
    un-jitted ``make_train_step`` from its warm start, on this file's
    batches."""
    spec = jexp.with_overrides(jexp.ExperimentSpec(),
                               _lm_overrides(algo, delay))
    b = jexp.build(spec)
    init_s, warm, step = jsteps.make_train_step(
        b.model, b.cfg, algo=algo, gamma=spec.algorithm.gamma, R=b.rule.R,
        delay=delay)
    t0, t1 = _lm_inputs(algo)
    state = warm(init_s(jax.random.key(spec.run.seed), NODES, jnp.float32),
                 {"tokens": jnp.asarray(t0)})
    W = jnp.asarray(b.schedule.stacked(0, b.wps))
    return _ref_report(step, state, {"tokens": jnp.asarray(t1)}, W), \
        np.array(W)


@pytest.mark.parametrize("device,impl", [("cpu", "dense"), ("meta", "dense"),
                                         ("meta", "pallas")])
@pytest.mark.parametrize("delay", [0, 1])
@pytest.mark.parametrize("algo", ["dsgd", "mc_dsgt"])
def test_trainer_verdict_is_the_references(algo, delay, device, impl):
    """The port's ``make_train_step`` on the same scenario: on CPU tensors
    (every op runs, the plain mixers) and on meta tensors (nothing
    executes, as the reference's ``make_jaxpr``), through the dense mixer
    and through ``gossip_mix``'s meta route, which reads the state through
    no aten op (the engine's range boundary carries the taint): the
    reference's verdict, False at delay 0 and True at delay 1."""
    want, W = _lm_reference(algo, delay)
    assert want["overlapped"] is bool(delay)
    spec = exp.with_overrides(exp.ExperimentSpec(), _lm_overrides(algo, delay))
    b = exp.build(spec, device="cpu")
    init_s, warm, step = steps.make_train_step(
        b.model, b.cfg, algo=algo, gamma=spec.algorithm.gamma, R=b.rule.R,
        delay=delay, gossip_impl=impl)
    if device == "cpu":
        params = b.model.init(torch.Generator().manual_seed(0),
                              torch.float32, "cpu")
        batches = [{"tokens": torch.from_numpy(t).long()}
                   for t in _lm_inputs(algo)]
    else:
        params = b.model.empty(torch.float32, "meta")
        batches = [{"tokens": torch.empty(t.shape, dtype=torch.int64,
                                          device="meta")}
                   for t in _lm_inputs(algo)]
    state = warm(init_s(params, NODES), batches[0])
    got = overlap_report(step, state, batches[1],
                         torch.from_numpy(W).to(device))
    assert got["mix_eqns"] > 0 and got["grad_eqns"] > 0
    assert got["overlapped"] is want["overlapped"]


# ---------------------------------------------------------------------------
# The smoke's reading of a profile (chip_smoke.py profile_split)
# ---------------------------------------------------------------------------

def _smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("repo_chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _trace(tmp_path, h_stream, steps):
    """A Chrome trace of ``steps`` delayed steps, µs: the x and h windows
    launched at 1 and 2 (x's kernel on stream 14 over 3–9, h's on
    ``h_stream`` over 10–16), the update's kernel on stream 7 over 0–12,
    the oracle's over 14–40 and 40–50 on stream 7; each step 100 µs on."""
    ev, corr = [], iter(range(1, 10_000))

    def span(name, a, b):
        ev.append({"ph": "X", "cat": "user_annotation", "name": name,
                   "ts": a, "dur": b - a})

    def kernel(launch, a, b, stream):
        c = next(corr)
        ev.append({"ph": "X", "cat": "cuda_runtime", "name": "launch",
                   "ts": launch, "dur": 0.5, "args": {"correlation": c}})
        ev.append({"ph": "X", "cat": "kernel", "name": "k", "ts": a,
                   "dur": b - a, "args": {"correlation": c,
                                          "stream": stream}})

    for k in range(steps):
        t = 100 * k
        span("obs:step", t, t + 60)
        span("obs_mix", t + 1, t + 1.5)
        kernel(t + 1.2, t + 3, t + 9, 14)
        span("obs_mix", t + 2, t + 2.5)
        kernel(t + 2.2, t + 10, t + 16, h_stream)
        kernel(t + 3, t, t + 12, 7)
        span("obs_grad", t + 4, t + 8)
        kernel(t + 5, t + 14, t + 40, 7)
        kernel(t + 6, t + 40, t + 50, 7)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_profile_split_reads_the_windows_beside_the_oracle(tmp_path,
                                                            monkeypatch):
    """Per step: the oracle's stream and span, each window's stream, its
    device ms, the ms beside another stream's kernels and inside the
    oracle's span; the gate passes with the h window on its own stream and
    fails with it on the oracle's."""
    smoke = _smoke()
    split = smoke.profile_split(_trace(tmp_path, 14, smoke.STEPS))
    assert len(split["per_step"]) == smoke.STEPS
    rec = split["per_step"][0]
    assert rec["oracle_streams"] == [7] and rec["oracle_ms"] == 36e-3
    x, h = rec["windows"]
    assert x["streams"] == h["streams"] == [14]
    assert x["ms"] == h["ms"] == 6e-3
    # x over 3–9 beside the update (0–12); h over 10–16 beside the update
    # until 12 and the oracle from 14
    assert x["beside_ms"] == 6e-3 and h["beside_ms"] == 4e-3
    assert x["in_oracle_ms"] == 0 and h["in_oracle_ms"] == 2e-3
    assert h["issued_ms"] == pytest.approx(-11.8e-3)
    assert h["start_ms"] == -4e-3
    smoke.side_stream_gate(split, "synthetic")
    on_oracle = smoke.profile_split(_trace(tmp_path, 7, smoke.STEPS))
    monkeypatch.setattr(smoke, "fail", lambda msg: (_ for _ in ()).throw(
        AssertionError(msg)))
    with pytest.raises(AssertionError, match="oracle's stream"):
        smoke.side_stream_gate(on_oracle, "synthetic")
