"""Slice 3 of the port against the JAX package: the sampled-client scenario
(``random-sampled`` + drop + churn, edge-list plans, sparse telemetry), the
``sparse_gossip_mix`` op with the ``sparse_segment_mix`` segment sum (the
JAX side runs its Pallas kernel in interpret mode), both ``make_mixer``
routes, the logreg host runtime, the gates that still raise, and the
observability and checkpoint axes that now run on every runtime.  The
CUDA kernel itself is held to its plain version on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import exp as jexp, sparse as jsparse  # noqa: E402
from repro.core import algorithms as jalg, driver as jdriver  # noqa: E402
from repro.core import engine as jengine, gossip as jgossip  # noqa: E402
from repro.data import logreg_dataset as jlogreg_dataset  # noqa: E402
from repro.data import logreg_loss_and_grad as jlogreg_loss  # noqa: E402
from repro.exp import registry as jregistry  # noqa: E402
from repro.kernels import ops as jops, ref as jref  # noqa: E402
from repro.sim import telemetry as jtelemetry  # noqa: E402
from repro_torch import exp, sparse  # noqa: E402
from repro_torch.core import algorithms as alg, driver, engine  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.data import logreg_dataset, logreg_loss_and_grad  # noqa: E402
from repro_torch.exp import registry  # noqa: E402
from repro_torch.kernels import ops, sparse_gossip  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs.metrics import read_events  # noqa: E402
from repro_torch.sim import telemetry  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SRC = REPO / "src"
# The reference's own tolerance for the sparse mix (tests/test_sparse.py):
# the same f32 products summed in another order (index_add_ vs segment_sum
# vs the Pallas one-hot matmul).
ATOL = 1e-5
# A few steps of training carry those reorderings through the tracker.
RTOL_RUN, ATOL_RUN = 1e-4, 1e-5
N, K, D, M, SEED = 2000, 32, 16, 8, 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _body(fn: ast.FunctionDef) -> str:
    """A function's code without its docstring."""
    body = fn.body[1:] if (isinstance(fn.body[0], ast.Expr) and isinstance(
        fn.body[0].value, ast.Constant)) else fn.body
    return ast.dump(ast.Module(body=body, type_ignores=[]))


def _function(path: Path, name: str) -> ast.FunctionDef:
    return next(node for node in ast.walk(ast.parse(path.read_text()))
                if isinstance(node, ast.FunctionDef) and node.name == name)


@pytest.mark.parametrize("module", [
    "sim/hashrand.py", "sim/channel.py", "sim/faults.py",
    "sparse/schedule.py", "sparse/sampled.py", "sparse/realize.py",
    "sparse/smoke.py", "sparse/__init__.py"])
def test_copies_are_verbatim(module):
    assert (SRC / "repro_torch" / module).read_text() == \
        (SRC / "repro" / module).read_text()


def test_numpy_parts_of_the_ports_are_the_references():
    """plan.py is the reference up to its mixer; sparse_windowed_gap is the
    reference's numpy (docstrings aside)."""
    cut = "    def make_mixer("
    port = (SRC / "repro_torch" / "sparse" / "plan.py").read_text()
    ref_ = (SRC / "repro" / "sparse" / "plan.py").read_text()
    assert port.split(cut)[0] == ref_.split(cut)[0]
    for mod, name in (("sparse/telemetry.py", "sparse_windowed_gap"),
                      ("sim/telemetry.py", "windowed_spectral_gap"),
                      ("sim/telemetry.py", "empirical_effective_diameter")):
        assert _body(_function(SRC / "repro_torch" / mod, name)) == \
            _body(_function(SRC / "repro" / mod, name))


def _scenario(pkg, n=N, horizon=24):
    """The seeded sampled scenario, realized with drop + churn, through the
    JAX package (``pkg`` "jax") or the port."""
    if pkg == "jax":
        from repro.exp import spec
        reg, realize = jregistry, jsparse.realize_sparse_schedule
    else:
        from repro_torch.exp import spec
        reg, realize = registry, sparse.realize_sparse_schedule
    sched = reg.build_topology(
        spec.TopologySpec(kind="random-sampled", sample_k=K, radius=0.45),
        n, horizon=horizon, seed=SEED)
    models = reg.build_channel_models(
        spec.ChannelSpec(link_drop=0.2, churn=0.02), SEED)
    return realize(sched, models)


def _fields(plan) -> dict:
    return {f: getattr(plan, f) for f in ("n", "src", "dst", "w", "offsets",
                                          "diags")}


def test_sampled_scenario_bit_equal():
    a, b = _scenario("jax"), _scenario("torch")
    assert a.period == b.period == 24
    assert b.edges_per_round.sum() > 0
    for r in range(a.period):
        ra, rb = a.round(r), b.round(r)
        for f in ("src", "dst", "w"):
            x, y = getattr(ra, f), getattr(rb, f)
            assert x.dtype == y.dtype and np.array_equal(x, y)
    pa, pb = a.plan(), b.plan()
    assert np.array_equal(pa.offsets, pb.offsets)
    assert pa.kinds == pb.kinds
    ta, tb = pa.tensors(), pb.tensors()
    assert ta.keys() == tb.keys()
    for k in ta:
        assert ta[k].dtype == tb[k].dtype and np.array_equal(ta[k], tb[k]), k
    window = [b.round(r) for r in range(8)]
    assert sparse.sparse_windowed_gap(window) == \
        jsparse.sparse_windowed_gap([a.round(r) for r in range(8)])


@pytest.mark.parametrize("use_pallas", [False, True])
def test_sparse_gossip_mix_matches_reference(use_pallas):
    """One padded round (pad edges w = 0, pad slots = n) through both
    packages' ops; the JAX kernel runs in interpret mode."""
    t = {k: v[2] for k, v in _scenario("torch").plan().tensors().items()}
    assert (t["slots"] == N).any() and (t["ew"] == 0).any()  # padding present
    x = np.random.default_rng(0).standard_normal((N, D)).astype(np.float32)
    args = [t[k] for k in ("esrc", "edst", "ew", "seg", "slots")]
    want = np.asarray(jops.sparse_gossip_mix(
        jnp.asarray(x), *map(jnp.asarray, args), use_pallas=use_pallas))
    before = sparse_gossip.sparse_segment_mix.launches
    got = ops.sparse_gossip_mix(torch.from_numpy(x.copy()),
                                *map(torch.from_numpy, args),
                                use_pallas=use_pallas)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    assert sparse_gossip.sparse_segment_mix.launches == before  # CPU: plain


@pytest.mark.parametrize("E,S", [(0, 1), (1, 1), (511, 7), (513, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_layout_and_wrapper_match_plain(E, S, dtype):
    """The wrapper's CPU path on edges grouped by segment_layout equals the
    JAX oracle on the ungrouped edges, with repeated src, dst and seg and
    padded edges (seg >= S lies in no segment)."""
    rng = np.random.default_rng(E + S)
    n = 300
    x = rng.standard_normal((n, 7)).astype(np.float32)
    src = rng.integers(0, n, E)
    dst = rng.integers(0, 40, E)
    w = rng.random(E).astype(np.float32)
    seg = rng.integers(0, S, E)
    pad = rng.random(E) < 0.1
    seg_p = np.where(pad, S, seg)
    tx = torch.from_numpy(x).to(dtype)
    xf = tx.float().numpy()
    want = np.asarray(jref.sparse_gossip_mix_ref(
        jnp.asarray(seg[~pad]), jnp.asarray(w[~pad]),
        jnp.asarray(xf[src[~pad]]), jnp.asarray(xf[dst[~pad]]), S))
    layout = sparse_gossip.segment_layout(
        *(torch.from_numpy(a) for a in (src, dst, w, seg_p)), S)
    assert layout[3].shape == (S + 1,) and int(layout[3][-1]) == (~pad).sum()
    got = sparse_gossip.sparse_segment_mix(tx, *layout)
    assert got.dtype == torch.float32 and got.shape == (S, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("use_pallas", [False, True])
def test_plan_mixers_match_reference_window(use_pallas):
    plan = _scenario("torch").plan()
    jplan = jsparse.SparseGossipPlan(**_fields(plan))
    x = np.random.default_rng(1).standard_normal((N, 3, 4)).astype(np.float32)
    jt = {k: jnp.asarray(v) for k, v in jplan.tensors().items()}
    want = np.asarray(jplan.make_mixer(use_pallas=use_pallas)(
        jt, 5, 6, {"a": jnp.asarray(x)})["a"])
    mixer = plan.make_mixer(use_pallas=use_pallas)
    tensors = driver.stage_plan(plan)
    tx = torch.from_numpy(x.copy())
    got = mixer(tensors, 5, 6, tx)
    assert got.data_ptr() == tx.data_ptr()   # in place
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    # a second window on the same staged plan reuses its prepared rounds
    got2 = mixer(tensors, 23, 2, torch.from_numpy(x.copy()))
    want2 = np.asarray(jplan.make_mixer(use_pallas=use_pallas)(
        jt, 23, 2, {"a": jnp.asarray(x)})["a"])
    np.testing.assert_allclose(got2.numpy(), want2, rtol=ATOL, atol=ATOL)


def test_logreg_data_and_gradients_match_reference():
    H, y = logreg_dataset(6, M, D, seed=SEED)
    jH, jy = jlogreg_dataset(6, M, D, seed=SEED)
    assert np.array_equal(H.numpy(), np.asarray(jH))
    assert np.array_equal(y.numpy(), np.asarray(jy))
    rng = np.random.default_rng(4)
    xs = (0.5 * rng.standard_normal((6, D))).astype(np.float32)
    idx = rng.integers(0, M, (6, 4))
    Hb, yb = np.take_along_axis(np.asarray(jH), idx[..., None], 1), \
        np.take_along_axis(np.asarray(jy), idx, 1)
    rho = 0.1
    tl, tfull, tstoch, tgl, tgn = logreg_loss_and_grad(rho)
    jl, jfull, _, jgl, jgn = jlogreg_loss(rho)
    # one pre-gathered minibatch
    np.testing.assert_allclose(
        tfull(torch.from_numpy(xs), torch.from_numpy(Hb),
              torch.from_numpy(yb)).numpy(),
        np.asarray(jfull(jnp.asarray(xs), jnp.asarray(Hb), jnp.asarray(yb))),
        rtol=1e-5, atol=1e-7)
    xb = xs.mean(0)
    for t_fn, j_fn in ((tgl, jgl), (tgn, jgn)):
        np.testing.assert_allclose(
            float(t_fn(torch.from_numpy(xb), H, y)),
            float(j_fn(jnp.asarray(xb), jH, jy)), rtol=1e-5)
    np.testing.assert_allclose(
        float(tl(torch.from_numpy(xs[0]), H[0], y[0])),
        float(jl(jnp.asarray(xs[0]), jH[0], jy[0])), rtol=1e-5)
    # the stochastic oracle is the full one on the indices its generator drew
    gen = torch.Generator().manual_seed(7)
    got = tstoch(torch.from_numpy(xs), H, y, gen, 4)
    idx = torch.randint(0, M, (6, 4), generator=torch.Generator().manual_seed(7))
    want = tfull(torch.from_numpy(xs), H.gather(1, idx[..., None].expand(
        -1, -1, D)), y.gather(1, idx))
    assert torch.equal(got, want)


class _KernelPlan(sparse.SparseGossipPlan):
    """The staged plan with its mixer asking for the segment-sum kernel."""

    def make_mixer(self, **kw):
        return super().make_mixer(**kw, use_pallas=True)


def _reference_run(sched, gossip_impl, n=N, steps=3):
    """JAX: MC-DSGT (R=2) with the full-batch oracle, evals every step."""
    H, y = jlogreg_dataset(n, M, D, seed=SEED)
    _, full, _, _, gn = jlogreg_loss(0.1)
    algo = jalg.from_rule(jengine.make_rule("mc_dsgt", 0.3, R=2))
    return jdriver.run_algorithm(
        algo, jnp.zeros((n, D)), lambda xs, key: full(xs, H, y), sched,
        steps, jax.random.key(0), eval_fn=lambda xb: gn(xb, H, y),
        gossip_impl=gossip_impl)


@pytest.mark.parametrize("route", ["scatter", "kernel", "dense"])
def test_run_algorithm_matches_reference(route):
    """3 MC-DSGT steps with the full-batch oracle (so no minibatch draws
    need replaying): the edge plan through the scatter mixer and through
    the kernel's wrapper, and the dense host path on a smaller fleet."""
    n = 300 if route == "dense" else N
    impl = "dense" if route == "dense" else "auto"
    sched = _scenario("torch", n)
    js, jhist = _reference_run(_scenario("jax", n), impl, n)
    H, y = logreg_dataset(n, M, D, seed=SEED)
    _, full, _, _, gn = logreg_loss_and_grad(0.1)
    plan = sched.plan()
    if route == "kernel":
        plan = _KernelPlan(**_fields(plan))
    x0 = torch.zeros((n, D))
    before = sparse_gossip.sparse_segment_mix.launches
    state, hist = driver.run_algorithm(
        alg.from_rule(engine.make_rule("mc_dsgt", 0.3, R=2)), x0,
        lambda xs, gen: full(xs, H, y), sched, 3, torch.Generator(),
        eval_fn=lambda xb: gn(xb, H, y), gossip_impl=impl, plan=plan)
    assert sparse_gossip.sparse_segment_mix.launches == before   # CPU
    assert not x0.any()                     # the caller's x0 is not mutated
    assert [t for t, _ in hist] == [t for t, _ in jhist] == [4, 8, 12]
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL_RUN)
    for f in ("x", "h", "g_prev"):
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(js, f)),
                                   rtol=RTOL_RUN, atol=ATOL_RUN, err_msg=f)


def test_state_carried_across_continues_the_reference():
    """A JAX mid-run state, carried into the port, takes the same next step
    through both routes."""
    jsched, sched = _scenario("jax"), _scenario("torch")
    js, _ = _reference_run(jsched, "auto", steps=2)
    H, y = jlogreg_dataset(N, M, D, seed=SEED)
    _, jfull, _, _, _ = jlogreg_loss(0.1)
    jalgo = jalg.from_rule(jengine.make_rule("mc_dsgt", 0.3, R=2))
    jplan = jsched.plan()
    jnext = jalg.plan_step(jalgo, jplan)(
        js, lambda xs, key: jfull(xs, H, y), jdriver.stage_plan(jplan), 8,
        jax.random.key(1))
    tH, ty = logreg_dataset(N, M, D, seed=SEED)
    _, full, _, _, _ = logreg_loss_and_grad(0.1)
    algo = alg.from_rule(engine.make_rule("mc_dsgt", 0.3, R=2))
    for plan in (sched.plan(), _KernelPlan(**_fields(sched.plan()))):
        state = alg.state_from_arrays(np.asarray(js.x), np.asarray(js.h),
                                      np.asarray(js.g_prev), int(js.k))
        nxt = alg.plan_step(algo, plan)(
            state, lambda xs, gen: full(xs, tH, ty),
            driver.stage_plan(plan), 8, torch.Generator())
        assert nxt.k == int(jnext.k) == 3
        for f in ("x", "h", "g_prev"):
            np.testing.assert_allclose(getattr(nxt, f).numpy(),
                                       np.asarray(getattr(jnext, f)),
                                       rtol=RTOL_RUN, atol=ATOL_RUN,
                                       err_msg=f)


def _example_specs():
    path = REPO / "examples" / "sampled_clients.py"
    spec = importlib.util.spec_from_file_location("sampled_clients", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SPECS


def test_exp_run_on_the_examples_sampled_auto_spec():
    jspec_ = _example_specs()["sampled_auto"]
    spec = exp.from_dict(jexp.to_dict(jspec_))
    assert exp.spec_hash(spec) == jexp.spec_hash(jspec_)
    res = exp.run(spec, device="cpu", quiet=True)
    assert [t for t, _ in res.history] == [4, 20]  # eval_every = steps = 5
    assert np.isfinite(res.history[-1][1])
    assert res.state.x.shape == (1000, 8) and bool(res.state.x.isfinite().all())
    tl = res.telemetry.history
    assert len(tl) == 5 and all(np.isfinite(h["consensus"]) for h in tl)
    assert res.built.realized == jexp.build(jspec_).realized
    assert set(res.built.seconds) == {"schedule", "plan", "data"}


def test_telemetry_recorders_match_reference():
    """The same realized schedule and state through both packages'
    recorders: equal window metrics and bytes, consensus to f32 rounding."""
    jsched, sched = _scenario("jax"), _scenario("torch")
    x = np.random.default_rng(5).standard_normal((N, D)).astype(np.float32)
    dense = gossip.theorem3_weight_schedule(8, 0.75)
    jdense = jgossip.theorem3_weight_schedule(8, 0.75)
    xd = x[:8]
    pairs = [(jsparse.SparseTelemetryRecorder(jsched, wps=4),
              sparse.SparseTelemetryRecorder(sched, wps=4), x),
             (jtelemetry.TelemetryRecorder(jdense, wps=4),
              telemetry.TelemetryRecorder(dense, wps=4), xd)]
    for jrec, rec, xs in pairs:
        for k in range(3):
            jst = jalg.AlgoState(jnp.asarray(xs), None, None, None, k)
            a = jrec.record(k, 4 * (k + 1), jst, {"loss": 1.5}, 0.25)
            b = rec.record(k, 4 * (k + 1), alg.state_from_arrays(xs),
                           {"loss": torch.tensor(1.5)}, 0.25)
            np.testing.assert_allclose(b.pop("consensus"),
                                       a.pop("consensus"), rtol=1e-5)
            assert a == b
        assert rec.bytes_total == jrec.bytes_total > 0


@pytest.mark.parametrize("overrides,match", [
    ({"model.arch": "whisper-tiny"}, "item 9"),
    ({"data.hetero_alpha": 0.1, "model.arch": "whisper-tiny"},
     "item 9"),
    ({"model.arch": "whisper-tiny", "run.gossip_impl": "pallas"}, "item 9"),
])
def test_unported_axes_still_raise(overrides, match):
    """The encoder-decoder (ROADMAP.md Queue 1 item 9 part 6), refused
    until it was ported, builds on each of these axes: its model, and a
    stream that gives the batch its frames."""
    del match
    built = exp.build(exp.with_overrides(exp.ExperimentSpec(), overrides),
                      device="cpu")
    assert built.cfg.arch_type == "audio"
    assert "frames" in built.stream.batch_at(0)


_SAMPLED = {"model.kind": "logreg", "model.d": 4, "model.m": 4,
            "topology.kind": "random-sampled", "topology.sample_k": 8,
            "run.nodes": 64, "run.gossip_impl": "auto"}


@pytest.mark.parametrize("overrides", [
    {"run.checkpoint": "c.msgpack"},
    {"run.restore": "c.msgpack"},
    {"obs.profile_dir": "prof"},
    {"model.kind": "logreg", "obs.metrics": "m.jsonl"},
    {"obs.metrics": "m.jsonl"},
    {"sampled": True, "obs.metrics": "m.jsonl"},
    {"sampled": True, "obs.profile_dir": "prof"},
])
def test_obs_and_checkpoint_axes_run(overrides, tmp_path, monkeypatch):
    """The observability and checkpoint axes (ROADMAP Queue 1 items 4 and
    10) build and run one step on the CPU, on the arch runtime, the logreg
    host runtime and the sampled-client family: the event log ends in its
    summary, the profile is written, the checkpoint exists and a restore of
    it resumes at its step."""
    monkeypatch.chdir(tmp_path)
    overrides = dict(overrides)
    base = exp.with_overrides(exp.ExperimentSpec(), {
        "run.steps": 1, "run.nodes": 2, "topology.beta": 0.5,
        "data.batch": 1, "data.seq": 16})
    if overrides.pop("sampled", False):
        base = exp.with_overrides(base, _SAMPLED)
    if "run.restore" in overrides:
        exp.run(exp.with_field(base, "run.checkpoint", "c.msgpack"),
                device="cpu", quiet=True)
    res = exp.run(exp.with_overrides(base, overrides), device="cpu",
                  quiet=True)
    if res.spec.model.kind == "arch":
        assert all(np.isfinite(h["loss"]) for h in res.history)
    else:
        assert all(np.isfinite(v) for _, v in res.history)
    if "obs.metrics" in overrides:
        events = read_events("m.jsonl")
        assert [e["event"] for e in events][0] == "meta"
        assert events[-1]["event"] == "summary"
        assert "grad_norm" in read_events("m.jsonl", "step")[0]
    if "obs.profile_dir" in overrides:
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    if "run.checkpoint" in overrides:
        assert (tmp_path / "c.msgpack").stat().st_size > 0
    if "run.restore" in overrides:
        assert res.state.step == 2


@pytest.mark.parametrize("overrides", [
    {"topology.kind": "random-sampled", "topology.sample_k": 8,
     "run.nodes": 64},                                             # arch
    {"model.kind": "logreg", "topology.kind": "random-sampled",
     "topology.sample_k": 8, "run.nodes": 10_000},                 # dense guard
    {"model.kind": "logreg", "topology.kind": "random-sampled",
     "topology.sample_k": 8, "run.nodes": 64, "run.gossip_impl": "pallas"},
    {"model.kind": "logreg", "topology.kind": "random-sampled",
     "topology.sample_k": 1, "run.nodes": 64, "run.gossip_impl": "auto"},
])
def test_reference_checks_refuse_what_the_reference_refuses(overrides):
    spec = exp.with_overrides(exp.ExperimentSpec(), overrides)
    with pytest.raises(ValueError):
        jexp.build(jexp.from_dict(exp.to_dict(spec)))
    with pytest.raises(ValueError):
        exp.build(spec, device="cpu")


def test_dense_gossip_plan_raises_its_item():
    """(Named when a dense plan still raised.)  ``plan_step`` on the
    theorem-3 schedule's dense plan (four ``sun`` rounds): 2 MC-DSGT steps
    from one staged copy of ``plan.tensors()`` equal the reference's
    ``plan_step`` at rtol 1e-4 / atol 1e-5 (both ``dynamic``)."""
    sched = gossip.theorem3_weight_schedule(4, 0.75)
    jsched = jgossip.theorem3_weight_schedule(4, 0.75)
    plan, jplan = sched.plan(0, 4), jsched.plan(0, 4)
    pstep = alg.plan_step(alg.from_rule(engine.make_rule("mc_dsgt", 0.3,
                                                         R=2)), plan)
    jstep = jalg.plan_step(jalg.from_rule(jengine.make_rule("mc_dsgt", 0.3,
                                                            R=2)), jplan)
    assert pstep.dispatch == jstep.dispatch == "dynamic"
    jH, jy = jlogreg_dataset(4, 8, 5, seed=1)
    _, jfull, _, _, _ = jlogreg_loss(0.1)
    H, y = logreg_dataset(4, 8, 5, seed=1)
    _, full, _, _, _ = logreg_loss_and_grad(0.1)
    jgrad = lambda xs, key: jfull(xs, jH, jy)  # noqa: E731
    grad = lambda xs, gen: full(xs, H, y)  # noqa: E731
    x0 = np.random.default_rng(2).standard_normal((4, 5)).astype(np.float32)
    ja = jalg.from_rule(jengine.make_rule("mc_dsgt", 0.3, R=2))
    js = ja.warm(ja.init(jnp.asarray(x0)), jgrad, jax.random.key(0))
    a = alg.from_rule(engine.make_rule("mc_dsgt", 0.3, R=2))
    ts = a.warm(a.init(torch.from_numpy(x0)), grad, torch.Generator())
    jt = jax.tree.map(jnp.asarray, jplan.tensors())
    tt = driver.stage_plan(plan)
    for k in range(2):
        js = jstep(js, jgrad, jt, 4 * k % 4, jax.random.key(k))
        ts = pstep(ts, grad, tt, 4 * k % 4, torch.Generator())
    for f in ("x", "h", "g_prev"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-4,
                                   atol=1e-5, err_msg=f)


def test_registry_builds_the_references_sampled_schedule():
    from repro.exp import spec as jspec
    from repro_torch.exp import spec as tspec
    kw = dict(kind="random-sampled", sample_k=16, radius=0.3)
    a = jregistry.build_topology(jspec.TopologySpec(**kw), 500, horizon=12,
                                 seed=1)
    b = registry.build_topology(tspec.TopologySpec(**kw), 500, horizon=12,
                                seed=1)
    assert b.is_sparse and b.period == a.period == 12
    assert np.array_equal(a.stacked(0, 12), b.stacked(0, 12))


def test_cli_runs_the_sampled_path_on_cpu(capsys):
    history = train.main([
        "--arch", "logreg", "--logreg-d", "8", "--logreg-m", "8", "--batch",
        "4", "--topology", "random-sampled", "--nodes", "500", "--sample-k",
        "16", "--link-drop", "0.2", "--churn", "0.02", "--algo", "mc_dsgt",
        "--R", "2", "--gamma", "0.3", "--gossip-impl", "auto", "--steps",
        "3", "--device", "cpu"])
    assert [t for t, _ in history] == [4, 8, 12]
    assert all(np.isfinite(v) for _, v in history)
    out = capsys.readouterr().out
    assert "step     2" in out and "grad_norm2" in out
