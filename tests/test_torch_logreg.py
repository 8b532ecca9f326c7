"""The rest of the logreg host path (the paper's §6) against the JAX package:
Dirichlet data, the ``dsgd``/``dsgt``/``mc_dsgt`` factories through
``algorithms.run`` on dense time-varying schedules, the host runtime's
compressed window (on the dense mixer and on an edge plan, with the
reference's pad to the quantization group), ``exp.weights_per_step``, the
lifted gates through ``exp.run`` and the train CLI, and the twins of the
three examples.  Every input is made with numpy from a fixed seed; oracles
are full-batch where the two packages must agree step for step, since the
port's minibatch draws come from a ``torch.Generator``."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import exp as jexp  # noqa: E402
from repro.core import algorithms as jalg, engine as jengine  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.data import (  # noqa: E402
    dirichlet_partition as jdirichlet_partition,
    logreg_dataset as jlogreg_dataset,
    logreg_dataset_dirichlet as jlogreg_dirichlet,
    logreg_loss_and_grad as jlogreg_loss,
)
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro_torch import exp  # noqa: E402
from repro_torch.core import algorithms as alg, compress, engine  # noqa: E402
from repro_torch.data import (  # noqa: E402
    dirichlet_partition,
    logreg_dataset,
    logreg_dataset_dirichlet,
    logreg_loss_and_grad,
)
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.launch import train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# The host runtime's tolerances (tests/test_torch_sparse.py): a few steps
# carry reordered f32 sums through the tracker.
RTOL, ATOL = 1e-4, 1e-5
# Slice 2's bound on int8 quantizations flipped by such a reordering.
MAX_FLIPS = 2e-3
N, M, SEED = 8, 16, 3


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


@pytest.mark.parametrize("n,m,d,alpha,seed", [
    (4, 8, 3, 0.1, 0), (16, 32, 54, 0.5, 1), (7, 5, 10, 10.0, 2),
    (32, 4, 8, 0.05, 7)])
def test_dirichlet_data_bit_equal(n, m, d, alpha, seed):
    labels = np.random.default_rng(seed).integers(0, 3, 5 * n)
    for a, b in zip(jdirichlet_partition(labels, n, alpha, seed=seed),
                    dirichlet_partition(labels, n, alpha, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    jH, jy = jlogreg_dirichlet(n, m, d, alpha=alpha, seed=seed)
    H, y = logreg_dataset_dirichlet(n, m, d, alpha=alpha, seed=seed)
    assert H.dtype == y.dtype == torch.float32
    np.testing.assert_array_equal(H.numpy(), np.asarray(jH))
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))


def _schedules(kind, n=N, horizon=64):
    kw = dict(kind=kind, centers=1)
    return (jregistry.build_topology(jspec.TopologySpec(**kw), n,
                                     horizon=horizon, seed=SEED),
            registry.build_topology(tspec.TopologySpec(**kw), n,
                                    horizon=horizon, seed=SEED))


def _runs(jalgo, algo, kind, d, steps=3, impl="dense", scheds=None):
    """``steps`` steps of one rule through both packages' ``run`` on the
    full-batch oracle, evals every step."""
    jsched, sched = scheds or _schedules(kind)
    n = sched.n if hasattr(sched, "n") else N
    jH, jy = jlogreg_dataset(n, M, d, seed=SEED)
    _, jfull, _, _, jgn = jlogreg_loss(0.1)
    js, jhist = jalg.run(jalgo, jnp.zeros((n, d)),
                         lambda xs, key: jfull(xs, jH, jy), jsched, steps,
                         jax.random.key(0), eval_fn=lambda xb: jgn(xb, jH, jy),
                         gossip_impl=impl)
    H, y = logreg_dataset(n, M, d, seed=SEED)
    _, full, _, _, gn = logreg_loss_and_grad(0.1)
    state, hist = alg.run(algo, torch.zeros((n, d)),
                          lambda xs, gen: full(xs, H, y), sched, steps,
                          torch.Generator(), eval_fn=lambda xb: gn(xb, H, y),
                          gossip_impl=impl)
    assert [t for t, _ in hist] == [t for t, _ in jhist]
    assert state.k == steps
    return state, hist, js, jhist


@pytest.mark.parametrize("kind", ["sun", "random-sun"])
@pytest.mark.parametrize("name,R", [("dsgd", 1), ("dsgt", 1), ("mc_dsgt", 2),
                                    ("mc_dsgt", 4)])
def test_run_matches_reference(name, R, kind):
    args = (0.3, R) if name == "mc_dsgt" else (0.3,)
    state, hist, js, jhist = _runs(getattr(jalg, name)(*args),
                                   getattr(alg, name)(*args), kind, d=16)
    wps = getattr(alg, name)(*args).weights_per_step
    assert [t for t, _ in hist] == [wps, 2 * wps, 3 * wps]
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL)
    fields = ("x",) if name == "dsgd" else ("x", "h", "g_prev")
    for f in fields:
        np.testing.assert_allclose(getattr(state, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def test_unported_factories_raise_item_2():
    """(Named when the four factories still raised.)  ``d2``,
    ``local_sgd``, ``personalized`` and ``gt_local`` build the reference's
    algorithm: name, rounds per step and every rule field, with and
    without a local optimizer (which d2 refuses in both packages); 2 steps
    of each on ``sun`` match the reference's (tests/test_torch_rules.py
    holds them at length)."""
    from repro import optim as joptim
    from repro_torch import optim
    fields = ("name", "kind", "gamma", "R", "mix_before_update",
              "correction_in_mix", "shared_round", "tracker_init",
              "supports_local_opt", "personalized", "tau")
    for name in ("d2", "local_sgd", "personalized", "gt_local"):
        a, b = getattr(alg, name)(0.1), getattr(jalg, name)(0.1)
        assert (a.name, a.weights_per_step) == (b.name, b.weights_per_step)
        assert {f: getattr(a.rule, f) for f in fields} == \
            {f: getattr(b.rule, f) for f in fields}
        if name == "d2":
            with pytest.raises(ValueError):
                alg.from_rule(a.rule, optim.momentum())
            with pytest.raises(ValueError):
                jalg.from_rule(b.rule, joptim.momentum())
        else:
            assert getattr(alg, name)(0.1, local_opt=optim.adam()).local_opt
        if name != "personalized":
            state, hist, js, jhist = _runs(b, a, "sun", d=8, steps=2)
            np.testing.assert_allclose(state.x.numpy(), np.asarray(js.x),
                                       rtol=RTOL, atol=ATOL)


def _close_up_to_flips(got, want, max_frac, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
    assert bad.sum() <= max_frac * bad.size, (
        f"{what}: {int(bad.sum())} of {bad.size} entries beyond rtol={RTOL} "
        f"atol={ATOL} (allowed {max_frac:.0e} of them)")


def _node_sums(got, gres, want, wres, what):
    """A flip moves mass between a payload and its residual and mixing keeps
    node sums, so the node sums of payload + residual are held with no
    entry excused."""
    np.testing.assert_allclose((got + gres).sum(0).numpy(),
                               np.asarray(want + wres).sum(0), rtol=RTOL,
                               atol=ATOL, err_msg=f"node sum of {what}")


def _sampled_scheds(n=500):
    """The sampled family (``n`` clients, 16 per round, drop + churn),
    realized through the JAX package and the port."""
    from repro import sparse as jsparse
    from repro_torch import sparse
    out = []
    for reg, spec, realize in (
            (jregistry, jspec, jsparse.realize_sparse_schedule),
            (registry, tspec, sparse.realize_sparse_schedule)):
        sched = reg.build_topology(
            spec.TopologySpec(kind="random-sampled", sample_k=16,
                              radius=0.45), n, horizon=24, seed=SEED)
        out.append(realize(sched, reg.build_channel_models(
            spec.ChannelSpec(link_drop=0.2, churn=0.02), SEED)))
    return tuple(out)


def _mixers(route):
    """(reference per-round mixer, port per-round mixer, n) for the dense
    window of ``random-sun`` or one plan round at a time of the sampled
    family, from round 5 on."""
    if route == "dense":
        jsched, sched = _schedules("random-sun")
        ws = sched.stacked(5, 4).astype(np.float32)
        jws, tws = jnp.asarray(ws), torch.from_numpy(ws)
        return (lambda i, m: jalg.mix(jws[i], m),
                lambda i, m: alg.mix(tws[i], m), N)
    from repro.core import driver as jdriver
    from repro_torch.core import driver
    jsched, sched = _sampled_scheds()
    jplan, plan = jsched.plan(), sched.plan()
    jmixer, mixer = jplan.make_mixer(), plan.make_mixer()
    jt, tt = jdriver.stage_plan(jplan), driver.stage_plan(plan)
    return (lambda i, m: jmixer(jt, 5 + i, 1, m),
            lambda i, m: mixer(tt, 5 + i, 1, m), sched.n)


# d = 784 and 54 pad to 1024 and 256 at group 256; 512 takes no pad
@pytest.mark.parametrize("d", [784, 54, 512])
@pytest.mark.parametrize("scheme,ef", [("sign", True), ("sign", False),
                                       ("int8", True), ("int8", False)])
@pytest.mark.parametrize("route", ["dense", "plan"])
def test_compressed_window_matches_reference(route, scheme, ef, d):
    """The host runtime's compressed window, 4 rounds, against the
    reference's ``make_compressed_mixer`` around the same mixer, with the
    gate on and (warmup) off.  sign is held with no entry excused: its pad
    zeros enter the last group's mean |g|, so a pad that differed from the
    reference's would move every entry of that group.  int8 may flip up to
    MAX_FLIPS of its entries from round 2 on."""
    jmix, mix, n = _mixers(route)
    rng = np.random.default_rng(d)
    x = rng.standard_normal((n, d)).astype(np.float32)
    res = (0.1 * rng.standard_normal((n, d))).astype(np.float32)
    jcfg = jcompress.CompressionConfig(scheme=scheme, error_feedback=ef)
    cfg = compress.CompressionConfig(scheme=scheme, error_feedback=ef)
    jcmix = jcompress.make_compressed_mixer(jmix, jcfg)
    cmix = compress.make_compressed_mixer(mix, cfg)
    for on in (True, False):
        want, wres = jcmix(0, 4, jnp.asarray(x), jnp.asarray(res), on)
        tres = torch.from_numpy(res.copy())
        got, gres = cmix(0, 4, torch.from_numpy(x.copy()), tres, on)
        assert gres.data_ptr() == tres.data_ptr() and gres.shape == (n, d)
        flips = 0 if scheme == "sign" or not on else MAX_FLIPS
        _close_up_to_flips(got.numpy(), want, flips, f"{scheme} x")
        _close_up_to_flips(gres.numpy(), wres, flips, f"{scheme} res")
        if not ef or not on:
            np.testing.assert_array_equal(gres.numpy(), res)
        if ef or not on:   # without feedback a flip's mass is lost
            _node_sums(got, gres, want, wres, "x + res")


@pytest.mark.parametrize("scheme,warmup", [("sign", 0), ("sign", 1),
                                           ("int8", 0), ("int8", 2)])
def test_compressed_run_matches_reference(scheme, warmup):
    """MC-DSGT (R = 2) with error-feedback compressed gossip through both
    packages' ``run``, 3 steps at d = 784, the warmup gate included.  sign
    holds every stream and the node sums of payload + residual with no
    entry excused.  An int8 flip in x moves that node's whole full-batch
    gradient, so from the next step on it reaches every entry of h and,
    through h, the node sums: int8 holds x and res_x up to MAX_FLIPS and
    the evals at RTOL; its window is held entry by entry above."""
    jcfg = jcompress.CompressionConfig(scheme=scheme, warmup=warmup)
    cfg = compress.CompressionConfig(scheme=scheme, warmup=warmup)
    state, hist, js, jhist = _runs(
        jalg.from_rule(jengine.make_rule("mc_dsgt", 0.3, R=2,
                                         compression=jcfg)),
        alg.from_rule(engine.make_rule("mc_dsgt", 0.3, R=2,
                                       compression=cfg)),
        "random-sun", d=784)
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL)
    flips = 0 if scheme == "sign" else MAX_FLIPS
    streams = [("x", state.x, js.x), ("res_x", state.res[0], js.res[0])]
    if scheme == "sign":
        streams += [("h", state.h, js.h), ("res_h", state.res[1], js.res[1])]
    for what, got, want in streams:
        _close_up_to_flips(got.numpy(), want, flips, f"{scheme} {what}")
    if scheme == "sign":
        _node_sums(state.x, state.res[0], js.x, js.res[0], "x + res_x")
        _node_sums(state.h, state.res[1], js.h, js.res[1], "h + res_h")


def test_pad_counts_in_the_sign_scale():
    """One compressed round of d = 54 at group 256: the pad's 202 zeros
    scale sign's payload by 54/256 against a group of the row alone."""
    cfg = compress.CompressionConfig(scheme="sign", group=256)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 54)).astype(np.float32))
    res = torch.zeros_like(x)
    out, res = compress.make_compressed_mixer(lambda i, m: m, cfg)(
        0, 1, x.clone(), res, True)
    want = torch.sign(x) * x.abs().sum(1, keepdim=True) / 256
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(res, x - want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name,R", [("dsgd", 1), ("dsgt", 1), ("mc_dsgt", 1),
                                    ("mc_dsgt", 2), ("mc_dsgt", 4)])
def test_weights_per_step_is_the_references(name, R):
    a = exp.AlgorithmSpec(name=name, R=R)
    assert exp.weights_per_step(a) == jexp.weights_per_step(
        jexp.AlgorithmSpec(name=name, R=R))


def _twin_specs(name):
    """(reference SPECS, twin SPECS) of ``examples/<name>.py``."""
    return (_module(REPO / "examples" / f"{name}.py").SPECS,
            _module(REPO / "examples" / "torch" / f"{name}.py").SPECS)


@pytest.mark.parametrize("example,key,steps", [
    ("quickstart", "dsgd", 16), ("quickstart", "dsgt", 8),
    ("quickstart", "mc_dsgt", 4), ("paper_figure2", "mnist_mc_dsgt", 4),
    ("sampled_clients", "sampled_auto", None),
    ("sampled_clients", "sampled_host_dense", None)])
def test_twin_specs_run_like_the_references(example, key, steps):
    """Each twin's spec is the reference's (same hash); ``exp.run`` on the
    CPU gives finite evals at the reference's budgets T."""
    jspecs, specs = _twin_specs(example)
    spec, jspec_ = specs[key], jspecs[key]
    assert exp.spec_hash(spec) == jexp.spec_hash(jspec_)
    if steps is not None:
        spec = exp.with_field(spec, "run.steps", steps)
        jspec_ = jexp.with_field(jspec_, "run.steps", steps)
    res = exp.run(spec, device="cpu", quiet=True)
    jres = jexp.run(jspec_)
    assert [t for t, _ in res.history] == [t for t, _ in jres.history]
    assert all(np.isfinite(v) for _, v in res.history)
    assert bool(res.state.x.isfinite().all())
    assert res.built.realized == jres.built.realized


def test_pinned_bytes_of_the_smokes_compressed_runs():
    """``chip_smoke.py``'s §6 phase holds the telemetry bytes of its
    compressed MNIST runs on the card to ``S6_BYTES_TOTAL``: both packages
    count them on the CPU."""
    smoke = _module(REPO / "chip_smoke.py")
    fig = _module(REPO / "examples" / "torch" / "paper_figure2.py")
    mnist = exp.with_field(fig.SPECS["mnist_mc_dsgt"], "run.steps",
                           smoke.S6_STEPS)
    for scheme, want in smoke.S6_BYTES_TOTAL.items():
        spec = exp.with_field(mnist, "compression.scheme", scheme)
        res = exp.run(spec, device="cpu", quiet=True)
        jres = jexp.run(jexp.from_dict(exp.to_dict(spec)))
        assert res.telemetry.bytes_total == jres.telemetry.bytes_total == want


@pytest.mark.parametrize("overrides", [
    {"compression.scheme": "int8"}, {"compression.scheme": "sign"},
    {"data.hetero_alpha": 0.1},
    {"topology.kind": "ring", "compression.scheme": "sign",
     "compression.warmup": 1, "data.hetero_alpha": 0.5}])
def test_lifted_axes_run_on_dense_topologies(overrides):
    """Compression and Dirichlet data on the dense host runtime: finite,
    and the realized section (bytes per round at the padded group count)
    is the reference's."""
    base = exp.with_overrides(exp.ExperimentSpec(), {
        "model.kind": "logreg", "model.d": 54, "model.m": 16,
        "topology.kind": "random-sun", "topology.centers": 2,
        "run.nodes": 8, "run.steps": 3, "algorithm.name": "mc_dsgt",
        "algorithm.R": 2, "algorithm.gamma": 0.3, **overrides})
    res = exp.run(base, device="cpu", quiet=True)
    assert all(np.isfinite(v) for _, v in res.history)
    jbuilt = jexp.build(jexp.from_dict(exp.to_dict(base)))
    assert res.built.realized == jbuilt.realized
    if base.compression.enabled:
        assert res.telemetry is not None and res.telemetry.bytes_total > 0
        assert res.state.res[0].shape == (8, 54)


def test_cli_logreg_with_telemetry_equals_exp_run(tmp_path, capsys):
    """``--arch logreg --topology random-sun --telemetry`` is ``exp.run`` of
    the same spec: same evals, and it writes the file and its manifest."""
    path = tmp_path / "t.json"
    argv = ["--arch", "logreg", "--topology", "random-sun", "--nodes", "16",
            "--algo", "mc_dsgt", "--R", "2", "--steps", "5", "--device",
            "cpu", "--telemetry", str(path)]
    history = train.main(argv)
    assert "grad_norm2" in capsys.readouterr().out
    spec = train.spec_from_args(train.build_parser().parse_args(argv))
    assert spec.model.kind == "logreg" and spec.run.telemetry == str(path)
    assert json.loads(path.read_text())["history"][-1]["step"] == 4
    manifest = exp.load_manifest(exp.manifest_path(str(path)))
    assert manifest["spec_parsed"] == spec
    assert manifest["realized"] == exp.build(spec, device="cpu").realized
    res = exp.run(exp.with_field(spec, "run.telemetry", None), device="cpu",
                  quiet=True)
    assert res.history == history
    for extra in (["--compress", "int8"], ["--hetero-alpha", "0.1"]):
        assert all(np.isfinite(v) for _, v in
                   train.main(argv + extra + ["--quiet"]))


def test_cli_logreg_pallas_raises_the_references_error():
    argv = ["--arch", "logreg", "--gossip-impl", "pallas", "--steps", "1"]
    from repro.launch import train as jtrain
    with pytest.raises(ValueError, match="gossip_impl must be"):
        jtrain.main(argv)
    with pytest.raises(ValueError, match="gossip_impl must be"):
        train.main(argv + ["--device", "cpu"])
