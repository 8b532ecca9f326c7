"""The federated/local-update rules against the JAX package: the local
optimizers (momentum, adam), the ``d2``, ``local_sgd``, ``gt_local`` and
``personalized`` rules on the host runtime (with ``local_sgd`` also held to
its analytic oracle) and in the arch trainer (with the local optimizers and
bf16 tracker storage), the reference's refusals, and the
``examples/federated.py`` twin.  Every input is made with numpy from a fixed
seed; oracles are full-batch where the two packages must agree step for
step."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp, optim as joptim  # noqa: E402
from repro.core import algorithms as jalg, engine as jengine  # noqa: E402
from repro.core import driver as jdriver  # noqa: E402
from repro.data import logreg_dataset as jlogreg_dataset  # noqa: E402
from repro.data import logreg_loss_and_grad as jlogreg_loss  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, exp, optim  # noqa: E402
from repro_torch.core import algorithms as alg, driver, engine  # noqa: E402
from repro_torch.data import logreg_dataset, logreg_loss_and_grad  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# The host runtime's and the arch trainer's step tolerances (slices 1-3).
RTOL, ATOL = 1e-4, 1e-5
N, M, D, SEED = 8, 16, 12, 3


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


# ---------------------------------------------------------------------------
# The local optimizers and the rule registry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_local_optimizers_match_reference(name):
    """Five updates on the same gradients: update and state at RTOL/ATOL
    (both packages compute the same f32 expressions; the port updates its
    moments in place)."""
    jo, o = getattr(joptim, name)(), getattr(optim, name)()
    rng = np.random.default_rng(0)
    x0 = rng.standard_normal((4, 300)).astype(np.float32)
    js, s = jo.init(jnp.asarray(x0)), o.init(torch.from_numpy(x0))
    for _ in range(5):
        g = rng.standard_normal((4, 300)).astype(np.float32)
        ju, js = jo.update(jnp.asarray(g), js)
        u, s = o.update(torch.from_numpy(g), s)
        np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=RTOL,
                                   atol=ATOL)
    if name == "momentum":
        np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=RTOL)
    elif name == "adam":
        assert s["t"] == int(js["t"]) == 5
        for k in ("m", "v"):
            np.testing.assert_allclose(s[k].numpy(), np.asarray(js[k]),
                                       rtol=RTOL, atol=1e-7)


def test_registry_builds_the_local_optimizers():
    assert list(registry.LOCAL_OPTS) == list(jregistry.LOCAL_OPTS)
    assert registry.build_local_opt("sgd") is None
    for name in ("momentum", "adam"):
        assert isinstance(registry.build_local_opt(name), optim.Optimizer)
    with pytest.raises(ValueError):
        registry.build_local_opt("lion")


RULE_FIELDS = ("name", "kind", "gamma", "R", "mix_before_update",
               "correction_in_mix", "shared_round", "tracker_init",
               "supports_local_opt", "personalized", "tau",
               "weights_per_step", "uses_tracker", "uses_prev_grad")


@pytest.mark.parametrize("name", engine.ALGORITHMS)
def test_rules_are_the_references(name):
    """Each rule's structure is the reference's; asking dsgt or d2 for
    R != 1 raises in both packages."""
    R = 3 if name in ("mc_dsgt", "local_sgd", "gt_local") else 1
    a = engine.make_rule(name, 0.2, R, tau=2.5)
    b = jengine.make_rule(name, 0.2, R, tau=2.5)
    assert {f: getattr(a, f) for f in RULE_FIELDS} == \
        {f: getattr(b, f) for f in RULE_FIELDS}
    spec = exp.AlgorithmSpec(name=name, R=R)
    assert exp.weights_per_step(spec) == jexp.weights_per_step(
        jexp.AlgorithmSpec(name=name, R=R))
    if name in ("dsgt", "d2"):
        for make in (engine.make_rule, jengine.make_rule):
            with pytest.raises(ValueError, match="uses R=1"):
                make(name, 0.2, 2)


# ---------------------------------------------------------------------------
# The host runtime
# ---------------------------------------------------------------------------

def _schedules(kind, n=N, **kw):
    return (jregistry.build_topology(jspec.TopologySpec(kind=kind, **kw), n,
                                     horizon=64, seed=SEED),
            registry.build_topology(tspec.TopologySpec(kind=kind, **kw), n,
                                    horizon=64, seed=SEED))


def _oracles(personalized, n=N, d=D):
    """Both packages' full-batch oracles on the same data; a personalized
    rule's returns (per-node full-batch losses, grads)."""
    jH, jy = jlogreg_dataset(n, M, d, seed=SEED)
    jloss, jfull, _, _, jgn = jlogreg_loss(0.1)
    H, y = logreg_dataset(n, M, d, seed=SEED)
    loss, full, _, _, gn = logreg_loss_and_grad(0.1)
    jgrad = lambda xs, key: jfull(xs, jH, jy)  # noqa: E731
    grad = lambda xs, gen: full(xs, H, y)  # noqa: E731
    if personalized:
        jgrad = lambda xs, key: (jax.vmap(jloss)(xs, jH, jy),  # noqa: E731
                                 jfull(xs, jH, jy))
        grad = lambda xs, gen: (torch.stack(  # noqa: E731
            [loss(xs[i], H[i], y[i]) for i in range(n)]), full(xs, H, y))
    return (jgrad, lambda xb: jgn(xb, jH, jy)), (grad, lambda xb: gn(xb, H, y))


def _host_runs(name, args, kind, local_opt=None, steps=3, kw=None,
               impl="dense"):
    personalized = name == "personalized"
    jsched, sched = _schedules(kind, **(kw or {}))
    (jgrad, jeval), (grad, evl) = _oracles(personalized)
    jkw = {} if local_opt is None else {"local_opt": getattr(
        joptim, local_opt)()}
    tkw = {} if local_opt is None else {"local_opt": getattr(
        optim, local_opt)()}
    js, jhist = jdriver.run_algorithm(
        getattr(jalg, name)(*args, **jkw), jnp.zeros((N, D)), jgrad, jsched,
        steps, jax.random.key(0), eval_fn=jeval, gossip_impl=impl)
    state, hist = driver.run_algorithm(
        getattr(alg, name)(*args, **tkw), torch.zeros((N, D)), grad, sched,
        steps, torch.Generator(), eval_fn=evl, gossip_impl=impl)
    assert state.k == steps
    assert [t for t, _ in hist] == [t for t, _ in jhist]
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL)
    return state, js


def _hold(state, js, fields=("x", "h", "g_prev")):
    for f in fields:
        got, want = getattr(state, f), getattr(js, f)
        if want is None:
            assert got is None, f
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


@pytest.mark.parametrize("kind", ["sun", "random-sun", "federated"])
@pytest.mark.parametrize("name,args", [
    ("d2", (0.2,)), ("local_sgd", (0.3,)), ("gt_local", (0.2,)),
    ("personalized", (0.3, 2.0))], ids=["d2", "local_sgd", "gt_local",
                                        "personalized"])
def test_rules_run_matches_reference(name, args, kind):
    """3 steps of each new rule through both packages' dense host runtime
    from x = 0: evals and x, h, g_prev at RTOL/ATOL."""
    state, js = _host_runs(name, args, kind)
    _hold(state, js)
    if name == "d2":
        assert state.h.data_ptr() != state.x.data_ptr()


@pytest.mark.parametrize("local_opt", ["momentum", "adam"])
@pytest.mark.parametrize("name,args", [
    ("dsgd", (0.1,)), ("local_sgd", (0.1,)), ("gt_local", (0.05,)),
    ("personalized", (0.1, 2.0))], ids=["dsgd", "local_sgd", "gt_local",
                                        "personalized"])
def test_local_optimizer_runs_match_reference(name, args, local_opt):
    """The rules that take a local optimizer, with momentum and adam, 3
    steps on ``random-sun``: evals, x, h, g_prev and the optimizer state
    at RTOL/ATOL."""
    state, js = _host_runs(name, args, "random-sun", local_opt=local_opt)
    _hold(state, js)
    got, want = state.opt_state, js.opt_state
    if local_opt == "momentum":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert got["t"] == int(want["t"]) == 3
        for k in ("m", "v"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=RTOL, atol=1e-7, err_msg=k)


def test_local_sgd_on_the_complete_graph_is_centralized_gd():
    """The analytic oracle: from identical x0 over the complete graph,
    local_sgd's node mean after each mix follows gradient descent on the
    mean objective, z ← z − γ ∇f(z) (full-batch oracle, K steps; the last
    step's local updates averaged)."""
    K, gamma = 5, 0.3
    _, sched = _schedules("complete")
    H, y = logreg_dataset(N, M, D, seed=SEED)
    _, full, _, _, _ = logreg_loss_and_grad(0.1)
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, D)).astype(np.float32)).expand(N, D).contiguous()
    state, _ = driver.run_algorithm(alg.local_sgd(gamma), x0,
                                    lambda xs, gen: full(xs, H, y), sched, K,
                                    torch.Generator())
    z = x0[:1].double()
    Hd, yd = H.double(), y.double()
    for _ in range(K):
        z = z - gamma * full(z.expand(N, D), Hd, yd).mean(dim=0,
                                                          keepdim=True)
    np.testing.assert_allclose(state.x.double().mean(dim=0).numpy(),
                               z[0].numpy(), rtol=1e-5, atol=1e-6)


def test_factories_refuse_what_the_reference_refuses():
    for mod, o in ((jalg, joptim), (alg, optim)):
        with pytest.raises(ValueError, match="local optimizer"):
            mod.from_rule(mod.engine.make_rule("d2", 0.1) if mod is jalg
                          else engine.make_rule("d2", 0.1), o.adam())
    for make in (jengine.make_rule, engine.make_rule):
        with pytest.raises(ValueError):
            make("nope", 0.1)
    for R in (jengine.UpdateRule, engine.UpdateRule):
        with pytest.raises(ValueError, match="sgd kind only"):
            R(name="p", kind="tracking", gamma=0.1, personalized=True)


def test_exp_run_takes_the_new_rules_and_local_optimizers():
    """``exp.run`` on the logreg runtime with every new rule and local
    optimizer, dense and auto: finite, and the realized section is the
    reference's; personalized raises ValueError where the reference's does
    (the logreg oracle returns no per-node losses)."""
    base = exp.with_overrides(exp.ExperimentSpec(), {
        "model.kind": "logreg", "model.d": 8, "model.m": 16,
        "run.nodes": 8, "run.steps": 2, "topology.kind": "hierarchical",
        "topology.pods": 2})
    for name, lo in (("d2", "sgd"), ("local_sgd", "adam"),
                     ("gt_local", "momentum"), ("dsgd", "adam")):
        for impl in ("dense", "auto"):
            spec = exp.with_overrides(base, {
                "algorithm.name": name, "algorithm.local_opt": lo,
                "run.gossip_impl": impl})
            res = exp.run(spec, device="cpu", quiet=True)
            assert all(np.isfinite(v) for _, v in res.history)
            assert res.built.realized == jexp.build(
                jexp.from_dict(exp.to_dict(spec))).realized
    spec = exp.with_field(base, "algorithm.name", "personalized")
    with pytest.raises(ValueError):
        jexp.run(jexp.from_dict(exp.to_dict(spec)))
    with pytest.raises(ValueError, match="per-node losses"):
        exp.run(spec, device="cpu", quiet=True)


# ---------------------------------------------------------------------------
# The arch trainer
# ---------------------------------------------------------------------------

CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
NA, B, S, GAMMA = 4, 2, 16, 0.05
# bf16 tracker storage: a tracker entry the two packages compute in f32 a
# few ulps apart may round to neighbouring bf16 values, one bf16 ulp (2^-8
# of the value) apart, and the next step's h + g − g⁻ carries that ulp of
# its largest term into a result that may be small: h and g_prev are held
# at rtol BF16_RTOL and an atol of BF16_RTOL × the leaf's largest |value|
# (readings: 4 of 32,768 embedding entries of h needed it, 1.2e-4 against
# a leaf maximum near 0.03); x within γ times that.
BF16_RTOL = 2.0 ** -7
# adam divides each entry's update by that entry's own gradient scale.  Its
# first update, u/(|u| + eps), amplifies a difference in u only where |u|
# sits within a few eps of 0: after the first step x is held at RTOL/ATOL
# on every column but those where some node's first adam input has |u| <
# ADAM_NEAR_ZERO = 100 eps (reading: 260 of 90,816 columns for dsgd, all
# the columns past RTOL/ATOL among them; mixing spreads a node's entry over
# its column).  From the second step on the update carries each entry's
# RELATIVE gradient error: the two packages' gradients agree to ~1e-8
# absolute (XLA and ATen sum in other orders), 1e-4..1e-2 relative on the
# small entries of the attention and MLP weights.  After warm start + 2
# steps, up to ADAM_MAX_FRAC of x's entries may leave RTOL/ATOL (reading:
# 0.19% for dsgd; 0.57% for gt_local, whose tracker then carries the
# gradients at those x, so adam with a tracker is held on the host runtime
# instead), each within ADAM_DX (largest reading 0.0022 = 0.043γ); the
# moments are held at RTOL/ATOL everywhere.
ADAM_NEAR_ZERO = 1e-6
ADAM_MAX_FRAC = 1e-2
ADAM_DX = 0.1 * GAMMA


def _arch_runs(algo, R=1, impl="dense", local_opt=None, aux_dtype=None,
               kind="sun", first=None):
    """Warm start + 2 steps through both packages' ``make_train_step`` on
    a reduced qwen1.5 from the same parameters and tokens; ``first``, a
    list, receives the port's first local-optimizer input (with one) and
    (port x, JAX x) after the first step."""
    jsched, sched = _schedules(kind, NA)
    wps = engine.make_rule(algo, GAMMA, R).weights_per_step
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo=algo, gamma=GAMMA, R=R, gossip_impl=impl,
        pallas_interpret=True, pallas_block_d=16_384, tau=2.0,
        aux_dtype=None if aux_dtype is None else jnp.bfloat16,
        local_opt=None if local_opt is None else getattr(joptim,
                                                         local_opt)())
    jstep = jax.jit(jstep)
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    opt = None if local_opt is None else getattr(optim, local_opt)()
    if opt is not None and first is not None:
        opt = _recording_first_input(opt, first)
    init, warm, step = steps.make_train_step(
        model, None, algo=algo, gamma=GAMMA, R=R, gossip_impl=impl, tau=2.0,
        aux_dtype=aux_dtype, local_opt=opt)
    js = jinit(jax.random.key(0), NA, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda l: l[0], js.x))), NA)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 128, (NA, R, B, S)).astype(np.int32)
               for _ in range(3)]
    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    for k in (1, 2):
        W = sched.stacked((k - 1) * wps, wps)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, tout = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
        if k == 1 and first is not None:
            first.append((ts.x.clone(), js.x))
    return ts, js, steps.flat_layout(model)


def _recording_first_input(opt, out: list):
    """``opt`` appending a copy of its first update's input to ``out``."""
    def update(g, s):
        if not out:
            out.append(g.clone())
        return opt.update(g, s)
    return optim.Optimizer(opt.init, update)


def _leafwise(port_mat, jtree, layout, what, rtol=RTOL, atol=ATOL,
              leaf_scale=0.0):
    """Leaf by leaf at rtol and atol + ``leaf_scale`` × the leaf's largest
    |value| (the reference's)."""
    want = {tuple(k.key for k in p): np.asarray(l, np.float32) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        w = want[path].reshape(NA, size)
        np.testing.assert_allclose(
            port_mat[:, off:off + size].float().numpy(), w, rtol=rtol,
            atol=atol + leaf_scale * float(np.abs(w).max()),
            err_msg=f"{what}: {'/'.join(path)}")


def _in_layout(jtree, layout):
    """A JAX state tree as the port's (NA, D) matrix."""
    want = {tuple(k.key for k in p): np.asarray(l, np.float32) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    return np.concatenate([want[path].reshape(NA, -1)
                           for path, _, _ in layout.entries], axis=1)


@pytest.mark.parametrize("algo,impl,local_opt", [
    ("d2", "pallas", None), ("local_sgd", "dense", None),
    ("gt_local", "pallas", None), ("personalized", "dense", None),
    ("local_sgd", "dense", "momentum"), ("gt_local", "dense", "momentum"),
    ("dsgd", "pallas", "adam"),
])
def test_arch_trainer_rules_match_reference(algo, impl, local_opt):
    """Warm start + 2 steps of each new rule (and local optimizer) in the
    arch trainer: losses and x, h, g_prev (and the optimizer's moments) at
    RTOL/ATOL, x after adam's second step as ADAM_MAX_FRAC / ADAM_DX say;
    the JAX side runs its Pallas gossip_mix in interpret mode under
    'pallas'."""
    first = []
    ts, js, layout = _arch_runs(algo, impl=impl, local_opt=local_opt,
                                first=first)
    if local_opt == "adam":
        u0, (x1, jx1) = first
        got, want = x1.numpy(), _in_layout(jx1, layout)
        near_zero = (u0.abs() < ADAM_NEAR_ZERO).any(dim=0).numpy()
        np.testing.assert_allclose(got[:, ~near_zero], want[:, ~near_zero],
                                   rtol=RTOL, atol=ATOL)
        got, want = ts.x.numpy(), _in_layout(js.x, layout)
        bad = np.abs(got - want) > ATOL + RTOL * np.abs(want)
        assert bad.mean() <= ADAM_MAX_FRAC, (
            f"{int(bad.sum())} of {bad.size} entries of x past RTOL/ATOL")
        np.testing.assert_allclose(got, want, rtol=0, atol=ADAM_DX)
        assert ts.opt["t"] == int(js.opt["t"]) == 2
        _leafwise(ts.opt["m"], js.opt["m"], layout, "m")
        _leafwise(ts.opt["v"], js.opt["v"], layout, "v", atol=1e-9)
    else:
        _leafwise(ts.x, js.x, layout, "x")
    if algo in ("d2", "gt_local"):
        _leafwise(ts.h, js.h, layout, "h")
        _leafwise(ts.g_prev, js.g_prev, layout, "g_prev")
    if local_opt == "momentum":
        _leafwise(ts.opt, js.opt, layout, "m")


@pytest.mark.parametrize("algo,impl", [("mc_dsgt", "pallas"),
                                       ("gt_local", "dense"),
                                       ("d2", "dense")])
def test_bf16_tracker_storage_matches_reference(algo, impl):
    """``aux_dtype`` bf16: h and g_prev are stored in bf16 (d2's h, x^{k-1},
    stays f32) and match the reference's to one bf16 ulp (BF16_RTOL); x
    within γ times that of the largest tracker entry."""
    R = 2 if algo == "mc_dsgt" else 1
    ts, js, layout = _arch_runs(algo, R, impl, aux_dtype=torch.bfloat16)
    assert ts.g_prev.dtype == torch.bfloat16
    assert ts.h.dtype == (torch.float32 if algo == "d2" else torch.bfloat16)
    hmax = float(ts.h.float().abs().max()) if algo != "d2" else 0.0
    _leafwise(ts.x, js.x, layout, "x", atol=ATOL + GAMMA * hmax * BF16_RTOL)
    _leafwise(ts.h, js.h, layout, "h", rtol=BF16_RTOL,
              leaf_scale=0.0 if algo == "d2" else BF16_RTOL)
    _leafwise(ts.g_prev, js.g_prev, layout, "g_prev", rtol=BF16_RTOL,
              leaf_scale=BF16_RTOL)


@pytest.mark.parametrize("route", ["dense", "fused"])
@pytest.mark.parametrize("stream", ["float32", "bfloat16"])
def test_compressed_window_with_bf16_residuals_matches_reference(route,
                                                                 stream):
    """``aux_dtype`` with compression: residuals (and a tracker stream)
    stored in bf16 run the window on f32 copies and are cast back at its
    end, as the reference's flatten_grouped / unflatten_grouped do, on the
    dense window and the fused one (its plain version here): sign gossip,
    2 rounds, the mixed stream at rtol 1e-5 and the residual to one bf16
    ulp (BF16_RTOL).

    The fused route writes the mixed stream into its input.  On the CPU
    ``jnp.asarray`` takes an aligned numpy array without a copy and JAX
    runs the reference's ops asynchronously, so the port is handed its own
    copy, after the reference's results are on the host: a port input that
    shared the reference's memory let the reference read the port's output
    whenever its ops ran late (a loaded machine)."""
    from repro.core import compress as jcompress
    from repro_torch.core import compress
    from repro_torch.dist import collectives as coll
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 256)).astype(np.float32)
    res = (0.01 * rng.standard_normal((4, 256))).astype(np.float32)
    gen = torch.Generator().manual_seed(4)
    Ws = engine.personalized_weights(torch.rand(2, 4, 4, generator=gen),
                                     torch.zeros(4), 1.0).numpy()
    dtype = getattr(torch, stream)
    x = torch.from_numpy(x).to(dtype).float().numpy()
    res = torch.from_numpy(res).to(torch.bfloat16).float().numpy()
    jcfg = jcompress.CompressionConfig(scheme="sign", group=64)
    cfg = compress.CompressionConfig(scheme="sign", group=64)
    jmix = jcompress.make_compressed_mixer(
        lambda i, m: jnp.asarray(Ws[i]) @ m, jcfg)
    jx, jres = jmix(0, 2, jnp.asarray(x, getattr(jnp, stream)),
                    jnp.asarray(res, jnp.bfloat16), None)
    jx, jres = np.asarray(jx, np.float32), np.asarray(jres, np.float32)
    tx = torch.from_numpy(x.copy()).to(dtype)
    tres = torch.from_numpy(res.copy()).to(torch.bfloat16)
    assert tx.data_ptr() != x.ctypes.data
    if route == "dense":
        got, gres = compress.make_compressed_mixer(
            lambda i, m: torch.from_numpy(Ws[i]) @ m, cfg)(0, 2, tx, tres,
                                                           True)
    else:
        got, gres = coll.fused_quantized_consensus(torch.from_numpy(Ws), tx,
                                                   tres, cfg, True)
    assert got.dtype == dtype and gres.dtype == torch.bfloat16
    assert gres.data_ptr() == tres.data_ptr()
    np.testing.assert_allclose(got.float().numpy(), jx,
                               rtol=BF16_RTOL if stream == "bfloat16"
                               else 1e-5, atol=1e-6)
    np.testing.assert_allclose(gres.float().numpy(), jres, rtol=BF16_RTOL,
                               atol=1e-6)


def test_train_step_refuses_a_local_optimizer_for_d2():
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    with pytest.raises(ValueError, match="local-optimizer"):
        jsteps.make_train_step(jbuild(jcfg), jcfg, algo="d2", gamma=0.1,
                               local_opt=joptim.adam())
    with pytest.raises(ValueError, match="local-optimizer"):
        steps.make_train_step(build(configs.get("qwen1.5-0.5b").reduced(
            **CUT)), None, algo="d2", gamma=0.1, local_opt=optim.adam())


def test_fedavg_cli_runs_and_plans_empty_rounds(capsys):
    """The reference's documented federated run through the port's train
    CLI (reduced, on the CPU): finite losses over the plan
    2×empty+1×complete; gt_local with adam on hierarchical pods too."""
    base = ["--preset", "reduced", "--nodes", "4", "--steps", "3",
            "--batch", "1", "--seq", "16", "--device", "cpu", "--quiet"]
    argv = base + ["--topology", "federated", "--local-steps", "2",
                   "--algo", "local_sgd", "--gossip-impl", "auto"]
    history = train.main(argv)
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)
    spec = train.spec_from_args(train.build_parser().parse_args(argv))
    assert exp.build(spec, device="cpu").plan.kinds == (
        "empty", "empty", "complete")
    history = train.main(base + ["--topology", "hierarchical", "--pods", "2",
                                 "--algo", "gt_local", "--local-opt", "adam",
                                 "--gossip-impl", "auto"])
    assert all(np.isfinite(h["loss"]) for h in history)


# ---------------------------------------------------------------------------
# The examples/federated.py twin
# ---------------------------------------------------------------------------

def test_federated_twin_specs_are_the_references():
    ref = _module(REPO / "examples" / "federated.py")
    twin = _module(REPO / "examples" / "torch" / "federated.py")
    for table in ("SCHEDULE_SPECS", "RULE_SPECS", "SPECS"):
        a, b = getattr(ref, table), getattr(twin, table)
        assert list(a) == list(b), table
        for key in a:
            assert exp.spec_hash(b[key]) == jexp.spec_hash(a[key]), key


@pytest.mark.parametrize("key,impl", [("fedavg4_dsgd", "auto"),
                                      ("dirichlet_local_sgd", "dense"),
                                      ("dirichlet_gt_local", "auto")])
def test_federated_twin_specs_run_like_the_references(key, impl):
    """Each of the twin's SPECS (the reference's CI pool) through
    ``exp.run`` for 5 steps in both packages: finite evals at the same
    budgets T and the same realized section (under ``gossip_impl='auto'``
    the same plan kinds)."""
    spec = _module(REPO / "examples" / "torch" / "federated.py").SPECS[key]
    s = exp.with_overrides(spec, {"run.steps": 5, "run.eval_every": 2,
                                  "run.gossip_impl": impl})
    res = exp.run(s, device="cpu", quiet=True)
    jres = jexp.run(jexp.from_dict(exp.to_dict(s)))
    assert [t for t, _ in res.history] == [t for t, _ in jres.history]
    assert all(np.isfinite(v) for _, v in res.history)
    assert res.built.realized == jres.built.realized


def test_federated_twin_main_prints_the_references_events(capsys):
    """The twin's main on the CPU: the reference's events in order, the
    plans and communication counts the reference prints, finite values."""
    twin = _module(REPO / "examples" / "torch" / "federated.py")
    out = twin.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert text.count("schedule_result") == 4
    assert text.count("rule_result") == 3
    assert out["schedules"]["fedavg(local=4)"]["plan"] == \
        "4xempty+1xcomplete"
    assert out["schedules"]["fedavg(local=4)"]["comm_rounds"] == 96
    assert out["schedules"]["sun(beta=1-1/n)"]["plan"] == "16xsun"
    values = [v["grad_sq"] for v in out["schedules"].values()]
    values += list(out["rules"].values())
    assert all(np.isfinite(v) for v in values)
