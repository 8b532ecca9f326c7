"""Gossip planning (``gossip_impl='auto'`` and ``'sun'``) against the JAX
package: the five structured mixers, ``make_plan_mixer`` in both dispatch
modes on the plan of every ported dense topology, the staged plan tensors,
``run_algorithm`` on the host runtime, and the arch trainer's ``sun`` and
``auto`` impls (the dense runs of a plan through the einsum or through
``gossip_mix``, whose plain version runs here).  Every input is made with
numpy from a fixed seed."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.data import logreg_dataset as jlogreg_dataset  # noqa: E402
from repro.data import logreg_loss_and_grad as jlogreg_loss  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import algorithms as alg, driver, engine  # noqa: E402
from repro_torch.data import logreg_dataset, logreg_loss_and_grad  # noqa: E402
from repro_torch.dist import collectives as coll, steps  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.kernels import gossip_matmul  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

# One mixing round: both packages sum the same f32 terms in other orders.
MIX_ATOL = 1e-6
# A plan window of up to 40 rounds (resampled matching) carries those
# roundings from round to round: inputs N(0, 1), errors seen below 4e-7.
PLAN_ATOL = 1e-5
# The host runtime's and the arch trainer's step tolerances (slices 1-3).
RTOL, ATOL = 1e-4, 1e-5
N, M, D, SEED = 8, 16, 12, 3

# every dense topology the port registers, with the sizes that give each
# its plan kinds: (name, nodes, TopologySpec overrides)
TOPOLOGIES = [
    ("sun", 8, {}), ("ring", 8, {}), ("one-peer-exp", 8, {}),
    ("static-exp", 8, {}), ("federated", 8, {"local_steps": 2}),
    ("complete", 8, {}), ("random-matching", 8, {}),
    ("resampled-matching", 8, {}), ("erdos-renyi", 8, {}),
    ("random-sun", 16, {"centers": 2}),
    ("hierarchical", 4, {"pods": 2}),       # matching + complete
    ("hierarchical", 8, {"pods": 2}),       # matching + two_level
    ("hierarchical", 16, {"pods": 4}),      # two_level only
    ("ring", 130, {}),                      # sparse (n >= 128)
]
_IDS = [f"{k}-{n}" for k, n, _ in TOPOLOGIES]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _schedules(kind, n, horizon=40, **kw):
    return (jregistry.build_topology(jspec.TopologySpec(kind=kind, **kw), n,
                                     horizon=horizon, seed=SEED),
            registry.build_topology(tspec.TopologySpec(kind=kind, **kw), n,
                                    horizon=horizon, seed=SEED))


def _plans(kind, n, kw, personalized=False):
    jsched, sched = _schedules(kind, n, **kw)
    pods = kw.get("pods")
    args = dict(pods=pods if pods and pods > 1 else None,
                personalized=personalized)
    return (jsched, sched, jsched.plan(0, jsched.period, **args),
            sched.plan(0, sched.period, **args))


def _x(n, d=D, seed=0):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


# ---------------------------------------------------------------------------
# The structured mixers
# ---------------------------------------------------------------------------

def _mixer_cases():
    rng = np.random.default_rng(7)
    n = 8
    mask = np.zeros(n, np.float32)
    mask[[1, 5]] = 1.0
    masks = np.stack([np.roll(mask, r) for r in range(3)])
    perm = np.array([3, 2, 1, 0, 7, 6, 5, 4], np.int32)
    w = rng.uniform(0.1, 0.5, n).astype(np.float32)
    w = np.minimum(w, w[perm])           # symmetric pairs share a weight
    B = np.full((4, 4), 0.1, np.float32) + 0.6 * np.eye(4, dtype=np.float32)
    return {
        "sun_mix": (lambda m, x: m.sun_mix(_t(m, mask), 0.75, x)),
        "sun_multi_consensus": (
            lambda m, x: m.sun_multi_consensus(_t(m, masks), 0.75, x)),
        "one_peer_mix": (lambda m, x: m.one_peer_mix(_t(m, perm),
                                                     _t(m, w), x)),
        "complete_mix": (lambda m, x: m.complete_mix(0.625, x)),
        "two_level_mix": (lambda m, x: m.two_level_mix(_t(m, B), 2, x)),
    }


def _t(m, a):
    return jnp.asarray(a) if m is jalg else torch.from_numpy(a)


@pytest.mark.parametrize("name", sorted(_mixer_cases()))
def test_structured_mixers_match_reference(name):
    """Each mixer against the reference's on one (n, D) input, at
    MIX_ATOL; the port's writes its one output into ``x`` itself."""
    fn = _mixer_cases()[name]
    x = _x(8, 1000, seed=1)
    want = np.asarray(fn(jalg, jnp.asarray(x)))
    xt = torch.from_numpy(x.copy())
    got = fn(alg, xt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MIX_ATOL)
    assert got.data_ptr() == xt.data_ptr()


def test_sun_mix_takes_a_float_or_a_staged_delta_alike():
    """The sun impl's float δ and a staged plan round's f32 δ give the same
    bits: both are taken in x's dtype before the division by n."""
    mask = torch.zeros(8)
    mask[3] = 1.0
    x = torch.from_numpy(_x(8, 300))
    a = alg.sun_mix(mask, 0.875, x.clone())
    b = alg.sun_mix(mask, torch.tensor(0.875, dtype=torch.float32),
                    x.clone())
    assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# Plans: tensors, staging, the dispatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,n,kw", TOPOLOGIES, ids=_IDS)
def test_staged_plan_tensors_bit_equal(kind, n, kw):
    """The port's plan (its verbatim gossip.py) is the reference's, and the
    tensors staged by ``driver.stage_plan`` / ``collectives.stage_plan``
    are ``plan.tensors()`` bit for bit."""
    _, _, jplan, plan = _plans(kind, n, kw)
    assert plan.kinds == jplan.kinds and plan.dispatch == jplan.dispatch
    want, jwant = plan.tensors(), jplan.tensors()
    assert sorted(want) == sorted(jwant)
    for staged in (driver.stage_plan(plan), coll.stage_plan(plan)):
        assert sorted(staged) == sorted(want)
        for key, arr in want.items():
            assert staged[key].numpy().dtype == arr.dtype
            np.testing.assert_array_equal(staged[key].numpy(), arr)
            np.testing.assert_array_equal(arr, jwant[key])


@pytest.mark.parametrize("kind,n,kw", TOPOLOGIES, ids=_IDS)
def test_plan_mixer_matches_reference(kind, n, kw):
    """``make_plan_mixer`` in static mode (and dynamic where the plan is
    kind-uniform) against the reference's on one period from round 0 and
    on a window that crosses the period's wrap, at PLAN_ATOL."""
    _, _, jplan, plan = _plans(kind, n, kw)
    P = plan.period
    jt = jax.tree.map(jnp.asarray, jplan.tensors())
    tt = driver.stage_plan(plan)
    x = _x(n, seed=2)
    modes = ["static"] + (["dynamic"] if plan.dispatch == "dynamic" else [])
    for mode in modes:
        jmix = jalg.make_plan_mixer(jplan, mode=mode)
        mixer = alg.make_plan_mixer(plan, mode=mode)
        assert mixer.dispatch == jmix.dispatch == mode
        for t0, rounds in ((0, P), (P - 1, 3), (2 * P - 1, P + 2)):
            want = np.asarray(jmix(jt, t0, rounds, jnp.asarray(x)))
            got = mixer(tt, t0, rounds, torch.from_numpy(x.copy()))
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=PLAN_ATOL,
                                       err_msg=f"{mode} t0={t0}")


@pytest.mark.parametrize("kind,n,kw,want", [
    ("ring", 4, {}, ("dense",)),
    ("federated", 4, {"local_steps": 2}, ("empty", "empty", "complete")),
    ("hierarchical", 4, {"pods": 2}, ("matching",) * 4 + ("complete",)),
    ("hierarchical", 16, {"pods": 4}, ("two_level",) * 10),
    ("sun", 4, {}, ("sun",) * 4)])
def test_plan_kinds_at_the_smokes_sizes(kind, n, kw, want):
    """The kinds ``chip_smoke.py``'s planning phase relies on, in both
    packages: at n = 4 every node of ``ring`` has degree 2, which no
    structured lowering takes, so each of its rounds is dense."""
    _, _, jplan, plan = _plans(kind, n, kw)
    assert plan.kinds == jplan.kinds == want


def test_dynamic_dispatch_refuses_a_mixed_plan():
    _, _, jplan, plan = _plans("federated", 8, {"local_steps": 2})
    with pytest.raises(ValueError, match="kind-uniform"):
        jalg.make_plan_mixer(jplan, mode="dynamic")
    with pytest.raises(ValueError, match="kind-uniform"):
        alg.make_plan_mixer(plan, mode="dynamic")


def test_empty_rounds_cost_nothing():
    """A federated plan's empty rounds run no mixer: a window of empty
    rounds returns the same tensor, untouched, and a dense block passed
    for the dense runs is never called."""
    _, _, _, plan = _plans("federated", 8, {"local_steps": 3})
    calls = []
    mixer = alg.make_plan_mixer(plan, dense_block=lambda Ws, x: calls.append(
        Ws) or x)
    x = torch.from_numpy(_x(8))
    before = x.clone()
    assert mixer(driver.stage_plan(plan), 0, 3, x) is x
    assert torch.equal(x, before) and not calls


def test_dense_runs_go_through_the_dense_block():
    """Consecutive dense rounds reach ``dense_block`` as one (r, n, n)
    stack per run, also across the period's wrap (one call for a window
    of 3 rounds on a 1-round ring plan)."""
    _, sched, _, plan = _plans("ring", 8, {})
    seen = []

    def block(Ws, x):
        seen.append(Ws.shape)
        return gossip_matmul.gossip_mix(Ws, x, out=x)

    for mode in ("static", "dynamic"):
        seen.clear()
        mixer = alg.make_plan_mixer(plan, mode=mode, dense_block=block)
        x = torch.from_numpy(_x(8))
        got = mixer(driver.stage_plan(plan), 5, 3, x.clone())
        assert seen == [(3, 8, 8)]
        want = alg.multi_consensus(torch.from_numpy(sched.stacked(5, 3)), x)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# ---------------------------------------------------------------------------
# The host runtime: run_algorithm(gossip_impl="auto")
# ---------------------------------------------------------------------------

def _oracles(n, d, personalized):
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


RULES = [("dsgd", (0.3,)), ("dsgt", (0.3,)), ("mc_dsgt", (0.3, 2)),
         ("d2", (0.2,)), ("local_sgd", (0.3,)), ("gt_local", (0.2,)),
         ("personalized", (0.3, 2.0))]


@pytest.mark.parametrize("name,args", RULES, ids=[r[0] for r in RULES])
@pytest.mark.parametrize("kind,n,kw", [
    ("sun", 8, {}), ("federated", 8, {"local_steps": 2}),
    ("hierarchical", 8, {"pods": 2})],
    ids=["sun", "federated", "hierarchical"])
def test_run_algorithm_auto_matches_reference(name, args, kind, n, kw):
    """3 steps of each rule through ``run_algorithm(gossip_impl='auto')``
    in both packages from x = 0 on the full-batch oracle, evals every
    step; states at RTOL/ATOL."""
    personalized = name == "personalized"
    jsched, sched, jplan, plan = _plans(kind, n, kw, personalized)
    (jgrad, jeval), (grad, evl) = _oracles(n, D, personalized)
    js, jhist = jalg.run(getattr(jalg, name)(*args), jnp.zeros((n, D)),
                         jgrad, jsched, 3, jax.random.key(0), eval_fn=jeval,
                         gossip_impl="auto") if not personalized else \
        _jrun_plan(jalg.personalized(*args), jgrad, jsched, jplan, jeval, n)
    state, hist = driver.run_algorithm(
        getattr(alg, name)(*args), torch.zeros((n, D)), grad, sched, 3,
        torch.Generator(), eval_fn=evl, gossip_impl="auto", plan=plan)
    assert [t for t, _ in hist] == [t for t, _ in jhist]
    np.testing.assert_allclose([v for _, v in hist],
                               [float(v) for _, v in jhist], rtol=RTOL)
    for f in ("x", "h", "g_prev"):
        got, want = getattr(state, f), getattr(js, f)
        if want is None:
            assert got is None, f
            continue
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                                   atol=ATOL, err_msg=f)


def _jrun_plan(jalgo, jgrad, jsched, jplan, jeval, n):
    """The reference's driver with an explicit (personalized) plan."""
    from repro.core import driver as jdriver
    return jdriver.run_algorithm(jalgo, jnp.zeros((n, D)), jgrad, jsched, 3,
                                 jax.random.key(0), eval_fn=jeval,
                                 gossip_impl="auto", plan=jplan)


# ---------------------------------------------------------------------------
# The arch trainer: gossip_impl 'sun' and 'auto'
# ---------------------------------------------------------------------------

CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
NA, B, S, GAMMA = 4, 2, 16, 0.05


def _arch_runs(algo, R, impl, kind, kw=None, auto_dense="einsum",
               reference=True):
    """Warm start + 2 steps of ``algo`` through the port's
    ``make_train_step`` (and, with ``reference``, the JAX package's on the
    same impl) on a reduced qwen1.5 from the same parameters and tokens;
    under 'auto' both take the topology's plan, under 'sun' the plan's
    center masks and δ."""
    jimpl = impl
    jsched, sched, jplan, plan = _plans(kind, NA, kw or {})
    wps = engine.make_rule(algo, GAMMA, R).weights_per_step
    sun_delta = plan.rounds[0].delta if "sun" in (impl, jimpl) else None
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    jkw = dict(algo=algo, gamma=GAMMA, R=R, gossip_impl=jimpl,
               sun_delta=sun_delta, pallas_interpret=True,
               pallas_block_d=16_384)
    if jimpl == "auto":
        jkw.update(plan=jplan, auto_dense=auto_dense)
    jinit, jwarm, jstep = jsteps.make_train_step(jbuild(jcfg), jcfg, **jkw)
    jstep = (jax.jit(jstep, static_argnums=3)
             if getattr(jstep, "gossip_dispatch", None) == "static"
             else jax.jit(jstep))
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    init, warm, step = steps.make_train_step(
        model, None, algo=algo, gamma=GAMMA, R=R, gossip_impl=impl,
        sun_delta=sun_delta, plan=plan if impl == "auto" else None,
        auto_dense=auto_dense)
    js = jinit(jax.random.key(0), NA, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda l: l[0], js.x))), NA)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 128, (NA, R, B, S)).astype(np.int32)
               for _ in range(3)]
    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    jt, tt = jax.tree.map(jnp.asarray, jplan.tensors()), \
        driver.stage_plan(plan)
    masks = plan.tensors().get("center_mask")
    for k in (1, 2):
        t = (k - 1) * wps
        jb = {"tokens": jnp.asarray(batches[k])}
        tb = {"tokens": torch.from_numpy(batches[k]).long()}
        if not reference:
            jout = None
        elif jimpl == "auto":
            js, jout = jstep(js, jb, jt, t % jplan.period)
        else:
            jw = (masks[[(t + q) % plan.period for q in range(wps)]]
                  if jimpl == "sun" else sched.stacked(t, wps))
            js, jout = jstep(js, jb, jnp.asarray(jw))
        if impl == "auto":
            ts, tout = step(ts, tb, tt, t % plan.period)
        else:
            tw = (masks[[(t + q) % plan.period for q in range(wps)]]
                  if impl == "sun" else sched.stacked(t, wps))
            ts, tout = step(ts, tb, torch.from_numpy(tw))
        if reference:
            np.testing.assert_allclose(float(tout["loss"]),
                                       float(jout["loss"]), rtol=RTOL)
    return ts, js, steps.flat_layout(model)


def _leafwise(port_mat, jtree, layout, what, rtol=RTOL, atol=ATOL):
    want = {tuple(k.key for k in p): np.asarray(l, np.float32) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        np.testing.assert_allclose(
            port_mat[:, off:off + size].float().numpy(),
            want[path].reshape(NA, size), rtol=rtol, atol=atol,
            err_msg=f"{what}: {'/'.join(path)}")


@pytest.mark.parametrize("impl,kind,algo,auto_dense", [
    ("sun", "sun", "mc_dsgt", "einsum"),
    ("auto", "sun", "mc_dsgt", "einsum"),
    ("auto", "federated", "local_sgd", "einsum"),
    ("auto", "hierarchical", "gt_local", "einsum"),
    ("auto", "ring", "mc_dsgt", "pallas"),
])
def test_arch_trainer_plan_impls_match_reference(impl, kind, algo,
                                                 auto_dense):
    """``make_train_step`` with gossip_impl 'sun' and 'auto' (the einsum or
    ``gossip_mix`` on the dense runs; on ``ring`` every round is dense)
    against the reference's on the same impl: losses and x, h, g_prev at
    RTOL/ATOL."""
    kw = {"local_steps": 1} if kind == "federated" else (
        {"pods": 2, "local_steps": 1} if kind == "hierarchical" else {})
    ts, js, layout = _arch_runs(algo, 2 if algo == "mc_dsgt" else 1, impl,
                                kind, kw, auto_dense)
    _leafwise(ts.x, js.x, layout, "x")
    if algo != "local_sgd":
        _leafwise(ts.h, js.h, layout, "h")
        _leafwise(ts.g_prev, js.g_prev, layout, "g_prev")


@pytest.fixture
def deterministic():
    """ATen's deterministic kernels: on the CPU the embedding's backward
    (an accumulating index_put_) otherwise adds duplicate tokens' rows in a
    thread-dependent order, which would hide what the bit-equality tests
    hold (the mixing paths)."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.usefixtures("deterministic")
def test_auto_pallas_on_ring_equals_pallas_bit_for_bit():
    """On ``ring`` (every plan round dense) ``auto`` with
    ``auto_dense='pallas'`` hands ``gossip_mix`` the same (R, n, n) stacks
    as ``pallas``: the states are equal bit for bit, with one launch of
    the wrapper per window in each (its plain version here)."""
    a, _, _ = _arch_runs("mc_dsgt", 2, "auto", "ring", auto_dense="pallas",
                         reference=False)
    b, _, _ = _arch_runs("mc_dsgt", 2, "pallas", "ring", reference=False)
    for f in ("x", "h", "g_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.usefixtures("deterministic")
def test_sun_equals_auto_on_the_sun_schedule():
    """gossip_impl 'sun' and 'auto' both run ``sun_mix`` on the theorem-3
    schedule: equal states."""
    a, _, _ = _arch_runs("mc_dsgt", 2, "sun", "sun", reference=False)
    b, _, _ = _arch_runs("mc_dsgt", 2, "auto", "sun", reference=False)
    for f in ("x", "h", "g_prev"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("kw", [
    dict(gossip_impl="ring"),
    dict(algo="personalized", gossip_impl="sun", sun_delta=1.0),
    dict(algo="personalized", gossip_impl="pallas"),
    dict(gossip_impl="sun"),
    dict(gossip_impl="auto"),
])
def test_train_step_refuses_what_the_reference_refuses(kw):
    kw = {"algo": "mc_dsgt", "gamma": 0.1, **kw}
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    with pytest.raises(ValueError):
        jsteps.make_train_step(jbuild(jcfg), jcfg, **kw)
    with pytest.raises(ValueError):
        steps.make_train_step(build(configs.get("qwen1.5-0.5b").reduced(
            **CUT)), None, **kw)
