"""The dense family's remaining fields and three models against the JAX
package: yi-6b (swiglu, tied embeddings), minitron-4b and nemotron-4-340b
(relu2 with no gate, untied embeddings).  The configs are verbatim copies;
the parameter trees have the reference's leaf sets at full width and
reduced; ``params_from_jax`` carries a tree across bit for bit; reduced to
d_model 512 (4 heads of 128 over 2 KV heads: head_dim 128, G = 2, the
serve paths' head_dim) each model's prefill and decode logits hold to the
reference's at atol 2e-4 with ``use_pallas`` on (the JAX kernels in
interpret mode) and off, ``serve_fleet`` serves the reference's tokens,
and 2 MC-DSGT steps of the reduced minitron hold to the reference's
trainer.  Weights are carried across by ``params_from_jax``; every other
input comes from a numpy seed."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import build, layers, params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("yi-6b", "minitron-4b", "nemotron-4-340b")
MODULES = {"yi-6b": "yi_6b", "minitron-4b": "minitron_4b",
           "nemotron-4-340b": "nemotron_4_340b"}
CUT = dict(d_model=512)          # 4 heads of 128 over 2 KV heads
# The reference's own tolerance between its kernel and jnp paths
# (tests/test_kernels.py test_kernels_integrate_into_model_path).
LOGIT_ATOL = 2e-4
# The arch trainer's step tolerance (slices 1-3).
RTOL, ATOL = 1e-4, 1e-5
PROMPT = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_is_a_verbatim_copy_and_registered(arch):
    mod = MODULES[arch]
    assert (SRC / f"repro_torch/configs/{mod}.py").read_text() == \
        (SRC / f"repro/configs/{mod}.py").read_text()
    assert dataclasses.asdict(configs.get(arch)) == \
        dataclasses.asdict(jconfigs.get(arch))
    assert arch in configs.names()


def _jshapes(cfg) -> dict:
    shapes = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.key(0),
                                                     jnp.float32))
    return {tuple(k.key for k in p): tuple(leaf.shape) for p, leaf
            in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("preset", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_references_leaf_set(arch, preset):
    """The reference's leaves and shapes (no gate under relu2, an
    ``unembed`` when untied), at the published widths (no memory: the
    meta device and ``jax.eval_shape``) and reduced."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    if preset == "reduced":
        cfg, jcfg = cfg.reduced(**CUT), jcfg.reduced(**CUT)
    got = dict(tree.items(build(cfg).shapes))
    assert got == _jshapes(jcfg)
    gated = cfg.mlp_act in ("swiglu", "geglu")
    assert (("units", "0_attn", "mlp", "wg") in got) == gated
    assert (("embed", "unembed") in got) == (not cfg.tie_embeddings)
    if preset == "full" and arch == "minitron-4b":
        # 32 layers of 2.62B in all and two untied 256,000 x 3072
        # embeddings of 786M each
        assert sum(int(np.prod(s)) for s in got.values()) == 4_190_309_376


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_round_trips(arch, dtype):
    jcfg = jconfigs.get(arch).reduced(**CUT)
    jparams = jbuild(jcfg).init(jax.random.key(1), dtype)
    params = params_from_jax(jax.device_get(jparams))
    assert dict(tree.items(build(configs.get(arch).reduced(**CUT)).shapes)) \
        == {p: tuple(t.shape) for p, t in tree.items(params)}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        got = dict(tree.items(params))[tuple(k.key for k in path)]
        want = np.asarray(leaf)
        if want.dtype.name == "bfloat16":
            got, want = got.view(torch.int16), want.view(np.int16)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_activations_match_reference(act):
    from repro.models import layers as jlayers
    rng = np.random.default_rng(3)
    p = {k: rng.standard_normal(s).astype(np.float32) * 0.2
         for k, s in (("wi", (16, 32)), ("wg", (16, 32)), ("wo", (32, 16)))}
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), act)
    got = layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x), act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="unknown activation"):
        layers.apply_mlp({k: torch.from_numpy(v) for k, v in p.items()},
                         torch.from_numpy(x), "tanh")


def _pair(arch, use_pallas):
    """Reduced ``arch`` in both packages, the JAX init carried across."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(**CUT),
                               use_pallas=use_pallas)
    cfg = dataclasses.replace(configs.get(arch).reduced(**CUT),
                              use_pallas=use_pallas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads) == (128, 2)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


@pytest.fixture(scope="module",
                params=[(a, p) for a in ARCHS for p in (True, False)],
                ids=[f"{a}-{'use_pallas' if p else 'jnp'}" for a in ARCHS
                     for p in (True, False)])
def served(request):
    """Prefill a prompt, then decode two tokens (positions 16 and 17), in
    both packages; the port's kernel counts must not move on the CPU."""
    arch, use_pallas = request.param
    jmodel, jparams, model, params = _pair(arch, use_pallas)
    tokens = np.random.default_rng(0).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    before = (flash_attention.launches, decode_attention.launches)
    jcache = jmodel.init_cache(2, PROMPT + 4, jnp.float32)
    cache = model.init_cache(2, PROMPT + 4, torch.float32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcache)
    log, cache = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               cache)
    logs, jlogs = [log], [jlog]
    for pos in (PROMPT, PROMPT + 1):
        tok = np.asarray(jnp.argmax(jlogs[-1], -1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(tok).long(),
                                       cache, pos)
        logs.append(log)
        jlogs.append(jlog)
    assert (flash_attention.launches, decode_attention.launches) == before
    return dict(logs=logs, jlogs=jlogs, jcache=jcache, cache=cache,
                tokens=tokens, jmodel=jmodel, jparams=jparams, model=model,
                params=params)


def test_prefill_and_decode_logits_match(served):
    """The prefill's last logits and two decode steps' at hd 128, G = 2."""
    for step, (got, want) in enumerate(zip(served["logs"], served["jlogs"])):
        assert got.shape == (2, 1, 512), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")


def test_caches_match(served):
    want = dict(tree.items(params_from_jax(jax.device_get(served["jcache"]))))
    got = dict(tree.items(served["cache"]))
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape, path
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_train_loss_matches(served):
    tokens = served["tokens"]
    want = float(served["jmodel"].train_loss(
        served["jparams"], {"tokens": jnp.asarray(tokens)}))
    got = served["model"].train_loss(
        served["params"], {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)


@pytest.mark.parametrize("arch", ["yi-6b", "minitron-4b"])
def test_serve_fleet_matches_reference(arch):
    """A 2-member fleet served through the kernels' routes (the JAX kernels
    in interpret mode): every request decodes the same tokens on the same
    node."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(**CUT),
                               use_pallas=True)
    cfg = dataclasses.replace(configs.get(arch).reduced(**CUT),
                              use_pallas=True)
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    spec = dict(requests=3, batch=2, prompt_len=PROMPT, max_new=4, fleet=2,
                dtype="f32", routing="round-robin")
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), params_from_jax(jax.device_get(jfleet)),
                      exp.ServeSpec(**spec))
    assert len(got.completed) == 3
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 4
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}


def test_minitron_mc_dsgt_steps_match_reference():
    """Warm start + 2 MC-DSGT (R = 2) steps of the reduced minitron-4b (no
    gate, an untied ``unembed``) through both packages'
    ``make_train_step`` on a ring of 4 from the same parameters and tokens:
    losses at RTOL, every leaf of x, h and g⁻ at RTOL/ATOL."""
    from repro_torch.exp import registry, spec as tspec
    n, R, B, S = 4, 2, 1, 16
    sched = registry.build_topology(tspec.TopologySpec(kind="ring"), n,
                                    horizon=64, seed=0)
    jcfg = jconfigs.get("minitron-4b").reduced(**CUT)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo="mc_dsgt", gamma=0.1, R=R,
        gossip_impl="dense")
    jstep = jax.jit(jstep)
    model = build(configs.get("minitron-4b").reduced(**CUT))
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="dense")
    js = jinit(jax.random.key(0), n, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda leaf: leaf[0], js.x))), n)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 512, (n, R, B, S)).astype(np.int32)
               for _ in range(3)]
    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    wps = 2 * R
    for k in (1, 2):
        W = np.asarray(sched.stacked((k - 1) * wps, wps), np.float32)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, tout = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
    layout = steps.flat_layout(model)
    assert any(path == ("embed", "unembed") for path, _, _ in layout.entries)
    for what in ("x", "h", "g_prev"):
        want = {tuple(k.key for k in p): np.asarray(leaf, np.float32)
                for p, leaf in jax.tree_util.tree_leaves_with_path(
                    getattr(js, what))}
        mat = getattr(ts, what)
        for path, shape, off in layout.entries:
            size = int(np.prod(shape))
            np.testing.assert_allclose(
                mat[:, off:off + size].numpy(), want[path].reshape(n, size),
                rtol=RTOL, atol=ATOL, err_msg=f"{what}: {'/'.join(path)}")


def test_the_smokes_hd128_serve_paths_fit_the_kernels():
    """``chip_smoke.py``'s yi-6b and minitron-4b serve paths: the prompt
    tiles (a multiple of 128) and the cache (prompt + new, a multiple of
    256) as both kernels need, the member sizes are the configs' parameter
    counts at the paths' depth (HD128_LAYERS of the published 32; widths
    as published), and the timed kernel shapes are the configs' heads at
    head_dim 128."""
    import importlib.util
    path = SRC.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_dense", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    for arch, sv, n_params, flash, dec in (
            ("yi-6b", smoke.YSERVE, smoke.YI_PARAMS, smoke.FLASH_YI,
             smoke.DECODE_YI),
            ("minitron-4b", smoke.MSERVE, smoke.MINITRON_PARAMS,
             smoke.FLASH_MT, smoke.DECODE_MT)):
        cfg = configs.get(arch)
        assert cfg.num_layers == 32 and 0 < smoke.HD128_LAYERS < 32
        cut = dataclasses.replace(cfg, num_layers=smoke.HD128_LAYERS)
        assert sv["prompt_len"] % 128 == 0
        assert (sv["prompt_len"] + sv["max_new"]) % 256 == 0
        assert (sv["requests"], sv["batch"], sv["fleet"]) == (8, 4, 4)
        assert sum(int(np.prod(s)) for _, s in tree.items(
            build(cut).shapes)) == n_params
        H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        assert flash == (1, sv["prompt_len"], H, KV, hd) and hd == 128
        assert dec == (1, sv["prompt_len"] + sv["max_new"], KV, H // KV, hd)
