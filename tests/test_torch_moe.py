"""The MoE family against the JAX package: granite-moe-3b-a800m (40 experts
top-8, ``("moe",)``) and llama4-maverick-400b-a17b (``("attn", "moe")``,
top-1 with a shared expert).  The configs are verbatim copies and the
parameter trees keep the reference's leaf order (router, shared, wg, wi,
wo).  Reduced (4 experts, d_model 256, 4 heads of 64 over 2 KV heads),
``apply_moe``'s output and load-balance loss, the router's top-k, each
choice's capacity slot and its keep flag hold to the reference's at f32,
dropless and at capacity factor 0.25, with its token groups
(``moe_seq_group``) too; equal gates go to the lower expert index; the
reference's invariants hold; prefill and decode logits hold at atol 2e-4
with ``use_pallas`` on (the JAX kernels in interpret mode) and off, the
train loss with its aux term at rtol 1e-4, and ``serve_fleet`` serves the
reference's tokens in bf16.  Weights are carried across by
``params_from_jax``; every other input comes from a numpy seed."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.models import build as jbuild, moe as jmoe  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import build, moe, params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCHS = ("granite-moe-3b-a800m", "llama4-maverick-400b-a17b")
MODULES = {"granite-moe-3b-a800m": "granite_moe_3b_a800m",
           "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b"}
# The reference's own tolerance between its kernel and jnp paths
# (tests/test_kernels.py test_kernels_integrate_into_model_path).
LOGIT_ATOL = 2e-4
# one MoE layer's output: sums of 256-term f32 products in another order
OUT_TOL = 1e-5
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


def _jleaves(cfg) -> list:
    shapes = jax.eval_shape(lambda: jbuild(cfg).init(jax.random.key(0),
                                                     jnp.float32))
    return [(tuple(k.key for k in p), tuple(leaf.shape)) for p, leaf
            in jax.tree_util.tree_leaves_with_path(shapes)]


@pytest.mark.parametrize("preset", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_are_the_references_leaves_in_order(arch, preset):
    """The reference's leaves, shapes and ``jax.tree.leaves`` order (an MoE
    leaf goes router, shared, wg, wi, wo), at the published widths (no
    memory: the meta device and ``jax.eval_shape``) and reduced."""
    cfg, jcfg = configs.get(arch), jconfigs.get(arch)
    if preset == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    got = list(tree.items(build(cfg).shapes))
    assert got == _jleaves(jcfg)
    name = "1_moe" if arch.startswith("llama4") else "0_moe"
    keys = [p[3] for p, _ in got if p[:3] == ("units", name, "moe")]
    assert keys[0] == "router" and keys[-3:] == ["wg", "wi", "wo"]
    assert ("shared" in keys) == cfg.shared_expert
    if preset == "full" and arch.startswith("granite"):
        assert sum(int(np.prod(s)) for _, s in got) == 3_298_793_472


def _jroute(p, x, cfg, cf):
    """The reference's routing (``repro/models/moe.py`` ``_moe_dense``,
    router to capacity slots), step for step."""
    E, k = jmoe._padded_experts(cfg), cfg.experts_per_token
    xf = x.reshape(-1, x.shape[-1])
    T = xf.shape[0]
    logits = jnp.einsum("td,de->te", xf, p["router"]).astype(jnp.float32)
    gates = jax.nn.softmax(logits, axis=-1)
    topv, topi = jax.lax.top_k(gates, k)
    topv = topv / jnp.maximum(topv.sum(-1, keepdims=True), 1e-9)
    C = jmoe._capacity(T, k, E, cf)
    flat = jax.nn.one_hot(topi, E, dtype=jnp.int32).reshape(T * k, E)
    pos = ((jnp.cumsum(flat, axis=0) - flat) * flat).sum(-1).reshape(T, k)
    return {"topv": topv, "topi": topi, "pos": pos, "keep": pos < C, "C": C}


def _moe_pair(arch, **over):
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(), **over)
    cfg = dataclasses.replace(configs.get(arch).reduced(), **over)
    p = jmoe.init_moe(jax.random.key(0), jcfg, jnp.float32)
    return jcfg, cfg, p, params_from_jax(jax.device_get(p))


@pytest.mark.parametrize("cf", [None, 0.25], ids=["dropless", "cf0.25"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_and_routing_match_reference(arch, cf):
    """64 tokens: the top-k gates and indices, each choice's slot and keep
    flag equal to the reference's; the layer's output at rtol = atol = 1e-5
    and the aux loss at rtol 1e-6.  At capacity 0.25 choices are dropped."""
    jcfg, cfg, jp, p = _moe_pair(arch)
    x = np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity_factor=cf)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg, capacity_factor=cf)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)
    want = _jroute(jp, jnp.asarray(x), jcfg,
                   cf if cf is not None else jcfg.moe_capacity_factor)
    got = moe.route(p, torch.from_numpy(x).reshape(-1, cfg.d_model), cfg,
                    cf)
    assert got["C"] == want["C"]
    for key in ("topi", "pos", "keep"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), err_msg=key)
    # softmax and the renormalization round differently in the last f32 bit
    np.testing.assert_allclose(got["topv"].numpy(), np.asarray(want["topv"]),
                               rtol=1e-5)
    if cf == 0.25:
        assert not got["keep"].all()


def test_token_groups_match_reference():
    """``moe_seq_group`` 16 splits 64 tokens into 4 dispatch groups: the
    output and the mean aux loss are the reference's vmapped groups'."""
    jcfg, cfg, jp, p = _moe_pair("granite-moe-3b-a800m", moe_seq_group=16)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32)
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, capacity_factor=1.0)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg, capacity_factor=1.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_equal_gates_go_to_the_lower_index():
    """A zero router gives every expert the same gate: each token's top k
    are experts 0 .. k-1 in order, as ``jax.lax.top_k`` gives them, and
    the layer's output is the reference's.  A planted tie inside a row
    keeps the index order too."""
    jcfg, cfg, jp, p = _moe_pair("granite-moe-3b-a800m")
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = np.random.default_rng(3).standard_normal(
        (1, 8, cfg.d_model)).astype(np.float32)
    r = moe.route(p, torch.from_numpy(x)[0], cfg)
    k = cfg.experts_per_token
    assert r["topi"].tolist() == [list(range(k))] * 8
    jout, _ = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    out, _ = moe.apply_moe(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    gates = np.array([[0.1, 0.3, 0.2, 0.3, 0.1, 0.3]], np.float32)
    _, want = jax.lax.top_k(jnp.asarray(gates), 4)
    vals, got = moe.top_k(torch.from_numpy(gates), 4)
    assert got.tolist() == np.asarray(want).tolist() == [[1, 3, 5, 2]]
    assert vals[0].tolist() == pytest.approx([0.3, 0.3, 0.3, 0.2])


def test_padding_experts_are_never_routed():
    """``moe_pad_experts`` 6 over 4 real experts: the padding experts get
    -1e30 logits, so no choice lands on them; output as the reference's."""
    jcfg, cfg, jp, p = _moe_pair("granite-moe-3b-a800m", moe_pad_experts=6)
    assert tuple(p["router"].shape) == (cfg.d_model, 6)
    x = np.random.default_rng(4).standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32)
    r = moe.route(p, torch.from_numpy(x)[0], cfg)
    assert int(r["topi"].max()) < cfg.num_experts
    assert float(r["gates"][:, cfg.num_experts:].max()) == 0.0
    jout, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    out, aux = moe.apply_moe(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), rtol=1e-6)


def test_dropless_routing_weights_sum_and_batch_permutation():
    """The twin of the reference's ``test_moe_dropless_routing_weights_sum``
    (tests/test_substrate.py): each token's renormalized gates sum to 1,
    aux > 0, and permuting the batch only permutes the output."""
    _, cfg, _, p = _moe_pair("granite-moe-3b-a800m")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    out, aux = moe.apply_moe(p, x, cfg)
    assert out.shape == x.shape and aux.item() > 0.0
    r = moe.route(p, x.reshape(-1, cfg.d_model), cfg)
    assert r["keep"].all()
    np.testing.assert_allclose(r["topv"].sum(-1).numpy(), 1.0, rtol=1e-6)
    out_p, _ = moe.apply_moe(p, x[[1, 0]], cfg)
    np.testing.assert_allclose(out_p.numpy(), out[[1, 0]].numpy(), atol=2e-5)


def test_capacity_drops_degrade_gracefully():
    """The twin of ``test_moe_capacity_drops_degrade_gracefully``: a tight
    capacity drops choices (their share of the output is 0), never NaNs."""
    _, cfg, _, p = _moe_pair("granite-moe-3b-a800m")
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 64, cfg.d_model)).astype(np.float32))
    full, _ = moe.apply_moe(p, x, cfg, capacity_factor=64.0)
    tight, _ = moe.apply_moe(p, x, cfg, capacity_factor=0.25)
    assert not torch.isnan(tight).any()
    assert tight.abs().sum() < full.abs().sum()


def _pair(arch, use_pallas):
    """Reduced ``arch`` in both packages, the JAX init carried across."""
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(),
                               use_pallas=use_pallas)
    cfg = dataclasses.replace(configs.get(arch).reduced(),
                              use_pallas=use_pallas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


SERVED = [("granite-moe-3b-a800m", True), ("granite-moe-3b-a800m", False),
          ("llama4-maverick-400b-a17b", False)]


@pytest.fixture(scope="module", params=SERVED,
                ids=[f"{a}-{'use_pallas' if p else 'jnp'}" for a, p in SERVED])
def served(request):
    """Prefill a prompt, then decode two tokens (positions 16 and 17), in
    both packages; the port's kernel counts must not move on the CPU.
    llama4's attention layers are granite's, so its kernel routes add
    nothing to granite's and it runs with use_pallas off."""
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
    """The prefill's last logits and two decode steps' (the MoE layers
    route the 32 prompt tokens together, then each decode token alone)."""
    for step, (got, want) in enumerate(zip(served["logs"], served["jlogs"])):
        assert got.shape == (2, 1, 512), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")


def test_caches_match(served):
    """An MoE layer's cache is its attention layer's KV cache."""
    want = dict(tree.items(params_from_jax(jax.device_get(served["jcache"]))))
    got = dict(tree.items(served["cache"]))
    assert list(got) == list(want)
    assert any(path[1].endswith("_moe") for path in got)
    for path, leaf in got.items():
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=str(path))


def test_train_loss_with_aux_matches(served):
    """The next-token loss plus 0.01 times the summed load-balance loss
    (a value only: with use_pallas the forward runs the attention kernels'
    routes, which have no backward in either package)."""
    tokens = served["tokens"]
    want = float(served["jmodel"].train_loss(
        served["jparams"], {"tokens": jnp.asarray(tokens)}))
    got = served["model"].train_loss(
        served["params"], {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)
    from repro_torch.models import transformer
    _, aux = transformer.forward(served["params"], served["model"].cfg,
                                 torch.from_numpy(tokens).long())
    assert aux.item() > 0.0


def test_serve_fleet_matches_reference_in_bf16():
    """A 2-member granite fleet cast to bf16 by both engines (bf16 router
    logits tie often, so the top-k order among equal gates shows here):
    every request decodes the same tokens on the same node."""
    arch = "granite-moe-3b-a800m"
    jcfg, cfg = jconfigs.get(arch).reduced(), configs.get(arch).reduced()
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    spec = dict(requests=3, batch=2, prompt_len=PROMPT, max_new=4, fleet=2,
                dtype="bf16", routing="round-robin")
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), params_from_jax(jax.device_get(jfleet)),
                      exp.ServeSpec(**spec))
    assert len(got.completed) == 3
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 4
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}


def test_the_smokes_granite_paths_fit_the_kernels():
    """``chip_smoke.py``'s granite-moe serve path: the prompt tiles (a
    multiple of 128) and the cache (a multiple of 256) as both kernels
    need, the member size is the config's parameter count at the path's
    depth (GRANITE_SERVE_LAYERS of the published 32; widths unchanged),
    the timed kernel shapes are its heads (24 over 8 of 64); and the
    training paths' cut depths give the D the smoke checks."""
    import importlib.util
    path = SRC.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_moe", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg, sv = configs.get("granite-moe-3b-a800m"), smoke.GSERVE
    assert sv["prompt_len"] % 128 == 0
    assert (sv["prompt_len"] + sv["max_new"]) % 256 == 0
    assert (sv["requests"], sv["batch"], sv["fleet"]) == (8, 4, 4)
    assert cfg.num_layers == 32 and 0 < smoke.GRANITE_SERVE_LAYERS < 32
    cut = dataclasses.replace(cfg, num_layers=smoke.GRANITE_SERVE_LAYERS)
    assert sum(int(np.prod(s)) for _, s in tree.items(
        build(cut).shapes)) == smoke.GRANITE_PARAMS
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert smoke.FLASH_GR == (1, sv["prompt_len"], H, KV, hd) and hd == 64
    assert smoke.DECODE_GR == (1, sv["prompt_len"] + sv["max_new"], KV,
                               H // KV, hd)
    for arch, layers in smoke.TRAIN_LAYERS.items():
        cut = dataclasses.replace(configs.get(arch), num_layers=layers)
        assert sum(int(np.prod(s)) for _, s in tree.items(
            build(cut).shapes)) == smoke.TRAIN_D[arch]
