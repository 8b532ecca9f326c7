"""The port's hybrid family (recurrentgemma-2b: RG-LRU blocks and local
MQA attention, 2:1, plus a remainder stack) against the JAX package's: the
RG-LRU block with and without a state, the geglu MLP, windowed and
block-local sliding attention, the ring-buffer cache once it wraps, the
plain flash and decode versions against the Pallas kernels (interpret mode)
at recurrentgemma's head_dim 256 and G = 10, and a reduced recurrentgemma
(1 unit + 2 remainder rglru layers, d_model 128, 4 query heads over 1 KV
head, window 16, vocab 256) in prefill and decode with ``use_pallas`` on
and off, decoding past the window, and ``serve_fleet`` token for token in
f32 and bf16.  Weights are carried across by ``params_from_jax``; every
other input comes from a numpy seed."""

import dataclasses
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jdecode)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.models import attention as jattn, build as jbuild  # noqa: E402
from repro.models import layers as jlayers, rglru as jrglru  # noqa: E402
from repro.models.transformer import param_count  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import (attention, build, layers,  # noqa: E402
                                params_from_jax, rglru)
from repro_torch.serve import serve_fleet  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# f32 sums of a few terms in another order (the RG-LRU block, the MLP, the
# attention paths): a few ulps; logits: the reference's own tolerance
# between its kernel and jnp paths (tests/test_kernels.py); caches: f32
# ulps of sums taken in other orders.
RTOL, ATOL = 1e-5, 1e-6
LOGIT_ATOL = 2e-4
CACHE_TOL = 1e-5
KERNEL_TOL = 2e-5        # the JAX kernel tests' f32 tolerance
PROMPT, DECODES, WINDOW = 40, 4, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    """The reduced recurrentgemma in both packages: 5 layers (1 unit of
    (rglru, rglru, attn) + a remainder of 2 rglru), d_model 128, 4 query
    heads of 32 over 1 KV head (MQA), window 16."""
    over = dict(dict(num_kv_heads=1, window=WINDOW), **over)
    small = dict(layers=5, d_model=128, d_ff=256, vocab=256)
    jcfg = dataclasses.replace(
        jconfigs.get("recurrentgemma-2b").reduced(**small), **over)
    cfg = dataclasses.replace(
        configs.get("recurrentgemma-2b").reduced(**small), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.units_and_rem == (1, 2)
    return jcfg, cfg


def _pair(use_pallas, dtype=jnp.float32):
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), dtype)
    return jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_config_is_a_verbatim_copy():
    assert (SRC / "repro_torch/configs/recurrentgemma_2b.py").read_text() == \
        (SRC / "repro/configs/recurrentgemma_2b.py").read_text()
    full = configs.get("recurrentgemma-2b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get("recurrentgemma-2b"))
    assert (full.head_dim, full.num_heads // full.num_kv_heads,
            full.units_and_rem) == (256, 10, (8, 2))


def test_full_width_parameter_count_is_the_references():
    """The reference's ``param_count`` of recurrentgemma-2b, from the
    port's shapes alone (no memory)."""
    model = build(configs.get("recurrentgemma-2b"))
    assert sum(int(np.prod(s)) for _, s in tree.items(model.shapes)) == \
        2_894_574_080
    jcfg, cfg = _cfgs()
    jshapes = jax.eval_shape(lambda k: jbuild(jcfg).init(k, jnp.float32),
                             jax.random.key(0))
    model = build(cfg)
    assert sum(int(np.prod(s)) for _, s in tree.items(model.shapes)) == \
        param_count(jshapes)
    assert model.shapes == tree.map(lambda a: tuple(a.shape), jshapes)


def test_params_from_jax_carries_the_rem_stack():
    """``rem`` crosses unchanged: the same paths, shapes, dtypes (lam f32
    in a bf16 model) and bits; the port's own init lays out the same
    tree."""
    jmodel, jparams, model, params = _pair(False, jnp.bfloat16)
    assert sorted(params["rem"]) == ["0_rglru", "1_rglru"]
    want = dict(tree.items(params_from_jax(jax.device_get(jparams))))
    host = jax.device_get(jparams)
    for path, leaf in tree.items(params):
        j = host
        for key in path:
            j = j[key]
        assert leaf.shape == tuple(j.shape), path
        assert leaf.dtype == (torch.float32 if path[-1] == "lam"
                              else torch.bfloat16), path
        assert torch.equal(leaf, want[path])
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(j, np.float32), err_msg=path)
    own = model.init(torch.Generator().manual_seed(0), torch.bfloat16)
    assert {p: (t.shape, t.dtype) for p, t in tree.items(own)} == \
        {p: (t.shape, t.dtype) for p, t in tree.items(params)}


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("with_state", [False, True])
def test_rglru_forward_matches_reference(use_pallas, with_state):
    """The block's output and new state, from the same weights and inputs,
    through the kernel route (S = 32 tiles; h0 folded into b_0) and the
    chunked scan."""
    jcfg, cfg = _cfgs(use_pallas=use_pallas)
    jp = jrglru.init_rglru(jax.random.key(1), jcfg, jnp.float32)
    p = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    st = {"conv": rng.standard_normal((2, cfg.conv_width - 1, cfg.lru_width)
                                      ).astype(np.float32),
          "h": rng.standard_normal((2, cfg.lru_width)).astype(np.float32)}
    jy, jst = jrglru.rglru_forward(
        jp, jnp.asarray(x), jcfg, chunk=8,
        state=tree.map(jnp.asarray, st) if with_state else None)
    y, new = rglru.rglru_forward(
        p, torch.from_numpy(x), cfg, chunk=8,
        state=tree.map(torch.from_numpy, st) if with_state else None)
    _close(y, jy)
    for name in ("conv", "h"):
        assert new[name].dtype == {"h": torch.float32}.get(name, y.dtype)
        _close(new[name], jst[name], msg=name)


def test_geglu_mlp_matches_reference():
    """geglu's GeLU is jax.nn.gelu's default, the tanh form."""
    rng = np.random.default_rng(3)
    jp = jlayers.init_mlp(jax.random.key(2), 64, 96, "geglu", jnp.float32)
    p = params_from_jax(jax.device_get(jp))
    assert sorted(p) == ["wg", "wi", "wo"]
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    want = jlayers.apply_mlp(jp, jnp.asarray(x), "geglu")
    _close(layers.apply_mlp(p, torch.from_numpy(x), "geglu"), want)
    # relu2 and gelu are ported (tests/test_torch_dense_archs.py); an
    # activation neither package knows raises
    with pytest.raises(ValueError, match="unknown activation"):
        layers.apply_mlp(p, torch.from_numpy(x), "tanh")


def _qkv(rng, B, S, J, G, hd):
    q = rng.standard_normal((B, S, J, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, J, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, J, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("S,window,q_chunk", [(40, 16, 1024), (40, 16, 16),
                                               (24, 7, 1024)])
def test_attend_full_with_a_window_matches_reference(S, window, q_chunk):
    rng = np.random.default_rng(S + window)
    q, k, v = _qkv(rng, 2, S, 1, 4, 32)
    pos = np.arange(S)
    want = jattn.attend_full(*map(jnp.asarray, (q, k, v)), jnp.asarray(pos),
                             jnp.asarray(pos), window=window,
                             q_chunk=q_chunk)
    got = attention.attend_full(*map(torch.from_numpy, (q, k, v)),
                                torch.from_numpy(pos), torch.from_numpy(pos),
                                window=window, q_chunk=q_chunk)
    _close(got, want)


@pytest.mark.parametrize("S,window", [(48, 16), (40, 16), (37, 8)])
def test_attend_sliding_block_matches_reference(S, window):
    """S a multiple of the window and not (the last block padded), equal
    to the reference's block-local path and to full attention with the
    window."""
    rng = np.random.default_rng(S * window)
    q, k, v = _qkv(rng, 2, S, 1, 4, 32)
    pos = np.arange(S)
    want = jattn.attend_sliding_block(*map(jnp.asarray, (q, k, v)),
                                      jnp.asarray(pos), window=window)
    got = attention.attend_sliding_block(*map(torch.from_numpy, (q, k, v)),
                                         torch.from_numpy(pos), window=window)
    assert got.shape == (2, S, 4, 32)
    _close(got, want)
    full = attention.attend_full(*map(torch.from_numpy, (q, k, v)),
                                 torch.from_numpy(pos), torch.from_numpy(pos),
                                 window=window)
    _close(got, full.numpy())


@pytest.mark.parametrize("S,C", [(40, 16), (16, 16), (33, 8)])
def test_cache_prefill_past_the_ring_matches_reference(S, C):
    """A prefill longer than the ring keeps its last C tokens, each at slot
    pos % C, bit-equal to the reference; then single-token inserts wrap
    the ring again."""
    cfg = types.SimpleNamespace(window=C, num_kv_heads=1, head_dim=8)
    rng = np.random.default_rng(S + C)
    k = rng.standard_normal((1, S + C + 3, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, S + C + 3, 1, 8)).astype(np.float32)
    jc = jattn.cache_prefill(
        jattn.init_cache(cfg, 1, S + C + 3, jnp.float32),
        jnp.asarray(k[:, :S]), jnp.asarray(v[:, :S]), jnp.arange(S))
    c = attention.init_cache(cfg, 1, S + C + 3, torch.float32)
    assert c["k"].shape[1] == C
    attention.cache_prefill(c, torch.from_numpy(k[:, :S]),
                            torch.from_numpy(v[:, :S]), torch.arange(S))
    for pos in range(S, S + C + 3):
        for name in ("k", "v", "kpos"):
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]), err_msg=name)
        one = slice(pos, pos + 1)
        jc = jattn.cache_insert(jc, jnp.asarray(k[:, one]),
                                jnp.asarray(v[:, one]), jnp.int32(pos))
        attention.cache_insert(c, torch.from_numpy(k[:, one]),
                               torch.from_numpy(v[:, one]), pos)
    assert sorted(c["kpos"].tolist()) == list(range(S + 3, S + C + 3))


# (B, S, KV, G, window): recurrentgemma's MQA heads at hd 256, small S
FLASH_HD256 = [(1, 40, 1, 10, 16), (1, 128, 1, 10, 48), (2, 32, 1, 10, 0)]
# (B, C, G, window, filled, pos): a wrapped ring, a part-filled one
DECODE_HD256 = [(1, 16, 10, 16, 16, 40), (2, 32, 10, 32, 20, 19),
                (1, 256, 10, 200, 256, 300)]


@pytest.mark.parametrize("case", FLASH_HD256)
def test_plain_flash_matches_the_pallas_kernel_at_hd256(case):
    """What the ``flash_attention`` wrapper runs on a CPU tensor against
    the Pallas kernel in interpret mode, at hd 256 and G = 10."""
    B, S, KV, G, window = case
    H, hd = KV * G, 256
    rng = np.random.default_rng(S + window)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, hd)).astype(np.float32)
    blk = min(128, S)
    want = jflash(*map(jnp.asarray, (q, k, v)), causal=True, window=window,
                  block_q=blk, block_k=blk, interpret=True)
    got = ref.attention_ref(*map(torch.from_numpy, (q, k, v)), window=window)
    _close(got, want, rtol=KERNEL_TOL, atol=KERNEL_TOL)


def _kpos(C, filled, pos, window):
    """tests/test_kernels.py's kpos: the ring's absolute positions once
    wrapped, else 0..filled-1 and -1 for the empty tail."""
    if window and pos >= C:
        base = pos - C + 1
        return ((np.arange(C) - base % C) % C + base).astype(np.int32)
    return np.where(np.arange(C) < filled, np.arange(C), -1).astype(np.int32)


@pytest.mark.parametrize("case", DECODE_HD256)
def test_plain_decode_matches_the_pallas_kernel_at_hd256(case):
    """What the ``decode_attention`` wrapper runs on a CPU tensor, and the
    kernel's split arithmetic at its hd-256 tile of 32 slots, against the
    Pallas kernel in interpret mode."""
    B, C, G, window, filled, pos = case
    hd = 256
    rng = np.random.default_rng(C + G + pos)
    q = rng.standard_normal((B, 1, 1, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, 1, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, 1, hd)).astype(np.float32)
    kpos = _kpos(C, filled, pos, window)
    want = jdecode(*map(jnp.asarray, (q, k, v, kpos)), jnp.int32(pos),
                   window=window, block_k=min(256, C), interpret=True)
    args = tuple(map(torch.from_numpy, (q, k, v, kpos)))
    _close(ref.decode_attention_ref(*args, pos, window=window), want,
           rtol=KERNEL_TOL, atol=KERNEL_TOL)
    for splits in (1, 2):
        _close(ref.decode_attention_split_ref(*args, pos, window=window,
                                              splits=splits, tile=32), want,
               rtol=KERNEL_TOL, atol=KERNEL_TOL, msg=f"splits {splits}")


@pytest.fixture(scope="module", params=[True, False],
                ids=["use_pallas", "jnp"])
def served(request):
    """Prefill a 40-token prompt (past the 16-slot ring), then decode 4
    tokens, in both packages."""
    jmodel, jparams, model, params = _pair(request.param)
    tokens = np.random.default_rng(0).integers(0, 256, (2, PROMPT)).astype(
        np.int32)
    max_len = PROMPT + DECODES
    jcache = jmodel.init_cache(2, max_len, jnp.float32)
    cache = model.init_cache(2, max_len, torch.float32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcache)
    log, cache = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               cache)
    out = dict(jlog=[jlog], log=[log],
               jcache=[params_from_jax(jax.device_get(jcache))],
               cache=[tree.map(torch.clone, cache)])
    for pos in range(PROMPT, PROMPT + DECODES):
        tok = np.asarray(jnp.argmax(out["jlog"][-1], -1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jnp.int32(pos))
        log, cache2 = model.decode_step(params, torch.from_numpy(tok).long(),
                                        cache, pos)
        assert cache2 is cache                  # updated in place
        out["jlog"].append(jlog)
        out["log"].append(log)
        out["jcache"].append(params_from_jax(jax.device_get(jcache)))
        out["cache"].append(tree.map(torch.clone, cache))
    return out


def test_prefill_and_decode_logits_match(served):
    for step, (got, want) in enumerate(zip(served["log"], served["jlog"])):
        assert got.shape == (2, 1, 256), step
        _close(got, want, rtol=0, atol=LOGIT_ATOL, msg=f"step {step}")


def test_caches_match(served):
    """Every leaf of the unit and remainder caches after the prefill and
    after each decode step (the ring's kpos bit-equal)."""
    for step, (got, want) in enumerate(zip(served["cache"],
                                           served["jcache"])):
        want = dict(tree.items(want))
        assert list(dict(tree.items(got))) == list(want)
        assert sorted(got["rem"]) == ["0_rglru", "1_rglru"]
        for path, leaf in tree.items(got):
            w = want[path]
            assert leaf.shape == w.shape and leaf.dtype == w.dtype, path
            if path[-1] == "kpos":
                assert torch.equal(leaf, w), (step, path)
            _close(leaf, w.numpy(), rtol=CACHE_TOL, atol=CACHE_TOL,
                   msg=f"{step} {path}")
    assert served["cache"][-1]["units"]["2_attn"]["k"].shape[2] == WINDOW


def test_training_the_hybrid_is_not_ported():
    """Training the hybrid through the kernels is not ported in either
    package (no kernel has a backward); with use_pallas off, as the arch
    trainer runs it, the spec builds (its steps are held to the
    reference's in tests/test_torch_arch_train.py), and so does the
    encoder-decoder's (tests/test_torch_encdec.py)."""
    spec = exp.with_overrides(exp.ExperimentSpec(),
                              {"model.arch": "recurrentgemma-2b",
                               "model.preset": "reduced"})
    built = exp.build(spec, device="cpu")
    assert built.cfg.pattern == ("rglru", "rglru", "attn")
    assert not built.cfg.use_pallas
    built = exp.build(exp.with_overrides(spec, {"model.arch": "whisper-tiny"}),
                      device="cpu")
    assert built.cfg.arch_type == "audio"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serve_fleet_matches_reference(dtype):
    """A 2-member fleet served through the kernels' routes (the JAX kernels
    in interpret mode), prompts past the window: every request decodes the
    same tokens on the same node.  The bf16 fleet is cast from f32 by both
    engines (lam included, as the reference's astype does)."""
    jcfg, cfg = _cfgs(use_pallas=True)
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    spec = dict(requests=3, batch=2, prompt_len=32, max_new=6, fleet=2,
                dtype=dtype, routing="round-robin")
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), params_from_jax(jax.device_get(jfleet)),
                      exp.ServeSpec(**spec))
    assert len(got.completed) == 3
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 6
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}
