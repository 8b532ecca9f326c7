"""The port's attention serving against the JAX package's: the plain
versions of ``flash_attention`` and ``decode_attention`` (what the wrappers
run on a CPU tensor) against the Pallas kernels in interpret mode and their
oracles, the ring-buffer KV cache bit for bit, a reduced qwen1.5 (2 layers,
d_model 256, 4 heads of 64, vocab 512) with G = 1 and G = 2 in prefill,
decode and train mode with ``use_pallas`` on and off, ``serve_fleet`` token
for token, and the shapes the JAX kernels assert on refused by the port's
wrappers.  Weights are carried across by ``params_from_jax``; every other
input comes from a numpy seed."""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jdecode)
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.models import attention as jattn, build as jbuild  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models import attention, build, params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

# The JAX kernel tests' tolerances (tests/test_kernels.py): f32 sums in
# another order; bf16 rounds p before (kernel) or after (oracle) normalising.
TOL = {"f32": 2e-5, "bf16": 2e-2}
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# Logits: the reference's own tolerance between its kernel and jnp paths
# (tests/test_kernels.py test_kernels_integrate_into_model_path).
LOGIT_ATOL = 2e-4
PROMPT = 16

# tests/test_kernels.py ATTN_CASES and DECODE_CASES, plus a row with no
# valid key: with a window and Sq > Sk, rows q >= Sk + window - 1 average v;
# then head_dim 192 at G = 12 (nemotron-4-340b's) and decodes at G > 16, the
# kernels' row groups.
ATTN_CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window, bq, bk)
    (1, 128, 128, 4, 4, 64, True, 0, 64, 64),
    (2, 256, 256, 4, 2, 64, True, 0, 128, 128),
    (1, 128, 128, 8, 1, 32, True, 0, 64, 64),      # MQA
    (1, 256, 256, 4, 4, 64, True, 64, 64, 64),     # sliding window
    (2, 128, 128, 2, 2, 128, False, 0, 64, 64),    # bidirectional
    (1, 512, 512, 2, 1, 64, True, 128, 128, 128),  # window > block
    (1, 256, 128, 2, 1, 64, True, 64, 128, 128),   # rows with no valid key
    # nemotron-4-340b's head_dim 192 with its G = 12 (96 over 8 heads)
    (1, 128, 128, 12, 1, 192, True, 0, 64, 64),
    (1, 256, 256, 24, 2, 192, True, 100, 128, 128),  # window off the tiles
    (1, 256, 128, 12, 1, 192, True, 64, 128, 128),   # rows with no valid key
]
DECODE_CASES = [
    # (B, C, J, G, hd, window, filled, pos, bk)
    (2, 256, 2, 2, 64, 0, 256, 255, 128),     # full cache
    (1, 512, 1, 8, 64, 0, 300, 299, 128),     # partially filled (kpos -1 tail)
    (2, 256, 2, 4, 128, 128, 256, 400, 64),   # ring buffer, window
    (1, 128, 4, 1, 32, 0, 128, 127, 128),     # MHA-ish
    (1, 128, 2, 2, 64, 0, 0, 5, 128),         # empty cache: every slot masked
    # nemotron-4-340b's head_dim 192 with its G = 12, and G past 16
    (1, 256, 2, 12, 192, 0, 256, 255, 128),   # full cache
    (1, 512, 1, 12, 192, 300, 512, 700, 128),  # ring buffer, window
    (1, 256, 1, 12, 192, 0, 100, 99, 128),    # kpos -1 tail
    (1, 256, 2, 20, 64, 0, 256, 255, 128),    # G = 20: two row groups
    (1, 256, 1, 33, 192, 0, 200, 199, 128),   # G = 33: three, the last of 1
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _normal(rng, shape, dtype):
    """The same normal draws as a JAX and a torch array of ``dtype``
    (bf16 rounds to nearest even in both)."""
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a).astype(JDT[dtype]), torch.from_numpy(a).to(
        TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _kpos(C, filled, pos, window):
    """tests/test_kernels.py's kpos: the ring's absolute positions once
    wrapped, else 0..filled-1 and -1 for the empty tail."""
    if window and pos >= C:
        base = pos - C + 1
        return ((np.arange(C) - base % C) % C + base).astype(np.int32)
    return np.where(np.arange(C) < filled, np.arange(C), -1).astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_matches_pallas_kernel_and_oracle(case, dtype):
    B, Sq, Sk, H, KV, hd, causal, window, bq, bk = case
    rng = np.random.default_rng(Sq + 7 * H + hd)
    jq, q = _normal(rng, (B, Sq, H, hd), dtype)
    jk, k = _normal(rng, (B, Sk, KV, hd), dtype)
    jv, v = _normal(rng, (B, Sk, KV, hd), dtype)
    kw = dict(causal=causal, window=window)
    want = jflash(jq, jk, jv, block_q=bq, block_k=bk, interpret=True, **kw)
    oracle = jref.attention_ref(jq, jk, jv, **kw)
    before = flash_attention.launches
    got = ops.attention(q, k, v, **kw)   # the CPU route
    assert flash_attention.launches == before
    assert got.shape == (B, Sq, H, hd) and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])
    plain = ref.attention_ref(q, k, v, **kw)
    _close(plain, oracle, TOL[dtype])
    if Sq > Sk and window:
        # the rows with no valid key: the mean of v over all Sk keys
        rows = slice(Sk + window - 1, Sq)
        mean = v.float().mean(1).repeat_interleave(H // KV, dim=1)
        _close(got[:, rows], np.broadcast_to(
            mean[:, None].numpy(), got[:, rows].shape), TOL[dtype])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_attention_matches_pallas_kernel_and_oracle(case, dtype):
    B, C, J, G, hd, window, filled, pos, bk = case
    rng = np.random.default_rng(C + 3 * G + hd)
    jq, q = _normal(rng, (B, 1, J, G, hd), dtype)
    jk, k = _normal(rng, (B, C, J, hd), dtype)
    jv, v = _normal(rng, (B, C, J, hd), dtype)
    kp = _kpos(C, filled, pos, window)
    jkpos, kpos = jnp.asarray(kp), torch.from_numpy(kp)
    want = jdecode(jq, jk, jv, jkpos, jnp.int32(pos), window=window,
                   block_k=bk, interpret=True)
    oracle = jref.decode_attention_ref(jq, jk, jv, jkpos, jnp.int32(pos),
                                       window=window)
    before = decode_attention.launches
    got = ops.decode_attention(q, k, v, kpos, pos, window=window)
    assert decode_attention.launches == before
    assert got.shape == (B, 1, J * G, hd) and got.dtype == TDT[dtype]
    _close(got, want, TOL[dtype])
    plain = ref.decode_attention_ref(q, k, v, kpos, pos, window=window)
    _close(plain, oracle, TOL[dtype])
    if not filled:
        mean = v.float().mean(1).repeat_interleave(G, dim=1)
        _close(got[:, 0], mean.numpy(), TOL[dtype])
    # the model's plain decode route computes the same
    cache = {"k": k, "v": v, "kpos": kpos}
    _close(attention.decode_attend(q, cache, pos, window=window),
           jattn.decode_attend(jq, {"k": jk, "v": jv, "kpos": jkpos},
                               jnp.int32(pos), window=window), TOL[dtype])


def test_wrappers_refuse_what_the_jax_kernels_assert_on():
    """Prompts that are not a multiple of 128 (and > 128), caches that are
    not a multiple of 256 (and > 256): the JAX kernels assert, and the
    port's wrappers raise on either device.  A fleet can only be served
    through the kernels at prompt and cache lengths both packages take."""
    rng = np.random.default_rng(0)
    for Sq, Sk in ((200, 128), (128, 200)):
        jq, q = _normal(rng, (1, Sq, 2, 64), "f32")
        jk, k = _normal(rng, (1, Sk, 2, 64), "f32")
        with pytest.raises(AssertionError):
            jflash(jq, jk, jk, interpret=True)
        with pytest.raises(ValueError, match="does not tile"):
            flash_attention(q, k, k)
    for C in (272, 400):
        jq, q = _normal(rng, (1, 1, 2, 1, 64), "f32")
        jk, k = _normal(rng, (1, C, 2, 64), "f32")
        kpos = torch.arange(C, dtype=torch.int32)
        with pytest.raises(AssertionError):
            jdecode(jq, jk, jk, jnp.asarray(kpos.numpy()), jnp.int32(C - 1),
                    interpret=True)
        with pytest.raises(ValueError, match="does not tile"):
            decode_attention(q, k, k, kpos, C - 1)
    q = torch.zeros(1, 128, 3, 64)
    with pytest.raises(ValueError, match="KV divide H"):
        flash_attention(q, torch.zeros(1, 128, 2, 64), torch.zeros(1, 128, 2,
                                                                    64))
    with pytest.raises(ValueError, match=r"kpos"):
        decode_attention(torch.zeros(1, 1, 2, 1, 64), torch.zeros(1, 8, 2, 64),
                         torch.zeros(1, 8, 2, 64),
                         torch.zeros(9, dtype=torch.int32), 0)


@pytest.mark.parametrize("S,window", [(5, 0), (12, 12), (24, 8), (23, 7)])
def test_cache_prefill_and_insert_match_reference(S, window):
    """One cache_prefill of a prompt, then single-token inserts past the
    ring's end: every leaf bit-equal to the reference's at each step, and
    the port writes into the cache it was given."""
    KV, hd, extra = 2, 4, 5
    cfg = types.SimpleNamespace(window=window, num_kv_heads=KV, head_dim=hd)
    rng = np.random.default_rng(S)
    k = rng.standard_normal((1, S + extra, KV, hd)).astype(np.float32)
    v = rng.standard_normal((1, S + extra, KV, hd)).astype(np.float32)
    jc = jattn.cache_prefill(jattn.init_cache(cfg, 1, S + extra, jnp.float32),
                             jnp.asarray(k[:, :S]), jnp.asarray(v[:, :S]),
                             jnp.arange(S))
    c = attention.init_cache(cfg, 1, S + extra, torch.float32)
    assert attention.cache_prefill(c, torch.from_numpy(k[:, :S]),
                                   torch.from_numpy(v[:, :S]),
                                   torch.arange(S)) is c

    def same():
        for name in ("k", "v", "kpos"):
            assert c[name].dtype == {"kpos": torch.int32}.get(
                name, torch.float32)
            np.testing.assert_array_equal(c[name].numpy(),
                                          np.asarray(jc[name]), err_msg=name)
    same()
    for pos in range(S, S + extra):
        one = slice(pos, pos + 1)
        jc = jattn.cache_insert(jc, jnp.asarray(k[:, one]),
                                jnp.asarray(v[:, one]), jnp.int32(pos))
        attention.cache_insert(c, torch.from_numpy(k[:, one]),
                               torch.from_numpy(v[:, one]), pos)
        same()


def _pair(use_pallas, kv_heads=None, dtype="f32"):
    """A reduced qwen1.5 in both packages (G = 1, or G = 4 / kv_heads),
    the JAX init carried across."""
    over = dict(use_pallas=use_pallas)
    if kv_heads:
        over["num_kv_heads"] = kv_heads
    jcfg = dataclasses.replace(jconfigs.get("qwen1.5-0.5b").reduced(), **over)
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), JDT[dtype])
    return jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


@pytest.fixture(scope="module",
                params=[(True, None), (False, None), (True, 2), (False, 2)],
                ids=["use_pallas-G1", "jnp-G1", "use_pallas-G2", "jnp-G2"])
def served(request):
    """Prefill a prompt, then decode two tokens (positions 16 and 17), in
    both packages."""
    use_pallas, kv = request.param
    jmodel, jparams, model, params = _pair(use_pallas, kv)
    tokens = np.random.default_rng(0).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    jcache = jmodel.init_cache(2, PROMPT + 4, jnp.float32)
    cache = model.init_cache(2, PROMPT + 4, torch.float32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcache)
    log, cache = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               cache)
    out = dict(jlog=[jlog], log=[log],
               jcache=[params_from_jax(jax.device_get(jcache))],
               cache=[tree.map(torch.clone, cache)])
    for pos in (PROMPT, PROMPT + 1):
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
    out.update(tokens=tokens, jmodel=jmodel, jparams=jparams, model=model,
               params=params, use_pallas=use_pallas)
    return out


def test_prefill_and_decode_logits_match(served):
    """The prefill's last logits and two decode steps' (the second reads a
    token whose rope angle is position 17)."""
    for step, (got, want) in enumerate(zip(served["log"], served["jlog"])):
        assert got.shape == (2, 1, 512), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")


def test_caches_match(served):
    for step, (got, want) in enumerate(zip(served["cache"],
                                           served["jcache"])):
        want = dict(tree.items(want))
        assert list(dict(tree.items(got))) == list(want)
        for path, leaf in tree.items(got):
            w = want[path]
            assert leaf.shape == w.shape and leaf.dtype == w.dtype, path
            np.testing.assert_allclose(leaf.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=f"{step} {path}")


def test_train_loss_matches_and_the_kernel_route_has_no_backward(served):
    tokens = served["tokens"]
    want = float(served["jmodel"].train_loss(
        served["jparams"], {"tokens": jnp.asarray(tokens)}))
    params = tree.map(lambda t: t.clone().requires_grad_(), served["params"])
    batch = {"tokens": torch.from_numpy(tokens).long()}
    loss = served["model"].train_loss(params, batch)
    np.testing.assert_allclose(loss.item(), want, rtol=1e-4)
    if served["use_pallas"]:
        with pytest.raises(NotImplementedError, match="no backward"):
            loss.backward()
    else:
        loss.backward()
        assert params["embed"]["embedding"].grad is not None


def test_bf16_logits_hold_to_the_reference():
    """The same prompt and two decode steps in bf16 with use_pallas on.
    Both packages round every activation to bf16, in other places (and the
    Pallas kernel rounds the unnormalised p): logits of magnitude up to ~4.5
    differ by up to 3 bf16 ulps (2^-6 each between 2 and 4), measured
    0.0469 at most over prompt seeds 0-3; atol 0.1 holds that with room.
    The greedy tokens agree."""
    jmodel, jparams, model, params = _pair(True, dtype="bf16")
    tokens = np.random.default_rng(1).integers(0, 512, (1, PROMPT))
    jcache = jmodel.init_cache(1, PROMPT + 4, jnp.bfloat16)
    cache = model.init_cache(1, PROMPT + 4, torch.bfloat16)
    jlog, jcache = jmodel.prefill(
        jparams, {"tokens": jnp.asarray(tokens, jnp.int32)}, jcache)
    log, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens).long()}, cache)
    logs, jlogs = [log], [jlog]
    for pos in (PROMPT, PROMPT + 1):
        tok = np.asarray(jnp.argmax(jlogs[-1], -1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(tok).long(),
                                       cache, pos)
        logs.append(log)
        jlogs.append(jlog)
    for got, want in zip(logs, jlogs):
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=0.1)
        assert int(got.float().argmax()) == int(jnp.argmax(want))


@pytest.mark.parametrize("prompt_len,max_new", [(16, 4), (128, 128)])
def test_serve_fleet_matches_reference(prompt_len, max_new):
    """A 2-member fleet served through the kernels' routes (the JAX kernels
    in interpret mode): every request decodes the same tokens on the same
    node."""
    jcfg = dataclasses.replace(jconfigs.get("qwen1.5-0.5b").reduced(),
                               use_pallas=True)
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(),
                              use_pallas=True)
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    spec = dict(requests=3, batch=2, prompt_len=prompt_len, max_new=max_new,
                fleet=2, dtype="f32", routing="round-robin")
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), params_from_jax(jax.device_get(jfleet)),
                      exp.ServeSpec(**spec))
    assert len(got.completed) == 3
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == max_new
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}
