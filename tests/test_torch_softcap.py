"""The attention logit softcap (``cfg.logit_softcap``: scores become
cap·tanh(s/cap) after the 1/√hd scale and before the mask) against the JAX
package: ``attend_full`` (causal, windowed and cross), the block-local
sliding attention and ``decode_attend``, then a reduced qwen1.5-0.5b and a
reduced recurrentgemma-2b (window 4 < the 12-token prompt) in train,
prefill and decode.  A cap of 0.5 against scores of order 1 bends nearly
every score, so each check also shows the cap changed the result.  With
``use_pallas`` the kernel routes drop the cap in both packages (neither
attention kernel takes one; ROADMAP.md Queue 3).  Inputs come from a numpy
seed, weights from the port's seeded init, handed to both packages."""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn, build as jbuild  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.models import attention, build  # noqa: E402

CAP = 0.5
# f32 attention in two libraries (a few ulps of sums taken in other
# orders); logits: the reference's own tolerance between its model paths;
# the train loss: the trainer's step tolerance.
RTOL, ATOL = 1e-5, 1e-6
LOGIT_ATOL = 2e-4
LOSS_RTOL = 1e-4
PROMPT, DECODES = 12, 3
# The reference's model functions compile at XLA's lowest backend
# optimization level: its CPU compile, not the arithmetic, is most of these
# tests' time.
FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jit(fn):
    """``jax.jit(fn)`` compiled at FAST on its first call (later calls must
    pass the same shapes)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options=FAST))
        return compiled[0](*args)
    return call


def _qkv(B=2, Sq=12, Sk=12, J=2, G=2, hd=16, seed=0):
    """q (B, Sq, J, G, hd) and k, v (B, Sk, J, hd), scaled so the scores
    are of order 1 after 1/√hd."""
    rng = np.random.default_rng(seed)
    q = (2 * rng.standard_normal((B, Sq, J, G, hd))).astype(np.float32)
    k = (2 * rng.standard_normal((B, Sk, J, hd))).astype(np.float32)
    v = rng.standard_normal((B, Sk, J, hd)).astype(np.float32)
    return q, k, v


def _both(fn_j, fn_t, arrays, **kw):
    """(reference, port) outputs of one attention function on the same
    numpy inputs, the port's as numpy."""
    want = np.asarray(_jit(functools.partial(fn_j, **kw))(
        *(jnp.asarray(a) for a in arrays)))
    got = fn_t(*(torch.from_numpy(np.array(a)) for a in arrays), **kw)
    return want, got.numpy()


@pytest.mark.parametrize("causal,window,Sk,q_chunk", [
    (True, 0, 12, 1024), (True, 5, 12, 4), (False, 0, 20, 5)])
def test_attend_full_with_softcap_matches_reference(causal, window, Sk,
                                                    q_chunk):
    q, k, v = _qkv(Sk=Sk)
    pos = (np.arange(12), np.arange(Sk))
    kw = dict(causal=causal, window=window, q_chunk=q_chunk)
    want, got = _both(jattn.attend_full, attention.attend_full,
                      (q, k, v) + pos, softcap=CAP, **kw)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain, _ = _both(jattn.attend_full, attention.attend_full,
                     (q, k, v) + pos, softcap=0.0, **kw)
    assert np.abs(plain - want).max() > 1e-2


def test_attend_sliding_block_with_softcap_matches_reference():
    q, k, v = _qkv(Sq=13, Sk=13)
    want, got = _both(jattn.attend_sliding_block,
                      attention.attend_sliding_block,
                      (q, k, v, np.arange(13)), window=4, softcap=CAP)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain, _ = _both(jattn.attend_sliding_block,
                     attention.attend_sliding_block,
                     (q, k, v, np.arange(13)), window=4)
    assert np.abs(plain - want).max() > 1e-2


@pytest.mark.parametrize("window", [0, 6])
def test_decode_attend_with_softcap_matches_reference(window):
    """One query against a ring of 8 slots holding positions 3..10 (slot
    pos % 8), at position 10."""
    q, k, v = _qkv(Sq=1, Sk=8)
    kpos = np.array([8, 9, 10, 3, 4, 5, 6, 7], np.int32)

    def jfn(q, k, v, kpos, **kw):
        return jattn.decode_attend(q, {"k": k, "v": v, "kpos": kpos},
                                   jnp.int32(10), **kw)

    def tfn(q, k, v, kpos, **kw):
        return attention.decode_attend(q, {"k": k, "v": v, "kpos": kpos},
                                       10, **kw)
    want, got = _both(jfn, tfn, (q, k, v, kpos), window=window, softcap=CAP)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    plain, _ = _both(jfn, tfn, (q, k, v, kpos), window=window)
    assert np.abs(plain - want).max() > 1e-2


def _cfgs(arch, **over):
    if arch == "qwen1.5-0.5b":
        small = dict(layers=2, d_model=64, d_ff=128, vocab=128)
    else:   # 1 unit of (rglru, rglru, attn), MQA, a window of 4
        small = dict(layers=3, d_model=64, d_ff=128, vocab=128)
        over = dict(dict(num_kv_heads=1, window=4), **over)
    jcfg = dataclasses.replace(jconfigs.get(arch).reduced(**small), **over)
    cfg = dataclasses.replace(configs.get(arch).reduced(**small), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    return jcfg, cfg


def _weights(jcfg, cfg):
    """(reference model, its params, the port's): the port's init from a
    seeded generator, the same values handed to the reference (whose own
    init costs seconds of eager compiles)."""
    params = build(cfg).init(torch.Generator().manual_seed(0))
    return jbuild(jcfg), tree.map(lambda t: jnp.asarray(t.numpy()),
                                  params), params


def _run(jmodel, jparams, model, params, tokens):
    """Both packages' train loss, prefill of the first PROMPT tokens and
    DECODES decode steps: [(name, reference, port)] as numpy."""
    jloss, jprefill, jdecode = (_jit(jmodel.train_loss),
                                _jit(jmodel.prefill),
                                _jit(jmodel.decode_step))
    out = [("train loss",
            np.asarray(jloss(jparams, {"tokens": jnp.asarray(tokens)})),
            model.train_loss(params, {"tokens": torch.from_numpy(
                tokens.astype(np.int64))}).detach().numpy())]
    B = tokens.shape[0]
    C = PROMPT + DECODES
    jcache = jmodel.init_cache(B, C, jnp.float32)
    cache = model.init_cache(B, C, torch.float32)
    jlog, jcache = jprefill(
        jparams, {"tokens": jnp.asarray(tokens[:, :PROMPT])}, jcache)
    log, cache = model.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :PROMPT].astype(np.int64))}, cache)
    out.append(("prefill", np.asarray(jlog), log.numpy()))
    for t in range(PROMPT, C):
        tok = tokens[:, t:t + 1]
        jlog, jcache = jdecode(jparams, jnp.asarray(tok), jcache,
                               jnp.int32(t))
        log, cache = model.decode_step(
            params, torch.from_numpy(tok.astype(np.int64)), cache, t)
        out.append((f"decode {t}", np.asarray(jlog), log.numpy()))
    return out


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b"])
def test_models_with_softcap_match_reference(arch):
    """Train loss at LOSS_RTOL, prefill and decode logits at LOGIT_ATOL;
    the capped model's logits differ from the uncapped one's."""
    jcfg, cfg = _cfgs(arch, logit_softcap=CAP)
    jmodel, jparams, params = _weights(jcfg, cfg)
    tokens = np.random.default_rng(1).integers(
        0, 128, (2, PROMPT + DECODES)).astype(np.int32)
    capped = _run(jmodel, jparams, build(cfg), params, tokens)
    for name, want, got in capped:
        if name == "train loss":
            np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        else:
            np.testing.assert_allclose(got, want, atol=LOGIT_ATOL,
                                       err_msg=name)
    plain = build(dataclasses.replace(cfg, logit_softcap=0.0))
    log, _ = plain.prefill(params, {"tokens": torch.from_numpy(
        tokens[:, :PROMPT].astype(np.int64))},
        plain.init_cache(2, PROMPT + DECODES, torch.float32))
    assert np.abs(log.numpy() - capped[1][2]).max() > 1e-3


def test_use_pallas_drops_the_softcap_in_both_packages():
    """With ``use_pallas`` the prefill (flash) and decode (decode
    attention) routes take no cap: in each package the capped model's
    logits equal the uncapped one's exactly, and the two packages agree at
    LOGIT_ATOL (the reference's kernels in interpret mode, the port's plain
    versions on the CPU)."""
    jcfg, cfg = _cfgs("qwen1.5-0.5b", use_pallas=True, logit_softcap=CAP)
    jmodel, jparams, params = _weights(jcfg, cfg)
    tokens = np.random.default_rng(2).integers(
        0, 128, (1, PROMPT + DECODES)).astype(np.int32)
    # the reference's flash kernel tiles the prompt whole (S <= 128)
    capped = _run(jmodel, jparams, build(cfg), params, tokens)[1:]
    jplain_cfg = dataclasses.replace(jcfg, logit_softcap=0.0)
    plain = _run(jbuild(jplain_cfg), jparams,
                 build(dataclasses.replace(cfg, logit_softcap=0.0)),
                 params, tokens)[1:]
    for (name, jc, tc), (_, jp, tp) in zip(capped, plain):
        assert np.array_equal(jc, jp), name
        assert np.array_equal(tc, tp), name
        np.testing.assert_allclose(tc, jc, atol=LOGIT_ATOL, err_msg=name)
