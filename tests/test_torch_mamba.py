"""The port's mamba family against the JAX package's: the recurrence's
routing (``chunked_linear_scan`` through the kernel and through the chunked
scan), the causal conv, and a reduced falcon-mamba (2 layers, d_model 256,
d_inner 512, N 16, vocab 512) in f32 with ``use_pallas`` on (the JAX kernel
in interpret mode) and off: prefill and decode logits, the serve caches and
the training loss, with the parameters carried across by
``params_from_jax``."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import build as jbuild, ssm as jssm  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.kernels import linear_recurrence  # noqa: E402
from repro_torch.models import build, params_from_jax, ssm  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
# Logits: the reference's own tolerance between its kernel and jnp paths
# (tests/test_kernels.py); caches and the recurrence: a few f32 ulps of sums
# taken in other orders.
LOGIT_ATOL = 2e-4
TOL = 1e-5
PROMPT = 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_config_is_a_verbatim_copy():
    assert (SRC / "repro_torch/configs/falcon_mamba_7b.py").read_text() == \
        (SRC / "repro/configs/falcon_mamba_7b.py").read_text()
    full = configs.get("falcon-mamba-7b")
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jconfigs.get("falcon-mamba-7b"))
    assert (full.d_inner, full.dt_rank, full.ssm_state) == (8192, 256, 16)


@pytest.mark.parametrize("use_pallas,S", [(True, 20), (True, 256),
                                          (True, 1), (False, 20),
                                          (False, 64), (False, 1)])
def test_chunked_linear_scan_matches_reference(use_pallas, S):
    """Both routes with a nonzero h0 (folded into b_0 on the kernel route),
    chunk 8 so the scan pads (S = 20) and carries across chunks."""
    rng = np.random.default_rng(S)
    B, di, N = 2, 32, 16
    a = rng.uniform(0.0, 1.0, (B, S, di, N)).astype(np.float32)
    b = rng.standard_normal((B, S, di, N)).astype(np.float32)
    h0 = rng.standard_normal((B, di, N)).astype(np.float32)
    want_all, want_last = jssm.chunked_linear_scan(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0), chunk=8,
        use_pallas=use_pallas)
    got_all, got_last = ssm.chunked_linear_scan(
        torch.from_numpy(a), torch.from_numpy(b.copy()), torch.from_numpy(h0),
        chunk=8, use_pallas=use_pallas)
    assert got_all.shape == (B, S, di, N) and got_last.shape == (B, di, N)
    np.testing.assert_allclose(got_all.numpy(), np.asarray(want_all),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               rtol=TOL, atol=TOL)


def test_kernel_route_folds_h0_into_the_callers_f32_b():
    a = torch.rand(1, 4, 512)
    b = torch.randn(1, 4, 512)
    h0 = torch.randn(1, 512)
    b0 = b[:, 0].clone()
    ssm.chunked_linear_scan(a, b, h0, use_pallas=True)
    torch.testing.assert_close(b[:, 0], b0 + a[:, 0] * h0, rtol=0, atol=0)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_matches_reference(with_state):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal((24,)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jy, jst = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 jnp.asarray(st) if with_state else None)
    y, new = ssm.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               torch.from_numpy(st) if with_state else None)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jst))


def _pair(use_pallas):
    jcfg = dataclasses.replace(jconfigs.get("falcon-mamba-7b").reduced(),
                               use_pallas=use_pallas)
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b").reduced(),
                              use_pallas=use_pallas)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


@pytest.fixture(scope="module", params=[True, False],
                ids=["use_pallas", "jnp"])
def served(request):
    """Prefill a prompt and decode one token in both packages."""
    jmodel, jparams, model, params = _pair(request.param)
    tokens = np.random.default_rng(0).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jmodel.init_cache(2, PROMPT + 4,
                                                    jnp.float32))
    before = linear_recurrence.linear_recurrence.launches
    log, cache = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               model.init_cache(2, PROMPT + 4, torch.float32))
    jcache_t = params_from_jax(jax.device_get(jcache))
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    jdec, jcache2 = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                       jnp.int32(PROMPT))
    cache_copy = tree.map(torch.clone, cache)
    dec, cache2 = model.decode_step(params, torch.from_numpy(tok).long(),
                                    cache_copy, PROMPT)
    assert linear_recurrence.linear_recurrence.launches == before  # CPU
    return dict(jlog=jlog, log=log, jcache=jcache_t, cache=cache, jdec=jdec,
                dec=dec, jcache2=params_from_jax(jax.device_get(jcache2)),
                cache2=cache2, cache_copy=cache_copy, tokens=tokens,
                jmodel=jmodel, jparams=jparams, model=model, params=params)


def test_prefill_logits_match(served):
    assert served["log"].shape == (2, 1, 512)
    np.testing.assert_allclose(served["log"].numpy(),
                               np.asarray(served["jlog"]), atol=LOGIT_ATOL)


def test_prefill_cache_matches(served):
    want = dict(tree.items(served["jcache"]))
    got = dict(tree.items(served["cache"]))
    assert list(got) == list(want)
    for path, leaf in got.items():
        assert leaf.shape == want[path].shape and leaf.dtype == \
            want[path].dtype, path
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=str(path))


def test_decode_logits_and_cache_match(served):
    np.testing.assert_allclose(served["dec"].numpy(),
                               np.asarray(served["jdec"]), atol=LOGIT_ATOL)
    want = dict(tree.items(served["jcache2"]))
    for path, leaf in tree.items(served["cache2"]):
        np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=str(path))
    # the cache is updated in place and returned
    assert served["cache2"] is served["cache_copy"]


def test_train_loss_matches(served):
    tokens = served["tokens"]
    want = float(served["jmodel"].train_loss(
        served["jparams"], {"tokens": jnp.asarray(tokens)}))
    got = served["model"].train_loss(
        served["params"], {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(got.item(), want, rtol=2e-4)


def test_parameter_tree_matches_reference():
    cfg = configs.get("falcon-mamba-7b").reduced()
    jparams = jax.eval_shape(lambda: jbuild(
        jconfigs.get("falcon-mamba-7b").reduced()).init(jax.random.key(0),
                                                        jnp.bfloat16))
    want = {tuple(k.key for k in path): (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.bfloat16)
    got = {path: (tuple(t.shape), str(t.dtype).split(".")[1])
           for path, t in tree.items(params)}
    assert got == want        # A_log stays f32 in a bf16 model
    assert dict(tree.items(model.shapes)) == {k: v[0] for k, v in want.items()}


def test_init_fills_a_fleets_views_in_place():
    model = build(configs.get("falcon-mamba-7b").reduced())
    fleet = model.empty(torch.float32, "cpu", lead=(2,))
    for i in range(2):
        out = tree.map(lambda t: t[i], fleet)
        got = model.init(torch.Generator().manual_seed(i), torch.float32,
                         "cpu", out=out)
        assert got is out
        solo = model.init(torch.Generator().manual_seed(i), torch.float32)
        for path, leaf in tree.items(solo):
            assert torch.equal(dict(tree.items(fleet))[path][i], leaf), path


def test_attention_layers_do_not_serve_yet():
    """The dense decoder serves (tests/test_torch_attention.py), with a
    sliding window too (tests/test_torch_hybrid.py), and with a logit
    softcap, use_pallas on or off (tests/test_torch_softcap.py: the kernel
    routes drop the cap, as the reference's do)."""
    cfg = configs.get("qwen1.5-0.5b").reduced(layers=1, d_model=32, d_ff=64,
                                              vocab=64)
    build(cfg).init_cache(1, 8, torch.float32)
    for use_pallas in (False, True):
        windowed = build(dataclasses.replace(cfg, use_pallas=use_pallas,
                                             window=4))
        assert windowed.init_cache(1, 8, torch.float32)["units"]["0_attn"][
            "k"].shape[2] == 4
        capped = build(dataclasses.replace(cfg, use_pallas=use_pallas,
                                           logit_softcap=30.0))
        assert capped.init_cache(1, 8, torch.float32)["units"]["0_attn"][
            "k"].shape[2] == 8


def test_mamba_training_is_not_ported():
    """Training mamba through the kernels is not ported in either package
    (no kernel has a backward); with use_pallas off, as the arch trainer
    runs it, the spec builds (its steps are held to the reference's in
    tests/test_torch_arch_train.py), and so does the encoder-decoder's
    (tests/test_torch_encdec.py)."""
    spec = exp.with_overrides(exp.ExperimentSpec(),
                              {"model.arch": "falcon-mamba-7b",
                               "model.preset": "reduced"})
    built = exp.build(spec, device="cpu")
    assert built.cfg.pattern == ("mamba",) and not built.cfg.use_pallas
    built = exp.build(exp.with_overrides(spec, {"model.arch": "whisper-tiny"}),
                      device="cpu")
    assert built.cfg.arch_type == "audio"
