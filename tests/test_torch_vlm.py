"""The VLM backbone on its stub frontend against the JAX package:
internvl2-1b (``frontend="vision"``, 256 patch embeddings before the text).
The config is a verbatim copy; the token stream carries the reference's
fields (``prefix_embeds`` (n, R, b, P, D) at 0.02 times a standard normal,
the tokens cut to ``seq − P``), drawn by the port's own generators; reduced
(8 patches, d_model 256), the prefill's logits and the text-only train loss
hold to the reference's, 2 MC-DSGT steps from the reference's stream hold
at rtol 1e-4 / atol 1e-5, the train CLI trains it, and serving refuses it
as the reference's engine does.  whisper-tiny is registered and, since
ROADMAP.md Queue 1 item 9 part 6, built (tests/test_torch_encdec.py)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.dist import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.data import token_stream_for  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
ARCH = "internvl2-1b"
# The arch trainer's step tolerance (slices 1-3); the reference's own
# tolerance between its model paths for logits.
RTOL, ATOL = 1e-4, 1e-5
LOGIT_ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,mod", [("internvl2-1b", "internvl2_1b"),
                                      ("whisper-tiny", "whisper_tiny")])
def test_config_is_a_verbatim_copy_and_registered(arch, mod):
    assert (SRC / f"repro_torch/configs/{mod}.py").read_text() == \
        (SRC / f"repro/configs/{mod}.py").read_text()
    assert dataclasses.asdict(configs.get(arch)) == \
        dataclasses.asdict(jconfigs.get(arch))
    assert arch in configs.names()


def test_encoder_decoder_is_refused_with_its_item():
    """whisper-tiny, refused until ROADMAP.md Queue 1 item 9 part 6 ported
    it, builds and its stream gives frames (tests/test_torch_encdec.py
    holds both to the reference)."""
    cfg = configs.get("whisper-tiny").reduced()
    assert build(cfg).cfg is cfg
    assert token_stream_for(cfg, 2, 1, 2, 16).batch_at(0)["frames"].shape \
        == (2, 1, 2, cfg.encoder_seq, cfg.d_model)


@pytest.mark.parametrize("preset", ["full", "reduced"])
def test_param_shapes_are_the_references_leaves(preset):
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    if preset == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0),
                                                      jnp.float32))
    want = [(tuple(k.key for k in p), tuple(leaf.shape)) for p, leaf
            in jax.tree_util.tree_leaves_with_path(shapes)]
    got = list(tree.items(build(cfg).shapes))
    assert got == want
    if preset == "full":
        assert sum(int(np.prod(s)) for _, s in got) == 493_753_344


def test_token_stream_modalities():
    """The twin of the reference's ``test_token_stream_modalities``
    (tests/test_substrate.py): the vlm stream's prefix_embeds and its
    shortened tokens, with the reference's shapes; the embeddings are the
    same on every call for a step, differ between steps, and are 0.02
    times a standard normal."""
    cfg = configs.get(ARCH).reduced()
    s = token_stream_for(cfg, 2, 1, 2, 24)
    b = s.batch_at(0)
    want = jtoken_stream_for(jconfigs.get(ARCH).reduced(), 2, 1, 2,
                             24).batch_at(0)
    assert b["prefix_embeds"].shape == (2, 1, 2, cfg.frontend_tokens,
                                        cfg.d_model)
    assert b["tokens"].shape == (2, 1, 2, 24 - cfg.frontend_tokens)
    for key in ("tokens", "prefix_embeds"):
        assert tuple(b[key].shape) == tuple(want[key].shape), key
    assert b["prefix_embeds"].dtype == torch.float32
    assert torch.equal(b["prefix_embeds"], s.batch_at(0)["prefix_embeds"])
    assert not torch.equal(b["prefix_embeds"],
                           s.batch_at(1)["prefix_embeds"])
    big = token_stream_for(cfg, 4, 2, 4, 24).batch_at(3)["prefix_embeds"]
    assert abs(float(big.mean())) < 1e-3
    assert abs(float(big.std()) - 0.02) < 5e-4


def _pair():
    jcfg, cfg = jconfigs.get(ARCH).reduced(), configs.get(ARCH).reduced()
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    return jcfg, jmodel, jparams, build(cfg), params_from_jax(
        jax.device_get(jparams))


def test_prefill_and_train_loss_match_reference():
    """The prefill of 8 patch embeddings and 8 tokens: the last logits at
    atol 2e-4; the train loss (text positions only) at rtol 1e-4."""
    jcfg, jmodel, jparams, model, params = _pair()
    b = jtoken_stream_for(jcfg, 1, 1, 2, 16).batch_at(0)
    jbatch = {k: v[0, 0] for k, v in b.items()}
    batch = {"tokens": torch.from_numpy(np.array(jbatch["tokens"])).long(),
             "prefix_embeds": torch.from_numpy(
                 np.array(jbatch["prefix_embeds"]))}
    jlog, _ = jmodel.prefill(jparams, jbatch,
                             jmodel.init_cache(2, 16, jnp.float32))
    log, _ = model.prefill(params, batch,
                           model.init_cache(2, 16, torch.float32))
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    want = float(jmodel.train_loss(jparams, jbatch))
    got = model.train_loss(params, batch).item()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # the patches change the text's loss: they are attended to
    plain = model.train_loss(params, dict(
        batch, prefix_embeds=torch.zeros_like(batch["prefix_embeds"])))
    assert plain.item() != got


def _torch_batch(jbatch) -> dict:
    return {"tokens": torch.from_numpy(np.array(jbatch["tokens"])).long(),
            "prefix_embeds": torch.from_numpy(
                np.array(jbatch["prefix_embeds"]))}


def test_mc_dsgt_steps_match_reference():
    """Warm start + 2 MC-DSGT (R = 2) steps of the reduced internvl2-1b
    through both packages' ``make_train_step`` on a ring of 4 from the same
    parameters, on the reference's stream (8 patches + 8 tokens a
    sequence): losses at RTOL, every leaf of x, h and g⁻ at RTOL/ATOL."""
    from repro_torch.exp import registry, spec as tspec
    n, R, B, S = 4, 2, 1, 16
    sched = registry.build_topology(tspec.TopologySpec(kind="ring"), n,
                                    horizon=64, seed=0)
    jcfg = jconfigs.get(ARCH).reduced()
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo="mc_dsgt", gamma=0.1, R=R,
        gossip_impl="dense")
    jstep = jax.jit(jstep)
    model = build(configs.get(ARCH).reduced())
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="dense")
    js = jinit(jax.random.key(0), n, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda leaf: leaf[0], js.x))), n)
    stream = jtoken_stream_for(jcfg, n, R, B, S, seed=1)
    js = jwarm(js, stream.batch_at(0))
    ts = warm(ts, _torch_batch(stream.batch_at(0)))
    wps = 2 * R
    for k in (1, 2):
        W = np.asarray(sched.stacked((k - 1) * wps, wps), np.float32)
        js, jout = jstep(js, stream.batch_at(k), jnp.asarray(W))
        ts, tout = step(ts, _torch_batch(stream.batch_at(k)),
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
    layout = steps.flat_layout(model)
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


def test_train_cli_trains_the_vlm():
    """``launch.train --arch internvl2-1b`` (reduced, ``--seq 24``: 8
    patches and 16 tokens) through the fused gossip's plain version."""
    history = train.main(["--arch", ARCH, "--preset", "reduced", "--nodes",
                          "4", "--algo", "mc_dsgt", "--R", "2", "--steps",
                          "2", "--batch", "1", "--seq", "24",
                          "--gossip-impl", "pallas", "--device", "cpu",
                          "--quiet"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


def test_serve_fleet_refuses_the_vlm_as_the_reference_does():
    jcfg, jmodel, jparams, model, params = _pair()
    spec = dict(requests=1, batch=1, prompt_len=4, max_new=2, fleet=1)
    jfleet = jax.tree.map(lambda t: t[None], jparams)
    with pytest.raises(ValueError, match="token-only archs"):
        jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    with pytest.raises(ValueError, match="token-only archs"):
        serve_fleet(model, tree.map(lambda t: t[None], params),
                    exp.ServeSpec(**spec))
