"""The encoder-decoder (whisper-tiny's backbone, ``models/encdec.py``)
against the JAX package: the parameter tree, layernorm and the sinusoidal
table, the train loss and every gradient leaf, prefill and decode with
their caches, the encoder's chunked attention against the reference's
padded chunks, decode teacher-forced against the forward, two MC-DSGT
steps of the arch trainer, a checkpoint crossing both ways, the stream's
``frames``, and serving's refusal.  Reduced configs cut to d_model 64 (2 +
2 layers, 4 heads of 16, 32 frames, a vocabulary of 128); the reference's
parameters come across through ``params_from_jax``, and its compiled
functions are jitted once a test."""

import dataclasses

import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.dist import steps as jsteps  # noqa: E402
from repro.models import build as jbuild, encdec as jencdec  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.data import token_stream_for  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, encdec, layers  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

ARCH = "whisper-tiny"
# f32 math in two libraries: the trainer's step tolerance (slices 1-3),
# the reference's own tolerance between its model paths for logits, and
# the caches' k and v (one projection each).
RTOL, ATOL = 1e-4, 1e-5
LOGIT_ATOL = 2e-4
CACHE_TOL = 1e-5
CUT = dict(d_model=64, d_ff=128, vocab=128)
# The reference's functions compile at XLA's lowest backend optimization
# level: its CPU compile, not the arithmetic, is most of these tests' time.
FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(reference cfg, model, params; port model, params): the reduced
    whisper-tiny from the reference's init."""
    jcfg = jconfigs.get(ARCH).reduced(**CUT)
    jmodel = jbuild(jcfg)
    jparams = _jit(jmodel.init, static_argnums=(1,))(jax.random.key(0),
                                                     jnp.float32)
    model = build(configs.get(ARCH).reduced(**CUT))
    return jcfg, jmodel, jparams, model, params_from_jax(
        jax.device_get(jparams))


def _jit(fn, static_argnums=()):
    """``jax.jit(fn)`` compiled at FAST on its first call (later calls must
    pass the same shapes)."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn, static_argnums=static_argnums)
                            .lower(*args).compile(compiler_options=FAST))
        dyn = [a for i, a in enumerate(args) if i not in static_argnums]
        return compiled[0](*dyn)
    return call


def _inputs(cfg, B=2, S=12, seed=0):
    """Seeded numpy tokens (B, S) and frames (B, Se, D)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = (0.02 * rng.standard_normal(
        (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return tokens, frames


def _t(a):
    """A port tensor of its own (tokens as int64)."""
    a = np.array(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.int32
                            else a)


@pytest.mark.parametrize("preset", ["full", "reduced"])
def test_param_shapes_are_the_references_leaves(preset):
    cfg, jcfg = configs.get(ARCH), jconfigs.get(ARCH)
    if preset == "reduced":
        cfg, jcfg = cfg.reduced(), jcfg.reduced()
    shapes = jax.eval_shape(lambda: jbuild(jcfg).init(jax.random.key(0),
                                                      jnp.float32))
    want = [(tuple(k.key for k in p), tuple(leaf.shape)) for p, leaf
            in jax.tree_util.tree_leaves_with_path(shapes)]
    model = build(cfg)
    assert list(tree.items(model.shapes)) == want
    assert [tuple(t.shape) for _, t in tree.items(model.empty(
        torch.float32, "meta", (3,)))] == [(3,) + s for _, s in want]
    if preset == "full":
        assert sum(int(np.prod(s)) for _, s in want) == 36_448_128


def test_layernorm_and_sinusoidal_table_match_reference():
    """Layernorm in f32 (mean and variance, eps 1e-6) on a bf16 and an f32
    input; the sinusoidal table at whisper's width (its frequencies over
    half − 1); a decode step's row equals the table's row bit for bit."""
    rng = np.random.default_rng(0)
    x = (3 + rng.standard_normal((2, 5, 384))).astype(np.float32)
    p = {"scale": rng.standard_normal(384).astype(np.float32),
         "bias": rng.standard_normal(384).astype(np.float32)}
    want = jlayers.apply_norm(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = layers.apply_norm(tree.map(torch.from_numpy, p), _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = layers.apply_norm(tree.map(torch.from_numpy, p), xb)
    assert got.dtype == torch.bfloat16
    want = jlayers.apply_norm(
        jax.tree.map(jnp.asarray, p),
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)
    # the angle pos·f reaches ~1500 rad: an ulp of f between the two
    # libraries' exp moves row pos by up to pos·2^-24, so each row is held
    # to 4 such ulps
    table = layers.sinusoidal_positions(1500, 384)
    want = np.asarray(jlayers.sinusoidal_positions(1500, 384))
    bound = 1e-6 + np.arange(1500)[:, None] * 2.0 ** -22
    assert (np.abs(table.numpy() - want) <= bound).all()
    for pos in (0, 7, 1499):
        row = layers.sinusoidal_at(torch.full((1,), float(pos)), 384)
        assert torch.equal(row, table[pos])


def test_train_loss_and_every_gradient_match_reference(pair):
    jcfg, jmodel, jparams, model, params = pair
    tokens, frames = _inputs(jcfg)
    jloss, jgrads = _jit(jax.value_and_grad(jmodel.train_loss))(
        jparams, {"tokens": jnp.asarray(tokens),
                  "frames": jnp.asarray(frames)})
    leaves = tree.map(lambda t: t.clone().requires_grad_(), params)
    loss = model.train_loss(leaves, {"tokens": _t(tokens),
                                     "frames": _t(frames)})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = dict(tree.items(params_from_jax(jax.device_get(jgrads))))
    for path, leaf in tree.items(leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), want[path].numpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg="/".join(path))


def test_prefill_and_decode_match_reference(pair):
    """An 8-token prefill over the frames, then 4 decode steps against the
    self ring and the cross cache: logits at LOGIT_ATOL, every cache leaf
    (the reference's cache through ``params_from_jax``) at CACHE_TOL."""
    jcfg, jmodel, jparams, model, params = pair
    tokens, frames = _inputs(jcfg)
    jcache = jmodel.init_cache(2, 16, jnp.float32)
    jprefill, jdecode = _jit(jmodel.prefill), _jit(jmodel.decode_step)
    jlog, jcache = jprefill(jparams, {"tokens": jnp.asarray(
        tokens[:, :8]), "frames": jnp.asarray(frames)}, jcache)
    cache = model.init_cache(2, 16, torch.float32)
    assert [p for p, _ in tree.items(cache)] == \
        [p for p, _ in tree.items(params_from_jax(jax.device_get(jcache)))]
    log, cache = model.prefill(params, {"tokens": _t(tokens[:, :8]),
                                        "frames": _t(frames)}, cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                               atol=LOGIT_ATOL)
    for t in range(8, 12):
        jlog, jcache = jdecode(jparams, jnp.asarray(
            tokens[:, t:t + 1]), jcache, jnp.int32(t))
        log, cache = model.decode_step(params, _t(tokens[:, t:t + 1]), cache,
                                       t)
        np.testing.assert_allclose(log.numpy(), np.asarray(jlog),
                                   atol=LOGIT_ATOL, err_msg=f"decode {t}")
    want = dict(tree.items(params_from_jax(jax.device_get(jcache))))
    for path, leaf in tree.items(cache):
        if leaf.dtype == torch.int32:
            assert torch.equal(leaf, want[path]), path
        else:
            np.testing.assert_allclose(leaf.numpy(), want[path].numpy(),
                                       rtol=CACHE_TOL, atol=CACHE_TOL,
                                       err_msg="/".join(path))


def test_encoder_chunked_route_matches_references_padded_chunks(pair):
    """q_chunk 12 below the 32 frames: the port slices the queries into 12
    + 12 + 8, the reference pads the last chunk with rows at position −1;
    the encoder states agree, and the port's chunks equal its one-chunk
    route (each row's softmax is its own)."""
    jcfg, _, jparams, model, params = pair
    _, frames = _inputs(jcfg)
    chunked = dataclasses.replace(model.cfg, q_chunk=12)
    want = jencdec.encode(jparams, dataclasses.replace(jcfg, q_chunk=12),
                          jnp.asarray(frames))
    got = encdec.encode(params, chunked, _t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    whole = encdec.encode(params, model.cfg, _t(frames))
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_decode_teacher_forced_equals_forward(pair):
    """The reference's cache-consistency check (tests/test_archs_smoke.py):
    prefill 8 tokens, then decode tokens 8..15 teacher-forced; each step's
    logits equal the train-mode forward's at its position (f32, so far
    tighter than the reference's bf16-minded rtol 5e-2 / atol 5e-3)."""
    jcfg, _, _, model, params = pair
    tokens, frames = _inputs(jcfg, B=1, S=16, seed=3)
    full = encdec.forward(params, model.cfg, _t(tokens), _t(frames))
    cache = model.init_cache(1, 32, torch.float32)
    log, cache = model.prefill(params, {"tokens": _t(tokens[:, :8]),
                                        "frames": _t(frames)}, cache)
    torch.testing.assert_close(log[:, 0], full[:, 7], rtol=1e-4, atol=1e-5)
    for t in range(8, 16):
        log, cache = model.decode_step(params, _t(tokens[:, t:t + 1]), cache,
                                       t)
        torch.testing.assert_close(log[:, 0], full[:, t], rtol=1e-4,
                                   atol=1e-5)


def test_mc_dsgt_steps_match_reference(pair):
    """Warm start + 2 MC-DSGT (R = 2) steps of the reduced whisper-tiny
    through both packages' ``make_train_step`` (the port's ``pallas``, the
    plain version on the CPU, against the reference's dense mixer) on a
    ring of 4 from the same parameters, on the reference's stream carried
    in (tokens and frames): losses at RTOL, every leaf of x, h and g⁻ at
    RTOL/ATOL."""
    from repro_torch.exp import registry, spec as tspec
    n, R, B, S = 4, 2, 1, 8
    sched = registry.build_topology(tspec.TopologySpec(kind="ring"), n,
                                    horizon=64, seed=0)
    jcfg, jmodel, jparams, model, _ = pair
    jinit, jwarm, jstep = jsteps.make_train_step(
        jmodel._replace(init=lambda key, dtype=None: jparams), jcfg,
        algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="dense")
    jwarm, jstep = _jit(jwarm), _jit(jstep)
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="pallas")
    js = jinit(jax.random.key(0), n, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda leaf: leaf[0], js.x))), n)
    stream = jtoken_stream_for(jcfg, n, R, B, S, seed=1)

    def batch(k):
        return {key: _t(v) for key, v in stream.batch_at(k).items()}
    js = jwarm(js, stream.batch_at(0))
    ts = warm(ts, batch(0))
    wps = 2 * R
    for k in (1, 2):
        W = np.asarray(sched.stacked((k - 1) * wps, wps), np.float32)
        js, jout = jstep(js, stream.batch_at(k), jnp.asarray(W))
        ts, tout = step(ts, batch(k), torch.from_numpy(W))
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


def test_checkpoint_crosses_both_ways(pair, tmp_path):
    """A reference MC-DSGT TrainState of the reduced whisper-tiny (every
    leaf random) saved by the reference restores in the port bit for bit;
    the port's file of it differs from the reference's only in ``treedef``,
    and the reference restores the port's file bit for bit."""
    jcfg, jmodel, jparams, model, _ = pair
    jinit, _, _ = jsteps.make_train_step(
        jmodel._replace(init=lambda key, dtype=None: jparams), jcfg,
        algo="mc_dsgt", gamma=0.1, R=2, gossip_impl="dense")
    init, _, step = steps.make_train_step(model, None, algo="mc_dsgt",
                                          gamma=0.1, R=2,
                                          gossip_impl="dense")
    js = jinit(jax.random.key(0), 2, jnp.float32)
    rng = np.random.default_rng(7)
    js = type(js)(**{f: jax.tree.map(
        lambda leaf: jnp.asarray(rng.standard_normal(np.shape(leaf)).astype(
            np.float32)), getattr(js, f)) if f in ("x", "h", "g_prev")
        else getattr(js, f) for f in js._fields})
    jpath, path = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jsave(jpath, js, step=5)
    ts = init(model.init(torch.Generator().manual_seed(0)), 2)
    ts, k = step.load_checkpoint(jpath, ts)
    assert k == 5
    layout = steps.flat_layout(model)
    got = steps.checkpoint_leaves(ts, layout, None)
    want = jax.tree.leaves(js)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert np.array_equal(np.asarray(g), np.asarray(w)), f"leaf {i}"
    step.save_checkpoint(path, ts, 5)
    jraw = msgpack.unpackb(open(jpath, "rb").read())
    raw = msgpack.unpackb(open(path, "rb").read())
    raw[b"treedef"] = jraw[b"treedef"]
    assert raw == jraw
    jback, jk = jload(path, js)
    assert int(jk) == 5
    for a, b in zip(jax.tree.leaves(jback), want):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_token_stream_frames():
    """The stream's ``frames`` (n, R, b, encoder_seq, d_model) f32 beside
    the whole ``seq`` of tokens, the reference's shapes; the same on every
    call for a step, other at another step, 0.02 times a standard
    normal."""
    cfg = configs.get(ARCH).reduced()
    s = token_stream_for(cfg, 2, 1, 2, 24)
    b = s.batch_at(0)
    want = jtoken_stream_for(jconfigs.get(ARCH).reduced(), 2, 1, 2,
                             24).batch_at(0)
    assert set(b) == set(want) == {"tokens", "frames"}
    for key in b:
        assert tuple(b[key].shape) == tuple(want[key].shape), key
    assert b["frames"].shape == (2, 1, 2, cfg.encoder_seq, cfg.d_model)
    assert b["frames"].dtype == torch.float32
    assert torch.equal(b["frames"], s.batch_at(0)["frames"])
    assert not torch.equal(b["frames"], s.batch_at(1)["frames"])
    big = token_stream_for(cfg, 4, 2, 4, 24).batch_at(3)["frames"]
    assert abs(float(big.mean())) < 1e-3
    assert abs(float(big.std()) - 0.02) < 5e-4


def test_serve_fleet_refuses_audio(pair):
    """The reference's engine serves token-only archs; so does the port's
    (the encoder-decoder decodes through ``model.decode_step``)."""
    _, jmodel, jparams, model, params = pair
    spec = dict(requests=1, batch=1, prompt_len=4, max_new=2, dtype="f32")
    with pytest.raises(ValueError, match="token-only"):
        jserve_fleet(jmodel, jax.tree.map(lambda t: t[None], jparams),
                     jexp.ServeSpec(**spec))
    with pytest.raises(ValueError, match="token-only"):
        serve_fleet(model, tree.map(lambda t: t[None], params),
                    exp.ServeSpec(**spec))


def test_train_cli_trains_whisper():
    """``launch.train --arch whisper-tiny`` (reduced) through the fused
    gossip's plain version: finite losses."""
    history = train.main(["--arch", ARCH, "--preset", "reduced", "--nodes",
                          "4", "--algo", "mc_dsgt", "--R", "2", "--steps",
                          "2", "--batch", "1", "--seq", "8",
                          "--gossip-impl", "pallas", "--device", "cpu",
                          "--quiet"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)
