"""The Dirichlet token streams (``TokenStream(hetero_alpha=)``) against the
JAX package: the node marginals bit for bit, the port's own categorical
draws against those marginals, and the arch runtime on a Dirichlet stream
(the ``examples/personalized_fleet.py`` cell, 2 steps) against the
reference's with its stream and init carried in.  Every draw comes from a
fixed seed."""

import dataclasses
import functools
import importlib
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.data.synthetic import TokenStream as JTokenStream  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.dist import steps as jdsteps  # noqa: E402
from repro.sim import telemetry as jtelemetry  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.data import TokenStream, token_stream_for  # noqa: E402
from repro_torch.dist import collectives, steps as dsteps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.sim import telemetry  # noqa: E402

# the module (the package exports its ``build`` function under that name)
tbuild = importlib.import_module("repro_torch.exp.build")
REPO = Path(__file__).resolve().parents[1]

# The arch trainer's step tolerance (slices 1-3).
RTOL, ATOL = 1e-4, 1e-5
# Empirical marginals from DRAWS categorical samples a node: each
# frequency's standard deviation is at most 0.5 / sqrt(DRAWS) = 0.0039;
# MARGINAL_ATOL is 5 of those.
DRAWS = 16_384
MARGINAL_ATOL = 0.02


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,vocab,active,alpha,seed", [
    (16, 512, 64, 0.1, 0),      # the personalized_fleet cell
    (4, 100, 0, 0.5, 3),        # the full vocabulary
    (3, 512, 7, 10.0, 11),      # near iid
])
def test_node_token_logits_are_the_references_bit_for_bit(n, vocab, active,
                                                          alpha, seed):
    kw = dict(vocab_size=vocab, n_nodes=n, rounds=1, batch=2, seq=4,
              seed=seed, active_vocab=active, hetero_alpha=alpha)
    got = TokenStream(**kw).node_token_logits()
    want = np.asarray(JTokenStream(**kw).node_token_logits())
    assert got.dtype == torch.float32
    assert got.shape == (n, active or vocab)
    np.testing.assert_array_equal(got.numpy(), want)


def test_node_token_logits_are_cached_and_need_alpha():
    stream = TokenStream(vocab_size=32, n_nodes=2, rounds=1, batch=1, seq=4,
                         hetero_alpha=0.3)
    assert stream.node_token_logits() is stream.node_token_logits()
    with pytest.raises(ValueError, match="hetero_alpha"):
        TokenStream(vocab_size=32, n_nodes=2, rounds=1, batch=1,
                    seq=4).node_token_logits()


@pytest.mark.parametrize("alpha", [0.1, 1.0])
def test_draws_follow_each_nodes_marginal(alpha):
    """Each node's empirical token frequencies over DRAWS draws lie within
    MARGINAL_ATOL of its marginal; the batch is (n, R, batch, seq) int64
    inside the active vocabulary, the same at every call of one step and
    different between steps."""
    n, active = 4, 16
    stream = TokenStream(vocab_size=512, n_nodes=n, rounds=2, batch=32,
                         seq=256, seed=5, active_vocab=active,
                         hetero_alpha=alpha)
    tokens = stream.batch_at(3)["tokens"]
    assert tokens.shape == (n, 2, 32, 256) and tokens.dtype == torch.int64
    assert 0 <= int(tokens.min()) and int(tokens.max()) < active
    assert torch.equal(tokens, stream.batch_at(3)["tokens"])
    assert not torch.equal(tokens, stream.batch_at(4)["tokens"])
    probs = stream.node_token_logits().double().exp().numpy()
    for i in range(n):
        freq = np.bincount(tokens[i].flatten().numpy(),
                           minlength=active) / DRAWS
        np.testing.assert_allclose(freq, probs[i], rtol=0,
                                   atol=MARGINAL_ATOL, err_msg=f"node {i}")


def test_token_stream_for_passes_alpha_and_refuses_unported_fields():
    cfg = configs.get("qwen1.5-0.5b").reduced()
    stream = token_stream_for(cfg, 2, 1, 1, 8, hetero_alpha=0.2)
    assert stream.hetero_alpha == 0.2 and stream.arch_type == "dense"
    # every field is ported: the vlm's (tests/test_torch_vlm.py) and the
    # audio frames (tests/test_torch_encdec.py), beside the Dirichlet tokens
    audio = dataclasses.replace(cfg, arch_type="audio", encoder_seq=3)
    b = token_stream_for(audio, 2, 1, 1, 8, hetero_alpha=0.2).batch_at(0)
    assert b["tokens"].shape == (2, 1, 1, 8)
    assert b["frames"].shape == (2, 1, 1, 3, cfg.d_model)


def test_train_cli_takes_hetero_alpha_on_the_arch_runtime():
    """``--hetero-alpha`` on the arch trainer (refused before this slice)
    runs: finite losses from the Dirichlet streams."""
    history = train.main(["--preset", "reduced", "--nodes", "4", "--algo",
                          "mc_dsgt", "--R", "2", "--steps", "2", "--batch",
                          "1", "--seq", "16", "--hetero-alpha", "0.1",
                          "--device", "cpu"])
    assert len(history) == 2
    assert all(np.isfinite(h["loss"]) for h in history)


class _ReferenceStream:
    """The reference's token stream for the same spec, as torch batches."""

    def __init__(self, jstream):
        self.jstream = jstream

    def batch_at(self, step):
        tokens = np.array(self.jstream.batch_at(step)["tokens"])
        return {"tokens": torch.from_numpy(tokens).long()}


def _example(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _personalized_cell():
    """The ``personalized_serve`` cell of the twin and of the reference's
    example (the same spec), 2 steps with a log line each and no serve
    phase."""
    over = {"run.steps": 2, "run.log_every": 1, "serve.requests": 0}
    spec = exp.with_overrides(_example(
        REPO / "examples/torch/personalized_fleet.py").SPECS[
            "personalized_serve"], over)
    jspec = jexp.with_overrides(_example(
        REPO / "examples/personalized_fleet.py").SPECS[
            "personalized_serve"], over)
    assert exp.spec_hash(spec) == jexp.spec_hash(jspec)
    return spec, jspec


class _Stop(Exception):
    pass


def test_arch_runtime_passes_the_specs_tau(monkeypatch):
    """The port's arch runtime builds its trainer with the spec's
    ``algorithm.tau`` (8.0 in this cell).  The reference's passes no tau
    (``repro/exp/build.py`` ``_run_arch``), so its trainer takes the
    default 4.0: a reference caveat (ROADMAP.md Queue 3), which the run
    comparison below undoes by handing the reference's trainer the spec's
    tau."""
    spec, jspec = _personalized_cell()
    seen = {}

    def spy(key):
        def make_train_step(*args, **kw):
            seen[key] = kw.get("tau")
            raise _Stop
        return make_train_step

    monkeypatch.setattr(dsteps, "make_train_step", spy("port"))
    monkeypatch.setattr(jdsteps, "make_train_step", spy("reference"))
    with pytest.raises(_Stop):
        exp.run(spec, device="cpu", quiet=True)
    with pytest.raises(_Stop):
        jexp.run(jspec, quiet=True)
    assert spec.algorithm.tau == 8.0
    assert seen == {"port": 8.0, "reference": None}


@pytest.fixture(scope="module")
def personalized_runs():
    """The cell through both packages' ``exp.run``.  The port's run takes
    the reference's init (jax.random.key(run.seed)) and its Dirichlet
    stream's batches, which its own generators cannot replay; the
    reference's trainer gets the spec's tau."""
    spec, jspec = _personalized_cell()
    mp = pytest.MonkeyPatch()
    mp.setattr(jdsteps, "make_train_step", functools.partial(
        jdsteps.make_train_step, tau=jspec.algorithm.tau))
    try:
        jres = jexp.run(jspec, quiet=True)
    finally:
        mp.undo()
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced()
    init = params_from_jax(jax.device_get(
        jbuild(jcfg).init(jax.random.key(spec.run.seed), jnp.float32)))
    real = tbuild.build_model

    def with_reference_init(cfg):
        model = real(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        return model._replace(init=lambda gen, dtype, device, out=None:
                              tree.map(lambda t: t.to(device, dtype).clone(),
                                       init))

    def reference_stream(cfg, n, R, batch, seq, seed=0, active_vocab=0,
                         hetero_alpha=None, device="cpu"):
        assert hetero_alpha == 0.1
        return _ReferenceStream(jtoken_stream_for(
            jcfg, n, R, batch, seq, seed=seed, active_vocab=active_vocab,
            hetero_alpha=hetero_alpha))

    mp = pytest.MonkeyPatch()
    mp.setattr(tbuild, "build_model", with_reference_init)
    mp.setattr(tbuild, "token_stream_for", reference_stream)
    try:
        res = exp.run(spec, device="cpu", quiet=True)
    finally:
        mp.undo()
    return res, jres


def test_personalized_run_on_dirichlet_streams_matches_reference(
        personalized_runs):
    """2 steps of the personalized rule over the realized waypoint-mobility
    schedule with 20% link drop on 16 nodes: losses at RTOL, every node's
    parameters leaf by leaf at RTOL/ATOL, and the last consensus distance
    within what those parameters' difference allows."""
    res, jres = personalized_runs
    assert [h["step"] for h in res.history] == \
        [h["step"] for h in jres.history] == [0, 1]
    np.testing.assert_allclose([h["loss"] for h in res.history],
                               [h["loss"] for h in jres.history], rtol=RTOL)
    want = {tuple(k.key for k in p): np.asarray(leaf, np.float32) for p, leaf
            in jax.tree_util.tree_leaves_with_path(jres.state.x)}
    n = res.spec.run.nodes
    layout = dsteps.flat_layout(res.built.model)
    assert len(layout.entries) == len(want)
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        np.testing.assert_allclose(
            res.state.x[:, off:off + size].numpy(),
            want[path].reshape(n, size), rtol=RTOL, atol=ATOL,
            err_msg="/".join(path))
    # the consensus distance ||x - x̄||_F after the last step differs from
    # the reference's by at most ||x - x_ref||_F (the triangle inequality;
    # 1% on it for the two f32 reductions), whatever the rule's weights do
    # with the entries' last bits
    dx = np.sqrt(sum(float(np.sum((res.state.x[:, off:off + int(
        np.prod(shape))].double().numpy() - want[path].reshape(n, -1)) ** 2))
        for path, shape, off in layout.entries))
    c, jc = res.history[-1]["consensus"], jres.history[-1]["consensus"]
    assert abs(c - jc) <= 1.01 * dx + 1e-6, (c, jc, dx)


def test_personalized_run_realizes_the_references_scenario(
        personalized_runs):
    res, jres = personalized_runs
    assert res.built.realized == jres.built.realized
    for g, w in zip(res.telemetry.history, jres.telemetry.history):
        for field in ("t", "window", "spectral_gap", "eff_diameter", "kinds"):
            assert g[field] == w[field], field


@pytest.mark.parametrize("fn", [telemetry.consensus_distance,
                                collectives.consensus_distance],
                         ids=["sim.telemetry", "dist.collectives"])
def test_consensus_distance_is_the_references_on_a_large_state(fn):
    """||x - x̄||_F of a 16 x 2^18 f32 state, nodes spread like the
    personalized cell's (~2e-4 an entry around a shared model): within
    1e-6 of the float64 value and of the reference's.  Both reductions
    took torch's ``vector_norm``, whose CPU kernel accumulates in f32 lane
    by lane (9.8e-5 low here, 0.28% on that cell's state); they square and
    sum now."""
    rng = np.random.default_rng(7)
    base = rng.standard_normal(1 << 18).astype(np.float32)
    x = (base + 2e-4 * rng.standard_normal((16, 1 << 18))).astype(
        np.float32)
    exact = np.sqrt(np.sum((x - x.astype(np.float64).mean(0)) ** 2))
    got = fn(torch.from_numpy(x))
    np.testing.assert_allclose(got, exact, rtol=1e-6)
    np.testing.assert_allclose(got, jtelemetry.consensus_distance(
        jnp.asarray(x)), rtol=1e-6)
