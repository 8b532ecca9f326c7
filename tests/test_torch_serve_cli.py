"""The port's serve entry points against the JAX package's: the serve CLI's
flag table and ``--dump-config`` JSON, ``exp.run``'s serve phase through the
CLI serving the same tokens as the reference's CLI on the same argv (a
reduced qwen1.5 fleet of 4 trained one MC-DSGT step from the reference's
initial parameters), the fleet served as views of the trained flat state,
the progress printer (a verbatim copy), the ``--metrics`` event log, and
the axes the port still refuses."""

import dataclasses
import importlib
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import exp, serve as serve_pkg, tree  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.obs import Console  # noqa: E402
from repro_torch.obs.metrics import read_events  # noqa: E402

# the module (the package exports its ``build`` function under that name)
tbuild = importlib.import_module("repro_torch.exp.build")
SRC = Path(__file__).resolve().parents[1] / "src"
ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "reduced", "--nodes", "4",
        "--steps", "1", "--requests", "6", "--serve-batch", "3",
        "--prompt-len", "8", "--max-new", "4", "--dtype", "f32"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_console_is_a_verbatim_copy():
    assert (SRC / "repro_torch/obs/console.py").read_text() == \
        (SRC / "repro/obs/console.py").read_text()


def test_flag_table_is_the_references():
    assert serve_cli.FLAG_TO_FIELD == jserve_cli.FLAG_TO_FIELD
    assert exp.ROUTING_POLICIES == ("user-affinity", "round-robin")
    assert exp.SERVE_DTYPES == ("bf16", "f32")


@pytest.mark.parametrize("argv", [
    ARGV,
    ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "4", "--algo",
     "mc_dsgt", "--gossip-impl", "pallas", "--steps", "2", "--requests", "8",
     "--serve-batch", "4", "--prompt-len", "128", "--max-new", "16",
     "--dtype", "bf16"],
    ["--algo", "personalized", "--tau", "2.0", "--routing", "round-robin",
     "--fleet", "2", "--serve-seed", "3"],
    [],                     # serve.requests defaults to 64 without --config
])
def test_dump_config_prints_the_references_json(argv, capsys):
    jserve_cli.main(argv + ["--dump-config"])
    want = capsys.readouterr().out
    serve_cli.main(argv + ["--dump-config", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert json.loads(got)["serve"]["requests"] > 0


def test_config_file_keeps_its_serve_requests(tmp_path, capsys):
    """With --config the file's serve.requests stands (no default of 64)."""
    path = tmp_path / "spec.json"
    path.write_text(exp.to_json(exp.ExperimentSpec()))
    spec = serve_cli.main(["--config", str(path), "--dump-config",
                           "--device", "cpu"])
    capsys.readouterr()
    assert spec.serve.requests == 0 and not spec.serve.enabled


class _ReferenceStream:
    """The reference's token stream for the same spec, as torch batches."""

    def __init__(self, jstream):
        self.jstream = jstream

    def batch_at(self, step):
        tokens = np.array(self.jstream.batch_at(step)["tokens"])
        return {"tokens": torch.from_numpy(tokens).long()}


@pytest.fixture(scope="module")
def served():
    """The reference CLI and the port's on ARGV."""
    return _serve_both(ARGV)


@pytest.fixture(scope="module")
def served_personalized():
    """The reference CLI and the port's on ARGV with ``--algo
    personalized`` (the per-node loss reweighting of the sun window)."""
    return _serve_both(ARGV + ["--algo", "personalized", "--tau", "2.0"])


def _serve_both(argv):
    """The reference CLI and the port's on ``argv``.  The two packages draw
    their initial parameters and token batches from their own generators
    (jax.random and torch.Generator), so the port's run takes the
    reference's: its init (jax.random.key(run.seed)) carried across, and
    its stream's batches.  Everything else, training step and serve phase,
    is the port's own."""
    want = jserve_cli.main(list(argv))
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced()
    init = params_from_jax(jax.device_get(
        jbuild(jcfg).init(jax.random.key(0), jnp.float32)))
    real = tbuild.build_model

    def with_reference_init(cfg):
        model = real(cfg)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        return model._replace(init=lambda gen, dtype, device, out=None:
                              tree.map(lambda t: t.to(device, dtype).clone(),
                                       init))

    def reference_stream(cfg, n, R, batch, seq, seed=0, active_vocab=0,
                         hetero_alpha=None, device="cpu"):
        return _ReferenceStream(jtoken_stream_for(
            jcfg, n, R, batch, seq, seed=seed, active_vocab=active_vocab,
            hetero_alpha=hetero_alpha))

    mp = pytest.MonkeyPatch()
    mp.setattr(tbuild, "build_model", with_reference_init)
    mp.setattr(tbuild, "token_stream_for", reference_stream)
    try:
        got = serve_cli.main(list(argv) + ["--device", "cpu", "--quiet"])
    finally:
        mp.undo()
    return got, want


def test_serve_cli_serves_the_references_tokens(served):
    _same_tokens(*served)


def test_serve_cli_personalized_serves_the_references_tokens(
        served_personalized):
    """``--algo personalized`` through the serve CLI (reduced, f32): the
    port's fleet serves the reference's tokens."""
    _same_tokens(*served_personalized)


def _same_tokens(got, want):
    assert got.fleet == want.fleet == 4
    assert len(got.completed) == 6
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 4
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}
    for k in ("requests", "fleet", "batch"):
        assert got.throughput[k] == want.throughput[k]


def test_serve_phase_serves_views_of_the_trained_state(monkeypatch, capsys):
    """``exp.run`` trains, then serves the first serve.fleet rows of the
    flat state, each leaf a view of them (f32: serve_fleet casts nothing);
    Result.serve holds the result and the CLI's line is printed."""
    seen = {}
    real = serve_pkg.serve_fleet

    def spy(model, fleet, sv, **kw):
        seen["fleet"] = fleet
        return real(model, fleet, sv, **kw)

    monkeypatch.setattr(serve_pkg, "serve_fleet", spy)
    spec = serve_cli.spec_from_args(serve_cli.build_parser().parse_args(
        ARGV + ["--fleet", "2", "--requests", "3"]))
    res = exp.run(spec, device="cpu")
    out = capsys.readouterr().out
    assert "served 3 requests over fleet 2" in out
    assert res.serve.fleet == 2 and len(res.serve.completed) == 3
    assert {c["node"] for c in res.serve.completed} <= {0, 1}
    x = res.state.x
    lo, hi = x.data_ptr(), x[1].data_ptr() + x[1].nbytes
    for path, leaf in tree.items(seen["fleet"]):
        assert leaf.shape[0] == 2, path
        assert lo <= leaf.data_ptr() and leaf.data_ptr() < hi, path
    emb = seen["fleet"]["embed"]["embedding"]
    assert emb.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()


def test_console_prints_and_is_quiet(capsys):
    Console().print("hello")
    Console(quiet=True).print("hidden")
    Console().event("served", requests=3, p50=1.5)
    assert capsys.readouterr().out == "hello\nserved requests=3 p50=1.5\n"


@pytest.mark.parametrize("flags,item", [
    (["--arch", "whisper-tiny"], 9),
    (["--arch", "whisper-tiny", "--algo", "personalized"], 9),
])
def test_unported_axes_raise_with_their_roadmap_item(flags, item):
    """The encoder-decoder (Queue 1 item 9 part 6, ported) trains; its
    serve phase refuses it, as the reference's engine does (audio prompts
    need frames the synthetic traffic cannot give)."""
    del item
    with pytest.raises(ValueError, match="token-only archs"):
        serve_cli.main(flags + ["--steps", "1", "--device", "cpu",
                                "--batch", "1", "--seq", "8", "--quiet"])


@pytest.mark.parametrize("flags", [["--metrics", "events.jsonl"]])
def test_metrics_flag_runs(flags, tmp_path, monkeypatch):
    """``--metrics`` (ROADMAP Queue 1 item 4) on the serve CLI: a
    ``serve_request`` event per request and the ``serve_summary``, emitted
    as they happen, then the training step's event (buffered until the
    recorder's close flushes it, as in the reference) and the summary."""
    monkeypatch.chdir(tmp_path)
    serve_cli.main(flags + ["--steps", "1", "--device", "cpu", "--nodes",
                            "4", "--requests", "3",
                            "--serve-batch", "3", "--prompt-len", "4",
                            "--max-new", "2", "--dtype", "f32",
                            "--quiet"])
    kinds = [e["event"] for e in read_events("events.jsonl")]
    assert kinds == ["meta"] + ["serve_request"] * 3 + \
        ["serve_summary", "step", "summary"]


def test_serve_needs_the_arch_runtime_and_a_gpu_by_default(monkeypatch):
    with pytest.raises(ValueError, match="needs the 'arch' runtime"):
        exp.build(exp.with_overrides(exp.ExperimentSpec(), {
            "model.kind": "logreg", "topology.kind": "random-sampled",
            "topology.sample_k": 2, "run.gossip_impl": "auto",
            "serve.requests": 1}), device="cpu")
    with pytest.raises(ValueError, match="serve.fleet"):
        exp.build(exp.with_overrides(exp.ExperimentSpec(), {
            "serve.requests": 1, "serve.fleet": 9}), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_cli.main(["--steps", "1"])


def test_realized_serve_section_is_the_references():
    """The manifest's ``realized`` section of a serving spec (requests,
    fleet, batch, routing) is the reference's."""
    args = serve_cli.build_parser().parse_args(ARGV + ["--fleet", "2"])
    spec = serve_cli.spec_from_args(args)
    jspec = jserve_cli.spec_from_args(jserve_cli.build_parser().parse_args(
        ARGV + ["--fleet", "2"]))
    got = exp.build(spec, device="cpu").realized
    assert got == jexp.build(jspec).realized
    assert got["serve"] == {"requests": 6, "fleet": 2, "batch": 3,
                            "routing": "user-affinity"}
