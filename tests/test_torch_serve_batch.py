"""The ``examples/serve_batch.py`` twin against the reference's example:
both hand their serve CLI the same argv (the twin adds ``--device``), a
reduced falcon-mamba-7b fleet of 4 trained 3 MC-DSGT steps, then 16
requests of 48 + 16 tokens on 8 slots; run end to end with the serve dtype
f32 (the port's run on the reference's init and stream, as
tests/test_torch_serve_cli.py does), every request decodes the reference's
tokens on the reference's node.

In the examples' own bf16 the two packages' logits differ by a few bf16
ulps (the trained fleets differ in 25 of 4.0M bf16 entries, and bf16
matmuls and elementwise chains round in other places), and greedy decoding
follows near-ties apart: request 6's first token is 149 at 2.5625 over 15
at 2.546875 in the reference, 141 and 149 tied at 2.546875 in the port.
The twin's bf16 run is held to completing every request."""

import dataclasses
import importlib
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data.synthetic import (  # noqa: E402
    token_stream_for as jtoken_stream_for)
from repro.launch import serve as jserve_cli  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import tree  # noqa: E402
from repro_torch.launch import serve as serve_cli  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402

# the module (the package exports its ``build`` function under that name)
tbuild = importlib.import_module("repro_torch.exp.build")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _ReferenceStream:
    """The reference's token stream for the same spec, as torch batches."""

    def __init__(self, jstream):
        self.jstream = jstream

    def batch_at(self, step):
        tokens = np.array(self.jstream.batch_at(step)["tokens"])
        return {"tokens": torch.from_numpy(tokens).long()}


def _with_reference_inputs(monkeypatch):
    """The port's build draws the reference's init (jax.random.key(0)) and
    its token stream: the two packages' generators differ."""
    jcfg = jconfigs.get("falcon-mamba-7b").reduced()
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

    monkeypatch.setattr(tbuild, "build_model", with_reference_init)
    monkeypatch.setattr(tbuild, "token_stream_for", reference_stream)


def test_twin_serves_the_references_tokens(monkeypatch):
    ref = _load(REPO / "examples" / "serve_batch.py", "reference_serve_batch")
    twin = _load(REPO / "examples" / "torch" / "serve_batch.py",
                 "port_serve_batch")
    argv = {}

    def f32(cli, key):
        def serve(args):
            argv[key] = list(args)
            return cli.main(list(args) + ["--dtype", "f32"])
        return serve

    monkeypatch.setattr(ref, "serve_main", f32(jserve_cli, "ref"))
    want = ref.main([])
    with monkeypatch.context() as mp:
        _with_reference_inputs(mp)
        monkeypatch.setattr(twin, "serve_main", f32(serve_cli, "port"))
        got = twin.main(["--device", "cpu"])
    assert argv["port"] == argv["ref"] + ["--device", "cpu"]
    assert got.fleet == want.fleet == 4
    assert len(got.completed) == len(want.completed) == 16
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 16
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}


def test_twin_serves_in_bf16():
    """The twin as it ships (the serve dtype bf16): 16 requests of 16
    tokens from the fleet of 4."""
    twin = _load(REPO / "examples" / "torch" / "serve_batch.py",
                 "port_serve_batch_bf16")
    res = twin.main(["--device", "cpu"])
    assert res.fleet == 4 and len(res.completed) == 16
    assert [c["rid"] for c in res.completed] == list(range(16))
    assert all(len(c["tokens"]) == 16 and all(0 <= t < 512
                                              for t in c["tokens"])
               for c in res.completed)
