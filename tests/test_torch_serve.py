"""The port's fleet serving against the JAX package's: the traffic module
(a verbatim copy) bit for bit, ``serve_fleet`` on the same reduced
falcon-mamba fleet with ``use_pallas`` on (the JAX kernel in interpret
mode) giving every request the same tokens, in f32 and, with the kernel
route and without, in bf16, continuous batching equal to serving each
request alone, and slots bound to views of the fleet."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro.serve import synth_requests as jsynth  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402
from repro_torch.serve import (SERVE_DTYPES, ServeResult,  # noqa: E402
                               route_user, serve_fleet, synth_requests)

SRC = Path(__file__).resolve().parents[1] / "src"
SERVE = dict(requests=3, batch=2, prompt_len=16, max_new=4, fleet=2,
             dtype="f32")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fleets():
    """A 2-member reduced falcon-mamba fleet in both packages (the JAX init,
    carried across)."""
    jcfg = dataclasses.replace(jconfigs.get("falcon-mamba-7b").reduced(),
                               use_pallas=True)
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b").reduced(),
                              use_pallas=True)
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    return jmodel, jfleet, build(cfg), params_from_jax(jax.device_get(jfleet))


def test_traffic_is_a_verbatim_copy():
    assert (SRC / "repro_torch/serve/traffic.py").read_text() == \
        (SRC / "repro/serve/traffic.py").read_text()


@pytest.mark.parametrize("routing", ["user-affinity", "round-robin"])
def test_synth_requests_bit_for_bit(routing):
    kw = dict(requests=12, prompt_len=9, routing=routing, seed=5)
    want = jsynth(jexp.ServeSpec(**kw), fleet=4, vocab=100)
    got = synth_requests(exp.ServeSpec(**kw), fleet=4, vocab=100)
    assert [(r.rid, r.user, r.node) for r in got] == \
        [(r.rid, r.user, r.node) for r in want]
    for g, w in zip(got, want):
        assert g.prompt.dtype == w.prompt.dtype
        np.testing.assert_array_equal(g.prompt, w.prompt)
    assert {route_user(3, rid, 4, "user-affinity") for rid in range(6)} == \
        {route_user(3, 0, 4, "user-affinity")}


@pytest.mark.parametrize("routing", ["user-affinity", "round-robin"])
def test_serve_fleet_matches_reference(fleets, routing):
    """Every request decodes the same tokens against the same node; the
    records agree in every field but the measured latency."""
    jmodel, jfleet, model, fleet = fleets
    spec = dict(SERVE, routing=routing)
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(model, fleet, exp.ServeSpec(**spec))
    assert isinstance(got, ServeResult) and got.fleet == 2
    assert len(got.completed) == SERVE["requests"]
    for g, w in zip(got.completed, want.completed):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}
    assert set(got.throughput) == set(want.throughput)
    for k in ("requests", "fleet", "batch"):
        assert got.throughput[k] == want.throughput[k]


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["use_pallas", "jnp"])
def test_serve_fleet_matches_reference_in_bf16(fleets, use_pallas):
    """The chip's serve dtype: both engines cast the f32 fleet to bf16
    (A_log too, as the reference's astype does) and serve 6 requests of 16
    + 8 tokens, with the kernel route (the JAX kernel in interpret mode)
    and the chunked scan: every request decodes the same tokens on the
    same node."""
    _, jfleet, _, fleet = fleets
    jcfg = dataclasses.replace(jconfigs.get("falcon-mamba-7b").reduced(),
                               use_pallas=use_pallas)
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b").reduced(),
                              use_pallas=use_pallas)
    spec = dict(SERVE, requests=6, max_new=8, dtype="bf16",
                routing="round-robin")
    want = jserve_fleet(jbuild(jcfg), jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), fleet, exp.ServeSpec(**spec))
    assert len(got.completed) == 6
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 8
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}


def _solo(model, params, req, sv):
    """Serve one request alone: batch-1 prefill, then decode."""
    cache = model.init_cache(1, sv.prompt_len + sv.max_new, torch.float32)
    logits, cache = model.prefill(
        params, {"tokens": torch.from_numpy(req.prompt).long()[None]}, cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    pos = sv.prompt_len
    while len(toks) < sv.max_new:
        cur = torch.full((1, 1), toks[-1], dtype=torch.long)
        logits, cache = model.decode_step(params, cur, cache, pos)
        toks.append(int(torch.argmax(logits[0, -1])))
        pos += 1
    return toks


def test_continuous_batching_matches_sequential(fleets):
    """Slots at different depths, on different nodes and admitted at
    different times batch together, and every request's tokens equal
    serving it alone."""
    _, _, model, fleet = fleets
    sv = exp.ServeSpec(**dict(SERVE, requests=5, routing="round-robin"))
    reqs = synth_requests(sv, fleet=2, vocab=model.cfg.vocab_size)
    res = serve_fleet(model, fleet, sv, requests=reqs)
    assert [c["rid"] for c in res.completed] == list(range(5))
    for rec, req in zip(res.completed, reqs):
        assert rec["node"] == req.node and rec["user"] == req.user
        p_node = tree.map(lambda leaf: leaf[req.node], fleet)
        assert rec["tokens"] == _solo(model, p_node, req, sv), \
            f"rid {req.rid} diverged from its solo decode"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slots_bind_views_of_the_fleet(fleets, dtype):
    """Every parameter a slot prefills or decodes with lies inside the
    fleet's own storage when the fleet is already in the serve dtype (a
    bf16 fleet keeps A_log in f32, as the init makes it, so that leaf alone
    is cast)."""
    _, _, model, fleet = fleets
    fleet = tree.build((path, t if path[-1] == "A_log"
                        else t.to(SERVE_DTYPES[dtype]))
                       for path, t in tree.items(fleet))
    storages = {path: (t.data_ptr(), t.data_ptr() + t.nbytes)
                for path, t in tree.items(fleet)}
    seen = []

    def spy(fn):
        def call(params, *args):
            seen.append(params)
            return fn(params, *args)
        return call

    spied = model._replace(prefill=spy(model.prefill),
                           decode_step=spy(model.decode_step))
    serve_fleet(spied, fleet, exp.ServeSpec(**dict(SERVE, dtype=dtype,
                                                   max_new=2)))
    assert len(seen) == 3 + 3       # 3 prefills, 3 one-token decodes
    for params in seen:
        for path, t in tree.items(params):
            lo, hi = storages[path]
            inside = lo <= t.data_ptr() and t.data_ptr() + t.nbytes <= hi
            assert inside == (path[-1] != "A_log" or dtype == "f32"), path


def test_serve_emits_events_and_throughput(fleets):
    _, _, model, fleet = fleets

    class Sink:
        events = []

        def emit(self, e):
            self.events.append(e)

    res = serve_fleet(model, fleet, exp.ServeSpec(**dict(SERVE, batch=3)),
                      obs=Sink())
    kinds = [e["event"] for e in Sink.events]
    assert kinds.count("serve_request") == 3 and kinds[-1] == "serve_summary"
    json.dumps(Sink.events)
    tp = res.throughput
    assert (tp["requests"], tp["fleet"], tp["batch"]) == (3, 2, 3)
    for key in ("prefill_tok_s", "decode_tok_s", "requests_per_s",
                "latency_p50_ms", "latency_p95_ms"):
        assert tp[key] > 0
    assert tp["latency_p95_ms"] >= tp["latency_p50_ms"]


def test_serve_rejects_what_it_cannot_serve(fleets):
    _, _, model, fleet = fleets
    with pytest.raises(ValueError, match="dtype"):
        serve_fleet(model, fleet, exp.ServeSpec(**dict(SERVE, dtype="fp4")))
    vlm = model._replace(cfg=dataclasses.replace(model.cfg, arch_type="vlm"))
    with pytest.raises(ValueError, match="token-only"):
        serve_fleet(vlm, fleet, exp.ServeSpec(**SERVE))
