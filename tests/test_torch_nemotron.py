"""nemotron-4-340b's attention layout against the JAX package: head_dim 192
(18,432 / 96) with G = 12 query heads per KV head (96 over 8).  A reduced
model of that layout (2 layers, d_model 2304, 12 heads over 1 KV head of
192, relu2, untied, vocab 512) holds its prefill and decode logits to the
reference's at atol 2e-4 with ``use_pallas`` on (the JAX kernels in
interpret mode) and off, and ``serve_fleet`` serves the reference's tokens.
The wrappers' launch geometry at nemotron's serve shapes (a 64-row
tensor-core prefill; a decode of 8 splits, 64 blocks, on the tensor-core
route) and at G > 16 (row groups) is pinned, and ``chip_smoke.py``'s
nemotron serve path is held to the config.  The chunked draw of large
leaves (``layers._dense_init``) gives on the CPU the bits of one draw, leaf
by leaf and for whole model trees.  Weights are carried across by
``params_from_jax``; every other input comes from a numpy seed."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, exp as jexp  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.serve import serve_fleet as jserve_fleet  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import build, layers, params_from_jax  # noqa: E402
from repro_torch.serve import serve_fleet  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# nemotron's head_dim and G at a width the CPU runs: 12 query heads of 192
# over 1 KV head.
LAYOUT = dict(num_heads=12, num_kv_heads=1, head_dim=192)
CUT = dict(d_model=2304)
# The reference's own tolerance between its kernel and jnp paths
# (tests/test_kernels.py test_kernels_integrate_into_model_path).
LOGIT_ATOL = 2e-4
PROMPT = 16
SMS = 132                       # an H100 SXM's SMs


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(use_pallas):
    """The reduced nemotron layout in both packages."""
    over = dict(LAYOUT, use_pallas=use_pallas)
    jcfg = dataclasses.replace(
        jconfigs.get("nemotron-4-340b").reduced(**CUT), **over)
    cfg = dataclasses.replace(
        configs.get("nemotron-4-340b").reduced(**CUT), **over)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.head_dim, cfg.num_heads // cfg.num_kv_heads) == (192, 12)
    assert (cfg.mlp_act, cfg.tie_embeddings, cfg.num_layers,
            cfg.vocab_size) == ("relu2", False, 2, 512)
    return jcfg, cfg


def test_wrappers_take_hd_192_at_nemotrons_serve_shapes():
    """flash: 64-row q-tiles of 160 threads (one consumer warpgroup),
    64-key tiles; decode: 32-slot tiles, 8 splits over 8 KV heads (64
    blocks), bf16 on the tensor cores and f32 on the SIMT route; hd 96
    still no kernel's."""
    assert 192 in fa.HEAD_DIMS and 192 in da.HEAD_DIMS
    assert 96 not in fa.HEAD_DIMS and 96 not in da.HEAD_DIMS
    cfg = configs.get("nemotron-4-340b")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (H, KV, hd) == (96, 8, 192)
    assert fa.launch_geometry(1, 1920, H, hd, torch.bfloat16) == {
        "grid": (96, 30, 1), "block": 160, "cluster": 1, "q_rows": 64,
        "k_tile": 64}
    assert fa.launch_geometry(1, 1920, H, hd, torch.float32)["grid"] == (
        30, 96, 1)
    assert da.tile_for(hd) == 32
    assert da.splits_for(1, KV, 2048, SMS, hd) == 8
    assert da.tensor_cores(hd, torch.bfloat16)
    assert not da.tensor_cores(hd, torch.float32)
    assert not da.tensor_cores(128, torch.bfloat16)
    assert da.launch_geometry(1, KV, 2048, hd, torch.bfloat16, SMS,
                              G=H // KV) == {
        "grid": (64, 1, 1), "block": 128, "cluster": 8, "tile": 32,
        "route": "tensor cores"}
    assert da.launch_geometry(1, KV, 2048, hd, torch.float32, SMS,
                              G=H // KV)["route"] == "simt"


@pytest.mark.parametrize("G,groups", [(1, 1), (16, 1), (17, 2), (20, 2),
                                      (32, 2), (33, 3)])
def test_decode_launches_row_groups_past_16(G, groups):
    """G > 16 query rows a KV head: groups of 16 as the grid's z, the split
    count the same as at G <= 16 (so a row's bits do not depend on G)."""
    assert da.row_groups(G) == groups
    geo = da.launch_geometry(2, 4, 1024, 64, torch.bfloat16, SMS, G=G)
    splits = da.splits_for(2, 4, 1024, SMS, 64)
    assert geo["grid"] == (4 * splits, 2, groups)
    assert geo["cluster"] == splits


def test_cpu_route_takes_every_head_dim_and_g():
    """On the CPU both wrappers take the plain version at any head_dim and
    G, hd 96 and G = 40 included, and launch nothing."""
    gen = torch.Generator().manual_seed(0)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    for hd in (96, 192):
        q = torch.randn(1, 128, 4, hd, generator=gen)
        k = torch.randn(1, 128, 2, hd, generator=gen)
        assert fa.flash_attention(q, k, k).shape == (1, 128, 4, hd)
        q1 = torch.randn(1, 1, 2, 40, hd, generator=gen)
        kpos = torch.arange(128, dtype=torch.int32)
        assert da.decode_attention(q1, k, k, kpos, 127).shape == (
            1, 1, 80, hd)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before


@pytest.fixture(scope="module", params=[True, False],
                ids=["use_pallas", "jnp"])
def served(request):
    """Prefill a prompt, then decode two tokens (positions 16 and 17), in
    both packages; the port's kernel counts must not move on the CPU."""
    jcfg, cfg = _cfgs(request.param)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    model, params = build(cfg), params_from_jax(jax.device_get(jparams))
    tokens = np.random.default_rng(0).integers(0, 512, (2, PROMPT)).astype(
        np.int32)
    before = (fa.flash_attention.launches, da.decode_attention.launches)
    jcache = jmodel.init_cache(2, PROMPT + 4, jnp.float32)
    cache = model.init_cache(2, PROMPT + 4, torch.float32)
    jlog, jcache = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)},
                                  jcache)
    log, cache = model.prefill(params,
                               {"tokens": torch.from_numpy(tokens).long()},
                               cache)
    logs, jlogs = [log], [jlog]
    for pos in (PROMPT, PROMPT + 1):
        tok = np.asarray(jnp.argmax(jlogs[-1], -1)).astype(np.int32)
        jlog, jcache = jmodel.decode_step(jparams, jnp.asarray(tok), jcache,
                                          jnp.int32(pos))
        log, cache = model.decode_step(params, torch.from_numpy(tok).long(),
                                       cache, pos)
        logs.append(log)
        jlogs.append(jlog)
    assert (fa.flash_attention.launches,
            da.decode_attention.launches) == before
    return dict(logs=logs, jlogs=jlogs)


def test_prefill_and_decode_logits_match(served):
    """The prefill's last logits and two decode steps' at hd 192, G = 12."""
    for step, (got, want) in enumerate(zip(served["logs"], served["jlogs"])):
        assert got.shape == (2, 1, 512), step
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")


def test_serve_fleet_matches_reference():
    """A 2-member fleet of the layout served through the kernels' routes
    (the JAX kernels in interpret mode): every request decodes the same
    tokens on the same node."""
    jcfg, cfg = _cfgs(True)
    jmodel = jbuild(jcfg)
    keys = jax.random.split(jax.random.key(0), 2)
    jfleet = jax.vmap(lambda k: jmodel.init(k, jnp.float32))(keys)
    spec = dict(requests=3, batch=2, prompt_len=PROMPT, max_new=4, fleet=2,
                dtype="f32", routing="round-robin")
    want = jserve_fleet(jmodel, jfleet, jexp.ServeSpec(**spec))
    got = serve_fleet(build(cfg), params_from_jax(jax.device_get(jfleet)),
                      exp.ServeSpec(**spec))
    assert len(got.completed) == 3
    for g, w in zip(got.completed, want.completed):
        assert len(g["tokens"]) == 4
        assert {k: v for k, v in g.items() if k != "latency_ms"} == \
            {k: v for k, v in w.items() if k != "latency_ms"}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chunk", [16, 256, 4096])
@pytest.mark.parametrize("shape", [(1000, 64), (1000, 24), (517, 33),
                                   (37, 5, 7), (3000, 3)])
def test_chunked_draw_is_one_draws_bits(shape, chunk, dtype, monkeypatch):
    """A leaf drawn in row chunks of about ``chunk`` values, straight into
    its destination, has the bits of one ``torch.randn`` of its shape,
    scaled and cast, and leaves the generator where one draw leaves it."""
    monkeypatch.setattr(layers, "DRAW_CHUNK", chunk)
    gen = torch.Generator().manual_seed(3)
    out = torch.full(shape, 7.0, dtype=dtype)
    got = layers._dense_init(gen, shape, shape[0], dtype, "cpu", out)
    after = torch.randn(5, generator=gen)
    assert got is out
    gen = torch.Generator().manual_seed(3)
    want = (torch.randn(shape, generator=gen)
            * (1.0 / math.sqrt(shape[0]))).to(dtype)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(after, torch.randn(5, generator=gen))


@pytest.mark.parametrize("arch", ["nemotron-4-340b", "qwen1.5-0.5b"])
def test_chunked_draw_keeps_the_cpu_trees(arch, monkeypatch):
    """Whole reduced trees (nemotron's layout with its untied ``unembed``
    drawn into the tree; qwen tied) in bf16 and f32: chunks of 256 values
    give every leaf the bits the default chunk, one draw a leaf at these
    sizes, gives."""
    if arch == "nemotron-4-340b":
        cfg = _cfgs(False)[1]
    else:
        cfg = configs.get(arch).reduced()
    model = build(cfg)
    for dtype in (torch.float32, torch.bfloat16):
        assert max(t.numel() for _, t in tree.items(
            model.empty(dtype, "meta"))) < layers.DRAW_CHUNK
        whole = model.init(torch.Generator().manual_seed(5), dtype)
        with monkeypatch.context() as m:
            m.setattr(layers, "DRAW_CHUNK", 256)
            out = model.empty(dtype, "cpu")
            chunked = model.init(torch.Generator().manual_seed(5), dtype,
                                 out=out)
        assert dict(tree.items(chunked)).keys() == dict(
            tree.items(whole)).keys()
        for (path, a), (_, b) in zip(tree.items(chunked), tree.items(whole)):
            assert torch.equal(_bits(a), _bits(b)), path
        assert chunked["embed"]["embedding"] is out["embed"]["embedding"]


def test_the_smokes_nemotron_serve_path_fits_the_kernels():
    """``chip_smoke.py``'s nemotron serve path: 2 members of the published
    widths cut to NEMOTRON_LAYERS of 96 layers (16,345,294,848 parameters
    a member, 65.38 GB for the fleet in bf16), the yi-6b path's traffic on
    a fleet of 2, and the timed kernel shapes the config's heads at
    head_dim 192."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_nemotron", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    cfg = configs.get("nemotron-4-340b")
    assert cfg.num_layers == 96 and smoke.NEMOTRON_LAYERS == 2
    cut = dataclasses.replace(cfg, num_layers=smoke.NEMOTRON_LAYERS)
    n = sum(int(np.prod(s)) for _, s in tree.items(build(cut).shapes))
    assert n == smoke.NEMOTRON_PARAMS == 16_345_294_848
    sv = smoke.NSERVE
    assert sv == dict(smoke.YSERVE, fleet=2)
    assert round(2 * n * sv["fleet"] / 1e9, 2) == 65.38
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert smoke.FLASH_NM == (1, sv["prompt_len"], H, KV, hd)
    assert smoke.DECODE_NM == (1, sv["prompt_len"] + sv["max_new"], KV,
                               H // KV, hd)
    assert "nemotron-4-340b" in smoke.PREDICTED
