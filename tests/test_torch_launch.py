"""``launch/`` on one H100 (the dry run on meta, the roofline, the
hillclimb) and ``kernels/cost.py`` against the JAX package and on their
own.

Against the reference: the parameter counts (total and active) of every
registered config equal its ``eval_shape`` count, ``model_flops_per_device``
equals its value for every config x input shape at one device,
``config_for_shape`` gives the same fields, and ``analyse`` equals the
reference's on the same record with the reference's TPU constants replaced
by the H100's and the collective bytes standing for the mix bytes.

On its own: the probes' extrapolation equals a trace at full depth (FLOPs
by dtype, bytes, peak, kernel calls, mix bytes) for every step kind; a
dense forward counts exactly its matmuls and the full-square plain
attention, or the causal half through the ``flash_attention`` meta route;
``last-unembed`` removes exactly 2·B·(S−1)·d·V FLOPs; the bf16 trackers'
effect on the peak; the FLOPs the dry run counts on meta equal
``FlopCounterMode``'s on the same step run on CPU tensors; each kernel
wrapper's meta route returns the CPU route's shapes and dtypes, launches
nothing and charges its work; the §6 table's bound column from
``kernels/cost.py``; full-width qwen1.5-0.5b rows trace.  Every input is
meta, or drawn from a numpy or torch seed."""

import ast
import dataclasses
import functools
import json
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.dist import steps as dsteps  # noqa: E402
from repro_torch.kernels import (cost, decode_attention,  # noqa: E402
                                 flash_attention, gossip_matmul,
                                 linear_recurrence, quantized_gossip,
                                 sparse_gossip)
from repro_torch.launch import dryrun, hillclimb, mesh, roofline  # noqa: E402
from repro_torch.models import build, model as modellib  # noqa: E402

torch.set_num_threads(2)
SRC = Path(__file__).resolve().parents[1] / "src"


def _ref_config_for_shape():
    """The reference's ``config_for_shape``, taken from its source: importing
    ``repro.launch.dryrun`` would set XLA_FLAGS for the whole process."""
    path = SRC / "repro" / "launch" / "dryrun.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef)
              and n.name == "config_for_shape")
    ns = {"dataclasses": dataclasses}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns["config_for_shape"]


_REF_PARAM_COUNTS = jroofline._param_counts   # before any test patches it


@functools.cache
def _ref_counts(arch: str):
    return _REF_PARAM_COUNTS(jconfigs.get(arch))


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", configs.names())
def test_param_counts_equal_the_reference(arch):
    assert roofline._param_counts(configs.get(arch)) == _ref_counts(arch)


@pytest.mark.parametrize("arch", configs.names())
def test_model_flops_equal_the_reference(arch, monkeypatch):
    monkeypatch.setattr(jroofline, "_param_counts",
                        lambda cfg: _ref_counts(cfg.name))
    for name, shape in configs.INPUT_SHAPES.items():
        jshape = jconfigs.INPUT_SHAPES[name]
        assert roofline.model_flops_per_device(
            configs.get(arch), shape, 1, 16) == \
            jroofline.model_flops_per_device(jconfigs.get(arch), jshape, 1,
                                             16)


def test_config_for_shape_equals_the_reference():
    ref = _ref_config_for_shape()
    for arch in configs.names():
        for name in configs.INPUT_SHAPES:
            got = dryrun.config_for_shape(configs.get(arch), name)
            want = ref(jconfigs.get(arch), name)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch,shape", [("qwen1.5-0.5b", "train_4k"),
                                        ("granite-moe-3b-a800m",
                                         "prefill_32k"),
                                        ("nemotron-4-340b", "decode_32k")])
def test_analyse_equals_the_reference(arch, shape, monkeypatch):
    """One bf16 record through both: the reference's peaks set to the
    H100's, its link bandwidth to HBM's, its collective bytes the mix's and
    its bytes the rest (the port's memory term leaves the mix out)."""
    monkeypatch.setattr(jroofline, "PEAK_FLOPS_BF16", mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jroofline, "HBM_BW", mesh.HBM_BW)
    monkeypatch.setattr(jroofline, "ICI_BW", mesh.HBM_BW)
    monkeypatch.setattr(jroofline, "V5E_HBM_BYTES", mesh.HBM_BYTES)
    monkeypatch.setattr(jroofline, "_param_counts",
                        lambda cfg: _ref_counts(cfg.name))
    flops, nbytes, mix, peak = 3.1e15, 2.2e12, 4.4e11, 5.5e10
    rec = {"arch": arch, "shape": shape, "mesh": dryrun.MESH, "devices": 1,
           "nodes": 16, "batch": configs.INPUT_SHAPES[shape].global_batch,
           "flops": flops, "flops_by_dtype": {"bfloat16": flops},
           "bytes_accessed": nbytes, "memory": {"peak_bytes": peak},
           "mix": {"total_bytes": mix}}
    jrec = {"arch": arch, "shape": shape, "mesh": "16x16", "devices": 1,
            "flops": flops, "bytes_accessed": nbytes - mix,
            "memory": {"peak_bytes": peak},
            "collectives": {"total_bytes": mix}}
    got, want = roofline.analyse(rec), jroofline.analyse(jrec)
    for k in ("t_compute_s", "t_memory_s", "model_flops_per_device",
              "useful_flops_ratio", "fits_hbm", "hbm_frac"):
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert got["t_mix_s"] == pytest.approx(want["t_collective_s"], rel=1e-12)
    names = {"compute": "compute", "memory": "memory", "mix": "collective"}
    assert names[got["dominant"]] == want["dominant"]


# ---------------------------------------------------------------------------
# The dry run on its own
# ---------------------------------------------------------------------------

def _small_shapes(monkeypatch, seq=256, batch=4):
    for name, shape in list(configs.INPUT_SHAPES.items()):
        monkeypatch.setitem(configs.INPUT_SHAPES, name, dataclasses.replace(
            shape, seq_len=seq if shape.kind != "decode" else 2 * seq,
            global_batch=batch))


def _reduced(arch, units=4, **fields):
    """``arch`` reduced to ``units`` pattern units (a window of 128, so a
    unit's stacked ring positions fill whole 512-byte allocations)."""
    c = configs.get(arch)
    cfg = c.reduced(layers=units * len(c.pattern))
    if cfg.encoder_layers:
        fields.setdefault("encoder_layers", units)
    if cfg.window:
        fields.setdefault("window", 128)
    return dataclasses.replace(cfg, **fields)


COUNTS = ("flops", "flops_by_dtype", "flops_counted", "bytes_accessed",
          "memory", "mix", "kernel_calls")


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "falcon-mamba-7b", "recurrentgemma-2b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("shape", list(configs.INPUT_SHAPES))
def test_probe_extrapolation_is_exact(arch, shape, monkeypatch):
    """Probes of 2 and 3 units extrapolated to a 4-unit config (the
    remainder layers kept) equal its whole trace, every count; the kernels'
    routes on (use_pallas for the serve shapes, gossip_mix for training)."""
    _small_shapes(monkeypatch)
    serve = configs.INPUT_SHAPES[shape].kind != "train"
    cfg = _reduced(arch, use_pallas=serve)
    kw = dict(nodes=2, train_kwargs={"gossip_impl": "pallas"},
              cfg_transform=lambda c: cfg, verbose=False)
    probed = dryrun.lower_one(arch, shape, probe=True, **kw)
    whole = dryrun.lower_one(arch, shape, probe=False, **kw)
    assert probed["probe"] and not whole["probe"]
    assert {k: probed[k] for k in COUNTS} == {k: whole[k] for k in COUNTS}
    assert whole["flops_counted"] > 0 and whole["memory"]["peak_bytes"] > 0
    if not serve:
        assert whole["kernel_calls"] == {"gossip_mix": 2}
        assert 0 < whole["mix"]["total_bytes"] < whole["bytes_accessed"]


def _dense_matmul_params(cfg) -> int:
    """The weights a dense decoder multiplies a token by: every layer's
    q, k, v, o projections and MLP, and the (tied) unembedding."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    per_layer = D * (H + 2 * KV) * hd + H * hd * D + 3 * D * cfg.d_ff
    return cfg.num_layers * per_layer + D * cfg.vocab_size


@pytest.mark.parametrize("use_pallas", [False, True])
def test_dense_prefill_counts_its_matmuls_and_attention(use_pallas,
                                                        monkeypatch):
    """A reduced qwen prefill of B x S tokens: 2·T·N_matmul, plus the plain
    attention's full square (4·B·H·S²·hd: it masks, it does not skip) or,
    through the flash_attention meta route, the causal half with the
    diagonal (4·B·H·hd·S(S+1)/2) at bf16's rate."""
    B, S = 2, 256
    _small_shapes(monkeypatch, seq=S, batch=B)
    cfg = _reduced("qwen1.5-0.5b", units=2, use_pallas=use_pallas,
                   dtype="bfloat16")
    rec = dryrun.lower_one("qwen1.5-0.5b", "prefill_32k", probe=False,
                           cfg_transform=lambda c: cfg, verbose=False)
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    matmul = 2 * B * S * _dense_matmul_params(cfg)
    if use_pallas:
        attn = L * 4 * B * H * hd * S * (S + 1) // 2
        assert rec["flops_counted"] == matmul
        assert rec["kernel_calls"] == {"flash_attention": L}
    else:
        attn = L * 4 * B * H * S * S * hd
        assert rec["flops_counted"] == matmul + attn
        assert rec["kernel_calls"] == {}
    assert rec["flops"] == rec["flops_by_dtype"]["bfloat16"] == matmul + attn


def test_last_unembed_removes_the_other_positions_unembedding():
    """internvl2-1b at full width, one 32,768-position prefill (256 patch
    embeddings + 32,512 tokens): prefill_last_only removes exactly
    2·B·(S−1)·d·V FLOPs, through the hillclimb pair."""
    out = {}
    pair = {"internvl2-prefill": hillclimb.PAIRS["internvl2-prefill"]}
    hillclimb.run_pairs(pair, out, batch=1)
    cfg = configs.get("internvl2-1b")
    S = configs.INPUT_SHAPES["prefill_32k"].seq_len
    v = out["internvl2-prefill"]
    assert v["baseline"]["flops"] - v["last-unembed"]["flops"] == \
        2 * 1 * (S - 1) * cfg.d_model * cfg.vocab_size
    assert v["last-unembed"]["peak_bytes"] < v["baseline"]["peak_bytes"]


def test_bf16_state_and_the_peak(monkeypatch):
    """aux_dtype=bf16 stores h and g⁻ in half the bytes, but the step's
    peak grows by 2·n·D bytes: the sample is a fresh f32 (n, D) gradient,
    and its bf16 copy (the new g⁻) is taken beside it and the old g⁻ and h,
    where the f32 step writes the sample into g⁻'s buffer.  (A reduced
    qwen, whose activations are small, so that moment holds the peak.)"""
    _small_shapes(monkeypatch, seq=128, batch=8)
    cfg = _reduced("qwen1.5-0.5b", units=2)
    n = 4
    D = dsteps.flat_layout(build(cfg)).size
    peak = {}
    for name, tkw in (("f32", {}), ("bf16", {"aux_dtype": torch.bfloat16})):
        peak[name] = dryrun.lower_one(
            "qwen1.5-0.5b", "train_4k", nodes=n, probe=False,
            cfg_transform=lambda c: cfg, train_kwargs=tkw,
            verbose=False)["memory"]["peak_bytes"]
    assert peak["bf16"] - peak["f32"] == 2 * n * D
    # the state the step leaves: h and g⁻ in bf16
    model = build(cfg)
    init_state, warm_start, step = dsteps.make_train_step(
        model, cfg, gamma=1e-3, R=2, aux_dtype=torch.bfloat16)
    bt = {"tokens": torch.empty((n, 2, 1, 128), dtype=torch.int64,
                                device="meta")}
    state = warm_start(init_state(model.empty(torch.float32, "meta"), n), bt)
    state, _ = step(state, bt, torch.empty(4, n, n, device="meta"))
    assert state.h.dtype == state.g_prev.dtype == torch.bfloat16
    assert state.x.dtype == torch.float32


def test_delayed_step_peak_charges_the_issued_window(monkeypatch):
    """A delayed MC-DSGT step (delay 1, gossip_mix's meta route) issues
    both windows before its oracle, so the h window's copy of its stale
    slot lives across the oracle: the peak is the synchronous step's plus
    exactly three (n, D) slots, the state's two stale slots and that copy.
    (A reduced qwen at 1,024 tokens, whose activations outweigh a slot, so
    the oracle holds both peaks.)"""
    _small_shapes(monkeypatch, seq=1024, batch=8)
    cfg = _reduced("qwen1.5-0.5b", units=1)
    n = 4
    D = dsteps.flat_layout(build(cfg)).size
    slot = -(-n * D * 4 // dryrun.ALLOC_ROUND) * dryrun.ALLOC_ROUND
    peak = {}
    for delay in (0, 1):
        peak[delay] = dryrun.lower_one(
            "qwen1.5-0.5b", "train_4k", nodes=n, probe=False,
            cfg_transform=lambda c: cfg, verbose=False,
            train_kwargs={"delay": delay, "gossip_impl": "pallas"}
        )["memory"]["peak_bytes"]
    assert peak[1] - peak[0] == 3 * slot


def test_meta_flops_equal_flop_counter_on_cpu_tensors(monkeypatch):
    """The card's gate rehearsed on the CPU: FlopCounterMode over one MC-DSGT
    step of a reduced qwen on real CPU tensors counts the FLOPs the dry run
    counts for the same step on meta (the plain gossip: the CPU route of
    gossip_mix is its plain version, which FlopCounterMode sees)."""
    S, n, R = 64, 2, 2
    _small_shapes(monkeypatch, seq=S, batch=n * R)
    cfg = _reduced("qwen1.5-0.5b", units=2)
    rec = dryrun.lower_one("qwen1.5-0.5b", "train_4k", nodes=n, R=R,
                           probe=False, cfg_transform=lambda c: cfg,
                           verbose=False)
    model = build(cfg)
    init_state, warm_start, step = dsteps.make_train_step(model, cfg,
                                                          gamma=1e-3, R=R)
    gen = torch.Generator().manual_seed(0)
    flat = modellib.materialize_batch(cfg, n * R, S, gen, torch.float32)
    bt = {k: v.reshape(n, R, 1, S) for k, v in flat.items()}
    rng = np.random.default_rng(0)
    w = rng.random((2 * R, n, n)).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    state = warm_start(init_state(model.init(gen), n), bt)
    with FlopCounterMode(display=False) as fc:
        step(state, bt, torch.from_numpy(w))
    assert fc.get_total_flops() == rec["flops_counted"] == rec["flops"]


# ---------------------------------------------------------------------------
# The kernel wrappers' meta routes and kernels/cost.py
# ---------------------------------------------------------------------------

def _meta_vs_cpu(fn, args, name, work):
    """``fn`` on meta copies of ``args`` against ``fn`` on ``args``: the same
    output shapes and dtypes, no launch, one charge of ``work``."""
    cpu = fn(*args)
    with cost.Recorder() as rec:
        meta = fn(*(a.to("meta") if torch.is_tensor(a) else a
                    for a in args))
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    meta = meta if isinstance(meta, tuple) else (meta,)
    assert [(m.device.type, m.shape, m.dtype) for m in meta] == \
        [("meta", c.shape, c.dtype) for c in cpu]
    assert rec.calls == [(name, work)]


def test_meta_routes_match_the_cpu_routes():
    g = torch.Generator().manual_seed(0)
    n, D, R = 4, 512, 2
    ws = torch.rand(R, n, n, generator=g)
    x = torch.randn(n, D, generator=g)
    _meta_vs_cpu(lambda w, a: gossip_matmul.gossip_mix(w, a), (ws, x),
                 "gossip_mix", cost.gossip_mix(n, D, R, 4))
    res = torch.randn(n, D, generator=g).bfloat16()
    _meta_vs_cpu(lambda w, a, r: quantized_gossip.quantized_gossip_mix(
        w, a, r, scheme="int8", group=64), (ws, x, res),
        "quantized_gossip_mix", cost.quantized_gossip_mix(n, D, R, 4, 2))
    a = torch.rand(2, 16, 8, generator=g)
    b = torch.randn(2, 16, 8, generator=g)
    _meta_vs_cpu(linear_recurrence.linear_recurrence, (a, b),
                 "linear_recurrence", cost.linear_recurrence(2, 16, 8, 4))
    q = torch.randn(1, 128, 4, 64, generator=g).bfloat16()
    k, v = (torch.randn(1, 128, 2, 64, generator=g).bfloat16()
            for _ in range(2))
    _meta_vs_cpu(lambda *t: flash_attention.flash_attention(*t, window=32),
                 (q, k, v), "flash_attention",
                 cost.flash_attention(1, 128, 128, 4, 2, 64, 2, "bfloat16",
                                      True, 32))
    q1 = torch.randn(2, 1, 2, 3, 64, generator=g)
    kc, vc = (torch.randn(2, 256, 2, 64, generator=g) for _ in range(2))
    kpos = torch.arange(256, dtype=torch.int32)
    _meta_vs_cpu(lambda *t: decode_attention.decode_attention(*t, 255),
                 (q1, kc, vc, kpos), "decode_attention",
                 cost.decode_attention(2, 256, 2, 3, 64, 4, "float32"))
    src = torch.tensor([0, 1, 2, 3])
    dst = torch.tensor([1, 1, 3, 3])
    w = torch.full((4,), 0.25)
    seg = torch.tensor([0, 0, 1, 1])
    layout = sparse_gossip.segment_layout(src, dst, w, seg, 2)
    xs = torch.randn(4, 32, generator=g)
    _meta_vs_cpu(lambda a, *lay: sparse_gossip.sparse_segment_mix(a, *lay),
                 (xs, *layout), "sparse_segment_mix",
                 cost.sparse_segment_mix(layout.rows.shape[0], 2, 4, 32, 4))
    for counter in (gossip_matmul.gossip_mix,
                    quantized_gossip.quantized_gossip_mix,
                    linear_recurrence.linear_recurrence,
                    flash_attention.flash_attention,
                    decode_attention.decode_attention,
                    sparse_gossip.sparse_segment_mix):
        assert counter.launches == 0


def test_meta_route_keeps_the_kernel_checks():
    """A meta tensor the kernel would refuse is refused on meta too."""
    q = torch.empty(1, 128, 4, 48, dtype=torch.bfloat16, device="meta")
    k = torch.empty(1, 128, 2, 48, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.flash_attention(q, k, k)
    x = torch.empty(4, 64, dtype=torch.float16, device="meta")
    with pytest.raises(TypeError):
        gossip_matmul.gossip_mix(torch.empty(2, 4, 4, device="meta"), x)


@pytest.mark.parametrize("work,ms", [
    (cost.gossip_mix(4, 463_987_712, 2, 4), 4.432),
    (cost.gossip_mix(32, 36_448_128, 2, 4), 2.785),
    (cost.gossip_mix(128, 9_112_064, 2, 4), 4.457),
    (cost.quantized_gossip_mix(4, 463_987_712, 2, 4, 4), 8.864),
    (cost.quantized_gossip_mix(32, 36_448_768, 2, 4, 4), 5.571),
    (cost.linear_recurrence(1, 2048, 131_072, 4), 0.9617),
    (cost.flash_attention(1, 1920, 1920, 16, 16, 64, 2, "bfloat16"), 0.007638),
    (cost.flash_attention(1, 1920, 1920, 96, 8, 192, 2, "bfloat16"), 0.1375),
    (cost.decode_attention(1, 2048, 16, 1, 64, 2, "bfloat16"), 0.002508),
    (cost.decode_attention(1, 2048, 8, 12, 192, 2, "bfloat16"), 0.003781),
])
def test_bounds_of_the_perf_table(work, ms):
    """The bound column of PERF.md §6 at the table's shapes (4 significant
    figures; the flash rows' 7.55 and 135.96 GFLOP)."""
    got, _ = cost.bound_ms(work)
    assert float(f"{got:.4g}") == ms


def test_attention_pairs():
    for Sq, Sk, causal, window in ((1920, 1920, True, 0),
                                   (3968, 3968, True, 2048),
                                   (128, 256, True, 0), (256, 256, False, 64),
                                   (300, 300, True, 301)):
        q = np.arange(Sq)[:, None]
        k = np.arange(Sk)[None, :]
        mask = np.ones((Sq, Sk), bool)
        if causal:
            mask &= k <= q
        if window:
            mask &= k > q - window
        assert cost.attention_pairs(Sq, Sk, causal, window) == mask.sum()
    assert cost.flash_attention(1, 1920, 1920, 16, 16, 64, 2,
                                "bfloat16").flops == 7_553_679_360


# ---------------------------------------------------------------------------
# Full width, and the command lines
# ---------------------------------------------------------------------------

def test_full_width_qwen_rows_trace(tmp_path):
    """qwen1.5-0.5b at its published widths: decode_32k at the global
    batch and train_4k on 4 nodes with gossip_mix trace, through the CLI
    for decode, and the roofline reads the records."""
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "qwen1.5-0.5b_decode_32k_1xH100.json")
                     .read_text())
    assert rec["batch"] == 128 and rec["reduced"] == []
    cfg = configs.get("qwen1.5-0.5b")
    # the KV cache of 128 sequences of 32,768 positions, in bf16
    cache = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads \
        * cfg.head_dim * 2
    assert cache < rec["memory"]["peak_bytes"] < 1.05 * cache
    train = dryrun.lower_one("qwen1.5-0.5b", "train_4k", nodes=4, batch=8,
                             train_kwargs={"gossip_impl": "pallas"},
                             verbose=False)
    assert train["kernel_calls"] == {"gossip_mix": 2}
    assert train["reduced"] == ["global_batch 256 -> 8"]
    D = 463_987_712
    assert train["mix"]["total_bytes"] == 2 * cost.gossip_mix(4, D, 2,
                                                              4).bytes
    (tmp_path / "train.json").write_text(json.dumps(train))
    rows = roofline.main(["--dir", str(tmp_path)])
    assert [r["shape"] for r in rows] == ["decode_32k", "train_4k"]
    assert rows[0]["dominant"] == "memory"
    assert rows[1]["dominant"] == "compute" and rows[1]["fits_hbm"]
    assert math.isclose(rows[1]["t_compute_s"],
                        train["flops"] / mesh.PEAK_FLOPS_F32)


def test_rows_in_processes_equal_the_rows_traced_here(monkeypatch):
    """``dryrun.results`` with 2 processes yields every row's record in the
    rows' order, equal to the record traced in this process but for its
    trace time (a config registered here at run time included), and a row
    that fails in a worker as its exception."""
    cut = dataclasses.replace(configs.get("qwen1.5-0.5b"),
                              name="qwen1.5-0.5b-2l", num_layers=2)
    monkeypatch.setitem(configs._REGISTRY, cut.name, cut)
    one = functools.partial(dryrun.lower_one, verbose=False)
    rows = [("qwen1.5-0.5b", "decode_32k"), ("no-such-arch", "decode_32k"),
            ("whisper-tiny", "long_500k"), (cut.name, "decode_32k")]
    got = list(dryrun.results(one, rows, 2,
                              first=lambda r: r[0] == "whisper-tiny"))
    assert [r for r, _ in got] == rows
    assert isinstance(got[1][1], KeyError)
    for (row, rec) in got[::2] + got[3:]:
        want = one(*row)
        rec.pop("trace_seconds")
        want.pop("trace_seconds")
        assert rec == want, row


def test_trace_memoises_only_meta_calls():
    """An op memoised on meta, then called on CPU tensors of the same
    shapes under the same trace, returns the CPU result: a hit rebuilds
    meta outputs, so only calls on meta are kept."""
    gen = torch.Generator().manual_seed(3)
    a, b = (torch.randn(16, 8, generator=gen) for _ in range(2))
    with dryrun.Trace() as tr:
        meta = torch.mm(a.to("meta"), b.t().to("meta"))
        got = torch.mm(a, b.t())
    assert meta.device.type == "meta" and got.device.type == "cpu"
    torch.testing.assert_close(got, a @ b.t(), rtol=0, atol=0)
    assert tr.flops_counted == 2 * (2 * 16 * 8 * 16)


def test_kernels_import_nothing_of_launch():
    """The kernel layer sits under the entry points: no module of
    ``repro_torch/kernels`` imports ``repro_torch.launch`` (the card's
    peaks live in ``kernels/cost.py``, and ``launch.mesh`` names them)."""
    for path in sorted((SRC / "repro_torch" / "kernels").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                name = "." * node.level + (node.module or "")
                assert "launch" not in name.split("."), (path.name, name)
            elif isinstance(node, ast.Import):
                assert not any("launch" in a.name.split(".")
                               for a in node.names), path.name
    assert mesh.HBM_BW is cost.HBM_BW and mesh.PEAK_FLOPS is cost.PEAK_FLOPS
