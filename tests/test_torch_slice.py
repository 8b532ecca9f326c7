"""The port's slices end to end against the JAX package: the MC-DSGT, DSGT
and DSGD train steps with ``gossip_impl="pallas"`` (the JAX side runs its
Pallas ``gossip_mix`` in interpret mode), the same with error-feedback
compression through ``quantized_gossip_mix`` (slice 2), the spec front
door, and the train CLI with its ``--device`` rule."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import exp as jexp  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sim import telemetry as jtelemetry  # noqa: E402
from repro_torch import configs, exp  # noqa: E402
from repro_torch.core import compress, gossip  # noqa: E402
from repro_torch.dist import collectives as coll, steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs.metrics import read_events  # noqa: E402

# Two steps of training reorder f32 matmul reductions (XLA vs ATen) and
# carry the differences through clipping, tracking and mixing.
RTOL, ATOL = 1e-4, 1e-5
CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
N, B, S, GAMMA = 4, 2, 16, 0.05
BLOCK_D = 16_384   # D = 90,816 -> 6 grid steps of the interpreted kernel
# Compression group: the CUT model's leaves then take 832 padding columns
# (D = 91,648), which every state tensor must keep at zero.
GROUP = 256
# Entries of a compressed state allowed past RTOL/ATOL (a fraction of all).
# The two oracles' gradients differ by a few ulps, enough to flip an int8
# rounding, or the sign of a value near 0, in the tracker's window, which
# moves that entry (and its residual) by one quantization step; 160 of
# 363,264 res_h entries (4.4e-4) in the int8 MC-DSGT case on this test's
# inputs.  A fault in the quantization would move nearly every entry.
MAX_FLIPS = 2e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close_up_to_flips(got, want, *, rtol, atol, what=""):
    """``got`` equals ``want`` within rtol/atol but for at most MAX_FLIPS
    of the entries (quantization flips)."""
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert bad.sum() <= MAX_FLIPS * bad.size, (
        f"{what}: {int(bad.sum())} of {bad.size} entries beyond rtol={rtol} "
        f"atol={atol}")


def _leafwise(port_mat, jtree, layout, what):
    want = {tuple(k.key for k in p): np.asarray(l) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        np.testing.assert_allclose(
            port_mat[:, off:off + size].numpy(),
            want[path].reshape(N, size), rtol=RTOL, atol=ATOL,
            err_msg=f"{what}: {'/'.join(path)}")


def _in_layout(jtree, layout):
    """A JAX state tree as the port's (N, D) matrix, zero in the padding."""
    want = {tuple(k.key for k in p): np.asarray(l) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    mat = np.zeros((N, layout.size), np.float32)
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        mat[:, off:off + size] = want[path].reshape(N, size)
    return mat


def _two_steps(algo, R, scheme=None, trackers=None):
    """Warm start + 2 steps of ``algo`` in both packages from the same
    parameters and tokens (losses held to each other on the way); returns
    (port state, JAX state, the port's layout).  A ``trackers`` list gets
    the (port, JAX) tracker h after the warm start and after step 1 (the
    trackers the two x windows mix), the port's copied (its step updates
    h in place)."""
    jcomp = comp = None
    if scheme is not None:
        jcomp = jcompress.CompressionConfig(scheme=scheme, group=GROUP)
        comp = compress.CompressionConfig(scheme=scheme, group=GROUP)
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    jmodel = jbuild(jcfg)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jmodel, jcfg, algo=algo, gamma=GAMMA, R=R, gossip_impl="pallas",
        pallas_interpret=True, pallas_block_d=BLOCK_D, compression=jcomp)
    jstep = jax.jit(jstep)
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    init, warm, step = steps.make_train_step(model, None, algo=algo,
                                             gamma=GAMMA, R=R,
                                             gossip_impl="pallas",
                                             compression=comp)
    layout = coll.FlatLayout(model.shapes, align=GROUP if comp else 1)

    js = jinit(jax.random.key(0), N, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda l: l[0], js.x))), N)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 128, (N, R, B, S)).astype(np.int32)
               for _ in range(3)]
    sched = gossip.theorem3_weight_schedule(N, 0.75)
    wps = 2 * R if algo != "dsgd" else R

    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    for k in (1, 2):
        if trackers is not None and ts.h is not None:
            trackers.append((ts.h.clone(), js.h))
        W = sched.stacked((k - 1) * wps, wps)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, tout = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
    assert ts.step == int(js.step) == 2
    return ts, js, layout


@pytest.mark.parametrize("algo,R", [("mc_dsgt", 2), ("dsgt", 1),
                                    ("dsgd", 1)])
def test_pallas_train_steps_match_reference(algo, R):
    ts, js, layout = _two_steps(algo, R)
    _leafwise(ts.x, js.x, layout, "x")
    # x - x̄ cancels most digits: its norm carries the states' absolute error
    np.testing.assert_allclose(coll.consensus_distance(ts.x),
                               jtelemetry.consensus_distance(js.x), rtol=1e-3)
    if algo == "dsgd":
        assert ts.h is None and ts.g_prev is None
    else:
        _leafwise(ts.h, js.h, layout, "h")
        _leafwise(ts.g_prev, js.g_prev, layout, "g_prev")


@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("algo,R", [("mc_dsgt", 2), ("dsgd", 1)])
def test_compressed_pallas_train_steps_match_reference(algo, R, scheme):
    """Error-feedback compressed steps against the JAX fused path (its
    Pallas ``quantized_gossip_mix`` interpreted): x, h, g_prev and both
    residuals within RTOL/ATOL up to MAX_FLIPS flipped entries.  A flip
    moves mass between a payload and its residual but keeps their node sum
    (W is column-stochastic and deq + res = buf), so the node sums of
    x + res_x and h + res_h are held tightly, with no entry excused.  The
    x windows mix x − γh: a flip of the tracker's payload h (excused in h
    above) moves x's node sum by γ times it, so x's invariant is the node
    sum of x + res_x + γ(h⁰ + h¹), h⁰ and h¹ the trackers the two x windows
    took (x⁰ is the same in both packages and res_x⁰ = 0)."""
    trackers = []
    ts, js, layout = _two_steps(algo, R, scheme, trackers)
    pad = np.ones(layout.size, bool)
    for _, shape, off in layout.entries:
        pad[off:off + int(np.prod(shape))] = False
    assert pad.sum() == 832
    streams = [("x", ts.x, js.x), ("res_x", ts.res[0], js.res[0])]
    if algo == "dsgd":
        assert ts.h is None and ts.res[1] is None
    else:
        streams += [("h", ts.h, js.h), ("g_prev", ts.g_prev, js.g_prev),
                    ("res_h", ts.res[1], js.res[1])]
    want = {}
    for what, got, jtree in streams:
        want[what] = _in_layout(jtree, layout)
        np.testing.assert_array_equal(got.numpy()[:, pad], 0.0,
                                      err_msg=f"{what}: padding")
        _close_up_to_flips(got.numpy(), want[what], rtol=RTOL, atol=ATOL,
                           what=what)
    shift = [np.zeros(layout.size, np.float32)] * 2    # (port, JAX)
    for th, jh in trackers:
        shift = [shift[0] + GAMMA * th.sum(0).numpy(),
                 shift[1] + GAMMA * _in_layout(jh, layout).sum(0)]
    for a, b in (("x", "res_x"), ("h", "res_h")):
        if a in want:
            got = (getattr(ts, a) + ts.res[a != "x"]).sum(0).numpy()
            ref = (want[a] + want[b]).sum(0)
            if a == "x":
                got, ref = got + shift[0], ref + shift[1]
            np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                                       err_msg=f"node sum of {a} + {b}")


def _run(argv, device="cpu"):
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "data.batch": 1, "data.seq": 16, "run.nodes": 2, "topology.beta": 0.5,
        **argv})
    return exp.run(spec, device=device, quiet=True)


def test_pallas_and_dense_paths_agree():
    """On the CPU both impls are plain torch; the fused path mixes all R
    rounds on the flat state in place, the dense one round by round."""
    a = _run({"run.gossip_impl": "pallas", "run.steps": 2})
    b = _run({"run.gossip_impl": "dense", "run.steps": 2})
    np.testing.assert_allclose([h["loss"] for h in a.history],
                               [h["loss"] for h in b.history], rtol=1e-6)
    torch.testing.assert_close(a.state.x, b.state.x, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scheme", ["sign", "int8"])
def test_compressed_pallas_and_dense_paths_agree(scheme):
    """The fused window (the kernel's plain version on the CPU) against the
    dense compressed mixer, one matmul per round; both plain torch here,
    so the mix is the only difference (see MAX_FLIPS)."""
    over = {"compression.scheme": scheme, "run.steps": 2, "run.nodes": 4,
            "algorithm.R": 2}
    a = _run({**over, "run.gossip_impl": "pallas"})
    b = _run({**over, "run.gossip_impl": "dense"})
    np.testing.assert_allclose([h["loss"] for h in a.history],
                               [h["loss"] for h in b.history], rtol=1e-5)
    for got, want in ((a.state.x, b.state.x), (a.state.res[0], b.state.res[0]),
                      (a.state.res[1], b.state.res[1])):
        _close_up_to_flips(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


SPECS = [{}, {"algorithm.name": "dsgd", "run.nodes": 8},
         {"topology.kind": "ring", "topology.beta": 1, "run.gossip_impl":
          "pallas", "model.preset": "full"},
         {"algorithm.R": 3, "data.seq": 128, "run.seed": 7}]


@pytest.mark.parametrize("overrides", SPECS)
def test_spec_hash_equal(overrides):
    a = jexp.with_overrides(jexp.ExperimentSpec(), overrides)
    b = exp.with_overrides(exp.ExperimentSpec(), overrides)
    assert exp.spec_hash(b) == jexp.spec_hash(a)
    assert exp.to_json(b) == jexp.to_json(a)


FLAGS = [["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "4",
          "--algo", "mc_dsgt", "--R", "2", "--gossip-impl", "pallas",
          "--steps", "3"],
         ["--topology", "federated", "--algo", "local_sgd", "--compress",
          "sign", "--hetero-alpha", "0.1"]]


@pytest.mark.parametrize("argv", FLAGS)
def test_dump_config_prints_the_references_json(argv, capsys):
    jtrain.main(argv + ["--dump-config"])
    want = capsys.readouterr().out
    train.main(argv + ["--dump-config", "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want and json.loads(got)["run"]["nodes"] > 0


def test_cli_runs_reduced_steps_on_cpu(capsys):
    history = train.main(["--preset", "reduced", "--nodes", "2", "--beta",
                          "0.5", "--steps",
                          "2", "--algo", "mc_dsgt", "--R", "2", "--batch",
                          "1", "--seq", "16", "--gossip-impl", "pallas",
                          "--device", "cpu"])
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["consensus"])
               for h in history)
    assert "step     1" in capsys.readouterr().out


def test_cli_compression_flags_reach_the_run():
    argv = ["--preset", "reduced", "--nodes", "2", "--beta", "0.5",
            "--steps", "1", "--batch", "1", "--seq", "16", "--gossip-impl",
            "pallas", "--compress", "int8", "--compress-group", "64",
            "--compress-warmup", "3", "--no-error-feedback", "--device", "cpu"]
    spec = train.spec_from_args(train.build_parser().parse_args(argv))
    assert exp.build(spec, device="cpu").rule.compression == \
        compress.CompressionConfig(scheme="int8", group=64, warmup=3,
                                   error_feedback=False)
    history = train.main(argv)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run(exp.ExperimentSpec())


@pytest.mark.parametrize("flags", [["--arch", "whisper-tiny"],
                                   ["--arch", "whisper-tiny",
                                    "--hetero-alpha", "0.1"],
                                   ["--arch", "whisper-tiny",
                                    "--gossip-impl", "pallas"]])
def test_unported_axes_raise_with_their_roadmap_item(flags):
    """The encoder-decoder, refused until Queue 1 item 9 part 6 was ported,
    trains through the CLI on every axis these flags name: one finite
    step each (reduced, 2 nodes)."""
    history = train.main(flags + ["--steps", "1", "--device", "cpu",
                                  "--nodes", "2", "--beta", "0.5",
                                  "--batch", "1", "--seq", "8", "--quiet"])
    assert len(history) == 1 and np.isfinite(history[0]["loss"])


@pytest.mark.parametrize("flags", [["--restore", "c.msgpack"],
                                   ["--arch", "logreg", "--metrics",
                                    "m.jsonl"],
                                   ["--profile-dir", "prof"],
                                   ["--metrics", "m.jsonl"],
                                   ["--checkpoint", "c.msgpack"],
                                   ["--arch", "logreg", "--profile-dir",
                                    "prof"]])
def test_obs_and_checkpoint_flags_run(flags, tmp_path, monkeypatch, capsys):
    """``--metrics``, ``--profile-dir``, ``--checkpoint`` and ``--restore``
    (ROADMAP Queue 1 items 4 and 10) run one step through the train CLI on
    the CPU: the event log ends in its summary and renders, the profile is
    written, the checkpoint exists, a restore resumes at its step."""
    monkeypatch.chdir(tmp_path)
    small = ["--steps", "1", "--device", "cpu", "--nodes", "2", "--beta",
             "0.5", "--batch", "1", "--seq", "16"]
    if "--restore" in flags:
        train.main(["--checkpoint", "c.msgpack"] + small)
    history = train.main(flags + small)
    assert len(history) == 1
    out = capsys.readouterr().out
    if "--metrics" in flags:
        assert read_events("m.jsonl")[-1]["event"] == "summary"
        assert report.main(["m.jsonl"]) == 0
        assert "-- optimality gap" in capsys.readouterr().out
    if "--profile-dir" in flags:
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    if "--checkpoint" in flags:
        assert (tmp_path / "c.msgpack").stat().st_size > 0
        assert (tmp_path / "c.msgpack.spec.json").exists()
    if "--restore" in flags:
        assert "restored step 1 from c.msgpack" in out
        assert "step     1" in out
