"""The port's first slice end to end against the JAX package: the MC-DSGT,
DSGT and DSGD train steps with ``gossip_impl="pallas"`` (the JAX side runs
its Pallas ``gossip_mix`` in interpret mode), the spec front door, and the
train CLI with its ``--device`` rule."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import exp as jexp  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro.sim import telemetry as jtelemetry  # noqa: E402
from repro_torch import configs, exp  # noqa: E402
from repro_torch.core import gossip  # noqa: E402
from repro_torch.dist import collectives as coll, steps  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

# Two steps of training reorder f32 matmul reductions (XLA vs ATen) and
# carry the differences through clipping, tracking and mixing.
RTOL, ATOL = 1e-4, 1e-5
CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
N, B, S, GAMMA = 4, 2, 16, 0.05
BLOCK_D = 16_384   # D = 90,816 -> 6 grid steps of the interpreted kernel


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _leafwise(port_mat, jtree, layout, what):
    want = {tuple(k.key for k in p): np.asarray(l) for p, l
            in jax.tree_util.tree_leaves_with_path(jtree)}
    for path, shape, off in layout.entries:
        size = int(np.prod(shape))
        np.testing.assert_allclose(
            port_mat[:, off:off + size].numpy(),
            want[path].reshape(N, size), rtol=RTOL, atol=ATOL,
            err_msg=f"{what}: {'/'.join(path)}")


@pytest.mark.parametrize("algo,R", [("mc_dsgt", 2), ("dsgt", 1),
                                    ("dsgd", 1)])
def test_pallas_train_steps_match_reference(algo, R):
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    jmodel = jbuild(jcfg)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jmodel, jcfg, algo=algo, gamma=GAMMA, R=R, gossip_impl="pallas",
        pallas_interpret=True, pallas_block_d=BLOCK_D)
    jstep = jax.jit(jstep)
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    init, warm, step = steps.make_train_step(model, None, algo=algo,
                                             gamma=GAMMA, R=R,
                                             gossip_impl="pallas")
    layout = coll.FlatLayout(model.shapes)

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
        W = sched.stacked((k - 1) * wps, wps)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, tout = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
    assert ts.step == int(js.step) == 2
    _leafwise(ts.x, js.x, layout, "x")
    # x - x̄ cancels most digits: its norm carries the states' absolute error
    np.testing.assert_allclose(coll.consensus_distance(ts.x),
                               jtelemetry.consensus_distance(js.x), rtol=1e-3)
    if algo == "dsgd":
        assert ts.h is None and ts.g_prev is None
    else:
        _leafwise(ts.h, js.h, layout, "h")
        _leafwise(ts.g_prev, js.g_prev, layout, "g_prev")


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


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        exp.run(exp.ExperimentSpec())


@pytest.mark.parametrize("flags", [["--algo", "d2"], ["--gossip-impl", "auto"],
                                   ["--compress", "int8"],
                                   ["--arch", "logreg"],
                                   ["--local-opt", "adam"],
                                   ["--link-drop", "0.1"], ["--delay", "1"],
                                   ["--checkpoint", "unused.msgpack"],
                                   ["--topology", "waypoint-mobility"]])
def test_unported_axes_raise_with_their_roadmap_item(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item"):
        train.main(flags + ["--steps", "1", "--device", "cpu"])
