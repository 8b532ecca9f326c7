"""The pattern-generic arch trainer against the JAX package: every family
the models build trains, with ``use_pallas`` off as in the reference.
Warm start + 2 MC-DSGT steps of the reduced falcon-mamba-7b (``("mamba",)``),
recurrentgemma-2b (``("rglru", "rglru", "attn")`` and its remainder stack)
and granite-moe-3b-a800m (``("moe",)``, its load-balance loss in the
objective) hold to the reference's trainer from the same parameters and
tokens; and the port's train CLI checkpoints and restores granite (the
twin of the reference's ``test_train_driver_cli``), the restored run equal
to the straight one.  The ``examples/serve_batch.py`` twin is held to the
reference's in tests/test_torch_serve_batch.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

# The arch trainer's step tolerance (slices 1-3).
RTOL, ATOL = 1e-4, 1e-5
# granite's reduced preset is dropless (capacity factor 64), so its expert
# buffers grow with the tokens: 8 a sequence keep them small.
SEQ = {"falcon-mamba-7b": 16, "recurrentgemma-2b": 16,
       "granite-moe-3b-a800m": 8}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(SEQ))
def test_mc_dsgt_steps_match_reference(arch):
    """Warm start + 2 MC-DSGT (R = 2) steps on a ring of 4 from the same
    parameters and tokens through both packages' ``make_train_step``:
    losses at RTOL, every leaf of x, h and g⁻ at RTOL/ATOL."""
    n, R, B, S = 4, 2, 1, SEQ[arch]
    sched = registry.build_topology(tspec.TopologySpec(kind="ring"), n,
                                    horizon=64, seed=0)
    jcfg = jconfigs.get(arch).reduced()
    jinit, jwarm, jstep = jsteps.make_train_step(
        jbuild(jcfg), jcfg, algo="mc_dsgt", gamma=0.1, R=R,
        gossip_impl="dense")
    jstep = jax.jit(jstep)
    model = build(configs.get(arch).reduced())
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="dense")
    js = jinit(jax.random.key(0), n, jnp.float32)
    ts = init(params_from_jax(jax.device_get(
        jax.tree.map(lambda leaf: leaf[0], js.x))), n)
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, 512, (n, R, B, S)).astype(np.int32)
               for _ in range(3)]
    js = jwarm(js, {"tokens": jnp.asarray(batches[0])})
    ts = warm(ts, {"tokens": torch.from_numpy(batches[0]).long()})
    wps = 2 * R
    for k in (1, 2):
        W = np.asarray(sched.stacked((k - 1) * wps, wps), np.float32)
        js, jout = jstep(js, {"tokens": jnp.asarray(batches[k])},
                         jnp.asarray(W))
        ts, tout = step(ts, {"tokens": torch.from_numpy(batches[k]).long()},
                        torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=RTOL)
    layout = steps.flat_layout(model)
    for what in ("x", "h", "g_prev"):
        want = {tuple(k.key for k in p): np.asarray(leaf, np.float32)
                for p, leaf in jax.tree_util.tree_leaves_with_path(
                    getattr(js, what))}
        mat = getattr(ts, what)
        assert sorted(want) == sorted(p for p, _, _ in layout.entries)
        for path, shape, off in layout.entries:
            size = int(np.prod(shape))
            np.testing.assert_allclose(
                mat[:, off:off + size].numpy(), want[path].reshape(n, size),
                rtol=RTOL, atol=ATOL, err_msg=f"{what}: {'/'.join(path)}")


def test_grad_leaves_keep_each_layer_of_a_unit_apart():
    """The hybrid's unit holds three layers: the trainer's per-unit list
    keeps every layer's leaves under its own name, each a view of its own
    slice of the flat state and gradient."""
    model = build(configs.get("recurrentgemma-2b").reduced(layers=6))
    layout = steps.flat_layout(model)
    x = torch.arange(layout.size, dtype=torch.float32)
    g = torch.zeros(layout.size)
    params = layout.grad_leaves(x, g)
    units = params["units"]
    assert len(units) == 2
    assert [sorted(u) for u in units] == [["0_rglru", "1_rglru", "2_attn"]] * 2
    seen = set()
    for u in units:
        for _, leaf in tree.items(u):
            assert leaf.grad is not None and leaf.requires_grad
            seen.add(leaf.data_ptr())
    assert len(seen) == sum(1 for _ in tree.items(units[0])) * 2


def _cli(argv):
    return train.main(["--arch", "granite-moe-3b-a800m", "--preset",
                       "reduced", "--nodes", "4", "--algo", "mc_dsgt",
                       "--R", "2", "--gamma", "0.05", "--batch", "1",
                       "--seq", "8", "--device", "cpu", "--quiet"] + argv)


def test_train_cli_checkpoints_and_restores_granite(tmp_path):
    """The twin of the reference's ``test_train_driver_cli``
    (tests/test_system.py) on the port: granite-moe reduced trains 2 steps
    and checkpoints, the restored run takes 1 more, and its loss is the
    straight 3-step run's third (the same state and tokens)."""
    ckpt = str(tmp_path / "drv.msgpack")
    hist = _cli(["--steps", "2", "--checkpoint", ckpt])
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert (tmp_path / "drv.msgpack").exists()
    hist2 = _cli(["--steps", "1", "--restore", ckpt])
    straight = _cli(["--steps", "3"])
    assert len(hist2) == 1 and len(straight) == 3
    np.testing.assert_allclose(hist2[0]["loss"], straight[2]["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(hist2[0]["consensus"],
                               straight[2]["consensus"], rtol=1e-4)


def test_clip_scales_each_node_to_norm_one():
    """The clip's norm is the reference's (leaf sums of squares, added in
    leaf order): after the warm start every node's clipped sample g⁻ of
    the reduced granite-moe (3.7M entries; unclipped norms ~20) has norm 1
    to 1e-6 in float64.  ``torch.linalg.vector_norm``'s CPU kernel read
    those norms 6e-4 low, so the clipped samples came out ~1.0006."""
    model = build(configs.get("granite-moe-3b-a800m").reduced())
    init, warm, _ = steps.make_train_step(model, None, algo="mc_dsgt",
                                          gamma=0.1, R=1,
                                          gossip_impl="dense")
    ts = init(model.init(torch.Generator().manual_seed(0)), 2)
    tokens = np.random.default_rng(1).integers(0, 512, (2, 1, 1, 8))
    ts = warm(ts, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(ts.g_prev.double().norm(dim=1).numpy(), 1.0,
                               rtol=1e-6)
