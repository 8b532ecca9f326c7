"""The port's checkpoints (``repro_torch.checkpoint``, the JAX package's
msgpack file format with the port's own codec) against the reference: the
codec's bytes, every leaf dtype, the legacy bfloat16 name, ``TrainState``
files crossing between the packages both ways leaf for leaf, a restored run
continuing as the uninterrupted one, and the manifest check on restore."""

import warnings

import ml_dtypes
import msgpack
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs, optim as joptim  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, exp, optim  # noqa: E402
from repro_torch.checkpoint import msgpack_ckpt as mc  # noqa: E402
from repro_torch.core import compress  # noqa: E402
from repro_torch.dist import steps  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

# a restored continuation against the reference's (one step of f32 math in
# two libraries after an exact restore), as the slices' parity tests
RTOL, ATOL = 1e-4, 1e-5
CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)
N, B, S, GAMMA = 4, 2, 16, 0.05


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


# ---------------------------------------------------------------------------
# The codec and the leaf dtypes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("payload", [
    {b"step": 0, b"treedef": b"PyTreeDef(CustomNode(TrainState[...]))",
     b"leaves": []},
    {b"step": 300, b"treedef": b"x" * 300, b"leaves": [
        {b"dtype": b"float32", b"shape": [4, 2, 64], b"data": b"\1" * 2048},
        {b"dtype": b"int32", b"shape": [], b"data": b"\7\0\0\0"},
        {b"dtype": b"bfloat16", b"shape": [70000], b"data": b"\2" * 140000}]},
    {b"step": 2 ** 40, b"treedef": b"", b"leaves": [
        {b"dtype": b"float16", b"shape": [1, 65536, 3],
         b"data": b"\3" * 393216}] * 17},
    [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33, -129,
     -40000, -2 ** 40, None, True, False, "s", "t" * 40, "u" * 70000],
], ids=["empty", "leaves", "array16", "scalars"])
def test_codec_is_msgpack(payload):
    """The port's encoder gives msgpack.packb's bytes on format payloads,
    and its decoder msgpack.unpackb's values."""
    data = msgpack.packb(payload)
    assert mc.packb(payload) == data
    assert mc.unpackb(data) == msgpack.unpackb(data)


def test_every_leaf_dtype_round_trips_bit_exact(tmp_path):
    """f32, bf16, f16 and int32 leaves (0-d, strided views and a ZeroLeaf
    among them) through the port's writer: the reference's loader and the
    port's reader both get the same bits."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal((6, 40)).astype(np.float32))
    leaves = [base[:, 3:13].view(6, 2, 5), base.bfloat16()[::2],
              base.half().T, torch.tensor(-7, dtype=torch.int32),
              torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, (3, 3),
                                            dtype=np.int32)),
              mc.ZeroLeaf((2, 3), torch.bfloat16)]
    path = str(tmp_path / "c.msgpack")
    mc.save_checkpoint(path, leaves, step=12)
    got, step, _ = mc.read_checkpoint(path)
    like = [jnp.zeros(tuple(t.shape), str(t.dtype).split(".")[1])
            for t in leaves]
    jgot, jstep = jload(path, like)
    assert step == int(jstep) == 12
    for t, g, j in zip(leaves, got, jax.tree.leaves(jgot)):
        want = (torch.zeros(t.shape, dtype=t.dtype)
                if isinstance(t, mc.ZeroLeaf) else t)
        assert g.dtype == want.dtype and g.shape == want.shape
        assert _bytes(g) == _bytes(want) == _bytes(j)
    # and back: the reference's file of the same leaves reads the same
    jsave(str(tmp_path / "j.msgpack"), jgot, step=12)
    again, _, _ = mc.read_checkpoint(str(tmp_path / "j.msgpack"))
    assert [_bytes(a) for a in again] == [_bytes(g) for g in got]


def test_legacy_v2_bfloat16_loads(tmp_path):
    """A file from before the name-based format stored bfloat16 as the
    mangled '<V2': it reads as bfloat16, as in the reference."""
    arr = np.arange(12, dtype=np.float32).reshape(3, 4).astype(
        ml_dtypes.bfloat16)
    path = tmp_path / "legacy.msgpack"
    path.write_bytes(msgpack.packb({
        b"step": 5, b"treedef": b"old", b"leaves": [
            {b"dtype": b"<V2", b"shape": [3, 4], b"data": arr.tobytes()}]}))
    target = torch.zeros((3, 4), dtype=torch.bfloat16)
    (got,), step = mc.load_checkpoint(str(path), [target])
    assert got is target and step == 5
    assert _bytes(target) == arr.tobytes()
    assert target.float().tolist() == np.arange(12.0).reshape(3, 4).tolist()
    (jgot,), _ = jload(str(path), [jnp.zeros((3, 4), jnp.bfloat16)])
    assert np.asarray(jgot).tobytes() == arr.tobytes()


def test_loader_refuses_a_mismatched_state(tmp_path):
    path = str(tmp_path / "c.msgpack")
    mc.save_checkpoint(path, [torch.ones(2, 3), torch.ones(4)], step=1)
    with pytest.raises(ValueError, match="holds 2 leaves"):
        mc.load_checkpoint(path, [torch.zeros(2, 3)])
    with pytest.raises(ValueError, match="shape"):
        mc.load_checkpoint(path, [torch.zeros(3, 2), torch.zeros(4)])
    with pytest.raises(ValueError, match="not zero"):
        mc.load_checkpoint(path, [torch.zeros(2, 3),
                                  mc.ZeroLeaf((4,), torch.float32)])


# ---------------------------------------------------------------------------
# TrainState files across the packages
# ---------------------------------------------------------------------------

# (algo, local optimizer, compression scheme, delay, bf16 trackers)
STATES = {"mc_dsgt": ("mc_dsgt", None, None, 0, False),
          "dsgd": ("dsgd", None, None, 0, False),
          "int8": ("mc_dsgt", None, "int8", 0, False),
          "delay1": ("mc_dsgt", None, None, 1, False),
          "adam": ("dsgd", "adam", None, 0, False),
          "momentum": ("local_sgd", "momentum", None, 0, False),
          "bf16-int8-delay1": ("mc_dsgt", None, "int8", 1, True)}


def _makers(algo, local_opt, scheme, delay, bf16):
    """Both packages' make_train_step on the reduced qwen1.5 of CUT."""
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    kw = dict(algo=algo, gamma=GAMMA, R=2 if algo == "mc_dsgt" else 1,
              delay=delay)
    j = jsteps.make_train_step(
        jbuild(jcfg), jcfg, gossip_impl="dense",
        aux_dtype=jnp.bfloat16 if bf16 else None,
        local_opt=getattr(joptim, local_opt)() if local_opt else None,
        compression=(jcompress.CompressionConfig(scheme=scheme, group=256)
                     if scheme else None), **kw)
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    comp = (compress.CompressionConfig(scheme=scheme, group=256) if scheme
            else None)
    t = steps.make_train_step(
        model, None, gossip_impl="dense",
        aux_dtype=torch.bfloat16 if bf16 else None,
        local_opt=getattr(optim, local_opt)() if local_opt else None,
        compression=comp, **kw)
    return j, t, steps.flat_layout(model, comp)


def _random_like(state, keep_zero: tuple):
    """``state`` (the reference's) with every leaf drawn from a seeded
    generator in its own dtype, but the fields in ``keep_zero`` (a rule
    without a tracker keeps zero trees there)."""
    rng = np.random.default_rng(7)

    def draw(leaf):
        leaf = np.asarray(leaf)
        if np.issubdtype(leaf.dtype, np.integer):
            return jnp.asarray(rng.integers(1, 1000, leaf.shape,
                                            dtype=leaf.dtype))
        return jnp.asarray(rng.standard_normal(leaf.shape).astype(
            leaf.dtype))
    fields = {f: (getattr(state, f) if f in keep_zero
                  else jax.tree.map(draw, getattr(state, f)))
              for f in state._fields}
    return type(state)(**fields)


@pytest.mark.parametrize("case", list(STATES))
def test_train_state_crosses_both_ways(case, tmp_path):
    """A reference TrainState (every leaf random) saved by the reference
    restores in the port leaf for leaf, bit for bit, with the step and
    adam's t; the port saves it back to a file that differs from the
    reference's only in ``treedef``, and the reference restores that one
    bit for bit too."""
    algo, local_opt, scheme, delay, bf16 = STATES[case]
    (jinit, _, _), (init, _, step), layout = _makers(*STATES[case])
    js = jinit(jax.random.key(0), N, jnp.float32)
    js = _random_like(js, ("h", "g_prev") if algo in ("dsgd", "local_sgd")
                      else ())
    jpath, path = str(tmp_path / "j.msgpack"), str(tmp_path / "t.msgpack")
    jsave(jpath, js, step=int(js.step))
    model = build(configs.get("qwen1.5-0.5b").reduced(**CUT))
    ts = init(model.init(torch.Generator().manual_seed(0), torch.float32,
                         "cpu"), N)
    ts, k = step.load_checkpoint(jpath, ts)
    assert k == ts.step == int(js.step)
    aux = torch.bfloat16 if bf16 else None
    got = steps.checkpoint_leaves(ts, layout, aux)
    want = jax.tree.leaves(js)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if isinstance(g, mc.ZeroLeaf):
            assert not np.asarray(w).any()
            g = torch.zeros(g.shape, dtype=g.dtype)
        assert str(g.dtype).split(".")[1] == np.asarray(w).dtype.name, i
        assert tuple(g.shape) == np.asarray(w).shape, i
        assert _bytes(g) == _bytes(w), f"leaf {i}"
    if local_opt == "adam":
        assert ts.opt["t"] == int(js.opt["t"])
    for mat in (ts.x, ts.h, ts.g_prev, *(ts.res or ())):
        if mat is not None and mat.shape[1] > sum(
                int(np.prod(s)) for _, s, _ in layout.entries):
            pad = torch.ones(mat.shape[1], dtype=torch.bool)
            for _, s, off in layout.entries:
                pad[off:off + int(np.prod(s))] = False
            assert not mat[:, pad].any()      # the padding stays zero
    step.save_checkpoint(path, ts, ts.step)
    jraw, raw = msgpack.unpackb(open(jpath, "rb").read()), \
        msgpack.unpackb(open(path, "rb").read())
    assert raw[b"treedef"] != jraw[b"treedef"]
    raw[b"treedef"] = jraw[b"treedef"]
    assert raw == jraw
    assert msgpack.packb(jraw) == open(jpath, "rb").read()
    jback, jk = jload(path, js)
    assert int(jk) == int(js.step)
    assert [_bytes(a) for a in jax.tree.leaves(jback)] == \
        [_bytes(b) for b in want]


def _tokens(R, k):
    return np.random.default_rng(10 + k).integers(
        0, 128, (N, R, B, S)).astype(np.int32)


@pytest.fixture
def deterministic():
    """ATen's deterministic kernels: on the CPU the embedding's backward
    otherwise adds duplicate tokens' rows in a thread-dependent order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(was)


@pytest.mark.usefixtures("deterministic")
def test_restore_continues_as_the_uninterrupted_run(tmp_path):
    """MC-DSGT R=2 with a stale window, the port: warm start + 3 steps
    straight equals 2 steps, a checkpoint, a restore into a fresh state and
    1 step, bit for bit (losses and every state tensor).  And the
    reference's checkpoint after its 2 steps, restored in the port,
    continues 1 step to the reference's state at RTOL/ATOL."""
    _restore_continuation(tmp_path)


def _restore_continuation(tmp_path):
    args = ("mc_dsgt", None, None, 1, False)
    (jinit, jwarm, jstep), (init, warm, step), layout = _makers(*args)
    jstep = jax.jit(jstep)
    sched = jregistry.build_topology(jspec.TopologySpec(kind="sun"), N,
                                     horizon=64, seed=3)
    Ws = [sched.stacked(4 * k, 4) for k in range(3)]
    js = jinit(jax.random.key(0), N, jnp.float32)
    params = params_from_jax(jax.device_get(jax.tree.map(lambda l: l[0],
                                                         js.x)))

    def port_run(state, ks):
        losses = []
        for k in ks:
            state, out = step(state, {"tokens": torch.from_numpy(
                _tokens(2, k + 1)).long()}, torch.from_numpy(Ws[k]))
            losses.append(float(out["loss"]))
        return state, losses

    first = {"tokens": torch.from_numpy(_tokens(2, 0)).long()}
    straight, l_straight = port_run(warm(init(params, N), first), range(3))
    half, l_half = port_run(warm(init(params, N), first), range(2))
    path = str(tmp_path / "port.msgpack")
    step.save_checkpoint(path, half, half.step)
    del half
    restored, k = step.load_checkpoint(path, init(params, N))
    assert k == 2
    rest, l_rest = port_run(restored, [2])
    assert l_half + l_rest == l_straight
    for f in ("x", "h", "g_prev"):
        assert torch.equal(getattr(rest, f), getattr(straight, f)), f
    for a, b in zip(rest.buf[0] + rest.buf[1],
                    straight.buf[0] + straight.buf[1]):
        assert torch.equal(a, b)
    # the reference's checkpoint, continued in the port
    js = jwarm(js, {"tokens": jnp.asarray(_tokens(2, 0))})
    for k in range(2):
        js, _ = jstep(js, {"tokens": jnp.asarray(_tokens(2, k + 1))},
                      jnp.asarray(Ws[k]))
    jpath = str(tmp_path / "ref.msgpack")
    jsave(jpath, js, step=2)
    ported, k = step.load_checkpoint(jpath, init(params, N))
    ported, _ = port_run(ported, [2])
    js, _ = jstep(js, {"tokens": jnp.asarray(_tokens(2, 3))},
                  jnp.asarray(Ws[2]))
    # x, h and g_prev: the first 3 × (parameter leaves) leaves of both
    per3 = 3 * len(layout.entries)
    for i, (g, w) in enumerate(zip(
            steps.checkpoint_leaves(ported, layout)[:per3],
            jax.tree.leaves(js)[:per3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"leaf {i}")


def test_restore_under_a_changed_delay_warns_through_the_manifest(tmp_path):
    """exp.run writes the checkpoint's manifest; restoring it under
    ``algorithm.delay`` = 1 warns on that field (the reference's
    ``check_restore_spec``), then the loader refuses the file (it holds no
    stale slots), as the reference's does."""
    ck = str(tmp_path / "c.msgpack")
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "run.nodes": 2, "topology.beta": 0.5, "run.steps": 1,
        "data.batch": 1, "data.seq": 16, "run.checkpoint": ck})
    exp.run(spec, device="cpu", quiet=True)
    assert (tmp_path / "c.msgpack.spec.json").exists()
    changed = exp.with_overrides(spec, {"run.checkpoint": None,
                                        "run.restore": ck,
                                        "algorithm.delay": 1})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(ValueError, match="leaves"):
            exp.run(changed, device="cpu", quiet=True)
    assert any("algorithm.delay" in str(w.message) for w in caught)
