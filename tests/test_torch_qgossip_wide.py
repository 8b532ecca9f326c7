"""``quantized_gossip_mix`` past the first design's n <= 16 and
power-of-two group <= 256: the plain version (what the wrapper runs on a
CPU tensor, and what ``chip_smoke.py`` holds each CUDA route to) against
the JAX package's oracle at n 17, 32 and 64 with groups 384, 512, 1024 and
4096, both schemes, error feedback on and off; the kernel's route for each
shape (``launch_geometry``: regs, tile, stream) and its refusals; and the
arch trainer at 32 nodes with int8 gossip in groups of 512 (``pallas``,
the plain version here) against the reference's trainer on its plain
compressed mixer, on a tiny whisper-tiny.  The reference's interpreted
Pallas kernel is never run at these sizes (minutes a call)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import compress as jcompress, gossip as jgossip  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.core import compress  # noqa: E402
from repro_torch.dist import collectives as coll, steps  # noqa: E402
from repro_torch.kernels import quantized_gossip, ref  # noqa: E402
from repro_torch.models import build  # noqa: E402

# f32 sums of n products (the mix) and of `group` magnitudes (the sign
# scale) in another order than XLA's: a few ulps on values of order 1.
RTOL, ATOL = 1e-5, 1e-5
# Entries allowed past RTOL/ATOL from round 2 on: a one-ulp difference can
# flip an int8 rounding (or a sign at 0), which moves that entry by one
# quantization step; a fault would move nearly every entry.
MAX_FLIPS = 1e-3
# Two training steps in two libraries, as the slices' parity tests.
STEP_RTOL, STEP_ATOL = 1e-4, 1e-5
STEP_FLIPS = 2e-3
FAST = {"xla_backend_optimization_level": 0}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jit(fn):
    """``jax.jit(fn)`` compiled at XLA's lowest backend optimization level
    on its first call (later calls must pass the same shapes): the
    reference's CPU compile, not its arithmetic, is most of these tests'
    time."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options=FAST))
        return compiled[0](*args)
    return call


def _flips(got, want, rtol, atol):
    return int((np.abs(got - want) > atol + rtol * np.abs(want)).sum())


@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,group", [(17, 384), (32, 512), (64, 1024),
                                     (32, 4096)])
def test_plain_version_matches_oracle_at_wide_shapes(n, group, scheme, ef):
    """R = 1 and R = 2 on 3 groups of columns: at R = 1 int8's residual bit
    for bit (max, division, rint and the product are exact), the mixed x
    (sums of n products in another order) and sign's residual within
    RTOL/ATOL; at R = 2 both within them but for MAX_FLIPS of the entries;
    the wrapper on CPU tensors, in place, equals the plain version bit for
    bit and launches nothing."""
    rng = np.random.default_rng(n * 10_000 + group)
    D = 3 * group
    x = rng.standard_normal((n, D)).astype(np.float32)
    res = (0.1 * rng.standard_normal((n, D))).astype(np.float32)
    for R in (1, 2):
        ws = jgossip.theorem3_weight_schedule(n, 1 - 1 / n).stacked(
            0, R).astype(np.float32)
        kw = dict(scheme=scheme, group=group, error_feedback=ef)
        # eager: under jit XLA may contract int8's buf - q·s into an FMA
        jo, jr = (np.asarray(a) for a in jref.quantized_gossip_mix_ref(
            jnp.asarray(ws), jnp.asarray(x), jnp.asarray(res), **kw))
        tws = torch.from_numpy(ws)
        o, r = ref.quantized_gossip_mix_ref(tws, torch.from_numpy(x.copy()),
                                            torch.from_numpy(res.copy()),
                                            **kw)
        for got, want, what in ((o.numpy(), jo, "x"), (r.numpy(), jr, "res")):
            if R == 1 and scheme == "int8" and what == "res":
                np.testing.assert_array_equal(got, want)
            elif R == 1:
                np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                           err_msg=what)
            else:
                assert _flips(got, want, RTOL, ATOL) <= MAX_FLIPS * got.size
        before = quantized_gossip.quantized_gossip_mix.launches
        xi, ri = torch.from_numpy(x.copy()), torch.from_numpy(res.copy())
        quantized_gossip.quantized_gossip_mix(tws, xi, ri, out=xi,
                                              res_out=ri, **kw)
        assert torch.equal(xi, o) and torch.equal(ri, r)
        assert quantized_gossip.quantized_gossip_mix.launches == before


@pytest.mark.parametrize("n,group,D,R,route,gpt,smem", [
    (4, 256, 1024, 2, "regs", 1, 2 * 16 * 4 + 8 * 16 * 4),
    (16, 8, 64, 4, "regs", 1, 4 * 256 * 4 + 8 * 16 * 4),
    (16, 512, 4096, 2, "tile", 1, 2 * 256 * 4 + 16 * 512 * 8 + 64),
    (4, 3, 3000, 1, "tile", 171, 64 + 171 * (4 * 3 * 8 + 16)),
    (17, 384, 384 * 1001, 2, "tile", 2, 2 * 289 * 4 + 2 * (17 * 384 * 8
                                                           + 68)),
    (32, 512, 36_448_768, 2, "tile", 1, 139_392),
    (64, 384, 384 * 401, 2, "tile", 1, 229_632),
    (64, 256, 256, 2, "tile", 1, 2 * 4096 * 4 + 64 * 256 * 8 + 256),
    (32, 1024, 1024 * 201, 2, "stream", 1, 2 * 1024 * 4 + 32 * 4),
    (64, 4096, 4096 * 51, 2, "stream", 1, 2 * 4096 * 4 + 64 * 4),
    (64, 36_448_128, 36_448_128, 1, "stream", 1, 4096 * 4 + 64 * 4)])
def test_launch_geometry_picks_the_route_from_shapes(n, group, D, R, route,
                                                     gpt, smem):
    """The first design where it applies (n <= 16, a power-of-two group
    <= 256); else a tile of whole groups in shared memory (x and res, 8
    bytes an entry, and a scale a (node, group)) beside the W stack, a few
    groups where they are narrow (up to 512 columns, as many as D has),
    one group up to the 227 KB a block may hold; else the stream route,
    which holds only W and a group's n scales."""
    geo = quantized_gossip.launch_geometry(n, group, D, R)
    assert (geo["route"], geo["gpt"], geo["smem"]) == (route, gpt, smem)
    assert geo["smem"] <= quantized_gossip.MAX_SHARED_BYTES


def test_launch_geometry_refuses_what_no_route_takes():
    with pytest.raises(ValueError, match="n <= 64"):
        quantized_gossip.launch_geometry(65, 256, 256, 1)
    with pytest.raises(ValueError, match="shared-memory limit"):
        quantized_gossip.launch_geometry(64, 256, 256, 15)   # 240 KB of W


def _to_mat(tree_, layout, n):
    """A reference state tree as the port's (n, D) matrix, zero in the
    padding columns."""
    want = {tuple(k.key for k in p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(tree_)}
    mat = np.zeros((n, layout.size), np.float32)
    for path, shape, off in layout.entries:
        mat[:, off:off + int(np.prod(shape))] = want[path].reshape(n, -1)
    return mat


def test_compressed_trainer_at_32_nodes_matches_reference():
    """Warm start + 2 MC-DSGT (R = 2) steps of a tiny whisper-tiny (d_model
    32, 1 + 1 layers, 8 frames) on 32 nodes with int8 gossip in groups of
    512: the port's ``pallas`` route (the kernel's plain version on the
    CPU, the route the card takes through the tile kernel) against the
    reference's dense compressed mixer, from the same weights and batches
    (seeded numpy).  Losses at STEP_RTOL; x, h, g⁻ and both residuals
    within STEP_RTOL/STEP_ATOL but for STEP_FLIPS of the entries; the
    padding columns stay zero."""
    n, R, B, S, group = 32, 2, 1, 6, 512
    small = dict(encoder_layers=1, num_layers=1, encoder_seq=8)
    jcfg = dataclasses.replace(jconfigs.get("whisper-tiny").reduced(
        d_model=32, d_ff=64, vocab=64), **small)
    cfg = dataclasses.replace(configs.get("whisper-tiny").reduced(
        d_model=32, d_ff=64, vocab=64), **small)
    model = build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    jparams = tree.map(lambda t: jnp.asarray(t.numpy()), params)
    jmodel = jbuild(jcfg)._replace(init=lambda key, dtype=None: jparams)
    jcomp = jcompress.CompressionConfig(scheme="int8", group=group)
    comp = compress.CompressionConfig(scheme="int8", group=group)
    jinit, jwarm, jstep = jsteps.make_train_step(
        jmodel, jcfg, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="dense",
        compression=jcomp)
    jwarm, jstep = _jit(jwarm), _jit(jstep)
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="pallas",
        compression=comp)
    layout = coll.FlatLayout(model.shapes, align=group)
    rng = np.random.default_rng(4)
    batches = [{"tokens": rng.integers(0, 64, (n, R, B, S)).astype(np.int32),
                "frames": (0.02 * rng.standard_normal(
                    (n, R, B, 8, 32))).astype(np.float32)}
               for _ in range(3)]

    def tb(b):
        return {"tokens": torch.from_numpy(b["tokens"].astype(np.int64)),
                "frames": torch.from_numpy(b["frames"].copy())}
    js = jinit(jax.random.key(0), n, jnp.float32)
    ts = init(params, n)
    js = jwarm(js, jax.tree.map(jnp.asarray, batches[0]))
    ts = warm(ts, tb(batches[0]))
    sched = jgossip.theorem3_weight_schedule(n, 1 - 1 / n)
    for k in (1, 2):
        W = sched.stacked((k - 1) * 2 * R, 2 * R).astype(np.float32)
        js, jout = jstep(js, jax.tree.map(jnp.asarray, batches[k]),
                         jnp.asarray(W))
        ts, tout = step(ts, tb(batches[k]), torch.from_numpy(W))
        np.testing.assert_allclose(float(tout["loss"]), float(jout["loss"]),
                                   rtol=STEP_RTOL)
    pad = np.ones(layout.size, bool)
    for _, shape, off in layout.entries:
        pad[off:off + int(np.prod(shape))] = False
    assert pad.any()
    for what, got, jtree in (("x", ts.x, js.x), ("h", ts.h, js.h),
                             ("g_prev", ts.g_prev, js.g_prev),
                             ("res_x", ts.res[0], js.res[0]),
                             ("res_h", ts.res[1], js.res[1])):
        got = got.numpy()
        assert not got[:, pad].any(), what
        bad = _flips(got, _to_mat(jtree, layout, n), STEP_RTOL, STEP_ATOL)
        assert bad <= STEP_FLIPS * got.size, (what, bad)
