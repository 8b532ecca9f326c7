"""``quantized_gossip_mix`` past the first design's n <= 16 and
power-of-two group <= 256, and in bf16: the plain version (what the wrapper
runs on a CPU tensor, and what ``chip_smoke.py`` holds each CUDA route to)
against the JAX package's oracle at n 17, 32 and 64 with groups 384, 512,
1024 and 4096, both schemes, error feedback on and off, and against the
JAX kernel in interpret mode and its oracle with bf16 x and/or res and at
n = 65 and 96; the kernel's route for each shape (``launch_geometry``:
regs, ring, stream; the ring's cluster, stages and shared bytes) and its
refusals; ``fused_quantized_consensus`` on bf16 streams, equal to the
upcast path it replaced; and the arch trainer at 32 nodes with int8 gossip
in groups of 512 (``pallas``, the plain version here), f32 and with bf16
trackers and residuals (``aux_dtype``), against the reference's trainer on
its plain compressed mixer, on a tiny whisper-tiny.  The reference's
interpreted Pallas kernel runs at 3 groups of columns only."""

import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import compress as jcompress, gossip as jgossip  # noqa: E402
from repro.dist import steps as jsteps  # noqa: E402
from repro.kernels import quantized_gossip as jqgossip  # noqa: E402
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
# bf16 tracker storage, as tests/test_torch_rules.py holds it: a value the two
# packages compute in f32 a few ulps apart may round to neighbouring bf16
# values, one bf16 ulp (2^-8 of the value) apart.
BF16_RTOL = 2.0 ** -7
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


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("xdt,rdt", [(BF16, BF16), (F32, BF16), (BF16, F32),
                                     (F32, F32)])
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,group", [(32, 512), (17, 384), (65, 256),
                                     (96, 256)])
def test_plain_version_matches_reference_kernel_bf16_and_past_64_nodes(
        n, group, scheme, xdt, rdt):
    """The inputs the kernel now takes -- x and res each f32 or bf16, n past
    64 -- through the plain version against the JAX kernel in interpret
    mode and the JAX oracle on the same values, R = 2, error feedback on:
    within RTOL/ATOL (a bf16 result at rtol BF16_RTOL: one a few f32 ulps
    off the reference's may round to the neighbouring bf16 value) but for
    MAX_FLIPS of the entries; x and res keep their dtypes; the plain version on bf16 inputs
    is the plain version on upcast copies, cast back, bit for bit (the
    card holds its kernel to the same); the wrapper on CPU tensors, in
    place, equals the plain version and launches nothing."""
    rng = np.random.default_rng(n * 1_000 + group)
    D, R = 3 * group, 2
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32)).to(
        xdt)
    res = torch.from_numpy((0.1 * rng.standard_normal((n, D))).astype(
        np.float32)).to(rdt)
    ws = jgossip.theorem3_weight_schedule(n, 1 - 1 / n).stacked(
        0, R).astype(np.float32)
    kw = dict(scheme=scheme, group=group, error_feedback=True)
    tws = torch.from_numpy(ws)
    o, r = ref.quantized_gossip_mix_ref(tws, x.clone(), res.clone(), **kw)
    assert o.dtype == xdt and r.dtype == rdt
    o32, r32 = ref.quantized_gossip_mix_ref(tws, x.float(), res.float(), **kw)
    assert torch.equal(o32.to(xdt), o) and torch.equal(r32.to(rdt), r)

    def jx(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == BF16
                           else jnp.float32)
    want = [jref.quantized_gossip_mix_ref(jnp.asarray(ws), jx(x), jx(res),
                                          **kw),
            jqgossip.quantized_gossip_mix(jnp.asarray(ws), jx(x), jx(res),
                                          block_d=D, interpret=True, **kw)]
    for jo, jr in want:
        for got, w in ((o, jo), (r, jr)):
            w = np.asarray(w, np.float32)
            rtol = BF16_RTOL if got.dtype == BF16 else RTOL
            assert _flips(got.float().numpy(), w, rtol, ATOL) <= \
                MAX_FLIPS * got.numel()
    before = quantized_gossip.quantized_gossip_mix.launches
    xi, ri = x.clone(), res.clone()
    quantized_gossip.quantized_gossip_mix(tws, xi, ri, out=xi, res_out=ri,
                                          **kw)
    assert torch.equal(xi, o) and torch.equal(ri, r)
    assert quantized_gossip.quantized_gossip_mix.launches == before


# (n, group, D, R, x and res bytes a value, route, cluster, stages, W in
# shared memory, dynamic shared bytes).  The ring's bytes: 128 of alignment
# slack, then 128 of barriers + W^T (R n n4 f32, n4 = n up to a multiple of
# 4) when staged + two f32 buffers of n x cols + two exchange slots (cluster
# x n x groups a tile, f32) + n f32 scales, padded to 128 bytes, then the
# stages (n x cols of x and of res as stored, each padded to 128 bytes); as
# many stages as fit (up to 4) in half an SM (115,712 bytes) where two
# blocks' registers fit, else in a whole block (232,448).
WHISPER = 36_448_768


def _pad128(nbytes):
    return -(-nbytes // 128) * 128


@pytest.mark.parametrize("n,group,D,R,nb,route,cluster,stages,w_smem,smem", [
    (4, 256, 1024, 2, (4, 4), "regs", None, None, None,
     2 * 16 * 4 + 8 * 16 * 4),
    (16, 8, 64, 4, (4, 4), "regs", None, None, None,
     4 * 256 * 4 + 8 * 16 * 4),
    # 16 rows: 256 columns for 256 threads' units, half a group a block
    (16, 512, 4096, 2, (4, 4), "ring", 2, 2, True, 100_992),
    # odd groups: 340 whole groups of 3 a block (1,020 columns)
    (4, 3, 3000, 1, (4, 4), "ring", 1, 2, True, 109_440),
    (17, 384, 384 * 1001, 2, (4, 4), "ring", 2, 3, True, 107_776),
    # whisper-tiny's 32-node shape: clusters of 4 blocks of 128 columns
    (32, 512, WHISPER, 2, (4, 4), "ring", 4, 2, True,
     128 + _pad128(128 + 2 * 32 * 32 * 4 + 2 * 32 * 128 * 4 + 2 * 4 * 32 * 4
                   + 32 * 4) + 2 * 2 * 32 * 128 * 4),
    (32, 512, WHISPER, 2, (2, 2), "ring", 4, 4, True,
     128 + 42_240 + 4 * 2 * 32 * 128 * 2),
    (32, 512, WHISPER, 2, (4, 2), "ring", 4, 2, True,
     128 + 42_240 + 2 * 32 * 128 * 6),
    (64, 384, 384 * 401, 2, (4, 4), "ring", 8, 2, True, 111_104),
    (64, 256, 256, 2, (4, 4), "ring", 4, 4, True, 199_168),
    # a group of 1024 at 32 nodes: clusters of 8 (the old stream shape)
    (32, 1024, 1024 * 201, 2, (4, 4), "ring", 8, 2, True, 108_928),
    # the stream route: the n scales, then a slab of 512 columns' deq or
    # the widest fewer that fits half an SM (116,224 bytes)
    (32, 4096, 4096 * 8898, 2, (4, 4), "stream", None, None, None,
     (32 + 32 * 512) * 4),
    (64, 4096, 4096 * 51, 2, (4, 4), "stream", None, None, None,
     (64 + 64 * 256) * 4),
    (64, 36_448_128, 36_448_128, 1, (4, 4), "stream", None, None, None,
     (64 + 64 * 256) * 4),
    # past 64 nodes: clusters of 8 blocks of 32 columns; n = 128 reads W
    # from device memory, n = 96 takes a whole SM for W and 4 stages
    (65, 256, 256 * 10, 2, (4, 4), "ring", 8, 3, True, 106_624),
    (96, 256, 256 * 10, 2, (4, 4), "ring", 8, 4, True, 203_392),
    (128, 256, 256 * 10, 2, (4, 4), "ring", 8, 2, False,
     128 + _pad128(128 + 2 * 128 * 32 * 4 + 2 * 8 * 128 * 4 + 128 * 4)
     + 2 * 2 * 128 * 32 * 4),
    (64, 256, 256, 15, (4, 4), "ring", 4, 2, False, 100_864),
    (200, 4096, 4096 * 5, 2, (4, 4), "stream", None, None, None,
     (200 + 200 * 128) * 4),
    (1000, 256, 256, 1, (4, 4), "stream", None, None, None,
     (1000 + 1000 * 16) * 4)])
def test_launch_geometry_picks_the_route_from_shapes(n, group, D, R, nb,
                                                     route, cluster, stages,
                                                     w_smem, smem):
    """The first design where it applies (n <= 16, a power-of-two group
    <= 256); else the ring, a tile of n rows x cols columns of at most 256
    units of 4 x 4 for the 256 threads (512 at two units a thread): a lone
    block takes whole groups, a cluster of 2, 4 or 8 blocks splits one,
    whichever comes first that fits in f32; else the stream route (a slab
    of up to 512 columns' deq in shared memory, W^T's rows padded to 16).
    bf16 changes the stages and bytes, never the tile."""
    geo = quantized_gossip.launch_geometry(n, group, D, R, *nb)
    assert geo["route"] == route and geo["smem"] == smem
    assert geo["smem"] <= quantized_gossip.MAX_SHARED_BYTES
    if route == "ring":
        assert (geo["cluster"], geo["stages"], geo["w_smem"]) == (
            cluster, stages, w_smem)
        n4 = -(-n // 4) * 4
        units = n4 // 4 * geo["cols"] // 4
        assert units <= 256 * geo["units"]
        assert geo["cols"] * cluster == group if cluster > 1 else \
            geo["cols"] % group == 0
        f32 = quantized_gossip.launch_geometry(n, group, D, R)
        assert {k: f32[k] for k in ("units", "cluster", "cols")} == {
            k: geo[k] for k in ("units", "cluster", "cols")}
        if geo["blocks_per_sm"] == 2:
            assert smem <= quantized_gossip.SM_SHARED_BYTES // 2 - 1024
    if route == "stream":
        assert geo["smem"] == (-(-n // 4) * 4 + n * geo["slab"]) * 4
        assert geo["npad"] == -(-n // 16) * 16


def test_launch_geometry_names_a_route_on_request():
    """The private ``_geometry`` takes a named route where that route can
    take the shapes (the card tests and the smoke hold the routes against
    one another through ``_launch_route``), and raises where it cannot;
    ``_launch_route`` launches CUDA tensors only.  The public
    launch_geometry and quantized_gossip_mix take no route."""
    geo = quantized_gossip._geometry
    assert geo(16, 256, 256 * 999, 2, 4, 4, "ring")["cluster"] == 1
    assert geo(16, 256, 256 * 999, 2, 4, 4, "stream")["npad"] == 16
    assert geo(32, 512, WHISPER, 2, 4, 4, "stream")["route"] == "stream"
    with pytest.raises(ValueError, match="regs route takes"):
        geo(17, 256, 256, 2, 4, 4, "regs")
    with pytest.raises(ValueError, match="no ring tile"):
        geo(32, 4096, 4096, 2, 4, 4, "ring")
    with pytest.raises(ValueError, match="unknown route"):
        geo(4, 256, 256, 2, 4, 4, "tile")
    ws, z = torch.eye(4)[None], torch.zeros(4, 256)
    with pytest.raises(ValueError, match="unknown route"):
        quantized_gossip._launch_route(ws, z, z, "tile", scheme="sign")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        quantized_gossip._launch_route(ws, z, z, "ring", scheme="sign")
    for public in (quantized_gossip.launch_geometry,
                   quantized_gossip.quantized_gossip_mix):
        assert "route" not in inspect.signature(public).parameters


def test_launch_geometry_refuses_what_no_route_takes():
    """Any n whose column fits shared memory is taken now (n = 65 and a W
    stack past shared memory among them); what is left: so many nodes that
    one column's deq and scales do not fit, and shapes that are not
    positive."""
    for n, R in ((65, 1), (64, 15), (4096, 1)):
        quantized_gossip.launch_geometry(n, 256, 256, R)
    with pytest.raises(ValueError, match="shared-memory limit"):
        quantized_gossip.launch_geometry(30_000, 256, 256, 1)
    with pytest.raises(ValueError, match="must be positive"):
        quantized_gossip.launch_geometry(0, 256, 256, 1)


@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("xdt,rdt", [(F32, BF16), (BF16, BF16), (BF16, F32)])
def test_fused_consensus_on_bf16_streams_equals_the_upcast_path(xdt, rdt,
                                                                scheme):
    """``fused_quantized_consensus`` mixes a bf16 stream or residual as it
    is stored (the kernel on the card, its plain version here) where it
    used to mix f32 copies and cast them back: the same bits, written in
    place, dtypes kept."""
    n, D, group = 8, 4 * 64, 64
    rng = np.random.default_rng(7)
    mat = torch.from_numpy(rng.standard_normal((n, D)).astype(
        np.float32)).to(xdt)
    res = torch.from_numpy((0.1 * rng.standard_normal((n, D))).astype(
        np.float32)).to(rdt)
    Ws = torch.from_numpy(jgossip.theorem3_weight_schedule(
        n, 1 - 1 / n).stacked(0, 2).astype(np.float32))
    cfg = compress.CompressionConfig(scheme=scheme, group=group)
    # the old path: f32 copies through the kernel, copied back
    m32 = mat.to(torch.float32, copy=True)
    r32 = res.to(torch.float32, copy=True)
    quantized_gossip.quantized_gossip_mix(
        Ws, m32, r32, scheme=scheme, group=group, out=m32, res_out=r32)
    want_m, want_r = m32.to(xdt), r32.to(rdt)
    ptrs = (mat.data_ptr(), res.data_ptr())
    got_m, got_r = coll.fused_quantized_consensus(Ws, mat, res, cfg, True)
    assert (got_m.data_ptr(), got_r.data_ptr()) == ptrs
    assert got_m.dtype == xdt and got_r.dtype == rdt
    assert torch.equal(got_m, want_m) and torch.equal(got_r, want_r)


def _to_mat(tree_, layout, n):
    """A reference state tree as the port's (n, D) matrix, zero in the
    padding columns."""
    want = {tuple(k.key for k in p): np.asarray(leaf) for p, leaf
            in jax.tree_util.tree_leaves_with_path(tree_)}
    mat = np.zeros((n, layout.size), np.float32)
    for path, shape, off in layout.entries:
        mat[:, off:off + int(np.prod(shape))] = want[path].reshape(n, -1)
    return mat


def _trainer_32(aux_dtype=None):
    """Warm start + 2 MC-DSGT (R = 2) steps of a tiny whisper-tiny (d_model
    32, 1 + 1 layers, 8 frames) on 32 nodes with int8 gossip in groups of
    512 through both packages' ``make_train_step`` (the port's ``pallas``
    route, the reference's dense compressed mixer), from the same weights
    and batches (seeded numpy), losses held at STEP_RTOL.  Returns (port
    state, reference state, layout, padding columns)."""
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
        compression=jcomp,
        aux_dtype=None if aux_dtype is None else jnp.bfloat16)
    jwarm, jstep = _jit(jwarm), _jit(jstep)
    init, warm, step = steps.make_train_step(
        model, None, algo="mc_dsgt", gamma=0.1, R=R, gossip_impl="pallas",
        compression=comp, aux_dtype=aux_dtype)
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
    return ts, js, layout, pad, n


def test_compressed_trainer_at_32_nodes_matches_reference():
    """:func:`_trainer_32` in f32: x, h, g⁻ and both residuals within
    STEP_RTOL/STEP_ATOL but for STEP_FLIPS of the entries; the padding
    columns stay zero."""
    ts, js, layout, pad, n = _trainer_32()
    for what, got, jtree in (("x", ts.x, js.x), ("h", ts.h, js.h),
                             ("g_prev", ts.g_prev, js.g_prev),
                             ("res_x", ts.res[0], js.res[0]),
                             ("res_h", ts.res[1], js.res[1])):
        got = got.numpy()
        assert not got[:, pad].any(), what
        bad = _flips(got, _to_mat(jtree, layout, n), STEP_RTOL, STEP_ATOL)
        assert bad <= STEP_FLIPS * got.size, (what, bad)


def test_compressed_trainer_at_32_nodes_with_bf16_aux_matches_reference():
    """:func:`_trainer_32` with ``aux_dtype`` bf16, as the reference's
    ``launch/hillclimb.py`` reaches it: x in f32 with a bf16 residual, h,
    g⁻ and h's residual in bf16, each mixed as it is stored (the path the
    card takes through the kernel's bf16 loads and rounding stores).  As
    tests/test_torch_rules.py holds bf16 trackers: h, g⁻ and both residuals
    at rtol BF16_RTOL and an atol of BF16_RTOL x the leaf's largest
    |value|, x within γ times that of the largest tracker entry; each but
    for STEP_FLIPS of the entries (an int8 decision a bf16 ulp can flip);
    the padding columns stay zero."""
    ts, js, layout, pad, n = _trainer_32(torch.bfloat16)
    assert ts.x.dtype == torch.float32
    assert ts.h.dtype == ts.g_prev.dtype == torch.bfloat16
    assert ts.res[0].dtype == ts.res[1].dtype == torch.bfloat16
    hmax = float(ts.h.float().abs().max())
    for what, got, jtree in (("x", ts.x, js.x), ("h", ts.h, js.h),
                             ("g_prev", ts.g_prev, js.g_prev),
                             ("res_x", ts.res[0], js.res[0]),
                             ("res_h", ts.res[1], js.res[1])):
        got = got.float().numpy()
        assert not got[:, pad].any(), what
        want = _to_mat(jtree, layout, n)
        bad = 0
        for _, shape, off in layout.entries:
            cols = slice(off, off + int(np.prod(shape)))
            w = want[:, cols]
            if what == "x":
                rtol, atol = STEP_RTOL, STEP_ATOL + 0.1 * hmax * BF16_RTOL
            else:
                rtol = BF16_RTOL
                atol = STEP_ATOL + BF16_RTOL * float(np.abs(w).max())
            bad += _flips(got[:, cols], w, rtol, atol)
        assert bad <= STEP_FLIPS * got.size, (what, bad)
