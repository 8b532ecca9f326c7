"""The port's CUDA kernels on the card: the cases ``chip_smoke.py`` does not
cover.  Its kernel check holds ``gossip_mix`` to its plain version at n 4
to 300, R 1/2/4 and both dtypes; here are n = 4 to 300 at R up to 8 on
both walks (n = 300 with W^T in chunks and its rows in two TMA boxes),
each fill (TMA, element copies), in place, the inputs it refuses, and the
engine's stale window (``delay``) mixing its slots through the kernel.  For ``quantized_gossip_mix`` (held to
its plain version by ``chip_smoke.py`` at n 4/16 on its regs route and at n
17 to 200 on its ring and stream routes, both schemes, EF on and off): its
largest n and W stack on the regs route, the one-column path that rows
without 16-byte alignment take, each wide route at narrow and wide groups
(a rerun and in place bit-equal), the ring's int8 bits equal to the regs
route's, bf16 x and/or res on every route equal to the f32 launch on
upcast copies, n = 65, 96 and 128 at a reduced D, and its refusals (f64,
f16, a column too large for shared memory, a route named where it cannot
take the shapes).  For
``sparse_segment_mix`` (held to its plain version by ``chip_smoke.py`` over
E, D, S, padding, bf16, U around the staging limit and the sampled-client
path's rounds): both variants on a state whose rows are not 16-byte
aligned, in f32 and bf16 and at a ragged D, reruns giving the same bits,
the two variants giving the same bits, and the refusals.  For
``linear_recurrence`` (held bit-equal to its plain version by
``chip_smoke.py`` at small and ragged shapes, the main shapes and the
serve paths' own inputs): a large B·C whose S is not a multiple of the
loop's 8-step load batch, in f32 and bf16, inputs that are not 16-byte
aligned, each of its three routes (the TMA ring, the cp.async ring, the
loop) at recurrentgemma-2b's C and a ragged one, and its refusals.  For ``flash_attention`` and ``decode_attention``
(held to their plain versions by ``chip_smoke.py`` at small, ragged-head and
masked cases and at the qwen1.5-0.5b serve path's shapes): yi-6b's heads (32
query heads over 4 KV heads of 128, G = 8) with the window off and on,
inputs that are not contiguous, and their refusals; for the bf16
tensor-core route of ``flash_attention``, every head_dim at Sq 16, 128 and
384 with G 1 and 4, a window, rows with no valid key, reruns bit-equal, and
a bf16 call it refuses that no other kernel serves; both kernels at the
yi-6b and minitron-4b serve paths' shapes (head_dim 128: 32 query heads
over 4 KV heads and 24 over 8, a 1920-token prefill, a 2048-slot cache) in
both dtypes, and at nemotron-4-340b's (head_dim 192: 96 query heads over 8
KV heads, G = 12) in both dtypes; for ``decode_attention``, clusters of 1,
2 and 8 blocks, caches whose splits hold no valid slot, reruns bit-equal,
and G past 16 (17 to 48 query rows a KV head at every head_dim), each row
group bit-equal to its rows launched alone.  At recurrentgemma-2b's
head_dim 256 (held at its serve shapes by ``chip_smoke.py``): the f32 flash
kernel at a sequence that is not a multiple of the window, decode split
over the most blocks a cluster takes in both dtypes, and both wrappers
refusing head_dims the JAX kernels take (48, 96, 160, 320) before any
launch.

These need an NVIDIA GPU and skip elsewhere; the file imports neither jax
nor the JAX package, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gossip  # noqa: E402
from repro_torch.kernels import gossip_matmul, quantized_gossip, ref  # noqa: E402
from repro_torch.kernels import linear_recurrence, sparse_gossip  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,R,D,offset", [
    (4, 2, 4_097, 0), (4, 2, 4_096, 0), (16, 4, 4_096, 0), (16, 4, 4_097, 0),
    (32, 2, 10_000, 0), (32, 2, 10_001, 0), (32, 2, 10_000, 1),
    (33, 3, 4_097, 0), (64, 8, 4_097, 0), (65, 2, 4_096, 0),
    (128, 2, 4_096, 0), (200, 4, 4_097, 0), (300, 2, 1_000, 0)])
def test_gossip_mix_kernel_matches_plain(n, R, D, offset, dtype):
    """n from 4 to 300 on both walks (300 streams W^T in chunks of its rows
    and stages its rows in two TMA boxes), each fill: TMA and element
    copies (a ragged D, or rows ``offset`` values off 16-byte alignment),
    out of place and in place."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    ws = torch.from_numpy(
        gossip.theorem3_weight_schedule(n, 1 - 1 / n).stacked(0, R)).cuda()
    flat = torch.from_numpy(np.random.default_rng(2).standard_normal(
        n * D + offset).astype(np.float32)).cuda().to(dtype)
    x = flat[offset:].view(n, D)
    geo = gossip_matmul.launch_geometry(n, D, R, x.element_size())
    assert geo["wp"] == (n < 300)
    if n >= 300:
        assert geo["kc"] < n and geo["boxes"] == 2

    def mix(**kw):
        return gossip_matmul.gossip_mix(ws, x, **kw)
    want = ref.gossip_mix_ref(ws, x)
    before = gossip_matmul.gossip_mix.launches
    got = mix()
    torch.cuda.synchronize()
    assert gossip_matmul.gossip_mix.launches == before + 1
    # f32: n products summed in another order; bf16: one output rounding
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    mix(out=x)   # in place
    torch.cuda.synchronize()
    assert torch.equal(x, got)


@pytest.mark.cuda
@pytest.mark.parametrize("delay", [1, 2])
def test_delayed_window_through_gossip_mix(delay):
    """4 delayed MC-DSGT steps (n = 4, R = 2, D = 4,097, a quadratic
    oracle) whose windows mix the stale slots through ``gossip_mix`` (2
    launches a step) against the same steps on the CPU, where the wrapper
    runs its plain version: x, h and every stale slot at rtol = atol = 1e-5
    (sums of 4 products in another order, carried over 4 steps)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.core import engine
    from repro_torch.dist import collectives as coll

    n, R, D, steps = 4, 2, 4_097, 4
    rng = np.random.default_rng(3)
    x0, target = (rng.standard_normal((n, D)).astype(np.float32)
                  for _ in range(2))
    ws = gossip.theorem3_weight_schedule(n, 0.75).stacked(0, steps * 2 * R)
    rule = engine.make_rule("mc_dsgt", 0.1, R, delay=delay)

    def run(device):
        c = torch.from_numpy(target).to(device)
        W = torch.from_numpy(ws).to(device)
        state = engine.init_state(rule, torch.from_numpy(x0).to(device))
        for k in range(-1, steps):
            ops = engine.EngineOps(
                mix=lambda off, r, mat: coll.fused_multi_consensus(
                    W[k * 2 * R + off:k * 2 * R + off + r], mat),
                grad=lambda x, out=None: (None, torch.sub(x, c, out=out)))
            state = (engine.warm_start(rule, state, ops) if k < 0
                     else engine.step(rule, state, ops)[0])
        return state

    before = gossip_matmul.gossip_mix.launches
    got = run("cuda")
    torch.cuda.synchronize()
    assert gossip_matmul.gossip_mix.launches == before + 2 * steps
    want = run("cpu")
    pairs = [(got.x, want.x), (got.h, want.h)]
    pairs += list(zip(got.buf[0] + got.buf[1], want.buf[0] + want.buf[1]))
    assert len(pairs) == 2 + 2 * delay
    for a, b in pairs:
        torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_gossip_mix_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    with pytest.raises(ValueError, match="contiguous"):
        gossip_matmul.gossip_mix(torch.eye(65, device="cuda")[None],
                                 torch.zeros(65, 16, device="cuda")[:, ::2])
    with pytest.raises(TypeError):
        gossip_matmul.gossip_mix(torch.eye(4, device="cuda")[None],
                                 torch.zeros(4, 8, device="cuda",
                                             dtype=torch.float16))


def _qgm_inputs(n, R, D, offset=0):
    """ws, x, res on the card; ``offset`` floats of slack before x and res
    (1 = rows only 4-byte aligned: the kernel's one-column path)."""
    rng = np.random.default_rng(n * 100 + R)
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(
        n, 1 - 1 / n).stacked(0, R)).cuda()

    def mat(scale):
        a = torch.from_numpy((scale * rng.standard_normal(n * D + offset))
                             .astype(np.float32)).cuda()
        return a[offset:].view(n, D)
    return ws, mat(1.0), mat(0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,R,group,offset", [(16, 12, 256, 0),
                                              (16, 3, 1, 0),
                                              (4, 2, 64, 1)])
def test_quantized_gossip_mix_kernel_matches_plain(scheme, n, R, group,
                                                   offset):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    D = 3 * 4096 + group * 5            # the last block is partial
    ws, x, res = _qgm_inputs(n, R, D, offset)
    kw = dict(scheme=scheme, group=group)
    before = quantized_gossip.quantized_gossip_mix.launches
    o1, r1 = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
    o2, r2 = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
    torch.cuda.synchronize()
    assert quantized_gossip.quantized_gossip_mix.launches == before + 2
    # fixed-order reductions, no atomics: a rerun gives the same bits
    assert torch.equal(o1, o2) and torch.equal(r1, r2)
    want_o, want_r = ref.quantized_gossip_mix_ref(ws, x, res, **kw)
    # f32 sums in another order (cuBLAS vs the kernel's FMA chain) move a
    # value by ulps; past round 1 that can flip one quantization of an
    # entry, so up to 1e-3 of the entries may differ by more.  A flip moves
    # an int8 entry by one step of its group, and each later round can
    # carry it on and flip once more: max(1, 2R - 3) steps, a step at most
    # (max|x| + R max|res|) / 127 over the group's columns of all nodes
    # (stochastic W mixes convex combinations; a round adds at most half a
    # step to |x + res|).
    tol = 1e-5

    def group_max(t):
        return t.abs().view(n, D // group, group).amax(dim=(0, 2))
    limit = (max(1, 2 * R - 3) * (group_max(x) + R * group_max(res)) / 127
             ).repeat_interleave(group) + tol
    for got, want in ((o1, want_o), (r1, want_r)):
        d = (got - want).abs()
        bad = d > tol + tol * want.abs()
        assert int(bad.sum()) <= 1e-3 * bad.numel(), int(bad.sum())
        if scheme == "int8":
            assert bool((d <= limit).all()), float((d / limit).max())
    # error feedback: deq + res = x + res in every round and W is
    # column-stochastic, so every column's node sum of x + res is kept
    # whatever flips (float64 sums)
    torch.testing.assert_close((o1.double() + r1.double()).sum(0),
                               (x.double() + res.double()).sum(0),
                               rtol=tol, atol=tol)


@pytest.mark.cuda
def test_quantized_gossip_mix_kernel_refuses_what_it_cannot_take():
    """Since slice 17 the kernel takes any n whose column fits shared
    memory, bf16 x and res, and any W stack; it still refuses other dtypes,
    a D that is not a multiple of the group, inputs that are not
    contiguous, so many nodes that a column does not fit, and a route named
    where it cannot take the shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    qgm = quantized_gossip.quantized_gossip_mix
    z = lambda n, D, **kw: torch.zeros(n, D, device="cuda", **kw)  # noqa: E731
    eye = lambda n: torch.eye(n, device="cuda")[None]  # noqa: E731
    with pytest.raises(TypeError, match="f32 or bf16"):
        qgm(eye(4), z(4, 512, dtype=torch.float64),
            z(4, 512, dtype=torch.float64), scheme="int8", group=512)
    with pytest.raises(TypeError, match="f32 or bf16"):
        qgm(eye(4), z(4, 256, dtype=torch.float16), z(4, 256),
            scheme="sign")
    with pytest.raises(ValueError, match="shared-memory limit"):
        qgm(torch.zeros(1, 1, 1, device="cuda").expand(1, 30_000, 30_000),
            z(30_000, 256), z(30_000, 256), scheme="sign")
    with pytest.raises(ValueError, match="multiple of group"):
        qgm(eye(4), z(4, 300), z(4, 300), scheme="sign", group=256)
    with pytest.raises(ValueError, match="contiguous"):
        qgm(eye(4), z(4, 512)[:, ::2], z(4, 256), scheme="sign")
    named = quantized_gossip._launch_route
    with pytest.raises(ValueError, match="regs route takes"):
        named(eye(17), z(17, 256), z(17, 256), "regs", scheme="sign")
    with pytest.raises(ValueError, match="unknown route"):
        named(eye(4), z(4, 256), z(4, 256), "tile", scheme="sign")


def _qgm_check_wide(n, R, group, D, scheme, ef, ws, x, res):
    """One launch of a wide shape against the plain version (R = 1 within
    rtol = atol = 1e-5, int8's residual exactly; from R = 2 on up to 1e-3
    of the entries flipped; with error feedback the node sums of x + res
    kept), a rerun and in place giving the same bits."""
    kw = dict(scheme=scheme, group=group, error_feedback=ef)
    o1, r1 = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
    o2, r2 = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
    xi, ri = x.clone(), res.clone()
    quantized_gossip.quantized_gossip_mix(ws, xi, ri, out=xi, res_out=ri,
                                          **kw)
    torch.cuda.synchronize()
    assert torch.equal(o1, o2) and torch.equal(r1, r2)
    assert torch.equal(xi, o1) and torch.equal(ri, r1)
    want_o, want_r = ref.quantized_gossip_mix_ref(ws, x, res, **kw)
    tol = 1e-5
    if R == 1:
        torch.testing.assert_close(o1, want_o, rtol=tol, atol=tol)
        if scheme == "int8" or not ef:
            assert torch.equal(r1, want_r)
        else:
            torch.testing.assert_close(r1, want_r, rtol=tol, atol=tol)
    for got, want in ((o1, want_o), (r1, want_r)):
        bad = (got - want).abs() > tol + tol * want.abs()
        assert int(bad.sum()) <= 1e-3 * bad.numel(), int(bad.sum())
    if ef:
        torch.testing.assert_close((o1.double() + r1.double()).sum(0),
                                   (x.double() + res.double()).sum(0),
                                   rtol=tol, atol=tol)
    return o1, r1


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,R,group,D,route", [
    (17, 3, 384, 384 * 1001, "ring"),       # clusters of 2 blocks of 192
    (64, 2, 96, 96 * 333, "ring"),          # clusters of 2 blocks of 48
    (32, 2, 512, 512 * 4001, "ring"),       # whisper-tiny's 32-node shape
    (64, 1, 4096, 4096 * 33, "stream"),
    (32, 4, 1024, 1024 * 129, "ring")])     # clusters of 8 (PR 28: stream)
def test_quantized_gossip_mix_wide_routes_match_plain(scheme, n, R, group, D,
                                                      route):
    """The ring and stream routes (n past 16, groups that are not powers
    of two or wider than 256): launch_geometry names the route; against
    the plain version as _qgm_check_wide holds it, error feedback on and
    off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    assert quantized_gossip.launch_geometry(n, group, D, R)["route"] == route
    ws, x, res = _qgm_inputs(n, R, D)
    for ef in (True, False):
        _qgm_check_wide(n, R, group, D, scheme, ef, ws, x, res)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,group,D", [(17, 3072, 3072 * 41),
                                       (128, 512, 512 * 61)])
def test_quantized_gossip_mix_ring_two_units_match_plain(scheme, n, group,
                                                         D):
    """The ring with two units a thread (tiles of more than 256 units):
    n = 17 in clusters of 8 blocks of 384 columns (96 column groups, so a
    thread's two units lie in different columns) and n = 128 in clusters of
    8 blocks of 64, against the plain version as _qgm_check_wide holds it,
    R 1 and 2, EF on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    for R in (1, 2):
        geo = quantized_gossip.launch_geometry(n, group, D, R)
        assert (geo["route"], geo["units"]) == ("ring", 2)
        ws, x, res = _qgm_inputs(n, R, D)
        for ef in (True, False):
            _qgm_check_wide(n, R, group, D, scheme, ef, ws, x, res)


@pytest.mark.cuda
@pytest.mark.parametrize("n,group,D", [(16, 256, 256 * 4001),
                                       (4, 64, 64 * 16_001),
                                       (8, 128, 128 * 8001)])
def test_quantized_gossip_mix_ring_int8_equals_regs_route(n, group, D):
    """Where the regs route takes a shape, the ring (launched by name)
    gives its bits in int8 (a max and the mix's FMA chain in the same
    order), and so does the stream route; R 1 and 2, EF on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    for R in (1, 2):
        ws, x, res = _qgm_inputs(n, R, D)
        for ef in (True, False):
            kw = dict(scheme="int8", group=group, error_feedback=ef)
            outs = {route: quantized_gossip._launch_route(
                ws, x, res, route, **kw)
                for route in ("regs", "ring", "stream")}
            torch.cuda.synchronize()
            for route in ("ring", "stream"):
                assert all(torch.equal(a, b) for a, b in
                           zip(outs[route], outs["regs"])), (route, R, ef)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,rdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("n,group,D,route", [
    (4, 256, 256 * 4001, "regs"), (32, 512, 512 * 601, "ring"),
    (4, 3, 3 * 20_001, "ring"), (64, 4096, 4096 * 11, "stream"),
    (96, 256, 256 * 201, "ring")])
def test_quantized_gossip_mix_bf16_equals_f32_on_upcast_copies(n, group, D,
                                                               route, xdt,
                                                               rdt):
    """bf16 x and/or res, on each route: the f32 launch's bits on upcast
    copies, cast back (bf16 widened as read, rounded to nearest even as
    stored), both schemes, EF on and off, R = 2; in place and a rerun the
    same bits.  (4, 3) has rows that are not 4-byte aligned in bf16: the
    ring's plain-copy fill."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    R = 2
    ws, x0, r0 = _qgm_inputs(n, R, D)
    x, res = x0.to(xdt), r0.to(rdt)
    assert quantized_gossip.launch_geometry(
        n, group, D, R, x.element_size(), res.element_size())["route"] == route
    for scheme in ("sign", "int8"):
        for ef in (True, False):
            kw = dict(scheme=scheme, group=group, error_feedback=ef)
            o, r = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
            o32, r32 = quantized_gossip.quantized_gossip_mix(
                ws, x.float(), res.float(), **kw)
            xi, ri = x.clone(), res.clone()
            quantized_gossip.quantized_gossip_mix(ws, xi, ri, out=xi,
                                                  res_out=ri, **kw)
            o2, r2 = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
            torch.cuda.synchronize()
            assert o.dtype == xdt and r.dtype == rdt
            assert torch.equal(o, o32.to(xdt)) and torch.equal(r, r32.to(rdt))
            assert torch.equal(xi, o) and torch.equal(ri, r)
            assert torch.equal(o2, o) and torch.equal(r2, r)


@pytest.mark.cuda
@pytest.mark.parametrize("scheme", ["sign", "int8"])
@pytest.mark.parametrize("n,group,route", [(65, 256, "ring"),
                                           (96, 256, "ring"),
                                           (128, 256, "ring"),
                                           (128, 2048, "stream")])
def test_quantized_gossip_mix_past_64_nodes_matches_plain(scheme, n, group,
                                                          route):
    """Past 64 nodes at a reduced D: the ring (W in shared memory at 65 and
    96, read from device memory at 128) and the stream route (128 nodes,
    group 2048), against the plain version as
    _qgm_check_wide holds it, R 1 and 2, EF on and off."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    D = group * 61
    for R in (1, 2):
        assert quantized_gossip.launch_geometry(n, group, D,
                                                R)["route"] == route
        ws, x, res = _qgm_inputs(n, R, D)
        for ef in (True, False):
            _qgm_check_wide(n, R, group, D, scheme, ef, ws, x, res)


def _sparse_round(n, D, E, S, ids, dtype, seed):
    """A round on an (n, D) state whose rows are only element-aligned (one
    value of slack before them), edges between ``ids`` of the n nodes, and
    a gossip round's weights: each receiver's sum below 1 (Metropolis), so
    partial sums stay of the order of x."""
    rng = np.random.default_rng(seed)
    flat = torch.from_numpy(rng.standard_normal(n * D + 1).astype(
        np.float32)).cuda().to(dtype)
    x = flat[1:].view(n, D)
    pick = torch.from_numpy(rng.choice(n, ids, replace=False)).cuda()
    src = pick[torch.from_numpy(rng.integers(0, ids, E)).cuda()]
    dst = pick[torch.from_numpy(rng.integers(0, ids, E)).cuda()]
    seg = torch.from_numpy(rng.integers(0, S, E)).cuda()
    w = torch.from_numpy(rng.random(E).astype(np.float32)).cuda()
    w = w / (torch.zeros(S, device="cuda").index_add_(0, seg, w)[seg] + 0.5)
    return x, src, dst, w, seg


def _variant_launches(x, layout, variant):
    """Two calls, which must launch ``variant`` twice and nothing else."""
    counts = sparse_gossip.sparse_segment_mix.variants
    before, launches = dict(counts), sparse_gossip.sparse_segment_mix.launches
    a = sparse_gossip.sparse_segment_mix(x, *layout)
    b = sparse_gossip.sparse_segment_mix(x, *layout)
    torch.cuda.synchronize()
    assert sparse_gossip.sparse_segment_mix.launches == launches + 2
    assert {k: counts[k] - before[k] for k in counts} == {
        variant: 2, **{k: 0 for k in counts if k != variant}}
    return a, b


@pytest.mark.cuda
def test_sparse_segment_mix_kernel_unaligned_rerun_and_refusals():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    n, D, E, S = 5_000, 784, 20_000, 256
    # ids from all 5,000 nodes: more rows than the staged variant takes
    x, src, dst, w, seg = _sparse_round(n, D, E, S, n, torch.float32, 3)
    layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
    assert layout.rows.numel() > sparse_gossip.max_staged_rows(x.dtype)
    a, b = _variant_launches(x, layout, "gather")
    assert torch.equal(a, b)    # each segment summed in one fixed order
    # f32 products summed in another order than index_add_'s atomics
    torch.testing.assert_close(
        a, ref.sparse_gossip_mix_ref(seg, w, x[src], x[dst], S),
        rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="int64"):
        sparse_gossip.sparse_segment_mix(x, layout[0].int(), *layout[1:])
    with pytest.raises(ValueError, match="int32"):
        sparse_gossip.sparse_segment_mix(x, *layout[:5], layout.lsrc.long(),
                                         layout.ldst)
    with pytest.raises(ValueError, match="int64"):
        sparse_gossip.sparse_segment_mix(x, *layout[:4], layout.rows.int(),
                                         *layout[5:])
    with pytest.raises(TypeError, match="f32 or bf16"):
        sparse_gossip.sparse_segment_mix(x.half(), *layout)
    with pytest.raises(ValueError, match="contiguous x"):
        sparse_gossip.sparse_segment_mix(x[:, ::2], *layout)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,ids", [("staged", 300), ("gather", 5_000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [784, 781])
def test_sparse_segment_mix_variants_unaligned_rerun(variant, ids, dtype, D):
    """Both variants on rows only element-aligned (the staged variant's
    4-byte copies in f32, 2-byte in bf16; the gather variant's one-column
    path) and on a ragged D: bit-equal reruns, and the two variants give the
    same bits on the same round."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    n, E, S = 5_000, 20_000, 256
    x, src, dst, w, seg = _sparse_round(n, D, E, S, ids, dtype, 7)
    layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
    a, b = _variant_launches(x, layout, variant)
    assert torch.equal(a, b)
    torch.testing.assert_close(
        a, ref.sparse_gossip_mix_ref(seg, w, x[src], x[dst], S),
        rtol=1e-5, atol=1e-5)
    if variant == "staged":
        # the same round through the gather variant: one order, one result
        geometry = sparse_gossip.launch_geometry
        try:
            sparse_gossip.launch_geometry = lambda *args: {
                "variant": "gather", "block": sparse_gossip.GATHER_THREADS}
            c = sparse_gossip.sparse_segment_mix(x, *layout)
        finally:
            sparse_gossip.launch_geometry = geometry
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_recurrence_kernel_is_bit_equal_to_plain(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(5)
    # aligned: the TMA ring, 37 steps a partial tile; the view below: the
    # cp.async ring in f32, the loop in bf16 (37 = 4 batches of its 8 steps
    # and 5 left over)
    B, S, C = 3, 37, 131_076
    a = torch.rand(B, S, C, device="cuda", generator=gen).to(dtype)
    b = torch.randn(B, S, C, device="cuda", generator=gen).to(dtype)
    before = linear_recurrence.linear_recurrence.launches
    h_all, h_last = linear_recurrence.linear_recurrence(a, b)
    want_all, want_last = ref.linear_recurrence_ref(a, b)
    # offset by one element (the cp.async ring or the loop): the same bits
    flat_a = torch.empty(B * S * C + 1, device="cuda", dtype=dtype)
    flat_b = torch.empty_like(flat_a)
    ua = flat_a[1:].view(B, S, C).copy_(a)
    ub = flat_b[1:].view(B, S, C).copy_(b)
    u_all, u_last = linear_recurrence.linear_recurrence(ua, ub)
    torch.cuda.synchronize()
    assert linear_recurrence.linear_recurrence.launches == before + 2
    # the product and the sum rounded separately in both: bit-equal
    for got in ((h_all, h_last), (u_all, u_last)):
        assert torch.equal(got[0], want_all) and torch.equal(got[1], want_last)


# (B, S, C, offset in elements, dtype, the route launch_geometry picks):
# recurrentgemma-2b's C over 5 tiles (the last one partial) and a C that is
# a multiple of 4 but not of 32 (bf16 rows not 16-byte strided: cp.async),
# each also as a view offset by one element (f32: cp.async; bf16 rows only
# 2-byte aligned: the loop)
LINREC_RING_CASES = [
    (1, 300, 2560, 0, torch.float32, "tma"),
    (1, 300, 2560, 0, torch.bfloat16, "tma"),
    (3, 65, 2564, 0, torch.float32, "tma"),
    (3, 65, 2564, 0, torch.bfloat16, "cp.async"),
    (1, 300, 2560, 1, torch.float32, "cp.async"),
    (1, 300, 2560, 1, torch.bfloat16, "loop"),
    (3, 65, 2564, 1, torch.float32, "cp.async"),
    (3, 65, 2564, 1, torch.bfloat16, "loop"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,offset,dtype,route", LINREC_RING_CASES)
def test_linear_recurrence_ring_routes_are_bit_equal(B, S, C, offset, dtype,
                                                     route):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(B * S + C + offset)
    n = B * S * C + offset
    a = torch.rand(n, device="cuda", generator=gen).to(dtype)[offset:]
    b = torch.randn(n, device="cuda", generator=gen).to(dtype)[offset:]
    a, b = a.view(B, S, C), b.view(B, S, C)
    assert linear_recurrence.geometry_for(a, b)["route"] == route
    before = linear_recurrence.linear_recurrence.launches
    got = linear_recurrence.linear_recurrence(a, b)
    again = linear_recurrence.linear_recurrence(a, b)
    want = ref.linear_recurrence_ref(a, b)
    torch.cuda.synchronize()
    assert linear_recurrence.linear_recurrence.launches == before + 2
    # each step's product and sum rounded separately, in order: bit-equal,
    # and a rerun gives the same bits
    for g in (got, again):
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])


@pytest.mark.cuda
def test_linear_recurrence_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    a = torch.rand(2, 8, 64, device="cuda")
    with pytest.raises(TypeError, match="f32 or"):
        linear_recurrence.linear_recurrence(a.half(), a.half())
    with pytest.raises(TypeError, match="f32 or"):
        linear_recurrence.linear_recurrence(a, a.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        linear_recurrence.linear_recurrence(a[:, :, ::2], a[:, :, ::2])
    with pytest.raises(ValueError, match="on"):
        linear_recurrence.linear_recurrence(a, a.cpu())


# flash_attention and decode_attention: f32 sums in another order; bf16 as
# the JAX kernel tests allow (the kernel rounds p before normalising it, the
# plain version after).
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
YI = dict(H=32, KV=4, hd=128)           # configs/yi_6b.py's heads


def _cuda_normal(rng, shape, dtype):
    return torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).cuda().to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 200])
def test_flash_attention_kernel_at_yi_heads(dtype, window):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(11)
    B, S = 2, 640
    q = _cuda_normal(rng, (B, S, YI["H"], YI["hd"]), dtype)
    k = _cuda_normal(rng, (B, S, YI["KV"], YI["hd"]), dtype)
    v = _cuda_normal(rng, (B, S, YI["KV"], YI["hd"]), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    # a strided q (every other head of a wider tensor) is made contiguous
    wide = torch.stack([q, q], dim=3).view(B, S, 2 * YI["H"], YI["hd"])
    strided = flash_attention(wide[:, :, ::2], k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    want = ref.attention_ref(q, k, v, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    assert torch.equal(strided, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 300])
def test_decode_attention_kernel_at_yi_heads(dtype, window):
    """A ring that has wrapped (slot c holds position pos - C + 1 .. pos)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(12)
    B, C, pos = 3, 1024, 1500
    J, G, hd = YI["KV"], YI["H"] // YI["KV"], YI["hd"]
    q = _cuda_normal(rng, (B, 1, J, G, hd), dtype)
    k = _cuda_normal(rng, (B, C, J, hd), dtype)
    v = _cuda_normal(rng, (B, C, J, hd), dtype)
    base = pos - C + 1
    kpos = torch.from_numpy(((np.arange(C) - base % C) % C + base).astype(
        np.int32)).cuda()
    before = decode_attention.launches
    got = decode_attention(q, k, v, kpos, pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, kpos, pos, window=window)
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_take_unaligned_inputs(dtype):
    """The kernels read 16-byte vectors; a tensor that starts off that
    alignment (one element into a buffer) is copied by the wrapper, and the
    result is the same bits as from an aligned copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(13)

    def shifted(shape):
        flat = _cuda_normal(rng, (int(np.prod(shape)) + 1,), dtype)
        return flat[1:].view(shape)
    q, k, v = shifted((1, 256, 4, 64)), shifted((1, 256, 2, 64)), \
        shifted((1, 256, 2, 64))
    assert q.data_ptr() % 16 != 0
    torch.testing.assert_close(flash_attention(q, k, v),
                               flash_attention(q.clone(), k.clone(),
                                               v.clone()), rtol=0, atol=0)
    kpos = torch.arange(256, device="cuda", dtype=torch.int32)
    q1 = shifted((1, 1, 2, 2, 64))
    torch.testing.assert_close(
        decode_attention(q1, k, v, kpos, 255),
        decode_attention(q1.clone(), k.clone(), v.clone(), kpos, 255),
        rtol=0, atol=0)


@pytest.mark.cuda
def test_attention_kernels_refuse_what_they_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    def z(*shape, **kw):
        return torch.zeros(shape, device="cuda", **kw)
    with pytest.raises(TypeError, match="f32 or all bf16"):
        flash_attention(z(1, 128, 2, 64, dtype=torch.float16),
                        z(1, 128, 2, 64, dtype=torch.float16),
                        z(1, 128, 2, 64, dtype=torch.float16))
    with pytest.raises(TypeError, match="f32 or all bf16"):
        flash_attention(z(1, 128, 2, 64), z(1, 128, 2, 64),
                        z(1, 128, 2, 64, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(z(1, 128, 2, 96), z(1, 128, 2, 96), z(1, 128, 2, 96))
    with pytest.raises(ValueError, match="does not tile"):
        flash_attention(z(1, 200, 2, 64), z(1, 200, 2, 64), z(1, 200, 2, 64))
    kpos = torch.arange(256, device="cuda", dtype=torch.int32)
    with pytest.raises(TypeError, match="f32 or all bf16"):
        decode_attention(z(1, 1, 2, 1, 64, dtype=torch.float16),
                         z(1, 256, 2, 64, dtype=torch.float16),
                         z(1, 256, 2, 64, dtype=torch.float16), kpos, 0)
    with pytest.raises(TypeError, match="int32 kpos"):
        decode_attention(z(1, 1, 2, 1, 64), z(1, 256, 2, 64),
                         z(1, 256, 2, 64), kpos.long(), 0)
    with pytest.raises(ValueError, match="head_dim"):
        decode_attention(z(1, 1, 2, 1, 48), z(1, 256, 2, 48),
                         z(1, 256, 2, 48), kpos, 0)
    with pytest.raises(ValueError, match="does not tile"):
        decode_attention(z(1, 1, 2, 1, 64), z(1, 272, 2, 64),
                         z(1, 272, 2, 64),
                         torch.arange(272, device="cuda", dtype=torch.int32),
                         0)


def _flash_case(rng, B, Sq, Sk, H, KV, hd, causal, window):
    """flash_attention on the bf16 (tensor-core) route against its plain
    version, a rerun bit-equal, one launch per call."""
    q = _cuda_normal(rng, (B, Sq, H, hd), torch.bfloat16)
    k = _cuda_normal(rng, (B, Sk, KV, hd), torch.bfloat16)
    v = _cuda_normal(rng, (B, Sk, KV, hd), torch.bfloat16)
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal, window=window)
    again = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(
        got, ref.attention_ref(q, k, v, causal=causal, window=window),
        rtol=tol, atol=tol)
    assert torch.equal(got, again)
    return got, v


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("Sq", [16, 128, 384])
@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256])
def test_flash_attention_tensor_core_route(hd, Sq, G):
    """Every head_dim (its own TMA box and swizzle: 64 B at hd 32, 128 B at
    64, two boxes at 128, three and four boxes and 64-row tiles at 192 and
    256), a q-tile
    padded past Sq (16), one tile and three, MHA and G = 4, causal and
    not."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(hd + Sq + G)
    for causal in (True, False):
        _flash_case(rng, 2, Sq, Sq, 4 * G, 4, hd, causal, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [32, 64, 128, 192, 256])
def test_flash_attention_tensor_core_window_and_keyless_rows(hd):
    """A window off the 128-key tiles, and with Sq > Sk rows that have no
    valid key, which average v over all Sk keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(20 + hd)
    _flash_case(rng, 1, 512, 512, 4, 2, hd, True, 200)
    Sq, Sk, window = 384, 128, 64
    got, v = _flash_case(rng, 1, Sq, Sk, 4, 2, hd, True, window)
    rows = slice(Sk + window - 1, Sq)
    mean = v.float().mean(1).repeat_interleave(2, dim=1)
    torch.testing.assert_close(got[:, rows].float(),
                               mean[:, None].expand_as(got[:, rows]),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_flash_attention_bf16_refusal_is_not_served_by_the_f32_kernel():
    """The library's bf16 entry takes hd 32, 64, 128, 192 and 256 only: hd
    96 in bf16 returns an error and writes nothing (the SIMT kernel, which is
    for f32, does not take it over); the wrapper raises before it for both
    routes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import flash_attention as fa_mod
    x = torch.zeros(1, 128, 2, 96, device="cuda", dtype=torch.bfloat16)
    o = torch.full_like(x, 7.0)
    lib = fa_mod._lib()
    before = flash_attention.launches
    err = lib.flash_attention_launch(
        x.data_ptr(), x.data_ptr(), x.data_ptr(), o.data_ptr(), 1, 128, 128,
        2, 2, 96, 1, 0, 96 ** -0.5, 1,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err != 0
    assert torch.all(o == 7.0)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(x, x, x)
    assert flash_attention.launches == before


def _decode_case(rng, B, C, J, G, hd, kpos, pos, window=0):
    q = _cuda_normal(rng, (B, 1, J, G, hd), torch.bfloat16)
    k = _cuda_normal(rng, (B, C, J, hd), torch.bfloat16)
    v = _cuda_normal(rng, (B, C, J, hd), torch.bfloat16)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kpos, pos, window=window)
    again = decode_attention(q, k, v, kpos, pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 2
    tol = ATTN_TOL[torch.bfloat16]
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kpos, pos, window=window),
        rtol=tol, atol=tol)
    assert torch.equal(got, again)
    return got, v


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,J,splits", [(3, 64, 32, 1), (1, 128, 1, 2),
                                          (1, 2048, 16, 8), (3, 2048, 16, 2)])
def test_decode_attention_cluster_sizes(B, C, J, splits):
    """Clusters of 1, 2 and 8 blocks (the split the wrapper picks for these
    shapes on a 132-SM H100), B = 3, a full cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import decode_attention as da_mod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if sms == 132:
        assert da_mod.splits_for(B, J, C, sms, 64) == splits
    rng = np.random.default_rng(C + J)
    kpos = torch.arange(C, device="cuda", dtype=torch.int32)
    _decode_case(rng, B, C, J, 2, 64, kpos, C - 1)


@pytest.mark.cuda
@pytest.mark.parametrize("filled", [0, 200])
def test_decode_attention_empty_splits(filled):
    """A 2048-slot cache in 8 splits with only its first 200 slots filled
    (7 splits without a valid slot drop out), and with none (every split
    empty: the mean of v over all 2048 slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(filled)
    C = 2048
    c = torch.arange(C, device="cuda", dtype=torch.int32)
    kpos = torch.where(c < filled, c, -1).int()
    got, v = _decode_case(rng, 1, C, 16, 1, 64, kpos, max(filled - 1, 5))
    if not filled:
        torch.testing.assert_close(got[:, 0].float(), v.float().mean(1),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [256, 100])
def test_flash_attention_hd256_f32_window_off_the_sequence(window):
    """The f32 (SIMT) kernel at recurrentgemma's head_dim 256 and G = 10
    over one KV head, S = 640, which is not a multiple of the window:
    equal to its plain version at the f32 tolerance, a rerun bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(window)
    S, H, KV, hd = 640, 10, 1, 256
    assert S % window
    q = _cuda_normal(rng, (1, S, H, hd), torch.float32)
    k = _cuda_normal(rng, (1, S, KV, hd), torch.float32)
    v = _cuda_normal(rng, (1, S, KV, hd), torch.float32)
    before = flash_attention.launches
    got = flash_attention(q, k, v, window=window)
    again = flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 2
    tol = ATTN_TOL[torch.float32]
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, window=window),
                               rtol=tol, atol=tol)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_hd256_at_the_largest_split(dtype):
    """recurrentgemma's decode (one KV head, G = 10, hd 256) on a wrapped
    2048-slot ring with its 2048-token window, split over the most blocks a
    cluster takes (8): each block keeps its own state, so the kernel's
    shared memory does not grow with the split count and fits the 227 KB a
    block may use in both dtypes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import decode_attention as da_mod
    B, C, J, G, hd, window, pos = 1, 2048, 1, 10, 256, 2048, 4000
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert da_mod.splits_for(B, J, C, sms, hd) == da_mod.MAX_SPLITS == 8
    res = da_mod.resources(hd, dtype)
    assert res["static_smem"] + res["dynamic_smem"] <= 232_448
    assert res["local_bytes"] == 0
    rng = np.random.default_rng(hd)
    q = _cuda_normal(rng, (B, 1, J, G, hd), dtype)
    k = _cuda_normal(rng, (B, C, J, hd), dtype)
    v = _cuda_normal(rng, (B, C, J, hd), dtype)
    c = torch.arange(C, device="cuda")
    base = pos - C + 1
    kpos = ((c - base % C) % C + base).int()
    got = decode_attention(q, k, v, kpos, pos, window=window)
    torch.cuda.synchronize()
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kpos, pos, window=window),
        rtol=tol, atol=2e-3 if dtype == torch.bfloat16 else tol)
    assert torch.equal(got, decode_attention(q, k, v, kpos, pos,
                                             window=window))


@pytest.mark.cuda
def test_attention_wrappers_refuse_hd_96_which_the_reference_takes():
    """The JAX kernels take any head_dim; the port's kernels take 32, 64,
    128, 192 and 256, and a CUDA call at hd 96 raises, naming head_dim,
    before any launch (the plain version, the CPU route, takes it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 128, 2, 96, device="cuda", dtype=dtype)
        q1 = torch.zeros(1, 1, 2, 1, 96, device="cuda", dtype=dtype)
        kpos = torch.arange(128, device="cuda", dtype=torch.int32)
        before = (flash_attention.launches, decode_attention.launches)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(x, x, x)
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q1, x, x, kpos, 127)
        assert (flash_attention.launches, decode_attention.launches) == before
    cpu = torch.zeros(1, 128, 2, 96)
    assert flash_attention(cpu, cpu, cpu).shape == (1, 128, 2, 96)


# The slice-14 serve paths' shapes at head_dim 128 (chip_smoke.py FLASH_YI,
# FLASH_MT, DECODE_YI, DECODE_MT): (B, S, H, KV) prefills and (B, C, J, G)
# decodes.  bf16 outputs there average hundreds of keys (|o| ~0.03-0.05), so
# bf16 is held at chip_smoke.py's serve atol (SERVE_ATOL_BF16) with rtol 2e-2.
HD128_FLASH = [(1, 1920, 32, 4), (1, 1920, 24, 8)]
HD128_DECODE = [(1, 2048, 4, 8), (1, 2048, 8, 3)]
HD128_ATOL_BF16 = {"flash": 1e-2, "decode": 2e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,KV", HD128_FLASH, ids=["yi-6b", "minitron-4b"])
def test_flash_attention_at_the_hd128_serve_shapes(B, S, H, KV, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    rng = np.random.default_rng(S + H)
    q = _cuda_normal(rng, (B, S, H, 128), dtype)
    k = _cuda_normal(rng, (B, S, KV, 128), dtype)
    v = _cuda_normal(rng, (B, S, KV, 128), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    atol = HD128_ATOL_BF16["flash"] if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), rtol=tol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,C,J,G", HD128_DECODE,
                         ids=["yi-6b", "minitron-4b"])
def test_decode_attention_at_the_hd128_serve_shapes(B, C, J, G, dtype):
    """A full cache read at its last position, as the serve paths' last
    decode step reads it; SIMT route, 8 splits a (b, KV head)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import decode_attention as da_mod
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geometry = da_mod.launch_geometry(B, J, C, 128, dtype, sms, G)
    assert geometry["route"] == "simt"
    assert geometry["grid"] == (J * da_mod.splits_for(B, J, C, sms, 128), B,
                                1)
    rng = np.random.default_rng(C + J)
    q = _cuda_normal(rng, (B, 1, J, G, 128), dtype)
    k = _cuda_normal(rng, (B, C, J, 128), dtype)
    v = _cuda_normal(rng, (B, C, J, 128), dtype)
    kpos = torch.arange(C, device="cuda", dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kpos, C - 1)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    atol = HD128_ATOL_BF16["decode"] if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kpos, C - 1), rtol=tol,
        atol=atol)


# nemotron-4-340b's serve path's shapes (chip_smoke.py FLASH_NM, DECODE_NM):
# 96 query heads over 8 KV heads of 192 (G = 12), a 1920-token prefill and
# a full 2048-slot cache read at its last position.  bf16 is held at the
# serve atol, as at head_dim 128.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_nemotrons_hd_192(dtype):
    """Both kernels at nemotron-4-340b's published head_dim, 18,432 / 96 =
    192: one launch each, equal to the plain version (flash on 64-row
    tiles, bf16 on the tensor cores; decode split 8 ways, bf16 on its
    tensor-core route), a rerun bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as da_mod
    cfg = configs.get("nemotron-4-340b")
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (H, KV, hd) == (96, 8, 192)
    S, C = 1920, 2048
    rng = np.random.default_rng(192)
    q = _cuda_normal(rng, (1, S, H, hd), dtype)
    k = _cuda_normal(rng, (1, S, KV, hd), dtype)
    v = _cuda_normal(rng, (1, S, KV, hd), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(
        got, ref.attention_ref(q, k, v), rtol=tol,
        atol=HD128_ATOL_BF16["flash"] if bf16 else tol)
    assert torch.equal(got, flash_attention(q, k, v))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geometry = da_mod.launch_geometry(1, KV, C, hd, dtype, sms, H // KV)
    assert geometry["route"] == ("tensor cores" if bf16 else "simt")
    if sms == 132:
        assert geometry["grid"] == (64, 1, 1) and geometry["cluster"] == 8
    q1 = _cuda_normal(rng, (1, 1, KV, H // KV, hd), dtype)
    kc = _cuda_normal(rng, (1, C, KV, hd), dtype)
    vc = _cuda_normal(rng, (1, C, KV, hd), dtype)
    kpos = torch.arange(C, device="cuda", dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q1, kc, vc, kpos, C - 1)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q1, kc, vc, kpos, C - 1), rtol=tol,
        atol=HD128_ATOL_BF16["decode"] if bf16 else tol)
    assert torch.equal(got, decode_attention(q1, kc, vc, kpos, C - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [48, 96, 160, 320])
def test_attention_wrappers_refuse_hd_outside_the_five(hd):
    """A head_dim outside 32, 64, 128, 192 and 256 (the JAX kernels take
    any) raises on a CUDA tensor, naming head_dim, before any launch, in
    both dtypes and for both wrappers; no fallback serves it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.zeros(1, 128, 2, hd, device="cuda", dtype=dtype)
        q1 = torch.zeros(1, 1, 2, 12, hd, device="cuda", dtype=dtype)
        kpos = torch.arange(128, device="cuda", dtype=torch.int32)
        before = (flash_attention.launches, decode_attention.launches)
        with pytest.raises(ValueError, match="head_dim"):
            flash_attention(x, x, x)
        with pytest.raises(ValueError, match="head_dim"):
            decode_attention(q1, x, x, kpos, 127)
        assert (flash_attention.launches, decode_attention.launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd,G", [(64, 17), (64, 33), (128, 20), (192, 20),
                                  (192, 48), (256, 33), (32, 40)])
def test_decode_attention_row_groups_past_16(hd, G, dtype):
    """G > 16 query rows a KV head: one launch of ceil(G / 16) row groups,
    equal to the plain version on a wrapped ring with a window, each group's
    rows bit-equal to the same rows launched alone (a group of <= 16), a
    rerun bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import decode_attention as da_mod
    B, C, J, pos, window = 2, 1024, 2, 1500, 700
    rng = np.random.default_rng(hd + G)
    q = _cuda_normal(rng, (B, 1, J, G, hd), dtype)
    k = _cuda_normal(rng, (B, C, J, hd), dtype)
    v = _cuda_normal(rng, (B, C, J, hd), dtype)
    base = pos - C + 1
    kpos = torch.from_numpy(((np.arange(C) - base % C) % C + base).astype(
        np.int32)).cuda()
    before = decode_attention.launches
    got = decode_attention(q, k, v, kpos, pos, window=window)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kpos, pos, window=window),
        rtol=tol, atol=tol)
    assert torch.equal(got, decode_attention(q, k, v, kpos, pos,
                                             window=window))
    rows = got.view(B, 1, J, G, hd)
    step = da_mod.ROW_GROUP
    for g0 in range(0, G, step):
        g1 = min(G, g0 + step)
        alone = decode_attention(q[:, :, :, g0:g1], k, v, kpos, pos,
                                 window=window)
        assert torch.equal(rows[:, :, :, g0:g1],
                           alone.view(B, 1, J, g1 - g0, hd)), (g0, g1)


# The slice-15 serve path's shapes (chip_smoke.py FLASH_GR, DECODE_GR):
# granite-moe-3b-a800m's 24 query heads over 8 KV heads of 64 (G = 3), a
# 1920-token prefill and a full 2048-slot cache read at its last position.
# bf16 is held at the serve atol, as at head_dim 128.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_granites_serve_shape(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    B, S, H, KV, hd = 1, 1920, 24, 8, 64
    rng = np.random.default_rng(27)
    q = _cuda_normal(rng, (B, S, H, hd), dtype)
    k = _cuda_normal(rng, (B, S, KV, hd), dtype)
    v = _cuda_normal(rng, (B, S, KV, hd), dtype)
    before = flash_attention.launches
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    atol = HD128_ATOL_BF16["flash"] if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(got, ref.attention_ref(q, k, v), rtol=tol,
                               atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_at_granites_serve_shape(dtype):
    """8 KV heads x 8 splits: 64 blocks of the card's SMs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    from repro_torch.kernels import decode_attention as da_mod
    B, C, J, G, hd = 1, 2048, 8, 3, 64
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    geometry = da_mod.launch_geometry(B, J, C, hd, dtype, sms, G)
    assert geometry["grid"] == (J * da_mod.splits_for(B, J, C, sms, hd), B,
                                1)
    rng = np.random.default_rng(28)
    q = _cuda_normal(rng, (B, 1, J, G, hd), dtype)
    k = _cuda_normal(rng, (B, C, J, hd), dtype)
    v = _cuda_normal(rng, (B, C, J, hd), dtype)
    kpos = torch.arange(C, device="cuda", dtype=torch.int32)
    before = decode_attention.launches
    got = decode_attention(q, k, v, kpos, C - 1)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    tol = ATTN_TOL[dtype]
    atol = HD128_ATOL_BF16["decode"] if dtype == torch.bfloat16 else tol
    torch.testing.assert_close(
        got, ref.decode_attention_ref(q, k, v, kpos, C - 1), rtol=tol,
        atol=atol)
