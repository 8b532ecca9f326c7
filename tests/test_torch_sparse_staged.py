"""The staged ``sparse_segment_mix`` layout against the JAX package: the
round compaction (``rows``, ``lsrc``, ``ldst``) against numpy, the CPU model
of the rows the staged kernel reads and the wrapper's CPU path against the
JAX Pallas kernel (interpret mode) and oracle, the kernel's dealing of
segments to warps, ``launch_geometry``'s choice of variant around the
staging limit, and the plan mixer laying out each round once per staged
plan.  The CUDA variants themselves are held to the plain version on the
card (``chip_smoke.py``, ``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import sparse as jsparse  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sparse_gossip as jsparse_gossip  # noqa: E402
from repro_torch import sparse  # noqa: E402
from repro_torch.core import driver  # noqa: E402
from repro_torch.kernels import ops, ref, sparse_gossip  # noqa: E402

# The reference's own tolerance for the sparse mix (tests/test_sparse.py):
# the same f32 products summed in another order (index_add_ vs
# segment_sum vs the Pallas one-hot matmul).
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _round(seed, n, E, S, D, pad_frac=0.1, n_dst=None):
    """A seeded round: x (n, D) f32, src, dst, w, seg (seg == S marks a
    padded edge, in no segment), with ids drawn from small ranges so that
    they repeat."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, D)).astype(np.float32)
    src = rng.integers(0, n, E)
    dst = rng.integers(0, n_dst or n, E)
    w = rng.random(E).astype(np.float32)
    seg = np.where(rng.random(E) < pad_frac, S, rng.integers(0, S, E))
    return x, src, dst, w, seg


def _jax_kernel(seg, w, xs, xd, S):
    """The JAX Pallas kernel in interpret mode, padded as the JAX op pads
    it (edges to its block with w = 0, D to 128, S to 8)."""
    E, D = xs.shape
    be = min(512, max(8, E))
    ep, dp, sp = -E % be, -D % 128, -S % 8
    seg_p = np.pad(seg, (0, ep))
    w_p = np.pad(w, (0, ep))
    xs_p = np.pad(xs, ((0, ep), (0, dp)))
    xd_p = np.pad(xd, ((0, ep), (0, dp)))
    out = jsparse_gossip.sparse_segment_mix(
        jnp.asarray(seg_p), jnp.asarray(w_p), jnp.asarray(xs_p),
        jnp.asarray(xd_p), num_segments=S + sp, block_e=be, block_d=128,
        interpret=True)
    return np.asarray(out)[:S, :D]


@pytest.mark.parametrize("E,n", [(0, 10), (1, 10), (37, 5), (600, 40),
                                 (2000, 3000)])
def test_compaction_is_numpy_unique(E, n):
    rng = np.random.default_rng(E)
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    rows, lsrc, ldst = sparse_gossip.compact_rows(
        torch.from_numpy(src)[None], torch.from_numpy(dst)[None],
        torch.tensor([E]))
    want, inv = np.unique(np.concatenate([src, dst]), return_inverse=True)
    assert rows[0].dtype == torch.int64
    assert lsrc.dtype == ldst.dtype == torch.int32
    assert np.array_equal(rows[0].numpy(), want)
    assert np.array_equal(lsrc[0].numpy(), inv[:E])
    assert np.array_equal(ldst[0].numpy(), inv[E:])


@pytest.mark.parametrize("n", [7, 300, 70_000])
def test_compaction_of_a_stack_is_each_rounds_own(n):
    """Rounds compacted together (one sort keyed by round and id) equal each
    round compacted alone; the edges past a round's inside count add no row
    and get local ids 0."""
    rng = np.random.default_rng(n)
    P, E = 5, 400
    src, dst = rng.integers(0, n, (P, E)), rng.integers(0, n, (P, E))
    inside = np.array([E, 0, 1, 399, 123])
    rows, lsrc, ldst = sparse_gossip.compact_rows(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(inside))
    assert len(rows) == P
    for r, k in enumerate(inside):
        want, inv = np.unique(np.concatenate([src[r, :k], dst[r, :k]]),
                              return_inverse=True)
        assert np.array_equal(rows[r].numpy(), want)
        assert np.array_equal(lsrc[r, :k].numpy(), inv[:k])
        assert np.array_equal(ldst[r, :k].numpy(), inv[k:])
        assert not lsrc[r, k:].any() and not ldst[r, k:].any()


@pytest.mark.parametrize("E,S", [(0, 1), (1, 1), (513, 7), (900, 64)])
def test_segment_layout_compacts_the_edges_in_segments(E, S):
    """rows are the distinct ids of the edges that lie in a segment, in the
    layout's order; a padded edge adds no row and gets local ids 0."""
    x, src, dst, w, seg = _round(E + S, 300, E, S, 4)
    lay = sparse_gossip.segment_layout(
        *(torch.from_numpy(a) for a in (src, dst, w, seg)), S)
    hi = int(lay.offsets[-1])
    assert hi == (seg < S).sum()
    s, d = lay.src[:hi].numpy(), lay.dst[:hi].numpy()
    want, inv = np.unique(np.concatenate([s, d]), return_inverse=True)
    assert np.array_equal(lay.rows.numpy(), want)
    assert np.array_equal(lay.lsrc[:hi].numpy(), inv[:hi])
    assert np.array_equal(lay.ldst[:hi].numpy(), inv[hi:])
    assert not lay.lsrc[hi:].any() and not lay.ldst[hi:].any()
    assert np.array_equal(lay.rows[lay.lsrc[:hi].long()].numpy(), s)
    assert np.array_equal(lay.rows[lay.ldst[:hi].long()].numpy(), d)


CASES = {
    # name: (seed, n, E, S, D, pad_frac, n_dst)
    "repeated ids": (0, 50, 700, 9, 16, 0.0, 6),
    "padded edges": (1, 400, 513, 31, 24, 0.3, None),
    "one segment": (2, 200, 300, 1, 8, 0.1, None),
    "ragged D": (3, 300, 520, 17, 7, 0.1, 40),
    "no edges": (4, 20, 0, 3, 5, 0.0, None),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_staged_model_and_wrapper_match_jax(case, dtype):
    """The staged kernel's reads (x[rows] gathered by local id) summed by the
    plain segment sum, and the wrapper's CPU path, against the JAX kernel in
    interpret mode and the JAX oracle on the ungrouped edges."""
    seed, n, E, S, D, pad_frac, n_dst = CASES[case]
    x, src, dst, w, seg = _round(seed, n, E, S, D, pad_frac, n_dst)
    tx = torch.from_numpy(x).to(dtype)
    xf = tx.float().numpy()
    keep = seg < S
    jargs = (seg[keep], w[keep], xf[src[keep]], xf[dst[keep]])
    want = np.asarray(jref.sparse_gossip_mix_ref(
        *map(jnp.asarray, jargs), S))
    lay = sparse_gossip.segment_layout(
        *(torch.from_numpy(a) for a in (src, dst, w, seg)), S)
    hi = int(lay.offsets[-1])
    xs, xd = ref.staged_rows_ref(tx, lay.rows, lay.lsrc[:hi], lay.ldst[:hi])
    assert torch.equal(xs, tx[lay.src[:hi]]) and torch.equal(
        xd, tx[lay.dst[:hi]])
    segs = torch.repeat_interleave(torch.arange(S), lay.offsets.diff())
    model = ref.sparse_gossip_mix_ref(segs, lay.w[:hi], xs, xd, S)
    before = sparse_gossip.sparse_segment_mix.launches
    got = sparse_gossip.sparse_segment_mix(tx, *lay)
    assert sparse_gossip.sparse_segment_mix.launches == before   # CPU: plain
    assert got.dtype == torch.float32 and got.shape == (S, D)
    assert torch.equal(got, model)
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
    if keep.any():
        np.testing.assert_allclose(got.numpy(), _jax_kernel(*jargs, S),
                                   rtol=ATOL, atol=ATOL)


@pytest.mark.parametrize("dtype,elem", [(torch.float32, 4),
                                        (torch.bfloat16, 2)])
def test_launch_geometry_around_the_staging_limit(dtype, elem):
    lim = sparse_gossip.max_staged_rows(dtype)
    overhead = sparse_gossip._staged_smem(0, 1, elem)
    # the limit is the most 32-column rows a block's shared memory holds
    assert lim * 32 * elem + overhead <= sparse_gossip.BLOCK_SMEM \
        < (lim + 1) * 32 * elem + overhead
    for U, variant in ((0, "staged"), (lim - 1, "staged"), (lim, "staged"),
                       (lim + 1, "gather"), (10 * lim, "gather")):
        geo = sparse_gossip.launch_geometry(U, 784, 256, dtype, 132)
        assert geo["variant"] == variant, (U, geo)
        if variant == "staged":
            assert geo["smem"] <= sparse_gossip.BLOCK_SMEM
            tiles, groups = geo["grid"]
            assert tiles * geo["tile"] >= 784 > (tiles - 1) * geo["tile"]
            assert 1 <= groups <= 256
        else:
            assert geo["block"] == sparse_gossip.GATHER_THREADS
    # at the limit only the narrowest tile fits
    assert sparse_gossip.launch_geometry(lim, 784, 256, dtype, 132)[
        "vec"] == 1


@pytest.mark.parametrize("U,D,S,vec,grid", [
    (256, 784, 256, 4, (7, 16)),    # the sampled-client main path
    (247, 784, 240, 4, (7, 15)),    # a main-path round with fewer segments
    (256, 781, 256, 4, (7, 16)),    # rows of 3,124 bytes: 4-byte copies
    (256, 7, 256, 1, (1, 16)),      # a tile of 32 columns covers D
    (256, 100, 5, 4, (1, 1)),       # one group holds every segment
    (600, 784, 256, 2, (13, 10)),   # vec 4 would not fit; 1 block an SM
    (256, 784, 4000, 4, (7, 18)),   # more segments than warps: 1 wave
])
def test_launch_geometry_shapes(U, D, S, vec, grid):
    geo = sparse_gossip.launch_geometry(U, D, S, torch.float32, 132)
    assert (geo["variant"], geo["vec"], geo["grid"]) == ("staged", vec, grid)
    assert geo["block"] == 32 * sparse_gossip.WARPS
    assert geo["smem"] == sparse_gossip._staged_smem(U, vec, 4) \
        <= sparse_gossip.BLOCK_SMEM


@pytest.mark.parametrize("nw", [1, 7, 64, 256, 288])
def test_warp_dealing_covers_every_edge_once(nw):
    """With S <= nw warps, warp k walks segment k alone; otherwise each warp
    takes whole segments whose first edge lies in its slice of E / nw
    edges: together they walk every edge once, none more than ceil(E / nw)
    plus the longest segment."""
    rng = np.random.default_rng(nw)
    sizes = rng.integers(0, 200, 256)
    sizes[rng.random(256) < 0.1] = 0            # empty segments too
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]))
    walks = ref.staged_warp_edges_ref(offsets, nw)
    E = int(sizes.sum())
    assert walks.shape == (nw,) and int(walks.sum()) == E
    assert int(walks.max()) <= -(-E // nw) + int(sizes.max())
    if nw >= sizes.size:
        assert walks[:sizes.size].tolist() == sizes.tolist()
        assert not walks[sizes.size:].any()
    empty = ref.staged_warp_edges_ref(torch.zeros(9, dtype=torch.long), nw)
    assert not empty.any()


class _KernelPlan(sparse.SparseGossipPlan):
    """A plan whose mixer asks for the segment-sum kernel."""

    def make_mixer(self, **kw):
        return super().make_mixer(**kw, use_pallas=True)


def _plan(n=400, horizon=16):
    from repro_torch.exp import registry, spec
    sched = registry.build_topology(
        spec.TopologySpec(kind="random-sampled", sample_k=24, radius=0.45),
        n, horizon=horizon, seed=5)
    models = registry.build_channel_models(
        spec.ChannelSpec(link_drop=0.2, churn=0.02), 5)
    return sparse.realize_sparse_schedule(sched, models).plan()


def _mixer_layout(kplan, tensors, r):
    """The layout the kernel mixer hands ops.sparse_gossip_mix for round r
    of the staged ``tensors``, caught on its way there."""
    caught = []
    real = ops.sparse_gossip_mix

    def spy(*args, **kw):
        caught.append(kw["layout"])
        return real(*args, **kw)

    ops.sparse_gossip_mix = spy
    try:
        x = torch.zeros((kplan.n, 1))
        kplan.make_mixer()(tensors, r, 1, x)
    finally:
        ops.sparse_gossip_mix = real
    return caught[0]


def test_prepare_lays_out_each_round_once_per_staged_plan():
    """The kernel mixer compacts all rounds of the plan in one call on its
    first window over a staged plan and never again for that plan; a newly
    staged plan is laid out anew.  Each round's layout equals the round laid
    out alone, and the mix equals the JAX mixer's (Pallas kernel, interpret
    mode)."""
    plan = _plan()
    kplan = _KernelPlan(**{f: getattr(plan, f) for f in (
        "n", "src", "dst", "w", "offsets", "diags")})
    mixer = kplan.make_mixer()
    tensors = driver.stage_plan(kplan)
    x = np.random.default_rng(2).standard_normal((plan.n, 6)).astype(
        np.float32)
    calls = sparse_gossip.compact_rows.calls
    got = mixer(tensors, 3, 5, torch.from_numpy(x.copy()))
    assert sparse_gossip.compact_rows.calls == calls + 1
    mixer(tensors, 11, 2 * plan.period, torch.from_numpy(x.copy()))
    assert sparse_gossip.compact_rows.calls == calls + 1
    mixer(driver.stage_plan(kplan), 0, 1, torch.from_numpy(x.copy()))
    assert sparse_gossip.compact_rows.calls == calls + 2
    for r in (0, 3, plan.period - 1):
        e = int(plan.edges_per_round[r])
        s = int(np.unique(plan.round(r).dst).size)
        alone = sparse_gossip.segment_layout(
            tensors["esrc"][r, :e].long(), tensors["edst"][r, :e].long(),
            tensors["ew"][r, :e], tensors["seg"][r, :e].long(), s)
        lay = _mixer_layout(kplan, tensors, r)
        for a, b in zip(alone, lay):
            assert torch.equal(a, b)
    jplan = jsparse.SparseGossipPlan(**{f: getattr(plan, f) for f in (
        "n", "src", "dst", "w", "offsets", "diags")})
    jt = {k: jnp.asarray(v) for k, v in jplan.tensors().items()}
    want = np.asarray(jplan.make_mixer(use_pallas=True)(
        jt, 3, 5, {"a": jnp.asarray(x)})["a"])
    np.testing.assert_allclose(got.numpy(), want, rtol=ATOL, atol=ATOL)
