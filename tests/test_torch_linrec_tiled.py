"""The Hopper ``linear_recurrence`` kernel's launch geometry and its walk,
on the CPU: ``launch_geometry`` covers every (batch, channel) once, stays in
a block's shared memory, takes TMA only where the stride and alignment let
it and spreads recurrentgemma-2b's narrow C over the card; the CPU model of
the kernel's tiled walk (``ref.linear_recurrence_tiled_ref``, driven by
those tiles, stages and tails) is bit-equal to the plain version and
agrees with the JAX package's oracle and Pallas kernel (interpret mode).
The kernel itself is held to the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_linrec_tiled.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import linear_recurrence as jlr, ref as jref  # noqa: E402
from repro_torch.kernels import linear_recurrence as lr, ref  # noqa: E402

SMS = 132                       # an H100 SXM
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(B, S, C, dtype, seed):
    """a in (0, 1) as mamba's exp(dt·A) is, b standard normal."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.0, 1.0, (B, S, C)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((B, S, C)).astype(np.float32))
    return a.to(dtype), b.to(dtype)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("C", [1, 5, 16, 100, 2560, 2564, 4099, 65_536,
                               131_072])
def test_launch_geometry_covers_each_channel_once(C, dtype, aligned):
    elem = dtype.itemsize
    for B in (1, 3, 64):
        for S in (1, 63, 64, 65, 3968):
            g = lr.launch_geometry(B, S, C, dtype, SMS, aligned)
            gx, gy = g["grid"]
            # every (batch, channel) in exactly one block
            assert gy == B and (gx - 1) * g["cb"] < C <= gx * g["cb"]
            assert g["smem"] <= lr.BLOCK_SMEM
            assert 1 <= g["stages"] <= lr.MAX_STAGES
            assert g["stages"] <= -(-S // g["tile_t"])
            if g["route"] == "loop":  # bf16 rows on 2 bytes only
                assert g["cb"] == lr.LOOP_THREADS and g["vec"] == 1
                assert elem == 2 and not (aligned and C % 2 == 0)
                continue
            assert g["cb"] in lr.CHANNELS and g["tile_t"] == lr.TILE_T
            # h tiles leave by TMA store where its rows are 16-byte strided
            assert g["vec"] == (4 if C % 4 == 0 else 1)
            # a consumer warp per 32 channels, a producer and a storer warp
            assert g["block"] == 32 * -(-g["cb"] // 32) + 64
            # a, b and h tiles in each stage
            assert g["smem"] >= g["stages"] * lr.TILE_T * g["cb"] \
                * (2 * elem + 4)
            if g["route"] == "tma":    # a 16-byte base and row stride
                assert aligned and C * elem % 16 == 0
            else:                      # 4-byte rows for 4-byte copies
                assert g["route"] == "cp.async"
                assert elem == 4 or (aligned and C % 2 == 0)
                assert not (aligned and C * elem % 16 == 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_launch_geometry_spreads_recurrentgemma_width(dtype):
    B, S, C = 1, 3968, 2560
    g = lr.launch_geometry(B, S, C, dtype, SMS, True)
    blocks = g["grid"][0] * g["grid"][1]
    assert g["route"] == "tma" and blocks >= 64 and g["stages"] >= 2
    # tiles of a and b in flight across the card while one drains: MBs (3.9
    # in f32), not the 164 KB of five 128-thread blocks
    in_flight = blocks * (g["stages"] - 1) * 2 * lr.TILE_T * g["cb"] \
        * dtype.itemsize
    assert in_flight >= 2**20
    # falcon-mamba-7b's width: the widest blocks, still one on every SM
    wide = lr.launch_geometry(1, 2048, 131_072, dtype, SMS, True)
    assert wide["route"] == "tma" and wide["cb"] == max(lr.CHANNELS)
    assert wide["grid"][0] >= SMS and wide["stages"] >= 2
    # an unaligned view of it: the cp.async ring in f32 (4-byte rows), the
    # loop in bf16 (rows on 2 bytes)
    view = lr.launch_geometry(1, 2048, 131_072, dtype, SMS, False)
    assert view["route"] == ("cp.async" if dtype == torch.float32
                             else "loop")


def test_launch_geometry_is_chosen_from_shapes_alone():
    cases = [(1, 3968, 2560, torch.float32, SMS, True),
             (3, 65, 2564, torch.bfloat16, SMS, True),
             (3, 65, 4099, torch.float32, SMS, False),
             (1, 2048, 131_072, torch.float32, SMS, True)]
    first = [dict(lr.launch_geometry(*c)) for c in cases]
    lr.launch_geometry.cache_clear()
    assert [lr.launch_geometry(*c) for c in cases] == first
    assert [lr.launch_geometry.__wrapped__(*c) for c in cases] == first


def _geometries(B, S, C, dtype):
    """The wrapper's geometries for (B, S, C) at a few card sizes and both
    alignments, each ring one again with 2 and 3 stages (so that the ring
    wraps at a short S), and the loop's, which the wrapper takes for bf16
    rows on 2 bytes alone."""
    out = [{"route": "loop", "vec": 1, "cb": lr.LOOP_THREADS,
            "tile_t": lr.LOOP_AHEAD, "stages": 1,
            "grid": (-(-C // lr.LOOP_THREADS), B)}]
    for sms in (SMS, 8, 1):
        for aligned in (True, False):
            g = lr.launch_geometry(B, S, C, dtype, sms, aligned)
            out.append(g)
            if g["route"] != "loop":
                out += [dict(g, stages=st) for st in (2, 3)]
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,S,C", [(1, 1, 5), (2, 63, 16), (3, 65, 20),
                                   (1, 130, 37), (2, 700, 33), (1, 20, 300),
                                   (1, 193, 2564)])
def test_tiled_walk_is_bit_equal_to_plain(B, S, C, dtype):
    a, b = _inputs(B, S, C, dtype, seed=B * S + C)
    want = ref.linear_recurrence_ref(a, b)
    routes = set()
    for g in _geometries(B, S, C, dtype):
        routes.add(g["route"])
        got = ref.linear_recurrence_tiled_ref(a, b, g)
        # the product and the sum rounded separately, in the same order
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), g
    # bf16 rows of an odd C are not 4-byte aligned: the loop alone takes them
    ring = dtype == torch.float32 or C % 2 == 0
    assert "loop" in routes and bool(routes & {"tma", "cp.async"}) == ring


def test_tiled_walk_refuses_a_geometry_that_misses_channels():
    a, b = _inputs(2, 10, 40, torch.float32, 0)
    g = lr.launch_geometry(2, 10, 40, torch.float32, SMS, True)
    with pytest.raises(ValueError, match="cover"):
        ref.linear_recurrence_tiled_ref(a, b, dict(g, grid=(1, 2)))
    with pytest.raises(ValueError, match="cover"):
        ref.linear_recurrence_tiled_ref(a, b, dict(g, grid=(g["grid"][0], 1)))


# (B, S, C): the first two tile as the Pallas kernel needs (S % min(128, S)
# and C % min(512, C) == 0), the others are ragged and held to the jnp
# oracle only.
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,C", [(1, 128, 512), (3, 16, 1536),
                                   (2, 130, 2564), (3, 65, 4099)])
def test_tiled_walk_matches_the_jax_kernel(B, S, C, dtype):
    tdt = getattr(torch, dtype)
    a, b = _inputs(B, S, C, tdt, seed=S + C)
    jdt = getattr(jnp, dtype)
    ja, jb = (jnp.asarray(x.float().numpy(), jdt) for x in (a, b))
    wants = [jref.linear_recurrence_ref(ja, jb)]
    if S % min(128, S) == 0 and C % min(512, C) == 0:
        wants.append(jlr.linear_recurrence(ja, jb, block_t=min(128, S),
                                           block_c=min(512, C),
                                           interpret=True))
    for aligned in (True, False):
        g = lr.launch_geometry(B, S, C, tdt, SMS, aligned)
        h_all, h_last = ref.linear_recurrence_tiled_ref(a, b, g)
        for want_all, want_last in wants:
            # the same f32 products and sums in the same order: only XLA's
            # contraction into FMAs may move the last bits
            np.testing.assert_allclose(h_all.numpy(), np.asarray(want_all),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                       rtol=1e-5, atol=1e-5)


def test_geometry_dict_is_what_the_model_reads():
    """Every route's dict carries the keys the CPU model and the C entry
    point read."""
    keys = {"route", "vec", "cb", "tile_t", "stages", "grid", "block",
            "smem"}
    for args in [(1, 3968, 2560, torch.float32, SMS, True),
                 (1, 70, 4099, torch.bfloat16, SMS, True),
                 (1, 70, 4099, torch.float32, SMS, False)]:
        g = lr.launch_geometry(*args)
        assert set(g) == keys and g["route"] in lr._ROUTES
