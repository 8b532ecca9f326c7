"""The Hopper ``gossip_mix`` kernel's launch geometry and its walk, on the
CPU: ``launch_geometry`` picks the walk, the tile and whether W streams in
chunks from the shapes alone, keeps a block within shared memory and takes
any n (the kernel once refused n > 64); the CPU model of the kernel's walk
(``ref.gossip_mix_tiled_ref``: the rounds collapsed into one matrix, column
tiles through a ring of stages, micro-tiles, chunks of W^T) agrees with
the plain version and with the JAX package's Pallas kernel (interpret
mode) and oracle.  The kernel itself is held to the plain
version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_gossip_tiled.py
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jgossip  # noqa: E402
from repro.kernels import gossip_matmul as jgm, ref as jref  # noqa: E402
from repro_torch.kernels import gossip_matmul as gm, ref  # noqa: E402

WHISPER_D = 36_448_128          # whisper-tiny's flat state
RAGGED_D = 1_000_003
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("x_bytes", [4, 2])
@pytest.mark.parametrize("R", [1, 2, 4, 16])
@pytest.mark.parametrize("n", [1, 3, 4, 16, 32, 33, 64, 65, 128, 200, 1000])
def test_launch_geometry_from_shapes_alone(n, R, x_bytes):
    geos = [gm.launch_geometry(n, D, R, x_bytes) for D in (WHISPER_D,
                                                           RAGGED_D)]
    # the width of x, ragged or not, changes nothing of the launch
    assert {k: v for k, v in geos[0].items() if k != "D"} == \
        {k: v for k, v in geos[1].items() if k != "D"}
    g = geos[0]
    assert g["smem"] <= gm.MAX_SHARED_BYTES
    cm, lr, lc, tc = g["cm"], g["lr"], g["lc"], g["tc"]
    assert cm == gm.TILE_CM[g["wp"]] and lr * lc == 32
    # the micro-tiles (8 x cm, a warp lr x lc of them) cut the tile evenly
    rows_pad = g["rows_pad"]
    assert n <= rows_pad < n + 8 * lr and rows_pad % (8 * lr) == 0
    assert tc <= gm.TMA_BOX and tc % (cm * lc) == 0
    assert g["units"] == rows_pad // 8 * tc // cm
    assert (rows_pad * tc) % (8 * cm) == 0
    assert g["threads"] % 32 == 0
    assert g["threads"] <= gm.TILE_THREADS
    assert g["threads"] * g["passes"] >= g["units"]
    # the warp walk: one micro-tile a thread, a warp over all n rows, W^T
    # resident; the block walk: W^T in chunks of fewer rows than n
    if g["wp"]:
        assert rows_pad == 8 * lr and g["kc"] == n
        assert g["passes"] == 1 and g["threads"] == g["units"]
    else:
        assert 1 <= g["kc"] < n
    assert 1 <= g["stages"] <= gm.MAX_STAGES
    # the rounds are collapsed into one matrix first: R changes nothing
    assert g == {**gm.launch_geometry(n, WHISPER_D, 1, x_bytes), "R": R}
    # the TMA boxes stage every row, 128-byte aligned past the first
    assert g["box_rows"] <= gm.TMA_BOX and g["box_rows"] * g["boxes"] >= n
    assert g["boxes"] == 1 or (g["box_rows"] * tc * x_bytes) % 128 == 0
    assert g["smem"] == gm.tile_smem(n, rows_pad, tc, g["stages"], g["wp"],
                                     g["kc"], x_bytes)
    # the blocks it is sized for fit an SM's shared memory and registers
    assert g["blocks_per_sm"] * (g["smem"] + 1024) <= gm.SM_SHARED_BYTES
    assert g["blocks_per_sm"] * g["threads"] * gm.TILE_REGS <= 65_536


def test_launch_geometry_at_the_timed_shapes():
    """The main path's 4 nodes: the warp walk, one-warp blocks, 16 an SM;
    whisper-tiny's 32 nodes: the warp walk, 3 blocks an SM of 4 warps in
    f32 and 4 in bf16; n = 128: the warp walk too, one block of 8 warps
    an SM (more warps than two of 3 with narrower tiles); past ~210 rows
    the block walk, W^T in chunks."""
    g = gm.launch_geometry(32, WHISPER_D, 2)
    assert (g["wp"], g["cm"], g["tc"], g["threads"], g["stages"],
            g["blocks_per_sm"], g["smem"]) == (True, 8, 256, 128, 2, 3, 69_888)
    b = gm.launch_geometry(32, WHISPER_D, 2, x_bytes=2)
    assert b["wp"] and b["blocks_per_sm"] == 4 and b["threads"] == 128
    g = gm.launch_geometry(128, 9_112_064, 2)
    assert g["wp"] and g["kc"] == 128
    assert (g["tc"], g["threads"], g["blocks_per_sm"], g["smem"]) == \
        (128, 256, 1, 196_864)
    g = gm.launch_geometry(300, 1000, 2)
    assert not g["wp"] and g["kc"] == 64 and g["boxes"] == 2
    g = gm.launch_geometry(4, 463_987_712, 2)
    assert (g["wp"], g["rows_pad"], g["tc"], g["threads"],
            g["blocks_per_sm"]) == (True, 8, 256, 32, 16)


def test_launch_geometry_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="positive"):
        gm.launch_geometry(0, 10, 2)
    with pytest.raises(ValueError, match="shared-memory limit"):
        gm.launch_geometry(100_000, 10, 1)


@functools.lru_cache(maxsize=None)
def _schedule(n):
    return jgossip.theorem3_weight_schedule(n, 1 - 1 / n)


def _inputs(n, R, D, dtype, seed):
    rng = np.random.default_rng(seed)
    ws = _schedule(n).stacked(0, R)
    x = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    return torch.from_numpy(ws), x.to(dtype)


def _walks(ws, x, blocks):
    """The walk at the kernel's geometry on ``blocks`` persistent blocks
    (on one, its ring wraps); the block walk also in two passes of half the
    threads."""
    n, D = x.shape
    g = gm.launch_geometry(n, D, ws.shape[0], x.element_size())
    out = [ref.gossip_mix_tiled_ref(ws, x, g, blocks=blocks)]
    if not g["wp"] and g["threads"] % 64 == 0:
        half = dict(g, threads=g["threads"] // 2, passes=2 * g["passes"])
        out.append(ref.gossip_mix_tiled_ref(ws, x, half, blocks=blocks))
    return out


# D: 512 tiles as the Pallas kernel needs (D % min(1024, D) == 0); 515 is
# ragged and held to the port's plain version only.  n = 300 takes the
# block walk, W^T in chunks of 64 rows and two TMA boxes a stage.
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("n", [3, 32, 65, 130, 300])
def test_tiled_walk_matches_plain_and_jax_kernel(n, R, dtype):
    tol = TOL[dtype]
    for D, blocks in ((512, 1), (515, 3)):
        ws, x = _inputs(n, R, D, dtype, seed=n * 10 + R)
        wants = [ref.gossip_mix_ref(ws, x).to(torch.float32).numpy()]
        if D % min(1024, D) == 0:
            jws = jnp.asarray(ws.numpy())
            jx = jnp.asarray(x.to(torch.float32).numpy(),
                             jnp.bfloat16 if dtype == torch.bfloat16
                             else jnp.float32)
            wants += [np.asarray(jref.gossip_mix_ref(jws, jx), np.float32),
                      np.asarray(jgm.gossip_mix(jws, jx, block_d=min(1024, D),
                                                interpret=True), np.float32)]
        for y in _walks(ws, x, blocks):
            assert y.dtype == dtype and y.shape == (n, D)
            for w in wants:
                # f32: sums of n products in another order; bf16: one
                # rounding of the output
                np.testing.assert_allclose(y.to(torch.float32).numpy(), w,
                                           rtol=tol, atol=tol)


def test_tiled_walk_refuses_a_geometry_that_does_not_tile():
    ws, x = _inputs(32, 2, 512, torch.float32, 0)
    g = gm.launch_geometry(32, 512, 2)
    with pytest.raises(ValueError, match="does not tile"):
        ref.gossip_mix_tiled_ref(ws, x, dict(g, rows_pad=24))
    with pytest.raises(ValueError, match="does not tile"):
        ref.gossip_mix_tiled_ref(ws, x, dict(g, units=g["units"] // 2))
