"""The Hopper ``decode_attention`` kernel splits the cache of each (batch,
KV head) over a cluster of blocks, runs an online softmax over each split
and combines the splits in rank order.  ``ref.decode_attention_split_ref``
is that arithmetic in plain PyTorch; here it is held, for 1, 2, 8 and 16
splits, to the JAX package's Pallas kernel in interpret mode (C <= 512), to
the JAX oracle ``decode_attention_ref`` and to the port's plain
``decode_attention_ref``, over the JAX kernel tests' decode cases, a
2048-slot cache with only its first 200 slots filled, so that whole splits
hold no valid slot, nemotron-4-340b's decode (head_dim 192, G = 12) and
G = 20 and 33, each walked in the kernel's tiles for its head_dim
(``decode_attention.tile_for``)."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import (  # noqa: E402
    decode_attention as jdecode)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.decode_attention import tile_for  # noqa: E402

# f32: sums in another order; bf16: the JAX kernel tests' 2e-2, and at
# C = 2048 (outputs that average hundreds of slots) chip_smoke.py's serve
# atol for decode_attention, 2e-3, with the same rtol.
TOL = {"f32": (2e-5, 2e-5), "bf16": (2e-2, 2e-2)}
SERVE_TOL_BF16 = (2e-2, 2e-3)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
TDT = {"f32": torch.float32, "bf16": torch.bfloat16}
# tests/test_torch_attention.py's DECODE_CASES (those of the JAX kernel
# tests), and the cache whose later splits are empty.
CASES = [
    # (B, C, J, G, hd, window, filled, pos, bk)
    (2, 256, 2, 2, 64, 0, 256, 255, 128),     # full cache
    (1, 512, 1, 8, 64, 0, 300, 299, 128),     # partially filled (kpos -1 tail)
    (2, 256, 2, 4, 128, 128, 256, 400, 64),   # ring buffer, window
    (1, 128, 4, 1, 32, 0, 128, 127, 128),     # MHA-ish
    (1, 128, 2, 2, 64, 0, 0, 5, 128),         # empty cache: every slot masked
    (1, 2048, 16, 1, 64, 0, 200, 199, 256),   # only the first 200 slots
    # nemotron-4-340b's decode (hd 192, G = 12), and G past 16
    (1, 2048, 8, 12, 192, 0, 2048, 2047, 256),
    (1, 256, 1, 20, 64, 0, 256, 255, 128),     # G = 20
    (2, 512, 1, 33, 192, 300, 512, 700, 128),  # G = 33, ring, window
]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _kpos(C, filled, pos, window):
    if window and pos >= C:
        base = pos - C + 1
        return ((np.arange(C) - base % C) % C + base).astype(np.int32)
    return np.where(np.arange(C) < filled, np.arange(C), -1).astype(np.int32)


@functools.cache
def _inputs(case, dtype):
    """numpy draws of q, k, v and kpos for ``case``, and the JAX reference
    for them: the Pallas kernel in interpret mode where C <= 512, else the
    oracle (interpret mode is slow at C = 2048)."""
    B, C, J, G, hd, window, filled, pos, bk = case
    rng = np.random.default_rng(C + 3 * G + hd)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((B, 1, J, G, hd), (B, C, J, hd), (B, C, J, hd))]
    kp = _kpos(C, filled, pos, window)
    jq, jk, jv = (jnp.asarray(a).astype(JDT[dtype]) for a in arrays)
    if C <= 512:
        want = jdecode(jq, jk, jv, jnp.asarray(kp), jnp.int32(pos),
                       window=window, block_k=bk, interpret=True)
    else:
        want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(kp),
                                         jnp.int32(pos), window=window)
    return arrays, kp, np.asarray(want.astype(jnp.float32))


def _close(got, want, tol):
    rtol, atol = tol
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("splits", [1, 2, 8, 16])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES)
def test_split_model_matches_jax_and_plain(case, dtype, splits):
    B, C, J, G, hd, window, filled, pos, bk = case
    arrays, kp, want = _inputs(case, dtype)
    q, k, v = (torch.from_numpy(a).to(TDT[dtype]) for a in arrays)
    kpos = torch.from_numpy(kp)
    got = ref.decode_attention_split_ref(q, k, v, kpos, pos, window=window,
                                         splits=splits, tile=tile_for(hd))
    assert got.shape == (B, 1, J * G, hd) and got.dtype == TDT[dtype]
    tol = SERVE_TOL_BF16 if dtype == "bf16" and C >= 2048 else TOL[dtype]
    _close(got, want, tol)
    plain = ref.decode_attention_ref(q, k, v, kpos, pos, window=window)
    _close(got, plain.float().numpy(), tol)
    if not (kp >= 0).any():
        # no valid slot anywhere: the mean of v over all C slots
        mean = v.float().mean(1).repeat_interleave(G, dim=1)
        _close(got[:, 0], mean.numpy(), tol)


@pytest.mark.parametrize("splits", [2, 8, 16])
def test_empty_splits_drop_out(splits):
    """Splits with no valid slot beside one that has them add nothing: the
    result equals the single split over the valid slots alone."""
    rng = np.random.default_rng(5)
    C, filled = 2048, 200
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 1, 4, 2, 64), (1, C, 4, 64), (1, C, 4, 64)))
    kpos = torch.from_numpy(_kpos(C, filled, filled - 1, 0))
    got = ref.decode_attention_split_ref(q, k, v, kpos, filled - 1,
                                         splits=splits)
    alone = ref.decode_attention_split_ref(q, k[:, :filled], v[:, :filled],
                                           kpos[:filled], filled - 1,
                                           splits=1)
    torch.testing.assert_close(got, alone, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("splits", [1, 8])
def test_serve_shape_keeps_the_serve_atol(splits):
    """At the serve path's decode shape (q (1, 1, 16, 1, 64), a full
    2048-slot bf16 cache) the split model stays within chip_smoke.py's
    serve tolerance of the plain version (rtol 2e-2, atol 2e-3) with 8
    splits as with 1; prints the smallest atol that passes at rtol 2e-2
    (run with -s to read it)."""
    rng = np.random.default_rng(11)
    C = 2048
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)
                                ).bfloat16()
               for s in ((1, 1, 16, 1, 64), (1, C, 16, 64), (1, C, 16, 64)))
    kpos = torch.arange(C, dtype=torch.int32)
    got = ref.decode_attention_split_ref(q, k, v, kpos, C - 1, splits=splits)
    want = ref.decode_attention_ref(q, k, v, kpos, C - 1).float()
    need = float(((got.float() - want).abs() - SERVE_TOL_BF16[0]
                  * want.abs()).max())
    print(f"splits={splits}: smallest atol at rtol {SERVE_TOL_BF16[0]}: "
          f"{need:.3e}")
    _close(got, want.numpy(), SERVE_TOL_BF16)
