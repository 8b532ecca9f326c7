"""The port's CUDA kernels on the card: the cases ``chip_smoke.py`` does not
cover.  Its kernel check holds ``gossip_mix`` to its plain version at n
4/16/64, R 1/2/4 and both dtypes; here are the largest W stack the kernel
takes in one launch (n=64, R=8: 128 KB of shared memory, past the 48 KB
default) and the inputs it refuses.

These need an NVIDIA GPU and skip elsewhere; the file imports neither jax
nor the JAX package, so it runs on a machine that has only torch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import gossip  # noqa: E402
from repro_torch.kernels import gossip_matmul, ref  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("n,R,D,dtype", [(64, 8, 4_097, torch.float32),
                                         (64, 8, 4_097, torch.bfloat16)])
def test_gossip_mix_kernel_matches_plain(n, R, D, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    ws = torch.from_numpy(
        gossip.theorem3_weight_schedule(n, 1 - 1 / n).stacked(0, R)).cuda()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (n, D)).astype(np.float32)).cuda().to(dtype)
    before = gossip_matmul.gossip_mix.launches
    got = gossip_matmul.gossip_mix(ws, x)
    torch.cuda.synchronize()
    assert gossip_matmul.gossip_mix.launches == before + 1
    # f32: n products summed in another order; bf16: one output rounding
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got, ref.gossip_mix_ref(ws, x), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_gossip_mix_kernel_refuses_what_it_cannot_take():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the Hopper kernel has no CPU mode")
    x = torch.zeros(65, 8, device="cuda")
    with pytest.raises(ValueError, match="n <= 64"):
        gossip_matmul.gossip_mix(torch.eye(65, device="cuda")[None], x)
    with pytest.raises(TypeError):
        gossip_matmul.gossip_mix(torch.eye(4, device="cuda")[None],
                                 torch.zeros(4, 8, device="cuda",
                                             dtype=torch.float16))
