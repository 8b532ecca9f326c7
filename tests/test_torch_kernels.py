"""The port's gossip_mix against the JAX package's: the plain version and the
CPU path of the wrapper held to the Pallas kernel (interpret mode) and its
jnp oracle, the launch counter, and the rule that the port imports neither
jax nor the JAX package.  The CUDA kernel itself is held to its plain
version on the card (``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jgossip  # noqa: E402
from repro.kernels import gossip_matmul as jgm, ref as jref  # noqa: E402
from repro_torch.kernels import gossip_matmul, ops, ref  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

# f32: the reference's own kernel tolerance (sums of n products reordered);
# bf16: one bf16 rounding of the output (2^-8 relative) plus reordering.
TOL = {np.float32: 1e-5, "bfloat16": 2e-2}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(n, R, D, seed=0):
    rng = np.random.default_rng(seed)
    ws = jgossip.theorem3_weight_schedule(n, 1 - 1 / n).stacked(0, R)
    x = rng.standard_normal((n, D)).astype(np.float32)
    return ws, x


def _t(a, dtype):
    t = torch.from_numpy(np.array(a, np.float32))
    return t.to(torch.bfloat16) if dtype == "bfloat16" else t


@pytest.mark.parametrize("n,R,D,bd", [(4, 2, 768, 256), (16, 4, 1024, 512),
                                      (64, 1, 512, 512), (3, 3, 1000, 1000)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_ref_and_cpu_wrapper_match_pallas_kernel(n, R, D, bd, dtype):
    ws, x = _inputs(n, R, D)
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    want = np.asarray(jgm.gossip_mix(jnp.asarray(ws), jx, block_d=bd,
                                     interpret=True), np.float32)
    oracle = np.asarray(jref.gossip_mix_ref(jnp.asarray(ws), jx), np.float32)
    tws, tx = torch.from_numpy(ws), _t(np.asarray(jx, np.float32), dtype)
    before = gossip_matmul.gossip_mix.launches
    for got in (ref.gossip_mix_ref(tws, tx), gossip_matmul.gossip_mix(tws, tx)):
        assert got.dtype == tx.dtype and got.shape == (n, D)
        got = got.to(torch.float32).numpy()
        tol = TOL[dtype]
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        np.testing.assert_allclose(got, oracle, rtol=tol, atol=tol)
    # the plain version on a CPU tensor is not a kernel launch
    assert gossip_matmul.gossip_mix.launches == before


@pytest.mark.parametrize("D", [1, 1001])
def test_in_place_and_ragged_d(D):
    ws, x = _inputs(4, 2, D, seed=1)
    want = np.asarray(jref.gossip_mix_ref(jnp.asarray(ws), jnp.asarray(x)))
    tx = torch.from_numpy(x.copy())
    out = ops.gossip_mix(torch.from_numpy(ws), tx, use_kernel=True, out=tx)
    assert out.data_ptr() == tx.data_ptr()
    np.testing.assert_allclose(tx.numpy(), want, rtol=1e-5, atol=1e-5)
    plain = ops.gossip_mix(torch.from_numpy(ws), torch.from_numpy(x))
    np.testing.assert_allclose(plain.numpy(), want, rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_it_cannot_mix():
    ws, x = _inputs(4, 2, 16)
    with pytest.raises(ValueError):
        gossip_matmul.gossip_mix(torch.from_numpy(ws),
                                 torch.from_numpy(x[:3]))
    with pytest.raises(ValueError):
        gossip_matmul.gossip_mix(torch.from_numpy(ws), torch.from_numpy(x),
                                 out=torch.zeros(4, 8))
    with pytest.raises(ValueError):
        gossip_matmul.gossip_mix(torch.from_numpy(ws).to("meta"),
                                 torch.from_numpy(x).to("meta"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    port = REPO / "src" / "repro_torch"
    for module in ("sim/hashrand.py", "sim/channel.py", "sim/faults.py",
                   "sim/telemetry.py", "sparse/plan.py", "sparse/schedule.py",
                   "sparse/sampled.py", "sparse/realize.py", "sparse/smoke.py",
                   "sparse/telemetry.py", "kernels/sparse_gossip.py"):
        assert port / module in files, module
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax", "optax"), \
                f"{path.relative_to(REPO)} imports {name}"
