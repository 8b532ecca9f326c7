"""The port's gossip_mix and linear_recurrence against the JAX package's: the
plain versions and the CPU paths of the wrappers held to the Pallas kernels
(interpret mode) and their jnp oracles, the launch counters, and the rule
that the port imports neither jax nor the JAX package.  The CUDA kernels
themselves are held to their plain versions on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``)."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import gossip as jgossip  # noqa: E402
from repro.kernels import gossip_matmul as jgm, ref as jref  # noqa: E402
from repro.kernels import linear_recurrence as jlr  # noqa: E402
from repro_torch.kernels import (gossip_matmul, linear_recurrence,  # noqa: E402
                                 ops, ref)

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
    # a meta tensor takes the shape-only route: no launch, no values
    got = gossip_matmul.gossip_mix(torch.from_numpy(ws).to("meta"),
                                   torch.from_numpy(x).to("meta"))
    assert (got.device.type, got.shape) == ("meta", x.shape)
    assert gossip_matmul.gossip_mix.launches == 0


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    twins = sorted((REPO / "examples" / "torch").glob("*.py"))
    assert {p.name for p in twins} >= {"quickstart.py", "paper_figure2.py",
                                       "sampled_clients.py", "federated.py"}
    files += twins
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    port = REPO / "src" / "repro_torch"
    for module in ("sim/hashrand.py", "sim/channel.py", "sim/faults.py",
                   "sim/telemetry.py", "sparse/plan.py", "sparse/schedule.py",
                   "sparse/sampled.py", "sparse/realize.py", "sparse/smoke.py",
                   "sparse/telemetry.py", "kernels/sparse_gossip.py",
                   "kernels/linear_recurrence.py", "models/ssm.py",
                   "serve/engine.py", "serve/traffic.py",
                   "kernels/flash_attention.py",
                   "kernels/decode_attention.py", "models/attention.py",
                   "optim/optimizers.py", "optim/__init__.py",
                   "obs/metrics.py", "obs/trace.py", "obs/optimality.py",
                   "obs/report.py", "core/lower_bound.py",
                   "checkpoint/msgpack_ckpt.py"):
        assert port / module in files, module
    # the card's machine has neither msgpack nor ml_dtypes either
    for path in files:
        for name in _imports(path):
            root = name.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro", "flax", "optax",
                                "msgpack", "ml_dtypes"), \
                f"{path.relative_to(REPO)} imports {name}"


def _recurrence_inputs(B, S, C, seed):
    """a in (0, 1) as mamba's exp(dt·A) is, b standard normal."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (B, S, C)).astype(np.float32),
            rng.standard_normal((B, S, C)).astype(np.float32))


# (B, S, C): the first three tile as the Pallas kernel needs (S % min(128, S)
# and C % min(512, C) == 0, so it runs in interpret mode too), the others are
# ragged and held to the jnp oracle only.
@pytest.mark.parametrize("B,S,C", [(1, 128, 512), (2, 256, 1024),
                                   (3, 16, 1536), (3, 7, 5), (1, 1, 1),
                                   (2, 300, 4099)])
@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_linear_recurrence_matches_pallas_kernel(B, S, C, dtype):
    a, b = _recurrence_inputs(B, S, C, seed=B * S + C)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    ja, jb = jnp.asarray(a, jdt), jnp.asarray(b, jdt)
    wants = [jref.linear_recurrence_ref(ja, jb)]
    if S % min(128, S) == 0 and C % min(512, C) == 0:
        wants.append(jlr.linear_recurrence(ja, jb, block_t=min(128, S),
                                           block_c=min(512, C),
                                           interpret=True))
    ta = _t(np.asarray(ja, np.float32), dtype)
    tb = _t(np.asarray(jb, np.float32), dtype)
    before = linear_recurrence.linear_recurrence.launches
    for h_all, h_last in (ref.linear_recurrence_ref(ta, tb),
                          ops.linear_recurrence(ta, tb)):
        assert h_all.dtype == h_last.dtype == torch.float32
        assert h_all.shape == (B, S, C) and h_last.shape == (B, C)
        for want_all, want_last in wants:
            # the same f32 products and sums in the same order: only the
            # compilers' contraction into FMAs may move the last bits
            np.testing.assert_allclose(h_all.numpy(), np.asarray(want_all),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(h_last.numpy(), np.asarray(want_last),
                                       rtol=1e-5, atol=1e-5)
    assert linear_recurrence.linear_recurrence.launches == before


def test_linear_recurrence_empty_time_axis_is_the_zero_state():
    a, b = torch.zeros(2, 0, 3), torch.zeros(2, 0, 3)
    h_all, h_last = linear_recurrence.linear_recurrence(a, b)
    assert h_all.shape == (2, 0, 3)
    assert torch.equal(h_last, torch.zeros(2, 3))


def test_linear_recurrence_wrapper_rejects_what_it_cannot_take():
    a, b = (torch.from_numpy(t) for t in _recurrence_inputs(2, 8, 16, 0))
    with pytest.raises(ValueError, match="one shape"):
        linear_recurrence.linear_recurrence(a, b[:, :4])
    with pytest.raises(ValueError, match="one shape"):
        linear_recurrence.linear_recurrence(a[0], b[0])
    # a meta tensor takes the shape-only route: no launch, no values
    h_all, h_last = linear_recurrence.linear_recurrence(a.to("meta"),
                                                        b.to("meta"))
    assert (h_all.device.type, h_all.shape, h_last.shape) == (
        "meta", a.shape, (a.shape[0], a.shape[2]))
    assert linear_recurrence.linear_recurrence.launches == 0
    with pytest.raises(ValueError, match="meta"):
        linear_recurrence.linear_recurrence(a, b.to("meta"))
