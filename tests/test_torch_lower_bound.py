"""The port's zero-chain lower-bound instances (``core/lower_bound.py``, a
torch port) against the JAX package's: the component functions and their
gradients at f32, the instances' parameters, the zero-chain property, and
the ``examples/lower_bound_demo.py`` twin's progress events."""

import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import lower_bound as jlb  # noqa: E402
from repro.obs import Console as JConsole  # noqa: E402
from repro_torch.core import lower_bound as lb  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
# f32 transcendental functions (exp, the normal CDF) in two libraries
RTOL, ATOL = 1e-6, 1e-7
D = 24


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _points():
    """Chain points of every regime: coordinates across psi's kink at ±1/2
    and around 0, exact zeros past a prefix (prog < d), and all zeros."""
    rng = np.random.default_rng(0)
    xs = [rng.uniform(-2, 2, D), rng.normal(0, 0.6, D),
          np.where(np.arange(D) < 9, rng.uniform(0.6, 1.5, D), 0.0),
          np.zeros(D), np.linspace(-1, 1, D)]
    return [x.astype(np.float32) for x in xs]


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", ["psi", "phi"])
def test_scalar_functions_match_reference(name):
    z = np.linspace(-3, 3, 601).astype(np.float32)
    f, jf = getattr(lb, name), getattr(jlb, name)
    _close(f(torch.from_numpy(z)).numpy(), jf(jnp.asarray(z)), name)
    g = torch.func.vmap(torch.func.grad(f))(torch.from_numpy(z))
    _close(g.numpy(), jax.jit(jax.vmap(jax.grad(jf)))(jnp.asarray(z)),
           f"{name}'")
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", ["h", "h1", "h2"])
def test_chain_functions_and_gradients_match_reference(name):
    f, jf = getattr(lb, name), getattr(jlb, name)
    jvg = jax.jit(jax.value_and_grad(jf))
    for i, x in enumerate(_points()):
        jv, jg = jvg(jnp.asarray(x))
        _close(f(torch.from_numpy(x)).numpy(), jv, f"{name} at point {i}")
        _close(lb._grad(f, torch.from_numpy(x)).numpy(), jg,
               f"grad {name} at point {i}")


def test_prog_matches_reference():
    xs = np.stack(_points())
    assert lb.prog(torch.from_numpy(xs)).tolist() == \
        np.asarray(jlb.prog(jnp.asarray(xs))).tolist() == [D, D, 9, 0, D]


@pytest.mark.parametrize("j", [0, 1, 5, D - 2])
def test_zero_chain_property_holds_exactly(j):
    """With prog(x) = j, every component of grad h, grad h1 and grad h2
    past j + 1 is exactly 0 (the safe ``where`` keeps the masked branch's
    gradient at 0, not 0·∞ = NaN), and the oracle of Instance 1 adds no
    progress either."""
    rng = np.random.default_rng(j)
    x = np.zeros(D, np.float32)
    x[:j] = rng.uniform(0.6, 1.5, j)
    xt = torch.from_numpy(x)
    assert int(lb.prog(xt)) == j
    for f in (lb.h, lb.h1, lb.h2):
        g = lb._grad(f, xt)
        assert torch.isfinite(g).all()
        assert (g[j + 1:] == 0).all(), f.__name__
        assert int(lb.prog(g)) <= j + 1
    inst = lb.make_instance1(L=1.0, Delta=1.0, sigma=1.0, n=4, T=1)._replace(
        d=D)
    o = inst.oracle(xt, torch.Generator().manual_seed(j))
    assert torch.isfinite(o).all() and int(lb.prog(o)) <= j + 1


def test_instances_are_the_references():
    for args in ((1.0, 1.0, 1.0, 4, 100), (2.0, 10.0, 0.5, 16, 960)):
        assert tuple(lb.make_instance1(*args)) == \
            tuple(jlb.make_instance1(*args))
    for args in ((1.0, 10.0, 16, 1 - 1 / 16, 96), (1.0, 1.0, 8, 0.5, 400),
                 (3.0, 2.0, 5, 0.9, 1000, 2.0)):
        a, b = lb.make_instance2(*args), jlb.make_instance2(*args)
        assert tuple(a) == tuple(b)
        assert (a.set1, a.set2) == (b.set1, b.set2)
    assert (lb.DELTA0, lb.ELL0, lb.G_INF) == (jlb.DELTA0, jlb.ELL0, jlb.G_INF)


def test_instance2_functions_match_reference():
    inst = lb.make_instance2(L=1.0, Delta=10.0, n=8, beta=0.75, T=96)
    jinst = jlb.make_instance2(L=1.0, Delta=10.0, n=8, beta=0.75, T=96)
    xs = np.random.default_rng(3).uniform(-1, 1, (8, inst.d)).astype(
        np.float32) * inst.lam
    _close(inst.grad_stacked(torch.from_numpy(xs)).numpy(),
           jax.jit(jinst.grad_stacked)(jnp.asarray(xs)), "grad_stacked")
    _close(inst.f(torch.from_numpy(xs[0])).numpy(),
           jax.jit(jinst.f)(jnp.asarray(xs[0])), "f")
    inst1 = lb.make_instance1(L=1.0, Delta=1.0, sigma=1.0, n=4, T=2)
    jinst1 = jlb.make_instance1(L=1.0, Delta=1.0, sigma=1.0, n=4, T=2)
    x1 = np.random.default_rng(4).uniform(-1, 1, inst1.d).astype(np.float32)
    _close(inst1.grad_f(torch.from_numpy(x1 * inst1.lam)).numpy(),
           jax.jit(jinst1.grad_f)(jnp.asarray(x1 * jinst1.lam)), "grad_f")


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"{path.parent.name}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _events(text: str) -> list:
    return [tuple(int(v) for v in re.findall(r"=(\d+)", line))
            for line in text.splitlines() if line.startswith("progress ")]


def test_demo_twin_progress_equals_the_references(capsys):
    """The twin's progress events (round, T, max_prog, cap) equal the
    reference demo's, integer for integer, and both print the same."""
    _module(REPO / "examples" / "lower_bound_demo.py").main(JConsole())
    want = capsys.readouterr().out
    got_events = _module(REPO / "examples" / "torch" /
                         "lower_bound_demo.py").main(["--device", "cpu"])
    got = capsys.readouterr().out
    assert _events(got) == _events(want) == got_events
    assert len(got_events) == 6
    assert got == want
