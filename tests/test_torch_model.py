"""The port's dense transformer against the JAX package's: the same
parameters (carried across by ``params_from_jax``) and the same numpy
tokens give the same loss and gradients, and the flat state layout lines up
column for column with the reference's ``flatten_stacked``."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.dist import collectives as jcoll  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, tree  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

# f32 throughout; the two frameworks reduce matmuls and the softmax in other
# orders, which moves results by a few ulps per op over a 2-layer model.
RTOL, ATOL = 1e-4, 1e-5
CUT = dict(layers=2, d_model=64, d_ff=128, vocab=128)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg = jconfigs.get("qwen1.5-0.5b").reduced(**CUT)
    cfg = configs.get("qwen1.5-0.5b").reduced(**CUT)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jmodel = jbuild(jcfg)
    jparams = jmodel.init(jax.random.key(0), jnp.float32)
    tokens = np.random.default_rng(0).integers(0, 128, (2, 16)).astype(np.int32)
    return jmodel, jparams, build(cfg), tokens


def test_shapes_and_layout_match_reference(pair):
    jmodel, jparams, model, _ = pair
    want = {tuple(k.key for k in path): tuple(leaf.shape) for path, leaf
            in jax.tree_util.tree_leaves_with_path(jparams)}
    got = dict(tree.items(model.shapes))
    assert list(got) == list(want) and got == want
    # the port's flat row is the reference's flatten_stacked row
    stacked = jax.tree.map(lambda l: l[None], jparams)
    jmat, _ = jcoll.flatten_stacked(stacked)
    row = coll.FlatLayout(model.shapes).flatten(
        params_from_jax(jax.device_get(jparams)))
    np.testing.assert_array_equal(row.numpy(), np.asarray(jmat)[0])


def test_train_loss_and_every_gradient_leaf_match(pair):
    jmodel, jparams, model, tokens = pair
    jloss, jgrads = jax.value_and_grad(jmodel.train_loss)(
        jparams, {"tokens": jnp.asarray(tokens)})
    params = tree.map(lambda t: t.requires_grad_(),
                      params_from_jax(jax.device_get(jparams)))
    loss = model.train_loss(params, {"tokens": torch.from_numpy(tokens).long()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    want = dict(tree.items(jax.device_get(jgrads)))
    for path, p in tree.items(params):
        np.testing.assert_allclose(p.grad.numpy(), want[path], rtol=RTOL,
                                   atol=ATOL, err_msg="/".join(path))


def test_flat_gradient_buffer_matches(pair):
    """The trainer's path: per-layer leaves viewing one flat row, gradients
    accumulated straight into a flat buffer."""
    jmodel, jparams, model, tokens = pair
    jgrads = jax.grad(jmodel.train_loss)(jparams, {"tokens": jnp.asarray(tokens)})
    layout = coll.FlatLayout(model.shapes)
    x = layout.flatten(params_from_jax(jax.device_get(jparams)))
    g = torch.zeros_like(x)
    for _ in range(2):  # two backward passes accumulate
        model.train_loss(layout.grad_leaves(x, g),
                         {"tokens": torch.from_numpy(tokens).long()}).backward()
    want = np.asarray(jcoll.flatten_stacked(
        jax.tree.map(lambda l: l[None], jgrads))[0])[0]
    np.testing.assert_allclose(g.numpy(), 2 * want, rtol=RTOL, atol=2 * ATOL)
    # the views see the row without copying it
    views = layout.views(x)
    assert views["embed"]["embedding"].data_ptr() == x.data_ptr()
