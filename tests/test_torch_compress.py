"""The port's compressed gossip against the JAX package's: the plain
``quantized_gossip_mix`` against the reference oracle (``repro.kernels.ref``),
the group-aligned flat layout against ``flatten_grouped``, the fused window
against the generic compressed mixer, the wire-format accounting and config
checks, and the engine's warmup gate and error-feedback switch.  Every input
is made with numpy from a fixed seed.  The CUDA kernel itself is held to its
plain version on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).

Quantization is discontinuous: summed in another order, one round's mixed
value can land on the other side of an int8 rounding boundary, or of 0 for
``sign``, and that entry then moves by one quantization step.  Round 1 sees
the inputs themselves, so R = 1 is held tightly (int8 exactly: max,
division, ``round`` and the product are exact operations).  From round 2 on,
a comparison allows such flipped entries, at most ``MAX_FLIPS`` of them."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro import exp as jexp  # noqa: E402
from repro.core import compress as jcompress, gossip as jgossip  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import build as jbuild  # noqa: E402
from repro_torch import configs, exp, tree  # noqa: E402
from repro_torch.core import compress, engine  # noqa: E402
from repro_torch.dist import collectives as coll  # noqa: E402
from repro_torch.kernels import ops, quantized_gossip, ref  # noqa: E402
from repro_torch.models import build, params_from_jax  # noqa: E402

SCHEMES = ("sign", "int8")
# f32 sums of n products (the mix) and of `group` magnitudes (the sign
# scale) in another order than XLA's: a few ulps on values of order 1.
RTOL, ATOL = 1e-5, 1e-5
# Entries allowed past RTOL/ATOL from round 2 on (a fraction of all): a
# one-ulp difference flips an int8 rounding with probability ~2*127*2^-24
# per entry and round; a fault in the kernel's arithmetic would move nearly
# every entry.
MAX_FLIPS = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def assert_close_up_to_flips(got, want, *, rtol, atol, max_frac, what=""):
    """``got`` equals ``want`` within rtol/atol except for at most a
    ``max_frac`` fraction of entries (quantization flips)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert bad.sum() <= max_frac * bad.size, (
        f"{what}: {int(bad.sum())} of {bad.size} entries beyond rtol={rtol} "
        f"atol={atol} (allowed {max_frac:.0e} of them)")


def _inputs(n, R, D, seed):
    rng = np.random.default_rng(seed)
    ws = jgossip.theorem3_weight_schedule(n, 0.6).stacked(seed % 4, R)
    x = rng.standard_normal((n, D)).astype(np.float32)
    res = (0.1 * rng.standard_normal((n, D))).astype(np.float32)
    return ws.astype(np.float32), x, res


def _oracle(ws, x, res, **kw):
    o, r = jref.quantized_gossip_mix_ref(jnp.asarray(ws), jnp.asarray(x),
                                         jnp.asarray(res), **kw)
    return np.asarray(o), np.asarray(r)


@pytest.mark.parametrize("group", [8, 64, 256])
@pytest.mark.parametrize("R", [1, 2, 4])
@pytest.mark.parametrize("ef", [True, False])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_plain_version_matches_oracle(scheme, ef, R, group):
    n, D = 8, 4096
    ws, x, res = _inputs(n, R, D, seed=R * 1000 + group)
    kw = dict(scheme=scheme, group=group, error_feedback=ef)
    want_o, want_r = _oracle(ws, x, res, **kw)
    tws, tx, tres = map(torch.from_numpy, (ws, x, res))
    before = quantized_gossip.quantized_gossip_mix.launches
    # ops.quantized_gossip_mix is the kernel wrapper itself
    assert ops.quantized_gossip_mix is quantized_gossip.quantized_gossip_mix
    for o, r in (ref.quantized_gossip_mix_ref(tws, tx, tres, **kw),
                 ops.quantized_gossip_mix(tws, tx, tres, **kw)):
        if scheme == "int8" and R == 1:
            np.testing.assert_array_equal(o.numpy(), want_o)
            np.testing.assert_array_equal(r.numpy(), want_r)
        elif R == 1:
            np.testing.assert_allclose(o.numpy(), want_o, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(r.numpy(), want_r, rtol=RTOL, atol=ATOL)
        else:
            for got, want, what in ((o, want_o, "x"), (r, want_r, "res")):
                assert_close_up_to_flips(got.numpy(), want, rtol=RTOL,
                                         atol=ATOL, max_frac=MAX_FLIPS,
                                         what=what)
    # the plain version on a CPU tensor is not a kernel launch
    assert quantized_gossip.quantized_gossip_mix.launches == before


def _qdq(buf, scheme, group):
    deq, err = ref.quantize_dequantize_ref(torch.tensor(buf), scheme=scheme,
                                           group=group)
    jdeq, jerr = jref.quantize_dequantize_ref(jnp.asarray(buf), scheme=scheme,
                                              group=group)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jdeq))
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))
    return deq.numpy(), err.numpy()


def test_int8_ties_round_half_to_even():
    # max|g| = 127 makes the scale exactly 1, so g / scale are the ties
    buf = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -2.5]],
                   np.float32)
    deq, _ = _qdq(buf, "int8", 8)
    np.testing.assert_array_equal(
        deq, [[127.0, 2.0, -4.0, 0.0, -0.0, 2.0, 126.0, -2.0]])


def test_sign_of_zero_is_zero():
    buf = np.array([[2.0, 0.0, -2.0, 0.0], [0.0, 1.0, 0.0, 0.0]], np.float32)
    deq, err = _qdq(buf, "sign", 4)
    np.testing.assert_array_equal(deq, [[1.0, 0.0, -1.0, 0.0],
                                        [0.0, 0.25, 0.0, 0.0]])
    np.testing.assert_array_equal(err, [[1.0, 0.0, -1.0, 0.0],
                                        [0.0, 0.75, 0.0, 0.0]])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_all_zero_group_stays_zero(scheme):
    buf = np.zeros((2, 64), np.float32)
    buf[1, 32:] = np.linspace(-1, 1, 32)     # one live group beside them
    deq, err = _qdq(buf, scheme, 32)
    assert np.isfinite(deq).all() and np.isfinite(err).all()
    np.testing.assert_array_equal(deq[:, :32], 0.0)
    np.testing.assert_array_equal(deq[0], 0.0)
    np.testing.assert_array_equal(err[0], 0.0)


def _stacked(trees):
    return jax.tree.map(lambda *ls: jnp.stack(ls), *trees)


@pytest.mark.parametrize("group", [1, 8, 256, 1000])
def test_aligned_layout_matches_flatten_grouped(group):
    """Column for column: the CUT-width qwen parameters of 3 nodes, and a
    tree of odd-sized leaves."""
    n = 3
    cut = dict(layers=2, d_model=64, d_ff=128, vocab=128)
    jmodel = jbuild(jconfigs.get("qwen1.5-0.5b").reduced(**cut))
    shapes = build(configs.get("qwen1.5-0.5b").reduced(**cut)).shapes
    params = [jax.device_get(jmodel.init(jax.random.key(i), jnp.float32))
              for i in range(n)]
    rng = np.random.default_rng(group)
    odd = [{"a": rng.standard_normal(13).astype(np.float32),
            "b": {"c": rng.standard_normal((3, 5)).astype(np.float32),
                  "d": rng.standard_normal(()).astype(np.float32)}}
           for _ in range(n)]
    odd_shapes = {"a": (13,), "b": {"c": (3, 5), "d": ()}}
    for trees, shp in ((params, shapes), (odd, odd_shapes)):
        want, _ = jcompress.flatten_grouped(
            _stacked([jax.tree.map(jnp.asarray, t) for t in trees]), group)
        layout = coll.FlatLayout(shp, align=group)
        got = torch.stack([layout.flatten(params_from_jax(t)) for t in trees])
        assert layout.size == want.shape[1] and layout.size % group == 0
        assert all(off % group == 0 for _, _, off in layout.entries)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        back = layout.views(got[1])
        for (path, leaf), (_, orig) in zip(
                tree.items(back), tree.items(params_from_jax(trees[1]))):
            np.testing.assert_array_equal(leaf.numpy(), orig.numpy(),
                                          err_msg=str(path))


@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("scheme", SCHEMES)
def test_fused_window_matches_generic_mixer(scheme, R):
    """``fused_quantized_consensus`` (the kernel path; its plain version on
    the CPU) == ``make_compressed_mixer`` around one matmul per round, and
    it works in place."""
    n, D, group = 8, 1024, 64
    ws, x, res = _inputs(n, R, D, seed=7 + R)
    cfg = compress.CompressionConfig(scheme=scheme, group=group)
    tws = torch.from_numpy(ws)
    cmix = compress.make_compressed_mixer(lambda idx, m: tws[idx] @ m, cfg)
    want, wres = cmix(0, R, torch.from_numpy(x), torch.from_numpy(res.copy()),
                      True)
    mat, rmat = torch.from_numpy(x.copy()), torch.from_numpy(res.copy())
    got, gres = coll.fused_quantized_consensus(tws, mat, rmat, cfg, True)
    assert got.data_ptr() == mat.data_ptr() and gres.data_ptr() == rmat.data_ptr()
    if R == 1:
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        torch.testing.assert_close(gres, wres, rtol=RTOL, atol=ATOL)
    else:
        assert_close_up_to_flips(got, want, rtol=RTOL, atol=ATOL,
                                 max_frac=MAX_FLIPS, what="x")
        assert_close_up_to_flips(gres, wres, rtol=RTOL, atol=ATOL,
                                 max_frac=MAX_FLIPS, what="res")
    # the gate off: the plain gossip_mix, res untouched
    mat, rmat = torch.from_numpy(x.copy()), torch.from_numpy(res.copy())
    got, gres = coll.fused_quantized_consensus(tws, mat, rmat, cfg, False)
    want = ref.gossip_mix_ref(tws, torch.from_numpy(x))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(gres.numpy(), res)


@pytest.mark.parametrize("dim,scheme,group", [
    (1000, "none", 256), (1000, "sign", 256), (1000, "int8", 256),
    (1000, "sign", 1000), (463_987_712, "int8", 256),
    (463_987_712, "sign", 256), (7, "sign", 4)])
def test_payload_bytes_matches_reference(dim, scheme, group):
    want = jcompress.payload_bytes(dim, scheme, group)
    assert compress.payload_bytes(dim, scheme, group) == want
    if scheme != "none":
        per_entry = {"sign": 1 / 8, "int8": 1}[scheme]
        assert want == math.ceil(dim * per_entry) + 4 * math.ceil(dim / group)


@pytest.mark.parametrize("kw", [dict(scheme="none"), dict(scheme="fp4"),
                                dict(scheme="sign", group=0),
                                dict(scheme="int8", warmup=-1)])
def test_compression_config_refuses_what_the_reference_refuses(kw):
    with pytest.raises(ValueError):
        jcompress.CompressionConfig(**kw)
    with pytest.raises(ValueError):
        compress.CompressionConfig(**kw)


@pytest.mark.parametrize("section", [
    {"scheme": "int8", "group": 128, "warmup": 5, "error_feedback": False},
    {"scheme": "sign"}, {}])
def test_build_compression_matches_reference(section):
    jspec = jexp.from_dict({"compression": section})
    spec = exp.from_dict({"compression": section})
    want = jexp.build_compression(jspec.compression)
    got = exp.build_compression(spec.compression)
    if want is None:
        assert got is None
    else:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("section", [{"scheme": "sign", "group": 0},
                                     {"scheme": "int8", "warmup": -1},
                                     {"scheme": "fp4"}])
def test_build_refuses_bad_compression(section):
    with pytest.raises(ValueError):
        exp.build(exp.from_dict({"compression": section}), device="cpu")


def test_wrapper_refuses_what_it_cannot_take():
    ws, x, res = _inputs(4, 2, 64, seed=0)
    tws, tx, tres = map(torch.from_numpy, (ws, x, res))
    with pytest.raises(ValueError, match="multiple of group"):
        quantized_gossip.quantized_gossip_mix(tws, tx, tres, scheme="int8",
                                              group=48)
    with pytest.raises(ValueError, match="scheme"):
        quantized_gossip.quantized_gossip_mix(tws, tx, tres, scheme="fp4")
    with pytest.raises(ValueError):
        quantized_gossip.quantized_gossip_mix(tws, tx, tres[:3], scheme="sign",
                                              group=8)
    with pytest.raises(ValueError):
        quantized_gossip.quantized_gossip_mix(
            tws.to("meta"), tx.to("meta"), tres.to("meta"), scheme="sign",
            group=8)


# ---------------------------------------------------------------------------
# The engine: warmup gate and error feedback, on a toy quadratic oracle
# ---------------------------------------------------------------------------

def _toy_run(rule, steps, cmix_kind, n=8, D=512, seed=3):
    """``steps`` steps of ``rule`` on f_i(x) = ½‖a_i ⊙ (x − c_i)‖², the
    (n, D) state mixed by dense matrices.  Returns the states after each
    step."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.5, (n, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((n, D)).astype(np.float32))
    x0 = torch.from_numpy(np.tile(rng.standard_normal(D).astype(np.float32),
                                  (n, 1)))
    Ws = torch.from_numpy(jgossip.theorem3_weight_schedule(n, 0.6)
                          .stacked(0, rule.weights_per_step)
                          .astype(np.float32))

    def grad(x, out=None):
        g = a * a * (x - c)
        return None, (g if out is None else out.copy_(g))

    def mix(off, r, mat):
        for i in range(off, off + r):
            mat = Ws[i] @ mat
        return mat

    cmix = None
    if rule.compression is not None:
        if cmix_kind == "fused":
            cmix = lambda off, r, mat, res, on: coll.fused_quantized_consensus(  # noqa: E731
                Ws[off:off + r], mat, res, rule.compression, on)
        else:
            cmix = compress.make_compressed_mixer(
                lambda i, mat: Ws[i] @ mat, rule.compression)
    ops_ = engine.EngineOps(mix=mix, grad=grad, cmix=cmix)
    state = engine.warm_start(rule, engine.init_state(rule, x0.clone()), ops_)
    out = []
    for _ in range(steps):
        state, _ = engine.step(rule, state, ops_)
        out.append(engine.EngineState(
            *(None if t is None else t.clone() for t in state[:3]), state.k,
            None if state.res is None else tuple(
                None if t is None else t.clone() for t in state.res)))
    return out


@pytest.mark.parametrize("cmix_kind", ["fused", "dense"])
@pytest.mark.parametrize("algo", ["mc_dsgt", "dsgd"])
def test_warmup_is_uncompressed_until_it_ends(algo, cmix_kind):
    """For k < warmup the state is bit-equal to an uncompressed run on the
    same (n, D) layout and the residuals are zero; at k = warmup the scheme
    activates: x differs and res_x is nonzero."""
    warmup, R = 2, 2 if algo == "mc_dsgt" else 1
    cfg = compress.CompressionConfig(scheme="sign", group=64, warmup=warmup)
    comp = _toy_run(engine.make_rule(algo, 0.1, R, compression=cfg),
                    warmup + 1, cmix_kind)
    plain = _toy_run(engine.make_rule(algo, 0.1, R), warmup + 1, cmix_kind)
    for k, (sc, sp) in enumerate(zip(comp, plain)):
        if k < warmup:
            torch.testing.assert_close(sc.x, sp.x, rtol=0, atol=0)
            if algo == "mc_dsgt":
                torch.testing.assert_close(sc.h, sp.h, rtol=0, atol=0)
            assert all(float(r.abs().max()) == 0.0
                       for r in sc.res if r is not None)
        else:
            assert float((sc.x - sp.x).abs().max()) > 0.0
            assert float(sc.res[0].abs().max()) > 0.0
    assert (comp[0].res[1] is None) == (algo == "dsgd")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_error_feedback_off_leaves_res_untouched(scheme):
    ws, x, res = _inputs(8, 2, 512, seed=5)
    tws = torch.from_numpy(ws)
    o, r = ref.quantized_gossip_mix_ref(tws, torch.from_numpy(x),
                                        torch.from_numpy(res), scheme=scheme,
                                        group=8, error_feedback=False)
    np.testing.assert_array_equal(r.numpy(), res)
    mat, rmat = torch.from_numpy(x.copy()), torch.from_numpy(res.copy())
    quantized_gossip.quantized_gossip_mix(tws, mat, rmat, scheme=scheme,
                                          group=8, error_feedback=False,
                                          out=mat, res_out=rmat)
    np.testing.assert_array_equal(rmat.numpy(), res)
    torch.testing.assert_close(mat, o, rtol=0, atol=0)
    # with feedback the residual moves
    _, r_ef = ref.quantized_gossip_mix_ref(tws, torch.from_numpy(x),
                                           torch.from_numpy(res),
                                           scheme=scheme, group=8)
    assert float((r_ef - torch.from_numpy(res)).abs().max()) > 0.0
    # and in the engine: zero residuals stay zero over two steps
    cfg = compress.CompressionConfig(scheme=scheme, group=64,
                                     error_feedback=False)
    states = _toy_run(engine.make_rule("mc_dsgt", 0.1, 2, compression=cfg),
                      2, "fused")
    assert all(float(r.abs().max()) == 0.0 for r in states[-1].res)


def test_engine_requires_cmix_and_residuals():
    cfg = compress.CompressionConfig(scheme="sign")
    rule = engine.make_rule("dsgd", gamma=0.1, compression=cfg)
    x0 = torch.ones(4, 256)
    state = engine.init_state(rule, x0)
    assert state.res[0].shape == x0.shape and state.res[1] is None
    ops_ = engine.EngineOps(mix=lambda off, r, t: t,
                            grad=lambda x, out=None: (None, x))
    with pytest.raises(ValueError, match="cmix"):
        engine.step(rule, state, ops_)
    with pytest.raises(ValueError, match="residual"):
        engine.step(rule, state._replace(res=None),
                    ops_._replace(cmix=lambda *a: a[2:4]))
