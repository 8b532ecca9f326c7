"""The port's reproducibility manifests and telemetry files against the JAX
package's: a manifest written by either package loads in the other with the
same spec and ``spec_hash``, the checked-in manifests under
``experiments/manifests/`` load in the port, the port's resolved manifests of
the quickstart's MC-DSGT spec and of the 100,000-client sampled spec equal
the checked-in files, and the dense ``TelemetryRecorder`` writes the
reference's file."""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import exp as jexp  # noqa: E402
from repro.core import algorithms as jalg  # noqa: E402
from repro.core import compress as jcompress  # noqa: E402
from repro.exp import registry as jregistry, spec as jspec  # noqa: E402
from repro.sim import telemetry as jtelemetry  # noqa: E402
from repro_torch import exp  # noqa: E402
from repro_torch.core import algorithms as alg, compress  # noqa: E402
from repro_torch.exp import registry, spec as tspec  # noqa: E402
from repro_torch.sim import telemetry  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
MANIFESTS = REPO / "experiments" / "manifests"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _twin(name: str):
    path = REPO / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SPEC = exp.with_overrides(exp.ExperimentSpec(), {
    "model.kind": "logreg", "model.d": 54, "topology.kind": "random-sun",
    "compression.scheme": "int8", "data.hetero_alpha": 0.1,
    "run.nodes": 8, "run.steps": 3, "run.telemetry": "t.json"})


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_manifest_written_by_one_package_loads_in_the_other(tmp_path,
                                                            writer):
    realized = exp.build(SPEC, device="cpu").realized
    jspec_ = jexp.from_dict(exp.to_dict(SPEC))
    out = str(tmp_path / "run.json")
    if writer == "port":
        path = exp.write_manifest(out, SPEC, realized=realized)
    else:
        path = jexp.write_manifest(out, jspec_, realized=realized)
    assert path == exp.manifest_path(out) == jexp.manifest_path(out)
    a, b = exp.load_manifest(path), jexp.load_manifest(path)
    assert a["spec_hash"] == b["spec_hash"] == exp.spec_hash(SPEC) == \
        jexp.spec_hash(jspec_)
    assert exp.to_dict(a["spec_parsed"]) == jexp.to_dict(b["spec_parsed"])
    assert a["spec_parsed"] == SPEC and b["spec_parsed"] == jspec_
    assert a["realized"] == b["realized"] == realized
    assert exp.resolved_manifest(SPEC, realized=realized) == \
        jexp.resolved_manifest(jspec_, realized=realized)


@pytest.mark.parametrize("name", sorted(p.name for p in
                                        MANIFESTS.glob("*.json")))
def test_checked_in_manifests_load_in_the_port(name):
    path = str(MANIFESTS / name)
    d = exp.load_manifest(path)
    assert d["spec_hash"] == exp.spec_hash(d["spec_parsed"])
    jd = jexp.load_manifest(path)
    assert exp.to_dict(d["spec_parsed"]) == jexp.to_dict(jd["spec_parsed"])


def test_diff_specs_and_restore_check_are_the_references(tmp_path):
    other = exp.with_overrides(SPEC, {"algorithm.gamma": 0.1,
                                      "run.steps": 9, "obs.every": 3})
    jother = jexp.from_dict(exp.to_dict(other))
    jspec_ = jexp.from_dict(exp.to_dict(SPEC))
    assert exp.diff_specs(SPEC, other) == jexp.diff_specs(jspec_, jother) \
        == ["algorithm.gamma"]
    ck = str(tmp_path / "ck.msgpack")
    assert exp.check_restore_spec(ck, other) is None
    jexp.write_manifest(ck, jspec_)
    with pytest.warns(UserWarning, match="algorithm.gamma"):
        assert exp.check_restore_spec(ck, other) == ["algorithm.gamma"]


def _checked_in(name: str, spec) -> None:
    want = json.loads((MANIFESTS / name).read_text())
    got = exp.resolved_manifest(
        spec, realized=exp.build(spec, device="cpu").realized)
    # the file went through JSON: compare what it holds, key for key
    assert json.loads(json.dumps(got)) == want


def test_quickstart_manifest_is_the_checked_in_one():
    _checked_in("quickstart_mc_dsgt.json",
                _twin("quickstart").SPECS["mc_dsgt"])


def test_sampled_100k_manifest_is_the_checked_in_one():
    """The 100,000-client sampled spec (its CPU build, schedule and data,
    takes ~10 s on one core); ``chip_smoke.py`` checks the manifest the
    twin writes on the card."""
    _checked_in("sampled_clients_100k.json", _twin("sampled_clients")._BASE)


@pytest.mark.parametrize("scheme,warmup", [(None, 0), ("sign", 1),
                                           ("int8", 0)])
def test_dense_telemetry_file_is_the_references(tmp_path, scheme, warmup):
    """The same realized schedule and states through both packages' dense
    recorders, dumped: equal fields and history except ``sec``, consensus
    to f32 rounding."""
    kw = dict(kind="random-sun", centers=2)
    jsched = jregistry.build_topology(jspec.TopologySpec(**kw), 8,
                                      horizon=40, seed=2)
    sched = registry.build_topology(tspec.TopologySpec(**kw), 8, horizon=40,
                                    seed=2)
    jcomp = comp = None
    if scheme:
        jcomp = jcompress.CompressionConfig(scheme=scheme, warmup=warmup)
        comp = compress.CompressionConfig(scheme=scheme, warmup=warmup)
    jrec = jtelemetry.TelemetryRecorder(jsched, wps=4, every=2,
                                        compression=jcomp)
    rec = telemetry.TelemetryRecorder(sched, wps=4, every=2,
                                      compression=comp)
    rng = np.random.default_rng(0)
    for k in range(5):
        xs = rng.standard_normal((8, 54)).astype(np.float32)
        jst = jalg.AlgoState(jnp.asarray(xs), None, None, None, k)
        jrec.record(k, 4 * (k + 1), jst, {"loss": 0.5 + k}, 0.1 * k)
        rec.record(k, 4 * (k + 1), alg.state_from_arrays(xs),
                   {"loss": torch.tensor(0.5 + k)}, 0.2 * k)
    jrec.dump(str(tmp_path / "j.json"))
    rec.dump(str(tmp_path / "t.json"))
    a = json.loads((tmp_path / "j.json").read_text())
    b = json.loads((tmp_path / "t.json").read_text())
    assert a["fields"] == b["fields"]
    assert len(a["history"]) == len(b["history"]) == 3
    for ea, eb in zip(a["history"], b["history"]):
        del ea["sec"], eb["sec"]
        np.testing.assert_allclose(eb.pop("consensus"), ea.pop("consensus"),
                                   rtol=1e-5)
        assert ea == eb
    assert rec.bytes_total == jrec.bytes_total > 0


def test_arch_trainer_writes_its_telemetry_file(tmp_path):
    """``run.telemetry`` on the arch trainer: the recorder's file and the
    manifest beside it, and the logged consensus is the recorder's."""
    path = str(tmp_path / "arch.json")
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "data.batch": 1, "data.seq": 16, "run.nodes": 2, "run.steps": 2,
        "topology.beta": 0.5, "run.gossip_impl": "pallas",
        "compression.scheme": "int8", "run.telemetry": path})
    res = exp.run(spec, device="cpu", quiet=True)
    history = json.loads(Path(path).read_text())["history"]
    assert [h["step"] for h in history] == [0, 1]
    assert [h["consensus"] for h in history] == \
        [h["consensus"] for h in res.history]
    assert history[-1]["bytes_total"] == res.telemetry.bytes_total > 0
    manifest = exp.load_manifest(exp.manifest_path(path))
    assert manifest["spec_parsed"] == spec
    assert manifest["realized"] == res.built.realized
    assert manifest["realized"] == jexp.build(
        jexp.from_dict(exp.to_dict(spec))).realized
