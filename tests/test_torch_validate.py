"""The port's spec smoke (``repro_torch.exp.validate``) against the JAX
package's: the ``examples/torch/`` twins' ``SPECS`` pool equals the
reference's ``examples/`` pool entry for entry (``spec_hash`` and JSON),
the four passes run on the CPU with ``--device cpu``, ``--only`` picks the
cells CI's steps pick, and ``--min-manifests`` above the checked-in count
fails, as the reference's guard does."""

import glob
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.exp import spec as jspec, validate as jvalidate  # noqa: E402
from repro_torch.exp import spec as tspec, validate  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = str(REPO / "examples")
TWINS = str(REPO / "examples" / "torch")
MANIFESTS = str(REPO / "experiments" / "manifests" / "*.json")
N_MANIFESTS = 4   # the checked-in files CI's --min-manifests 4 counts


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _drop_loaded_examples():
    """Both packages' ``iter_example_specs`` register each example as a
    ``_exp_validate_<name>`` module; take them out again."""
    before = set(sys.modules)
    yield
    for name in set(sys.modules) - before:
        if name.startswith("_exp_validate_"):
            del sys.modules[name]


@pytest.fixture(scope="module")
def pools():
    """Both pools as {(example, spec name): spec}."""
    want = {(ex, name): spec
            for ex, name, spec in jvalidate.iter_example_specs(EXAMPLES)}
    got = {(ex, name): spec
           for ex, name, spec in validate.iter_example_specs(TWINS)}
    return got, want


def test_twin_pool_is_the_references(pools):
    """Every entry of the reference's pool, ``personalized_serve``
    included, has a twin with the same hash and JSON, and the twins add
    none."""
    got, want = pools
    assert sorted(got) == sorted(want)
    assert ("personalized_fleet", "personalized_serve") in got
    for key in want:
        assert tspec.spec_hash(got[key]) == jspec.spec_hash(want[key]), key
        assert tspec.to_json(got[key]) == jspec.to_json(want[key]), key


def test_shrink_is_the_references(pools):
    """The smoke-sized copies hash alike too (serve phases cut to 8
    requests of 8 + 4 tokens on 4 slots)."""
    got, want = pools
    for key in want:
        small, jsmall = (validate.shrink(got[key], 2),
                         jvalidate.shrink(want[key], 2))
        assert tspec.spec_hash(small) == jspec.spec_hash(jsmall), key
    sv = validate.shrink(got[("personalized_fleet", "personalized_serve")],
                         2).serve
    assert (sv.requests, sv.batch, sv.prompt_len, sv.max_new) == (8, 4, 8, 4)


def test_loading_the_twins_runs_no_main(capsys):
    """Loading ``examples/torch/*.py`` runs module bodies only: the timing
    scripts (``*_compare.py``) and the twins print nothing and start no
    run."""
    names = [ex for ex, _, _ in validate.iter_example_specs(TWINS)]
    assert capsys.readouterr().out == ""
    assert "attention_compare" not in names
    assert "gossip_compare" not in names
    assert len(glob.glob(str(Path(TWINS) / "*_compare.py"))) == 4


def test_every_pass_runs_on_the_cpu(capsys):
    """``python -m repro_torch.exp.validate --device cpu --min-manifests 4``:
    14 example cells, the obs smoke, the 4 compression cells and the 4
    manifests, every one ok, exit code 0."""
    rc = validate.main(["--examples", TWINS, "--manifests", MANIFESTS,
                        "--device", "cpu", "--min-manifests",
                        str(N_MANIFESTS)])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "FAIL" not in out
    assert "14 example spec(s) smoked" in out
    assert out.count("ok   personalized_fleet:personalized_serve") == 1
    assert out.count("ok   obs:metrics-path") == 1
    assert out.count("ok   compression:") == 4
    assert f"{N_MANIFESTS} manifest(s) round-tripped, 0 failed" in out


@pytest.mark.parametrize("only,cells,compression", [
    ("serve", ["personalized_fleet:personalized_serve"], 0),
    ("compression", [], 4),    # no example tag says "compression"
    ("sampled", ["sampled_clients:sampled_auto",
                 "sampled_clients:sampled_host_dense"], 0),
])
def test_only_picks_the_cells_ci_picks(only, cells, compression, capsys,
                                       pools):
    """CI's three ``--only`` steps: the same cells as the reference's pool
    under the same filter, no obs smoke, the compression cells only for
    ``--only compression``."""
    want = sorted(f"{ex}:{name}" for ex, name in pools[1]
                  if only in f"{ex}:{name}")
    assert want == sorted(cells)
    rc = validate.main(["--examples", TWINS, "--manifests", MANIFESTS,
                        "--device", "cpu", "--only", only,
                        "--min-manifests", str(N_MANIFESTS)])
    out = capsys.readouterr().out
    assert rc == 0, out
    ran = sorted(line.split()[1] for line in out.splitlines()
                 if line.startswith("ok   ") and not line.split()[1]
                 .startswith(("obs:", "compression:")))
    assert ran == sorted(cells)
    assert out.count("ok   compression:") == compression
    assert "obs:metrics-path" not in out


@pytest.mark.parametrize("min_manifests,rc", [(N_MANIFESTS, 0),
                                              (N_MANIFESTS + 1, 1)])
def test_min_manifests_guard(min_manifests, rc, capsys):
    """Above the checked-in count the guard fails, as the reference's does
    (``--only`` matching no cell keeps the run to the manifest pass)."""
    args = ["--manifests", MANIFESTS, "--only", "no-such-cell",
            "--min-manifests", str(min_manifests)]
    assert validate.main(["--examples", TWINS, "--device", "cpu", *args]) \
        == rc
    out = capsys.readouterr().out
    assert jvalidate.main(["--examples", EXAMPLES, *args]) == rc
    assert capsys.readouterr().out == out
    if rc:
        assert "the schema-drift guard would be vacuous" in out


def test_a_failing_cell_is_reported_not_raised(capsys, monkeypatch):
    """A cell that raises is collected as a failure and the run exits 1."""
    def broken(spec, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(validate, "_run", broken)
    rc = validate.main(["--examples", TWINS, "--manifests", MANIFESTS,
                        "--device", "cpu", "--only", "serve"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL personalized_fleet:personalized_serve: boom" in out
    assert "personalized_fleet:personalized_serve: RuntimeError: boom" in out
