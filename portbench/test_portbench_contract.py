"""The benchmark's files against its contract, and what the harness loads."""

import ast
import json
import re
from pathlib import Path

from portbench import run

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    assert all(0.01 <= m["bound"] <= 0.25 for m in e2e.values())
    assert all(m["source"] in ("host_clock", "device_trace")
               for m in e2e.values())


def test_every_cell_names_what_exists(cell_name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == cell_name)
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"].startswith("portbench/")
    loaded = run.load_cell(cell_name)
    assert loaded["config"]["name"] == conf["name"]
    assert loaded["config"]["reduced"] == conf["reduced"]
    assert (HERE / "reference" / f"{loaded['config']['family']}.py").exists()
    assert (HERE / "kinds" / f"{loaded['traffic']['kind']}.py").exists()
    assert loaded["traffic"]["why"]
    from portbench import compare

    assert set(loaded["limits"]) <= set(compare.NUMBERS)
    assert loaded["per_layer"] and len(loaded["end_to_end"]) >= 2
    for m in BENCH["per_layer"]:
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", ())) <= {
            w["name"] for w in BENCH["workloads"]}
        assert (HERE / "metrics" / f"{m['name']}.py").exists()


def _imports(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_jax_and_a_reference_of_its_own():
    for path in HERE.rglob("*.py"):
        assert not _imports(path) & set(run.FORBIDDEN), path
    for path in (HERE / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_modules_by_whole_top_level_name():
    assert run.loaded_forbidden({"repro_torch": 0, "repro_torch.x": 0,
                                 "jaxtyping": 0}) == []
    assert run.loaded_forbidden({"repro.core": 0, "jax": 0,
                                 "flax.linen": 0}) == ["flax", "jax",
                                                       "repro"]


def test_refuses_without_a_device(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(run, "_setup_paths", lambda: None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", BENCH["workloads"][0]["name"], "--seed",
                   str(2 ** 31 + 7), "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def test_result_line_has_the_contracts_keys(cell_name):
    from portbench.tinycells import tiny_cell

    cell = tiny_cell(cell_name)
    line = run.measure(cell, seed=2 ** 31 + 11, seconds=0.2, trace=False,
                       device="cpu", t_start=0.0)
    assert set(line) == LINE_KEYS and list(line)[-1] == "checks"
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    json.dumps(line)


def test_traced_line_has_the_contracts_keys(monkeypatch):
    """A traced line's keys, from a canned profile summary."""
    from portbench.kinds import decentralized_train as dt

    summary = {"steps": 2, "kernels": 10, "grad_ms": 8.0, "mix_ms": 1.0,
               "rule_ms": 1.0, "busy_s": 0.01, "window_s": 0.012,
               "mix_windows": [[("gossip_mix_warp_kernel", 400.0)]] * 4,
               "device_by_name": [("k", 0.01)],
               "idle_by_host": [("aten::mm", 0.002)]}

    def fake_run(family, config, traffic, limits, **kw):
        return {"correct": True, "attempted": 3, "failed": 0, "checks": {},
                "trace": summary,
                "cell": dt.cell_info(family, config, traffic, 1 << 20),
                "end_to_end": {}, "peak_bytes": 1}

    monkeypatch.setattr(dt, "run", fake_run)
    cell = run.load_cell(BENCH["workloads"][0]["name"])
    line = run.measure(cell, seed=1, seconds=1, trace=True, device="cpu",
                       t_start=0.0)
    assert set(line) == LINE_KEYS | {"breakdown"}
    assert list(line)[-1] == "checks"
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["metrics"]) <= {m["name"] for m in cell["per_layer"]}
    assert "oracle_ms" in line["metrics"]


def test_file_names_are_names():
    for p in HERE.rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            assert re.match(r"^[A-Za-z0-9_./-]{1,200}$",
                            str(p.relative_to(ROOT))), p
