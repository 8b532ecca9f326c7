"""The spec smoke, the port of the JAX package's ``exp/validate.py`` (its CI
entry): prove every example's spec literal builds and runs on the port,
and that every checked-in manifest still parses (schema drift fails fast).

    PYTHONPATH=src python -m repro_torch.exp.validate [--examples DIR]
        [--manifests GLOB] [--steps N] [--min-manifests K] [--only SUBSTR]
        [--device DEV]

Four passes, as in the reference:

1. every ``SPECS`` entry exported by the example scripts (the twins under
   ``examples/torch/`` by default, whose pool is the reference's) is
   rebuilt with a tiny run shape (``--steps``, no checkpoint/telemetry/obs
   I/O) and executed end to end through :func:`repro_torch.exp.run`;
2. the observability path (:mod:`repro_torch.obs`) is smoked: a tiny
   ObsSpec-enabled run must produce a parseable JSONL event log covering
   every step, a manifest that round-trips, and a report render;
3. the compressed-gossip axis is smoked: {sign, int8} x {20% link drop,
   federated} MC-DSGT cells run end to end and must report bytes telemetry
   and a realized bytes/round priced at the scheme's wire format;
4. every manifest matching ``--manifests`` (the checked-in scenario
   manifests under ``experiments/manifests/`` by default) is round-tripped
   through the strict ``from_dict``/``to_dict`` pair, and the run fails if
   fewer than ``--min-manifests`` matched (a vacuous glob is a failure,
   not a pass).

Every run takes ``--device`` (default ``cuda``, as ``launch/train.py``;
``--device cpu`` runs without a GPU).  Loading an example runs its module
body only: the twins' ``main()`` (and the ``*_compare.py`` timing scripts')
sits behind ``if __name__ == "__main__"``.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import importlib.util
import json
import os
import sys
import tempfile

from ..core import compress
from ..obs import report as obs_report
from . import manifest as mf, spec as S
from .build import run as _run


def iter_example_specs(examples_dir: str):
    """Yield ``(example_name, spec_name, spec)`` for every module-level
    ``SPECS`` mapping in ``<examples_dir>/*.py``."""
    for path in sorted(glob.glob(os.path.join(examples_dir, "*.py"))):
        name = os.path.splitext(os.path.basename(path))[0]
        modname = f"_exp_validate_{name}"
        spec_obj = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec_obj)
        sys.modules[modname] = mod
        spec_obj.loader.exec_module(mod)
        for spec_name, spec in getattr(mod, "SPECS", {}).items():
            yield name, spec_name, spec


def shrink(spec: S.ExperimentSpec, steps: int) -> S.ExperimentSpec:
    """A smoke-sized copy of ``spec``: ``steps`` steps, no output files, and
    a handful of short serve requests when the spec enables a serve phase
    (still exercising admit/prefill/decode/evict end to end)."""
    sv = spec.serve
    if sv.enabled:
        sv = dataclasses.replace(sv, requests=min(sv.requests, 8),
                                 batch=min(sv.batch, 4),
                                 max_new=min(sv.max_new, 4),
                                 prompt_len=min(sv.prompt_len, 8))
    return dataclasses.replace(
        spec,
        run=dataclasses.replace(
            spec.run, steps=steps, eval_every=1, checkpoint=None,
            restore=None, telemetry=None),
        obs=S.ObsSpec(), serve=sv)


def validate_obs(steps: int, device: str = "cuda") -> list[str]:
    """Smoke the metrics path end to end: run a tiny ObsSpec-enabled spec,
    then assert the JSONL event log parses, covers every step, carries a
    summary, round-trips its manifest, and renders through the report."""
    failures = []
    with tempfile.TemporaryDirectory() as tmp:
        log = os.path.join(tmp, "obs.jsonl")
        spec = S.from_dict({
            "model": {"kind": "logreg", "d": 8, "m": 32},
            "algorithm": {"name": "mc_dsgt", "R": 2},
            "run": {"steps": steps + 2, "nodes": 4},
            "obs": {"metrics": log, "every": 2},
        })
        try:
            _run(spec, device=device, quiet=True)
            with open(log) as f:
                events = [json.loads(line) for line in f]
            kinds = [e["event"] for e in events]
            n_steps = kinds.count("step")
            assert kinds[0] == "meta", f"first event {kinds[0]!r}, not meta"
            assert n_steps == spec.run.steps, \
                f"{n_steps} step events for {spec.run.steps} steps " \
                "(flush batching lost events)"
            assert kinds[-1] == "summary", "no trailing summary event"
            assert events[-1]["optimality"]["gap_ratio"] is not None
            m = mf.load_manifest(mf.manifest_path(log))
            assert m["spec_parsed"] == spec
            text = obs_report.render(events)
            assert "optimality gap" in text and "grad_norm" in text
            print(f"ok   obs:metrics-path  [{S.spec_hash(spec)}]  "
                  f"events={len(events)}")
        except Exception as e:  # noqa: BLE001 - collect, don't crash
            failures.append(f"obs:metrics-path: {type(e).__name__}: {e}")
            print(f"FAIL obs:metrics-path: {e}")
    return failures


def validate_compression(steps: int, only: str = None,
                         device: str = "cuda") -> list[str]:
    """Smoke the compressed-gossip axis end to end: {sign, int8} x {20%
    link drop, federated} MC-DSGT cells, each a ``steps``-step ``exp.run``
    that must produce bytes telemetry and a realized-compression manifest
    block priced at the scheme's wire format."""
    failures = []
    scenarios = {
        "drop20": {"topology": {"kind": "waypoint-mobility", "radius": 0.45},
                   "channel": {"link_drop": 0.2}},
        "federated": {"topology": {"kind": "federated", "local_steps": 2}},
    }
    for scen, sections in scenarios.items():
        base = S.from_dict({
            "model": {"kind": "logreg", "d": 32, "m": 64},
            "algorithm": {"name": "mc_dsgt", "R": 2, "gamma": 0.2},
            "run": {"steps": steps, "nodes": 8, "eval_every": 1},
            "compression": {"group": 16},
            **sections})
        for spec in S.sweep(base, {"compression.scheme": ["sign", "int8"]}):
            tag = f"compression:{scen}-{spec.compression.scheme}"
            if only and only not in tag:
                continue
            try:
                result = _run(spec, device=device, quiet=True)
                assert result.telemetry is not None, "no telemetry recorder"
                assert result.telemetry.bytes_total > 0
                rc = result.built.realized["compression"]
                want = compress.payload_bytes(
                    spec.model.d, spec.compression.scheme,
                    spec.compression.group)
                assert rc["bytes_per_round"] == want, rc
                assert rc["bytes_per_round"] < rc["baseline_bytes_per_round"]
                print(f"ok   {tag}  [{S.spec_hash(spec)}]  "
                      f"wire_bytes={result.telemetry.bytes_total}")
            except Exception as e:  # noqa: BLE001 - collect all failures
                failures.append(f"{tag}: {type(e).__name__}: {e}")
                print(f"FAIL {tag}: {e}")
    return failures


def validate_manifests(pattern: str) -> list[str]:
    """Strict round-trip of every manifest matching ``pattern``; returns
    failure strings (empty = all good)."""
    failures = []
    for path in sorted(glob.glob(pattern)):
        try:
            m = mf.load_manifest(path)
            spec = m["spec_parsed"]
            again = S.from_dict(S.to_dict(spec))
            if again != spec:
                failures.append(f"{path}: to_dict/from_dict not a fixpoint")
            if m["spec_hash"] != S.spec_hash(spec):
                failures.append(f"{path}: stored spec_hash "
                                f"{m['spec_hash']} != {S.spec_hash(spec)}")
        except Exception as e:  # noqa: BLE001 - report, don't crash the loop
            failures.append(f"{path}: {type(e).__name__}: {e}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--examples", default=os.path.join("examples", "torch"))
    ap.add_argument("--manifests", default="experiments/manifests/*.json")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--min-manifests", type=int, default=1,
                    help="fail unless at least this many checked-in "
                         "manifests matched --manifests (guards against "
                         "the glob silently matching nothing)")
    ap.add_argument("--only", default=None,
                    help="run only example specs whose name contains SUBSTR")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; --device cpu runs "
                         "without a GPU)")
    args = ap.parse_args(argv)

    failures = []
    n_specs = 0
    for example, spec_name, spec in iter_example_specs(args.examples):
        tag = f"{example}:{spec_name}"
        if args.only and args.only not in tag:
            continue
        n_specs += 1
        try:
            small = shrink(spec, args.steps)
            # the JSON round trip is part of the contract being smoked
            assert S.from_json(S.to_json(small)) == small
            result = _run(small, device=args.device, quiet=True)
            assert result.history is not None
            print(f"ok   {tag}  [{S.spec_hash(small)}]  "
                  f"history={len(result.history)}")
        except Exception as e:  # noqa: BLE001 - collect all failures
            failures.append(f"{tag}: {type(e).__name__}: {e}")
            print(f"FAIL {tag}: {e}")
    print(f"{n_specs} example spec(s) smoked")

    if not args.only:
        failures += validate_obs(args.steps, args.device)
    if not args.only or "compression" in args.only:
        failures += validate_compression(args.steps, args.only, args.device)

    mfails = validate_manifests(args.manifests)
    n_manifests = len(glob.glob(args.manifests))
    print(f"{n_manifests} manifest(s) round-tripped, {len(mfails)} failed")
    failures += mfails
    if n_manifests < args.min_manifests:
        failures.append(
            f"only {n_manifests} manifest(s) matched {args.manifests!r} "
            f"(expected >= {args.min_manifests}) — the schema-drift guard "
            "would be vacuous")

    if failures:
        print("\nFAILURES:")
        for f in failures:
            print(f"  {f}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
