"""Reproducibility manifests: the fully-resolved spec JSON written next to
every run output (checkpoint / telemetry), and the mismatch check
``restore_or_warm`` applies when a run resumes from a checkpoint whose
manifest disagrees with the current spec.
"""

from __future__ import annotations

import json
import os
import warnings
from typing import Optional

from . import spec as S

MANIFEST_FORMAT = "repro.exp/manifest/v1"

# Run-shape fields that legitimately differ between a run and its restore
# continuation — excluded from the mismatch comparison.
_RESUMABLE_RUN_FIELDS = ("steps", "checkpoint", "restore", "telemetry",
                         "log_every", "eval_every")

# Whole sections that are observation-only: they never change the training
# trajectory, so a restore continuation may change them freely.
_NON_SCENARIO_SECTIONS = ("obs",)


def manifest_path(output_path: str) -> str:
    """The manifest sits next to its output: ``<output>.spec.json``."""
    return output_path + ".spec.json"


def resolved_manifest(spec: S.ExperimentSpec, *, realized: dict | None = None) -> dict:
    """The manifest payload: the FULL spec (defaults included, so the file
    is self-contained even if future defaults change), its hash, and the
    realized quantities a reader cannot derive from the spec alone (the
    materialized schedule period, rounds per step, horizon, plan kinds)."""
    return {
        "format": MANIFEST_FORMAT,
        "spec": S.to_dict(spec, elide_defaults=False),
        "spec_hash": S.spec_hash(spec),
        "realized": dict(realized or {}),
    }


def write_manifest(output_path: str, spec: S.ExperimentSpec, *,
                   realized: dict | None = None) -> str:
    path = manifest_path(output_path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(resolved_manifest(spec, realized=realized), f, indent=1,
                  sort_keys=True)
    return path


def load_manifest(path: str) -> dict:
    with open(path) as f:
        d = json.load(f)
    if d.get("format") != MANIFEST_FORMAT:
        raise ValueError(f"{path}: not a {MANIFEST_FORMAT} manifest "
                         f"(format={d.get('format')!r})")
    # strict round-trip: schema drift in the spec section fails here
    d["spec_parsed"] = S.from_dict(d["spec"])
    return d


def _comparable(spec: S.ExperimentSpec) -> dict:
    d = S.to_dict(spec, elide_defaults=False)
    for f in _RESUMABLE_RUN_FIELDS:
        d["run"].pop(f, None)
    for sec in _NON_SCENARIO_SECTIONS:
        d.pop(sec, None)
    return d


def diff_specs(a: S.ExperimentSpec, b: S.ExperimentSpec) -> list[str]:
    """Dotted paths of scenario-defining fields on which ``a`` and ``b``
    disagree (run-shape fields a restore continuation may change are
    ignored)."""
    da, db = _comparable(a), _comparable(b)
    out = []
    for section in da:
        for field in da[section]:
            if da[section][field] != db[section][field]:
                out.append(f"{section}.{field}")
    return sorted(out)


def check_restore_spec(restore_path: str,
                       spec: S.ExperimentSpec) -> Optional[list[str]]:
    """Compare ``spec`` against the manifest written next to the checkpoint
    being restored, warning (not raising — resuming under a deliberately
    changed scenario is legal, just worth flagging) on every mismatching
    scenario field.  Returns the mismatch list, or None when no manifest
    exists."""
    path = manifest_path(restore_path)
    if not os.path.exists(path):
        return None
    try:
        saved = load_manifest(path)["spec_parsed"]
    except (ValueError, KeyError, TypeError, OSError) as e:
        warnings.warn(f"unreadable spec manifest {path}: {e}")
        return None
    mismatches = diff_specs(saved, spec)
    if mismatches:
        warnings.warn(
            f"restoring {restore_path} under a spec that differs from its "
            f"manifest on: {', '.join(mismatches)} (saved manifest: {path})")
    return mismatches
