"""Render a run summary from a JSONL event log (a copy of the JAX
package's ``obs/report.py``): a log written by either package renders to
the same text.

``python -m repro_torch.obs.report <log.jsonl>`` prints the run header, the
per-phase wall-clock table, per-metric stats with a unicode sparkline of
the series, and the optimality-gap section (measured best ||grad f||^2 vs
the paper's lower-bound floor for the run's cell).  Everything is computed
from the log alone — no re-execution — so it works on logs shipped as CI
artifacts.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

from .metrics import OBS_METRICS, read_events

_BARS = "▁▂▃▄▅▆▇█"


def sparkline(vals, width: int = 32) -> str:
    """Downsample ``vals`` to ``width`` buckets of unicode bars."""
    vals = [v for v in vals if v is not None]
    if not vals:
        return ""
    if len(vals) > width:
        step = len(vals) / width
        vals = [vals[int(i * step)] for i in range(width)]
    lo, hi = min(vals), max(vals)
    if hi <= lo:
        return _BARS[0] * len(vals)
    return "".join(_BARS[min(len(_BARS) - 1,
                             int((v - lo) / (hi - lo) * len(_BARS)))]
                   for v in vals)


def _fmt(v, nd: int = 4) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.{nd}g}"
    return str(v)


def _series(steps, key):
    return [s[key] for s in steps if s.get(key) is not None]


def _stats(vals) -> Optional[dict]:
    if not vals:
        return None
    return {"first": vals[0], "last": vals[-1],
            "min": min(vals), "max": max(vals), "n": len(vals)}


def render(events: list, width: int = 32) -> str:
    """The full text report for one event log."""
    meta = next((e for e in events if e.get("event") == "meta"), {})
    steps = [e for e in events if e.get("event") == "step"]
    evals = [e for e in events if e.get("event") == "eval"]
    summary = next((e for e in events if e.get("event") == "summary"), {})
    lines: list[str] = []

    title = meta.get("name") or meta.get("algo") or "run"
    lines.append(f"== repro.obs report: {title} ==")
    head = {k: v for k, v in meta.items()
            if k not in ("event", "name") and not isinstance(v, (dict, list))}
    if head:
        lines.append("  " + "  ".join(f"{k}={_fmt(v)}"
                                      for k, v in sorted(head.items())))
    if steps:
        secs = _series(steps, "sec")
        lines.append(f"  steps recorded: {len(steps)}   "
                     f"T: {steps[-1].get('t', '-')}   "
                     f"step time: {_fmt(sum(secs) / len(secs))}s mean"
                     if secs else f"  steps recorded: {len(steps)}")

    phases = summary.get("phases") or {}
    if phases:
        lines.append("")
        lines.append("-- phases " + "-" * (width + 18))
        lines.append(f"  {'phase':<12}{'total s':>10}{'calls':>8}"
                     f"{'mean ms':>10}")
        for name, p in sorted(phases.items(),
                              key=lambda kv: -kv[1]["total_sec"]):
            lines.append(f"  {name:<12}{p['total_sec']:>10.4f}"
                         f"{p['count']:>8}{p['mean_ms']:>10.3f}")

    metric_keys = ["loss", *OBS_METRICS]
    shown = [k for k in metric_keys if _series(steps, k)]
    if shown:
        lines.append("")
        lines.append("-- metrics " + "-" * (width + 17))
        for key in shown:
            vals = _series(steps, key)
            st = _stats(vals)
            lines.append(f"  {key:<17} {sparkline(vals, width):<{width}} "
                         f"last={_fmt(st['last'])} min={_fmt(st['min'])} "
                         f"max={_fmt(st['max'])}")
    if evals:
        vals = [e["value"] for e in evals]
        st = _stats(vals)
        lines.append(f"  {'eval':<17} {sparkline(vals, width):<{width}} "
                     f"last={_fmt(st['last'])} min={_fmt(st['min'])} "
                     f"max={_fmt(st['max'])}")

    opt = summary.get("optimality")
    if opt:
        lines.append("")
        lines.append("-- optimality gap " + "-" * (width + 10))
        lines.append(f"  cell: {opt.get('cell', '-')}   "
                     f"bound: {opt.get('bound', 'paper')}   "
                     f"n={opt.get('n', '-')} beta={_fmt(opt.get('beta'))}")
        lines.append(f"  T={opt.get('T', '-')}   "
                     f"floor={_fmt(opt.get('floor'))}   "
                     f"best ||grad f||^2={_fmt(opt.get('best_grad_sq'))}")
        gap = opt.get("gap_ratio")
        slope = opt.get("rate_slope")
        lines.append(f"  gap ratio (measured / floor): {_fmt(gap)}   "
                     f"empirical slope d log/d logT: {_fmt(slope)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run summary from a repro.obs / repro_torch.obs "
                    "JSONL event log")
    ap.add_argument("log", help="path to the .jsonl event log")
    ap.add_argument("--width", type=int, default=32,
                    help="sparkline width (default 32)")
    ap.add_argument("--json", action="store_true",
                    help="dump the summary event as JSON instead")
    args = ap.parse_args(argv)
    events = read_events(args.log)
    try:
        if args.json:
            summary = next((e for e in events
                            if e.get("event") == "summary"), {})
            print(json.dumps(summary, indent=1))
        else:
            print(render(events, width=args.width))
    except BrokenPipeError:  # e.g. piped into head
        sys.stderr.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
