"""The traced run's profile, read in memory: where the device's time went.

``torch.profiler`` records the host's ranges and ops and, through CUPTI, the
device's kernels, copies and sets, each device operation tied to the host
call that launched it by a correlation id.  :func:`events` takes the
profiler's own events (no trace file is written); :func:`summarize` splits
the device time of the profiled steps by the host range that launched each
operation, as the program's ``obs_grad`` (the oracle) and ``obs_mix`` (a
gossip window) ranges and the harness's own step and window ranges mark
them: the arithmetic of the program's ``chip_smoke.profile_split``, frozen
here.  Busy time is the union of the device operations' intervals inside the
window; each part of an idle gap is named by the innermost host call open
during it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = ("cuda_runtime", "cuda_driver")
HOST = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
STEP, WINDOW, GRAD, MIX = ("portbench_step", "portbench_window", "obs_grad",
                           "obs_mix")


class Event(NamedTuple):
    name: str
    cat: str
    start: float        # µs
    end: float          # µs
    corr: int           # correlation id
    linked: int         # the host op's id, for a device op or launch
    thread: int


def _category(e) -> str:
    """The event's kind, by its device and name: the installed torch's
    profiler events carry no activity type."""
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        if e.is_user_annotation():
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    if e.is_user_annotation():
        return "user_annotation"
    return "cuda_runtime" if name.startswith(("cuda", "cu")) else "cpu_op"


def events(prof) -> list:
    """The profiler's events after its window closed, as :class:`Event`."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append(Event(e.name(), _category(e), start,
                         start + e.duration_ns() / 1e3,
                         e.correlation_id(), e.linked_correlation_id(),
                         e.start_thread_id()))
    return out


def _spans(evs, name):
    return sorted((e.start, e.end) for e in evs
                  if e.cat == "user_annotation" and e.name == name)


def _inside(t, spans, starts):
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= spans[i][1]


def _union(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def summarize(evs: list) -> dict:
    """What the metrics read from one profile: the steps, their device time
    by layer (ms), kernels launched, device time by operation name, each
    gossip window's kernels, the window's busy and idle seconds, and the
    idle gaps by the host call open during them."""
    steps, window = _spans(evs, STEP), _spans(evs, WINDOW)
    grad, mix = _spans(evs, GRAD), _spans(evs, MIX)
    if not steps or len(window) != 1:
        raise ValueError(f"the profile holds {len(steps)} step ranges and "
                         f"{len(window)} window ranges")
    w0, w1 = window[0]
    starts = {k: [a for a, _ in v] for k, v in
              (("step", steps), ("grad", grad), ("mix", mix))}
    launched = {e.corr: e.start for e in evs if e.cat in LAUNCH}
    host_ops = {e.corr: e.start for e in evs
                if e.cat in ("cpu_op", "user_annotation")}
    out = {"steps": len(steps), "window_s": (w1 - w0) / 1e6,
           "grad_ms": 0.0, "mix_ms": 0.0, "rule_ms": 0.0, "kernels": 0,
           "device_ops": 0, "unmatched": 0}
    by_name = defaultdict(float)
    per_mix = defaultdict(list)       # mix range index -> [(name, µs)]
    busy = []
    ranges = {e.name for e in evs if e.cat == "user_annotation"}
    for e in evs:
        # a host range's device-side mirror is no device work, whatever
        # category an older torch gives it
        if e.cat not in DEVICE or e.name in ranges:
            continue
        out["device_ops"] += 1
        if e.end >= w0 and e.start <= w1:
            busy.append((max(e.start, w0), min(e.end, w1)))
            by_name[e.name] += (min(e.end, w1) - max(e.start, w0)) / 1e6
        ts = launched.get(e.corr, host_ops.get(e.linked))
        if ts is None:
            out["unmatched"] += 1
            continue
        if not _inside(ts, steps, starts["step"]):
            continue
        dur = (e.end - e.start) / 1e3
        if e.cat == "kernel":
            out["kernels"] += 1
        if _inside(ts, grad, starts["grad"]):
            out["grad_ms"] += dur
        elif _inside(ts, mix, starts["mix"]):
            out["mix_ms"] += dur
            i = bisect.bisect_right(starts["mix"], ts) - 1
            per_mix[i].append((e.name, e.end - e.start))
        else:
            out["rule_ms"] += dur
    merged = _union(busy)
    out["busy_s"] = sum(b - a for a, b in merged) / 1e6
    out["mix_windows"] = [per_mix[i] for i in sorted(per_mix)]
    out["device_by_name"] = sorted(by_name.items(), key=lambda kv: -kv[1])
    gaps, t = [], w0
    for a, b in merged:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    out["idle_by_host"] = _label_gaps(evs, gaps)
    return out


def _label_gaps(evs: list, gaps: list) -> list:
    """[(host call, idle s)] summed over the gaps, largest first: each part
    of a gap is named by the innermost host op open on the steps' thread
    during it (``python`` where none is)."""
    step = next(e for e in evs if e.cat == "user_annotation"
                and e.name == STEP)
    host = sorted((e for e in evs if e.cat in HOST
                   and e.thread == step.thread),
                  key=lambda e: (e.start, -e.end))
    edges = sorted({t for e in host for t in (e.start, e.end)})
    parts = []                # (midpoint, µs) of each gap cut at the edges
    for a, b in sorted(gaps):
        lo, hi = bisect.bisect_right(edges, a), bisect.bisect_left(edges, b)
        cuts = [a] + edges[lo:hi] + [b]
        parts += [((p + q) / 2, q - p) for p, q in zip(cuts, cuts[1:])
                  if q > p]
    total = defaultdict(float)
    stack, i = [], 0
    for t, dur in parts:
        while i < len(host) and host[i].start <= t:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < t:
            stack.pop()
        total[stack[-1].name[:80] if stack else "python"] += dur / 1e6
    return sorted(total.items(), key=lambda kv: -kv[1])
