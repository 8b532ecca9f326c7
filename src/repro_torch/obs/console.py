"""The one progress-output helper for examples and CLIs.

Everything user-facing that used to be a bare ``print(...)`` routes through
a :class:`Console` so (a) ``--quiet`` silences progress chatter in one
place, and (b) structured progress lines stay machine-parseable:
``Console.event`` emits ``name key=value key=value ...`` with stable
formatting, and can mirror the same record into a metrics sink.
"""

from __future__ import annotations

import sys
from typing import Optional


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


class Console:
    """Progress printer with a ``--quiet`` switch and optional sink mirror.

    ``print`` is free-form text (suppressed when quiet); ``event`` is one
    machine-parseable ``name k=v ...`` line, optionally mirrored into
    ``sink`` (a :class:`repro.obs.metrics.MetricsSink`) as
    ``{"event": name, **fields}`` so a run's stdout and its event log
    agree.
    """

    def __init__(self, quiet: bool = False, sink=None, stream=None):
        self.quiet = bool(quiet)
        self.sink = sink
        self.stream = stream if stream is not None else sys.stdout

    @classmethod
    def from_argv(cls, argv=None) -> "Console":
        argv = sys.argv[1:] if argv is None else argv
        return cls(quiet=("--quiet" in argv or "-q" in argv))

    def print(self, *args, **kwargs):
        if not self.quiet:
            print(*args, file=self.stream, **kwargs)

    def event(self, name: str, **fields):
        if self.sink is not None:
            self.sink.emit({"event": name, **fields})
        if not self.quiet:
            parts = [name] + [f"{k}={_fmt(v)}" for k, v in fields.items()]
            print(" ".join(parts), file=self.stream)

    def rule(self, title: Optional[str] = None, width: int = 64):
        if self.quiet:
            return
        if title:
            pad = max(0, width - len(title) - 4)
            print(f"-- {title} {'-' * pad}", file=self.stream)
        else:
            print("-" * width, file=self.stream)
