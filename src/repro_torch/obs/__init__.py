"""repro_torch.obs — observability for both runtimes of the port, the JAX
package's ``repro.obs``:

* :mod:`repro_torch.obs.metrics` — the :class:`MetricsSink` protocol with a
  JSONL :class:`EventLog` backend, and the :class:`ObsRecorder` driver hook
  that batches the engine's in-step scalars (grad norm, consensus
  distance, mixing residual, tracker drift — computed once in
  :mod:`repro_torch.core.engine` for both runtimes) and moves them to the
  host every ``every`` steps in one pinned copy, off the hot path;
* :mod:`repro_torch.obs.trace` — per-phase wall-clock spans
  (data/step/telemetry/checkpoint), optionally as
  ``torch.profiler.record_function`` ranges, the opt-in
  ``--profile-dir`` N-step ``torch.profiler`` trace, and the overlap
  proof: :func:`overlap_report` / :func:`mix_depends_on_grad` run a step
  under a taint analysis that follows the ``obs_grad`` outputs to the
  ``obs_mix`` ranges (True, the mix overlap-eligible, under ``delay > 0``);
* :mod:`repro_torch.obs.optimality` — the measured ||∇f||² trajectory
  against the paper's lower bound (:mod:`repro_torch.core.lower_bound`)
  per (algorithm × topology-class × channel) cell;
* :mod:`repro_torch.obs.report` — ``python -m repro_torch.obs.report
  <log.jsonl>`` renders a run summary from a log of either package;
* :mod:`repro_torch.obs.console` — the one progress-output helper.

Enable it declaratively: ``ExperimentSpec(obs=ObsSpec(metrics="run.jsonl"))``
or ``launch/train.py --metrics run.jsonl [--metrics-every N]
[--profile-dir DIR]``.
"""

from .console import Console  # noqa: F401
from .metrics import (  # noqa: F401
    EVENT_FIELDS,
    OBS_METRICS,
    ChainSink,
    EventLog,
    MemorySink,
    MetricsSink,
    ObsRecorder,
    read_events,
)
from .optimality import GapTracker, cell_key, theoretical_floor  # noqa: F401
from .trace import (  # noqa: F401
    PHASES,
    Profiler,
    Tracer,
    mix_depends_on_grad,
    overlap_report,
)
