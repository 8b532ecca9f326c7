"""repro_torch.sim — channel faults and mixing telemetry, the ported part of
the JAX package's ``sim/``.

``hashrand``, ``channel`` and ``faults`` are numpy copies of the reference's
modules (pinned to them by the tests); ``telemetry`` is its recorder on
torch state tensors.  The mobility topologies are not ported yet (ROADMAP.md
Queue 1 item 5).
"""

from .channel import (  # noqa: F401
    BernoulliDropChannel,
    GilbertElliottChannel,
    LinkLatencyModel,
)
from .faults import (  # noqa: F401
    NodeChurn,
    StragglerInjection,
    combined_mask,
    realize_weight_schedule,
    repair_weights,
)
from .telemetry import (  # noqa: F401
    TELEMETRY_FIELDS,
    TelemetryRecorder,
    consensus_distance,
    empirical_effective_diameter,
    windowed_spectral_gap,
)
