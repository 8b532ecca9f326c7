"""repro_torch.sim — wireless mobility, channel faults and mixing telemetry,
the port of the JAX package's ``sim/``.

``hashrand``, ``channel``, ``faults`` and ``mobility`` are numpy copies of
the reference's modules (pinned to them by the tests); ``telemetry`` is its
recorder on torch state tensors.
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
from .mobility import (  # noqa: F401
    RandomGeometricSchedule,
    RandomWaypointSchedule,
    random_geometric_schedule,
    random_waypoint_schedule,
    unit_disk_adjacency,
)
from .telemetry import (  # noqa: F401
    TELEMETRY_FIELDS,
    TelemetryRecorder,
    consensus_distance,
    empirical_effective_diameter,
    windowed_spectral_gap,
)
