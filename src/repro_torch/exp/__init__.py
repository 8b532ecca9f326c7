"""repro_torch.exp — the declarative experiment front door of the port.

The spec tree, its JSON and ``spec_hash`` are the JAX package's (a copy), so
one spec file describes the same run in both packages; ``run(spec,
device=...)`` trains it with the port on the given device, and serves the
trained fleet when the spec enables a serve phase.  The reproducibility
manifests (:mod:`repro_torch.exp.manifest`, a copy) are the reference's
files: one written by either package loads in the other.
"""

from .build import (  # noqa: F401
    Built,
    Result,
    build,
    resolve_device,
    run,
    weights_per_step,
)
from .manifest import (  # noqa: F401
    check_restore_spec,
    diff_specs,
    load_manifest,
    manifest_path,
    resolved_manifest,
    write_manifest,
)
from .registry import (  # noqa: F401
    ALGORITHMS,
    CHANNELS,
    COMPRESSIONS,
    GOSSIP_IMPLS,
    LOCAL_OPTS,
    MODEL_KINDS,
    OBS_METRICS,
    ROUTING_POLICIES,
    SERVE_DTYPES,
    TOPOLOGIES,
    build_compression,
    build_topology,
    register_topology,
)
from .spec import (  # noqa: F401
    AlgorithmSpec,
    ChannelSpec,
    CompressionSpec,
    DataSpec,
    ExperimentSpec,
    ModelRef,
    ObsSpec,
    RunSpec,
    ServeSpec,
    TopologySpec,
    from_dict,
    from_json,
    load,
    spec_hash,
    sweep,
    to_dict,
    to_json,
    with_field,
    with_overrides,
)
