"""repro_torch.serve — personalized fleet serving, the port of the JAX
package's ``repro.serve``.

A decentralized run leaves a *stacked fleet*: n model copies with a leading
node axis.  This package serves the whole fleet behind one continuously
batched endpoint.

* :mod:`repro_torch.serve.traffic` — synthetic requests and the user→node
  routing policies (a verbatim copy of the reference's numpy module);
* :mod:`repro_torch.serve.engine` — the continuous-batching loop
  (admit/route/prefill/decode/evict over a slot table), each slot decoding
  against views of its routed node's parameters.

Entry point: :func:`serve_fleet`, which ``exp.run``'s serve phase and the
serve CLI (:mod:`repro_torch.launch.serve`) call.
"""

from .engine import SERVE_DTYPES, ServeResult, serve_fleet  # noqa: F401
from .traffic import Request, route_user, synth_requests  # noqa: F401
