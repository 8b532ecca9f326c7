"""repro_torch.obs — the port's observability package.  So far it holds the
progress printer the CLIs and ``exp.run``'s serve phase print through,
:class:`~repro_torch.obs.console.Console` (a verbatim copy of the JAX
package's stdlib-only ``obs/console.py``).  The recorder, tracer and gap
dashboard are not ported yet (ROADMAP.md Queue 1 item 4)."""

from .console import Console  # noqa: F401
