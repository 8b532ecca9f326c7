"""The benchmark of ``repro_torch`` (``portbench/run.py``) and its yardstick:
the traffic generator, the frozen work counts and peaks, the trace reader,
the plain reference and the comparison that decides ``correct``.  Nothing
here imports ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro``, and
nothing under ``reference/`` imports ``repro_torch``."""
