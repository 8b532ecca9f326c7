"""Model substrate of the port: layers, attention, the dense transformer,
and the unified build API."""

from . import attention, layers, model, transformer  # noqa: F401
from .model import Model, build, params_from_jax  # noqa: F401
