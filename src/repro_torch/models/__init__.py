"""Model substrate of the port: layers, attention, the decoder transformer,
the encoder-decoder, and the unified build API."""

from . import attention, encdec, layers, model, transformer  # noqa: F401
from .model import Model, build, params_from_jax  # noqa: F401
