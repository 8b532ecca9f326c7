"""Architecture config registry: resolve --arch <id> to a ModelConfig.

The port trains and serves the dense family (qwen1.5-0.5b, yi-6b,
minitron-4b, and nemotron-4-340b, which fits one card only reduced), the
mamba falcon-mamba-7b, the hybrid recurrentgemma-2b and the MoE family
(granite-moe-3b-a800m, and llama4-maverick-400b-a17b, which fits one card
only reduced), trains the internvl2-1b VLM backbone on its stub frontend,
and trains and decodes the whisper-tiny encoder-decoder on its stub frames.
Each config module is a copy of the reference's.  ``logreg_paper`` (a copy)
holds the paper's §6 protocols, which are not architectures and register
nothing."""
from .base import INPUT_SHAPES, InputShape, ModelConfig  # noqa: F401

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"arch {name!r} is not ported yet (have "
                       f"{sorted(_REGISTRY)}; see ROADMAP.md Queue 1)")
    return _REGISTRY[name]


def names() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    from . import (  # noqa: F401
        falcon_mamba_7b,
        granite_moe_3b_a800m,
        internvl2_1b,
        llama4_maverick_400b_a17b,
        logreg_paper,
        minitron_4b,
        nemotron_4_340b,
        qwen1_5_0_5b,
        recurrentgemma_2b,
        whisper_tiny,
        yi_6b,
    )
