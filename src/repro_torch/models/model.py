"""Unified model API: ``build(cfg)`` returns the functions the trainer and
the tests share, and ``params_from_jax`` carries a JAX parameter tree across.

The first slice of the port runs the dense decoder (qwen1.5-0.5b's family);
every other configuration raises ``NotImplementedError`` naming the
ROADMAP.md item that ports it.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import tree
from . import transformer


class Model(NamedTuple):
    cfg: Any
    shapes: dict              # parameter leaf shapes (the JAX layout)
    init: Callable            # (generator, dtype, device) -> params
    train_loss: Callable      # (params, batch) -> scalar


def _check_supported(cfg) -> None:
    unsupported = {
        "arch_type": (cfg.arch_type, "dense"),
        "pattern": (cfg.pattern, ("attn",)),
        "window": (cfg.window, 0),
        "logit_softcap": (cfg.logit_softcap, 0.0),
        "mlp_act": (cfg.mlp_act, "swiglu"),
        "norm": (cfg.norm, "rmsnorm"),
        "tie_embeddings": (cfg.tie_embeddings, True),
        "frontend": (cfg.frontend, ""),
        "use_pallas": (cfg.use_pallas, False),
    }
    for field, (have, ported) in unsupported.items():
        if have != ported:
            raise NotImplementedError(
                f"{cfg.name}: {field}={have!r} is not ported yet (the port "
                f"runs {field}={ported!r}; ROADMAP.md Queue 1 item 9)")


def build(cfg) -> Model:
    _check_supported(cfg)
    return Model(
        cfg=cfg,
        shapes=transformer.param_shapes(cfg),
        init=lambda gen, dtype=torch.float32, device="cpu":
            transformer.init_params(gen, cfg, dtype, device),
        train_loss=lambda p, b: transformer.train_loss(p, cfg, b),
    )


def params_from_jax(params) -> dict:
    """The JAX package's parameter tree (nested dicts of arrays, e.g. after
    ``jax.device_get``) as the port's parameters: the same tree and leaf
    layouts, as CPU tensors.  A copy, no transpose."""
    return tree.map(lambda a: torch.from_numpy(np.array(a)), params)
