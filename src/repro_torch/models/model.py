"""Unified model API: ``build(cfg)`` returns the functions the trainer, the
server and the tests share, and ``params_from_jax`` carries a JAX parameter
tree (or serve cache) across.

The port runs the dense decoder (the family of qwen1.5-0.5b, yi-6b,
minitron-4b and nemotron-4-340b: any MLP activation, tied or untied
embeddings), the mamba stack (falcon-mamba-7b's family), the hybrid of
RG-LRU and local attention (recurrentgemma-2b's family), the MoE decoder
(granite-moe-3b-a800m's ``("moe",)`` and llama4-maverick's ``("attn",
"moe")`` with a shared expert) and the VLM backbone on its stub frontend
(internvl2-1b: ``prefix_embeds`` in the batch, text positions scored) in
every mode; serving refuses the VLM as the reference does.
``use_pallas`` routes attention to the Hopper ``flash_attention``
(prefill, and a train-mode forward that cannot be differentiated, as in
the reference) and ``decode_attention`` (decode), both with the config's
sliding window, and the mamba and RG-LRU recurrences to
``linear_recurrence``; every other configuration raises
``NotImplementedError`` naming the ROADMAP.md item that ports it.
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
    init: Callable            # (generator, dtype, device, out=None) -> params
    empty: Callable           # (dtype, device, lead=()) -> uninitialised tree
    train_loss: Callable      # (params, batch) -> scalar
    prefill: Callable         # (params, batch, cache) -> (logits, cache)
    decode_step: Callable     # (params, token, cache, pos) -> (logits, cache)
    init_cache: Callable      # (batch, max_len, dtype, device) -> cache


# The families the port runs, (arch_type, pattern), each with use_pallas on
# or off.
PORTED = {("dense", ("attn",)), ("ssm", ("mamba",)),
          ("hybrid", ("rglru", "rglru", "attn")), ("moe", ("moe",)),
          ("moe", ("attn", "moe")), ("vlm", ("attn",))}


def _check_supported(cfg) -> None:
    if cfg.arch_type == "audio":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (arch_type='audio') is not "
            "ported yet (ROADMAP.md Queue 1 item 9 part 6)")
    family = (cfg.arch_type, tuple(cfg.pattern))
    if family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: arch_type={cfg.arch_type!r} with pattern="
            f"{cfg.pattern!r} is not ported yet (the port runs "
            f"{sorted(PORTED)}; ROADMAP.md Queue 1 item 9)")
    unsupported = {
        "logit_softcap": (cfg.logit_softcap, (0.0,)),
        "mlp_act": (cfg.mlp_act, ("swiglu", "geglu", "relu2", "gelu")),
        "norm": (cfg.norm, ("rmsnorm",)),
        "frontend": (cfg.frontend, ("", "vision")),
    }
    for field, (have, ported) in unsupported.items():
        if have not in ported:
            raise NotImplementedError(
                f"{cfg.name}: {field}={have!r} is not ported yet (the port "
                f"runs {field} in {ported!r}; ROADMAP.md Queue 1 item 9)")


def build(cfg) -> Model:
    _check_supported(cfg)

    def _prefill(p, b, c):
        return transformer.prefill(p, cfg, b["tokens"], c,
                                   prefix_embeds=b.get("prefix_embeds"),
                                   last_only=cfg.prefill_last_only)

    return Model(
        cfg=cfg,
        shapes=transformer.param_shapes(cfg),
        init=lambda gen, dtype=torch.float32, device="cpu", out=None:
            transformer.init_params(gen, cfg, dtype, device, out),
        empty=lambda dtype=torch.float32, device="cpu", lead=():
            transformer.empty_params(cfg, dtype, device, lead),
        train_loss=lambda p, b: transformer.train_loss(p, cfg, b),
        prefill=_prefill,
        decode_step=lambda p, t, c, pos:
            transformer.decode_step(p, cfg, t, c, pos),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device="cpu":
            transformer.init_cache(cfg, batch, max_len, dtype, device),
    )


def params_from_jax(params) -> dict:
    """The JAX package's parameter tree or serve cache (nested dicts of
    arrays, e.g. after ``jax.device_get``) as the port's: the same tree,
    the remainder stack ``rem`` included, the same leaf layouts and dtypes
    (mamba's A_log and rglru's lam stay f32; bf16 stays bf16, bit for bit),
    as CPU tensors.  A copy, no transpose."""
    return tree.map(_tensor, params)


def _tensor(a) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' type, which torch refuses
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)
