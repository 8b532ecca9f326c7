"""Falcon-Mamba-7B: pure mamba1 stack, attention-free [arXiv:2410.05355]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b",
    arch_type="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,                       # no separate MLP; mamba block only
    vocab_size=65_024,
    pattern=("mamba",),
    ssm_state=16,
    ssm_expand=2,
    conv_width=4,
    source="arXiv:2410.05355",
))
