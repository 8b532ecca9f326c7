"""Granite-3.0-3B-A800M MoE: 40 experts top-8, small expert hidden dim
[hf:ibm-granite/granite-3.0-1b-a400m-base family]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,                     # expert hidden dim
    vocab_size=49_155,
    pattern=("moe",),
    num_experts=40,
    experts_per_token=8,
    moe_d_ff=512,
    mlp_act="swiglu",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
