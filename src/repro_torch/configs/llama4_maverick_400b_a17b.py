"""Llama-4-Maverick-400B-A17B: alternating dense/MoE layers, 128 routed
experts top-1 + shared expert, early-fusion multimodal (text backbone here)
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    arch_type="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    pattern=("attn", "moe"),      # interleaved MoE every other layer
    num_experts=128,
    experts_per_token=1,
    moe_d_ff=8192,
    shared_expert=True,
    mlp_act="swiglu",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
))
