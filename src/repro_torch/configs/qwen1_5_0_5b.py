"""Qwen1.5-0.5B: dense GQA(=MHA) with QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="qwen1.5-0.5b",
    arch_type="dense",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    qkv_bias=True,
    mlp_act="swiglu",
    source="hf:Qwen/Qwen1.5-0.5B",
))
