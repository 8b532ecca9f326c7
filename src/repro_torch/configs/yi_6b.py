"""Yi-6B: llama-architecture dense GQA [arXiv:2403.04652]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="yi-6b",
    arch_type="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11_008,
    vocab_size=64_000,
    mlp_act="swiglu",
    source="arXiv:2403.04652",
))
