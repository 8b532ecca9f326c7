"""RecurrentGemma-2B: RG-LRU recurrent blocks + local attention, 2:1 pattern
[arXiv:2402.19427]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    num_layers=26,                # 8 full (rglru, rglru, attn) units + 2 rglru
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,               # MQA in the local-attention layers
    d_ff=7680,
    vocab_size=256_000,
    pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    conv_width=4,
    window=2048,                  # local attention window
    mlp_act="geglu",
    source="arXiv:2402.19427",
))
