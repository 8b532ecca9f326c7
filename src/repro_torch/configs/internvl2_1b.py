"""InternVL2-1B backbone: InternLM2-chat-1.8B-style language model consuming
InternViT patch embeddings via the stub frontend [arXiv:2404.16821]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="internvl2-1b",
    arch_type="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151_655,
    pattern=("attn",),
    mlp_act="swiglu",
    frontend="vision",
    frontend_tokens=256,          # ViT patches after pixel-shuffle projector
    source="arXiv:2404.16821",
))
