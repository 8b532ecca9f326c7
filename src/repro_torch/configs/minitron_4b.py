"""Minitron-4B: width/depth-pruned Nemotron-4 (squared-ReLU, GQA)
[arXiv:2407.14679]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="minitron-4b",
    arch_type="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=9216,
    vocab_size=256_000,
    mlp_act="relu2",
    tie_embeddings=False,
    source="arXiv:2407.14679",
))
