"""Nemotron-4-340B: dense GQA with squared-ReLU MLP, untied embeddings
[arXiv:2402.16819]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="nemotron-4-340b",
    arch_type="dense",
    num_layers=96,
    d_model=18_432,
    num_heads=96,
    num_kv_heads=8,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_act="relu2",
    tie_embeddings=False,
    source="arXiv:2402.16819",
))
