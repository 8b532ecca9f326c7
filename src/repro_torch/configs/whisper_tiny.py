"""Whisper-tiny: 4+4 encoder-decoder, conv frontend stubbed to frame
embeddings [arXiv:2212.04356]."""
from . import register
from .base import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    num_layers=4,                 # decoder layers
    encoder_layers=4,
    encoder_seq=1500,             # 30 s of audio after the conv frontend
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51_865,
    norm="layernorm",
    mlp_act="gelu",
    rope_theta=0.0,               # absolute positions, no rope
    frontend="audio",
    source="arXiv:2212.04356",
))
