"""Tiny configurations of the two families and the traffic that drives them,
for runs of the harness on the CPU in the tests."""

from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# Tiny configurations of the two families and traffic that drives them, for
# runs of the harness on the CPU.
TINY_DECODER = {
    "name": "tiny-decoder", "family": "decoder", "hidden_size": 32,
    "intermediate_size": 64, "num_hidden_layers": 2,
    "num_attention_heads": 4, "num_key_value_heads": 4, "head_dim": 8,
    "vocab_size": 64, "hidden_act": "silu", "rms_norm_eps": 1e-6,
    "rope_theta": 10000.0, "tie_word_embeddings": True, "qkv_bias": True,
    "training_dtype": "float32"}
TINY_ENCDEC = {
    "name": "tiny-encdec", "family": "encdec", "d_model": 32,
    "encoder_layers": 2, "decoder_layers": 2, "encoder_attention_heads": 4,
    "decoder_attention_heads": 4, "encoder_ffn_dim": 64,
    "decoder_ffn_dim": 64, "vocab_size": 64, "max_source_positions": 12,
    "activation_function": "gelu_tanh", "layer_norm_eps": 1e-6,
    "training_dtype": "float32"}
TINY_TRAIN = {
    "kind": "decentralized_train", "nodes": 4, "algorithm": "mc_dsgt",
    "R": 2, "gamma": 0.05, "clip": 1.0, "gossip_impl": "pallas",
    "compression": None, "schedule": {"kind": "theorem3", "beta": 0.75},
    "batch": 1, "seq": 8, "pool": 4}
TINY_INT8 = dict(TINY_TRAIN, nodes=8, batch=2, compression={
    "scheme": "int8", "group": 32, "error_feedback": True, "warmup": 0},
    schedule={"kind": "theorem3", "beta": 0.875})


def tiny_cell(cell_name: str) -> dict:
    """A cell of BENCHMARK.json with its model and job cut to a CPU's size:
    the cell's metrics and limits, a tiny configuration of its family."""
    import sys

    sys.path.insert(0, str(ROOT))
    from portbench import run

    cell = run.load_cell(cell_name)
    tiny = cell["config"]["family"] == "decoder"
    cell["config"] = TINY_DECODER if tiny else TINY_ENCDEC
    cell["traffic"] = TINY_TRAIN if tiny else TINY_INT8
    return cell
