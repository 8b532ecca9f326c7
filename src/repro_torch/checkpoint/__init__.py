"""repro_torch.checkpoint — msgpack checkpoints in the JAX package's file
format (:mod:`repro_torch.checkpoint.msgpack_ckpt`): a file written by
either package restores in the other."""

from .msgpack_ckpt import (  # noqa: F401
    ZeroLeaf,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
