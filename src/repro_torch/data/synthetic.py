"""Synthetic LM token batches for the decentralized trainer.

``TokenStream`` gives (n_nodes, R, batch, seq) batches, so each node's R
gradient-accumulation rounds see distinct microbatches (Assumption 2's
independent oracle queries), like the JAX package's ``data/synthetic.py``.
Its tokens come from a ``torch.Generator`` seeded by (seed, step); the JAX
package's ``jax.random`` stream cannot be replayed in torch, so tests that
compare the two packages hand both the same numpy batches.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class TokenStream:
    vocab_size: int
    n_nodes: int
    rounds: int            # R microbatches per step
    batch: int             # per-node, per-round sequences
    seq: int
    seed: int = 0
    active_vocab: int = 0  # 0 = full vocab; else the first k tokens only
    device: str = "cpu"

    def batch_at(self, step: int) -> dict:
        """Step ``step``'s batch, the same on every call.  Tokens are drawn
        on the CPU (a few KB) and moved to ``device``."""
        seed = int(np.random.SeedSequence((self.seed, step)).generate_state(1)[0])
        gen = torch.Generator().manual_seed(seed)
        shape = (self.n_nodes, self.rounds, self.batch, self.seq)
        hi = self.active_vocab or self.vocab_size
        tokens = torch.randint(0, hi, shape, generator=gen)
        return {"tokens": tokens.to(self.device)}


def token_stream_for(cfg, n_nodes: int, rounds: int, batch: int, seq: int,
                     seed: int = 0, active_vocab: int = 0,
                     device: str = "cpu") -> TokenStream:
    return TokenStream(vocab_size=cfg.vocab_size, n_nodes=n_nodes,
                       rounds=rounds, batch=batch, seq=seq, seed=seed,
                       active_vocab=active_vocab, device=device)
