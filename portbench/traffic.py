"""The one generator of the benchmark's inputs, driven by a traffic file.

A training traffic file (``portbench/workloads/<traffic>.json``, kind
``decentralized_train``) fixes the job: ``nodes`` model copies, ``R``
micro-batches of ``batch`` samples of ``seq`` tokens a node and step, the
rule and its gossip, and ``pool``, the distinct step batches drawn: the warm
start takes the first and each step the next, round the pool, so the first
``pool`` − 1 steps each see rows of their own.  A sample's fields come from
the configuration's family (:func:`batch_fields`): token ids uniform over
the vocabulary, and frame embeddings standard normal in bf16, the precision
the program's frame templates use.  Everything is drawn on the run's device
from a generator seeded by the run's seed.
"""

from __future__ import annotations

import torch

from . import weights


def make_pool(family, config: dict, traffic: dict, seed: int, device) -> list:
    """``traffic["pool"]`` batches, each {field: (n, R, b, ...)}."""
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.generator_seed(seed, "batches"))
    n, R = traffic["nodes"], traffic["R"]
    fields = family.batch_fields(config, traffic["batch"], traffic["seq"])
    pool = []
    for _ in range(traffic["pool"]):
        batch = {}
        for name, (shape, what) in fields.items():
            full = (n, R) + tuple(shape)
            if what == "tokens":
                batch[name] = torch.randint(0, config["vocab_size"], full,
                                            generator=gen, device=device)
            elif what == "frames":
                batch[name] = torch.randn(full, generator=gen, device=device,
                                          dtype=torch.bfloat16)
            else:
                raise ValueError(f"unknown field kind {what!r}")
        pool.append(batch)
    return pool


def tokens_per_step(traffic: dict) -> int:
    """Training tokens a step consumes: n · R · b · S (target tokens)."""
    return (traffic["nodes"] * traffic["R"] * traffic["batch"]
            * traffic["seq"])
