"""Synthetic request traffic and user→node routing for :mod:`repro.serve`.

Requests are synthesized from the :class:`repro.exp.spec.ServeSpec` alone
(seeded, reproducible): a small population of users issues fixed-length
random-token prompts.  Routing decides which fleet node's *personalized*
parameters a request decodes against:

* ``user-affinity`` — each user pins to one node via a stable hash, so a
  user always hits the same personalization (the serving contract that
  makes per-node models meaningful);
* ``round-robin``   — requests cycle the fleet regardless of user (the
  uniform-fleet ablation: only sensible when every model is
  interchangeable).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class Request:
    """One synthetic serve request, already routed."""

    rid: int              # request id (admission order)
    user: int             # issuing user id
    node: int             # routed fleet node (whose params decode this)
    prompt: np.ndarray    # (prompt_len,) int32 token ids


def route_user(user: int, rid: int, fleet: int, policy: str) -> int:
    """Resolve a request's fleet node under ``policy`` (see
    :data:`repro.exp.registry.ROUTING_POLICIES`)."""
    if fleet < 1:
        raise ValueError(f"fleet must be >= 1, got {fleet}")
    if policy == "round-robin":
        return rid % fleet
    if policy == "user-affinity":
        # stable across processes/sessions (unlike hash()): the same user
        # lands on the same node in every run
        return zlib.crc32(str(int(user)).encode()) % fleet
    raise ValueError(f"unknown routing policy {policy!r}")


def synth_requests(serve, *, fleet: int, vocab: int) -> list:
    """Materialize ``serve.requests`` routed requests from a ServeSpec.

    The user population is ~requests/4 (so affinity routing shows repeat
    traffic per user); prompts are uniform random tokens of
    ``serve.prompt_len``.  Deterministic in ``serve.seed``.
    """
    rng = np.random.default_rng(serve.seed)
    users = max(1, serve.requests // 4)
    out = []
    for i in range(serve.requests):
        user = int(rng.integers(users))
        prompt = rng.integers(0, vocab, size=serve.prompt_len,
                              dtype=np.int64).astype(np.int32)
        out.append(Request(rid=i, user=user,
                           node=route_user(user, i, fleet, serve.routing),
                           prompt=prompt))
    return out
