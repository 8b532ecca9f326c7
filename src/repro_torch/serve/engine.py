"""Continuous-batching serve engine over a stacked personalized fleet, the
port of the JAX package's ``serve/engine.py``.

One endpoint serves all n per-node models.  The engine keeps a fixed table
of ``serve.batch`` decode slots; every loop iteration it

1. **admits** pending requests into free slots (the request's routed node
   decides which fleet member's parameters the slot binds to);
2. **prefills** each admitted prompt into the slot's cache, reset first to
   a fresh single-request cache;
3. **decodes** one token for every active slot, each against its node's
   parameters, its own cache and its own position;
4. **evicts** slots that produced their ``max_new`` tokens, records the
   completed request and frees the slot.

Where the reference decodes all slots in one vmapped call with the slots'
parameters gathered from the stacked fleet, the port decodes each active
slot as a batch-1 call, and a slot's parameters are *views* of the fleet
(``fleet_leaf[node]``), never a copy: a 7B fleet of 4 fills most of an
80 GB card, and a gathered copy per slot would not fit beside it.  Each
slot is independent inside the reference's vmap, so the tokens are the
same (an inactive slot's output, which the reference computes and drops,
is not computed).  The slot cache is ``serve.batch`` single-request caches
stacked on a leading slot axis, as in the reference; prefill and decode
update a slot's rows in place.

The reference's ``shard_fleet`` and ``mesh=`` place the fleet on a device
mesh; on one card they are no-ops and are not ported.  The model's kernel
policy (``cfg.use_pallas``: mamba prefill through the Hopper
``linear_recurrence``, attention prefill and decode through
``flash_attention`` and ``decode_attention``) is the engine's only kernel
decision.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, NamedTuple

import numpy as np
import torch

from .. import tree
from . import traffic

SERVE_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


class ServeResult(NamedTuple):
    """What a serve phase returns.  ``completed`` is one record per
    request (rid/user/node/tokens/latency_ms, sorted by rid);
    ``throughput`` aggregates prefill/decode token rates and request
    latency percentiles."""

    completed: list
    throughput: dict
    fleet: int
    serve: Any  # the ServeSpec this ran


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else 0.0


def serve_fleet(model, fleet_params, serve, *, requests=None,
                obs=None) -> ServeResult:
    """Serve ``requests`` (default: synthesized from ``serve``) against the
    stacked ``fleet_params`` with continuous batching, on the fleet's
    device.

    ``model`` is a :class:`repro_torch.models.Model`; ``fleet_params``
    leaves carry a leading fleet axis.  Leaves already in the serve dtype
    are used as they are (no copy).  ``serve`` is a
    :class:`repro_torch.exp.ServeSpec`.  ``obs`` (any sink with ``emit``)
    receives one ``serve_request`` event per completion and a final
    ``serve_summary``."""
    cfg = model.cfg
    if getattr(cfg, "arch_type", "dense") in ("vlm", "audio"):
        raise ValueError("repro.serve serves token-only archs (vlm/audio "
                         "prompts need frontend inputs the synthetic "
                         "traffic cannot provide)")
    if serve.dtype not in SERVE_DTYPES:
        raise ValueError(f"serve.dtype={serve.dtype!r}: unknown "
                         f"(have {sorted(SERVE_DTYPES)})")
    dtype = SERVE_DTYPES[serve.dtype]
    first = next(leaf for _, leaf in tree.items(fleet_params))
    fleet, device = first.shape[0], first.device
    B = serve.batch
    max_len = serve.prompt_len + serve.max_new
    if requests is None:
        requests = traffic.synth_requests(serve, fleet=fleet,
                                          vocab=cfg.vocab_size)

    params = tree.map(lambda leaf: leaf.to(dtype), fleet_params)
    node_params = [tree.map(lambda leaf: leaf[i], params)
                   for i in range(fleet)]
    blank = model.init_cache(1, max_len, dtype, device)
    cache = tree.map(lambda *xs: torch.stack(xs), *[blank] * B)
    slot_cache = [tree.map(lambda leaf: leaf[j], cache) for j in range(B)]

    # host-side slot table
    active = np.zeros(B, bool)
    node = np.zeros(B, np.int32)
    pos = np.zeros(B, np.int32)
    remaining = np.zeros(B, np.int32)
    rid = np.full(B, -1, np.int64)
    admit_t = np.zeros(B, np.float64)
    toks_out: dict[int, list] = {}
    req_by_id = {r.rid: r for r in requests}

    pending = deque(requests)
    completed: list[dict] = []
    cur_tok = torch.zeros((B, 1, 1), dtype=torch.long, device=device)
    prefill_s = decode_s = 0.0
    prefill_toks = decode_toks = 0
    t_start = time.perf_counter()

    while pending or active.any():
        # -- admit + prefill ------------------------------------------------
        for j in np.flatnonzero(~active):
            if not pending:
                break
            req = pending.popleft()
            t0 = time.perf_counter()
            tree.map(lambda dst, src: dst.copy_(src), slot_cache[j], blank)
            prompt = torch.as_tensor(req.prompt, device=device).long()[None]
            logits, _ = model.prefill(node_params[req.node],
                                      {"tokens": prompt}, slot_cache[j])
            tok = int(torch.argmax(logits[0, -1]))
            prefill_s += time.perf_counter() - t0
            prefill_toks += serve.prompt_len
            active[j] = True
            node[j] = req.node
            pos[j] = serve.prompt_len
            remaining[j] = serve.max_new - 1
            rid[j] = req.rid
            admit_t[j] = time.perf_counter()
            toks_out[req.rid] = [tok]
            cur_tok[j, 0, 0] = tok

        if not active.any():
            break

        # -- decode one token for every active slot -------------------------
        t0 = time.perf_counter()
        for j in np.flatnonzero(active):
            logits, _ = model.decode_step(node_params[node[j]], cur_tok[j],
                                          slot_cache[j], int(pos[j]))
            cur_tok[j, 0, 0] = torch.argmax(logits[0, -1])
        nxt = cur_tok.view(B).cpu().numpy()
        decode_s += time.perf_counter() - t0
        decode_toks += int(active.sum())

        now = time.perf_counter()
        for j in np.flatnonzero(active):
            toks_out[int(rid[j])].append(int(nxt[j]))
            pos[j] += 1
            remaining[j] -= 1
            if remaining[j] <= 0:
                # -- evict: record completion, free the slot ----------------
                r = req_by_id[int(rid[j])]
                rec = {"rid": r.rid, "user": r.user, "node": int(node[j]),
                       "tokens": toks_out.pop(r.rid),
                       "latency_ms": round(float(now - admit_t[j]) * 1e3, 3)}
                completed.append(rec)
                if obs is not None:
                    obs.emit({"event": "serve_request", **rec})
                active[j] = False

    wall = time.perf_counter() - t_start
    lat = [c["latency_ms"] for c in completed]
    throughput = {
        "requests": len(completed),
        "fleet": fleet,
        "batch": B,
        "wall_s": round(wall, 4),
        "prefill_tok_s": round(prefill_toks / max(prefill_s, 1e-9), 1),
        "decode_tok_s": round(decode_toks / max(decode_s, 1e-9), 1),
        "requests_per_s": round(len(completed) / max(wall, 1e-9), 2),
        "latency_p50_ms": round(_percentile(lat, 50), 3),
        "latency_p95_ms": round(_percentile(lat, 95), 3),
    }
    if obs is not None:
        obs.emit({"event": "serve_summary", **throughput})
    completed.sort(key=lambda c: c["rid"])
    return ServeResult(completed=completed, throughput=throughput,
                       fleet=fleet, serve=serve)
