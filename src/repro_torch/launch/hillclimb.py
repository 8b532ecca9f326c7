"""Performance hillclimb on one H100: trace the baseline and optimized
variants of the reference's three (arch x shape) pairs with the port's dry
run and compare their roofline terms, the counterpart of the JAX package's
``launch/hillclimb.py``.

Pairs (the reference's):
  1. nemotron-4-340b x train_4k — multi-consensus gossip over 340B
     parameters a node;
  2. granite-moe-3b-a800m x prefill_32k — the MoE einsum dispatch at 1M
     tokens explodes the memory term;
  3. internvl2-1b x prefill_32k — the unembedding of all 32k positions.

Variants are opt-in config/step flags (defaults = paper-faithful baseline):
  sun-gossip     gossip_impl='sun'  — structured gossip, two node-axis sums
                 for sun-shaped W instead of an n x n product
  moe-group      cfg.moe_seq_group=4096 — per-group MoE dispatch
  last-unembed   cfg.prefill_last_only=True — unembed 1 position at prefill
  bf16-state     aux_dtype=bf16 — MC-DSGT tracker/accumulator in bf16
  pad48          cfg.moe_pad_experts=48 — the expert axis padded to 48

The reference's variants that only change mesh placement have no meaning
on one card and are left out: ``sun+bf16+hier4x64`` (a hierarchical mesh)
and those with ``attn_shard_fallback='replicate'`` (the port's attention
never reads that field); ``grp+last+pad48`` is its ``grp+last+ra+pad48``
without the replication.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.hillclimb [--pair N] [--jobs 8] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os

import torch

from .dryrun import lower_one, results
from .roofline import analyse


def terms(rec: dict) -> dict:
    a = analyse(rec)
    return {"compute_s": a["t_compute_s"], "memory_s": a["t_memory_s"],
            "mix_s": a["t_mix_s"], "peak_hbm_frac": a["hbm_frac"]}


def _cfg(**fields):
    return lambda c: dataclasses.replace(c, **fields)


SUN = {"gossip_impl": "sun", "sun_delta": 1.0}
GROUP = dict(moe_seq_group=4096)
PAIRS = {
    "nemotron-train": dict(
        arch="nemotron-4-340b", shape="train_4k",
        variants={
            "baseline": {},
            "sun-gossip": {"train_kwargs": SUN},
            "bf16-state": {"train_kwargs": {"aux_dtype": torch.bfloat16}},
            "sun+bf16": {"train_kwargs": {**SUN,
                                          "aux_dtype": torch.bfloat16}},
        }),
    "granite-prefill": dict(
        arch="granite-moe-3b-a800m", shape="prefill_32k",
        variants={
            "baseline": {},
            "moe-group4k": {"cfg_transform": _cfg(**GROUP)},
            "moe-group4k+last": {"cfg_transform": _cfg(
                **GROUP, prefill_last_only=True)},
            "grp+last+pad48": {"cfg_transform": _cfg(
                **GROUP, prefill_last_only=True, moe_pad_experts=48)},
        }),
    "internvl2-prefill": dict(
        arch="internvl2-1b", shape="prefill_32k",
        variants={
            "baseline": {},
            "last-unembed": {"cfg_transform": _cfg(prefill_last_only=True)},
        }),
}


def trace_variant(name: str, vname: str, **kw) -> dict:
    """The dry run's record of variant ``vname`` of pair ``name`` (``kw``
    to :func:`lower_one`, e.g. ``nodes``)."""
    spec = PAIRS[name]
    v = spec["variants"][vname]
    return lower_one(spec["arch"], spec["shape"], verbose=False,
                     cfg_transform=v.get("cfg_transform"),
                     train_kwargs=v.get("train_kwargs"), **kw)


def run_pairs(pairs: dict, out: dict, jobs: int = 1, **kw):
    """The reference's ``run_pair`` for several pairs at once: trace every
    variant of every pair in ``pairs`` (``kw`` to
    :func:`lower_one`, e.g. ``nodes``), all in one batch of ``jobs``
    processes, into ``out[name]`` and print their terms pair by pair; a
    variant that fails to trace raises."""
    items = [(name, v) for name, spec in pairs.items()
             for v in spec["variants"]]
    for (name, vname), rec in results(functools.partial(trace_variant, **kw),
                                      items, jobs):
        if isinstance(rec, Exception):
            raise rec
        spec = pairs[name]
        if vname == next(iter(spec["variants"])):
            print(f"=== {name}: {spec['arch']} x {spec['shape']} ===",
                  flush=True)
        tt = terms(rec)
        out.setdefault(name, {})[vname] = {
            **tt, "flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "mix_bytes": rec["mix"]["total_bytes"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "trace_s": rec["trace_seconds"]}
        print(f"  {vname:18s} compute {tt['compute_s']:.3e}s  "
              f"memory {tt['memory_s']:.3e}s  "
              f"mix {tt['mix_s']:.3e}s  "
              f"hbm {tt['peak_hbm_frac']:.2f}  "
              f"({rec['trace_seconds']:.0f}s to trace)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pair", default=None, choices=list(PAIRS) + [None])
    ap.add_argument("--jobs", type=int, default=1,
                    help="trace the variants in this many processes")
    ap.add_argument("--out", default="experiments/hillclimb_torch.json")
    args = ap.parse_args(argv)
    results_ = {}
    if os.path.exists(args.out):
        results_ = json.load(open(args.out))
    pairs = {args.pair: PAIRS[args.pair]} if args.pair else PAIRS
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    run_pairs(pairs, results_, jobs=args.jobs)
    with open(args.out, "w") as f:
        json.dump(results_, f, indent=2)
    print(f"wrote {args.out}")
    return results_


if __name__ == "__main__":
    main()
