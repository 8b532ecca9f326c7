"""Roofline analysis of the dry run's records on one H100, the counterpart
of the JAX package's ``launch/roofline.py``.

Reads ``experiments/dryrun_torch/*.json`` (written by
:mod:`repro_torch.launch.dryrun`), derives three terms per (arch x shape)
that partition the step and prints a markdown table:

    compute term = sum over dtypes of FLOPs_dtype / peak_dtype
    memory term  = (bytes - mix bytes) / HBM bandwidth
    mix term     = mix bytes / HBM bandwidth

The mix term takes the place of the reference's collective term: on one
card the gossip moves device memory, not links.  The peaks are the H100's
(:mod:`repro_torch.launch.mesh`: f32 matrix products at 67 TFLOP/s, TF32
off; bf16 at 989).

MODEL_FLOPS uses 6*N*D for training (2ND fwd + 4ND bwd) and 2*N*D for
inference, with N_active for MoE, over the record's batch (a cut batch
counts what was traced).  The column MODEL_FLOPS / FLOPs exposes the work
beyond the model's: a masked full-square attention, the gossip, MoE
capacity slots.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir DIR] [--out FILE]
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import math
import os

from .. import configs, tree
from ..models import build
from .mesh import HBM_BW, HBM_BYTES, PEAK_FLOPS


def _param_counts(cfg):
    """(total, active) parameter counts from the model's leaf shapes (no
    allocation).  Each token runs k of E experts: the experts' ``wi``,
    ``wg`` and ``wo`` leaves under ``moe`` count k/E of their size."""
    shapes = list(tree.items(build(cfg).shapes))
    total = sum(math.prod(s) for _, s in shapes)
    active = total
    if cfg.num_experts and cfg.experts_per_token:
        es = sum(math.prod(s) for path, s in shapes
                 if "moe" in path and path[-1] in ("wi", "wg", "wo"))
        active = total - es + es * cfg.experts_per_token / cfg.num_experts
    return total, active


def model_flops_per_device(cfg, shape, devices: int, train_nodes: int,
                           R: int = 2) -> float:
    total, active = _param_counts(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * active * tokens / devices
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * active * tokens / devices
    # decode: one token per sequence
    return 2.0 * active * shape.global_batch / devices


def analyse(record: dict, R: int = 2) -> dict:
    """The record with its three terms (seconds), the dominant one, the
    useful-FLOPs ratio and its peak against the card's HBM."""
    cfg = configs.get(record["arch"])
    shape = dataclasses.replace(configs.INPUT_SHAPES[record["shape"]],
                                global_batch=record["batch"])
    mix = record["mix"]["total_bytes"]
    t_compute = sum(f / PEAK_FLOPS[dt]
                    for dt, f in record["flops_by_dtype"].items())
    t_memory = (record["bytes_accessed"] - mix) / HBM_BW
    t_mix = mix / HBM_BW
    terms = {"compute": t_compute, "memory": t_memory, "mix": t_mix}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(cfg, shape, record["devices"],
                                record["nodes"] or 1, R)
    useful = mf / record["flops"] if record["flops"] > 0 else 0.0
    peak = record["memory"]["peak_bytes"]
    return {
        **record,
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_mix_s": t_mix,
        "dominant": dominant,
        "model_flops_per_device": mf,
        "useful_flops_ratio": useful,
        "fits_hbm": peak <= HBM_BYTES,
        "hbm_frac": peak / HBM_BYTES,
    }


def markdown_table(rows) -> str:
    hdr = ("| arch | shape | card | compute s | memory s | mix s | "
           "dominant | useful FLOPs | HBM frac |\n"
           "|---|---|---|---|---|---|---|---|---|\n")
    body = ""
    for r in rows:
        body += (f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                 f"| {r['t_compute_s']:.2e} | {r['t_memory_s']:.2e} "
                 f"| {r['t_mix_s']:.2e} | **{r['dominant']}** "
                 f"| {r['useful_flops_ratio']:.2f} "
                 f"| {r['hbm_frac']:.2f}{'' if r['fits_hbm'] else ' ⚠OVER'} |\n")
    return hdr + body


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rows = [analyse(json.load(open(path))) for path in
            sorted(glob.glob(os.path.join(args.dir, "*.json")))]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    print(markdown_table(rows))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=2)
    if rows:
        mix_bound = max(rows, key=lambda r: r["t_mix_s"] / max(
            r["t_compute_s"] + r["t_memory_s"] + r["t_mix_s"], 1e-30))
        worst_useful = min((r for r in rows if r["shape"] == "train_4k"),
                           key=lambda r: r["useful_flops_ratio"], default=None)
        print(f"\nmost mix-bound: {mix_bound['arch']}/{mix_bound['shape']}")
        if worst_useful:
            print(f"worst useful-FLOPs (train): {worst_useful['arch']} "
                  f"({worst_useful['useful_flops_ratio']:.2f})")
    return rows


if __name__ == "__main__":
    main()
