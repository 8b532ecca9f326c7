"""Personalized fleet serving CLI of the port — a thin argv -> spec
translator, the same flags as the JAX package's ``launch/serve.py`` plus
``--device``.

Like :mod:`repro_torch.launch.train`, every flag maps to one field of
:class:`repro_torch.exp.ExperimentSpec` (``FLAG_TO_FIELD``, the reference's
table) and the run itself is ``repro_torch.exp.run(spec, device=...)``:
train the fleet, then serve ``--requests`` synthetic routed requests
against it with continuous batching (:mod:`repro_torch.serve`).  There is
no serving code here: the dtype comes from ``--dtype`` (ServeSpec) and the
kernels from the model's config, as in the reference (the trained config's
``use_pallas`` is off, so serving takes the model's plain attention and
scan).  ``--device`` (default ``cuda``) is a runtime argument, not a spec
field, so ``--dump-config`` prints the same JSON as the reference's CLI
for the same flags.  Flags whose scenario axis is not ported yet are
accepted and raise ``NotImplementedError`` naming their ROADMAP.md item
when the run is built (the encoder-decoder whisper-tiny: item 9 part 6).
Every other family trains, then serves (falcon-mamba-7b reduced is
``examples/torch/serve_batch.py``); a VLM's fleet is refused by the serve
engine, as in the reference.  ``--metrics PATH`` writes the event log,
with one ``serve_request`` event per request and the ``serve_summary``.

Config files round-trip exactly as in train: ``--config PATH`` loads a
spec JSON as the baseline, explicit flags override it, and
``--dump-config`` prints the fully-resolved spec JSON and exits.

``--algo personalized`` (``--tau``) trains the fleet with the
loss-proximity reweighted mix, so each node's model stays its own, and
serves those personalized models (user-affinity routing by default).

Example — train a 4-node qwen1.5-0.5b fleet at full width on one H100 and
serve 8 requests from it in bf16:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --preset full --nodes 4 --algo mc_dsgt --gossip-impl pallas \
        --steps 2 --requests 8 --serve-batch 4 --prompt-len 128 \
        --max-new 16 --dtype bf16
"""

from __future__ import annotations

import argparse

from repro_torch import exp

# flag dest -> dotted ExperimentSpec field (same contract as launch.train:
# argparse.SUPPRESS keeps unset flags out of the namespace, so the
# baseline — dataclass defaults or --config — survives untouched).
FLAG_TO_FIELD = {
    "arch": "model.arch",
    "preset": "model.preset",
    "steps": "run.steps",
    "nodes": "run.nodes",
    "topology": "topology.kind",
    "radius": "topology.radius",
    "algo": "algorithm.name",
    "gamma": "algorithm.gamma",
    "tau": "algorithm.tau",
    "gossip_impl": "run.gossip_impl",
    "link_drop": "channel.link_drop",
    "hetero_alpha": "data.hetero_alpha",
    "batch": "data.batch",
    "seq": "data.seq",
    "active_vocab": "data.active_vocab",
    "checkpoint": "run.checkpoint",
    "restore": "run.restore",
    "log_every": "run.log_every",
    "seed": "run.seed",
    "metrics": "obs.metrics",
    "requests": "serve.requests",
    "serve_batch": "serve.batch",
    "max_new": "serve.max_new",
    "prompt_len": "serve.prompt_len",
    "fleet": "serve.fleet",
    "routing": "serve.routing",
    "dtype": "serve.dtype",
    "serve_seed": "serve.seed",
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
    ap.add_argument("--config", metavar="PATH",
                    help="baseline spec JSON (a spec or a manifest); "
                         "explicit flags override it")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the fully-resolved spec JSON and exit")
    # -- training side (the fleet being served) ----------------------------
    ap.add_argument("--arch", help="registered LM architecture")
    ap.add_argument("--preset", choices=["reduced", "full"])
    ap.add_argument("--steps", type=int)
    ap.add_argument("--nodes", type=int,
                    help="fleet size: one personalized model per node")
    ap.add_argument("--topology", choices=list(exp.TOPOLOGIES))
    ap.add_argument("--radius", type=float,
                    help="unit-disk range for the mobility topologies")
    ap.add_argument("--algo", choices=list(exp.ALGORITHMS),
                    help="'personalized' trains genuinely distinct per-node "
                         "models (loss-proximity neighbor averaging)")
    ap.add_argument("--gamma", type=float)
    ap.add_argument("--tau", type=float,
                    help="personalized rule: loss-proximity temperature "
                         "(higher = sharper clustering)")
    ap.add_argument("--gossip-impl", choices=list(exp.GOSSIP_IMPLS),
                    help="multi-consensus path of the training phase: "
                         "dense, or pallas (all R rounds in one pass of the "
                         "Hopper gossip_mix kernel; its plain version on the "
                         "CPU)")
    ap.add_argument("--link-drop", type=float,
                    help="per-round per-link drop probability (repro.sim)")
    ap.add_argument("--hetero-alpha", type=float,
                    help="Dirichlet(alpha) non-iid data across nodes — what "
                         "makes per-node personalization worth serving")
    ap.add_argument("--batch", type=int, help="training batch per node")
    ap.add_argument("--seq", type=int)
    ap.add_argument("--active-vocab", type=int)
    ap.add_argument("--checkpoint")
    ap.add_argument("--restore",
                    help="serve a previously trained fleet: restore the "
                         "checkpoint, run 0 further steps with --steps 0")
    ap.add_argument("--log-every", type=int)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--metrics", metavar="PATH",
                    help="repro_torch.obs JSONL event log — includes one "
                         "serve_request event per completion and a final "
                         "serve_summary")
    # -- serving side (ServeSpec) ------------------------------------------
    ap.add_argument("--requests", type=int,
                    help="synthetic requests to serve after training "
                         "(0 disables the serve phase)")
    ap.add_argument("--serve-batch", type=int, dest="serve_batch",
                    help="continuous-batching decode slots")
    ap.add_argument("--max-new", type=int, dest="max_new",
                    help="tokens generated per request")
    ap.add_argument("--prompt-len", type=int, dest="prompt_len")
    ap.add_argument("--fleet", type=int,
                    help="serve only the first N node models "
                         "(0 = the whole fleet)")
    ap.add_argument("--routing", choices=sorted(exp.ROUTING_POLICIES),
                    help="user-affinity pins each user to one node's "
                         "personalization; round-robin cycles the fleet")
    ap.add_argument("--dtype", choices=sorted(exp.SERVE_DTYPES),
                    help="serve-time parameter/KV-cache dtype")
    ap.add_argument("--serve-seed", type=int, dest="serve_seed",
                    help="traffic synthesis seed (users + prompts)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default cuda; "
                         "raises without a GPU unless --device cpu is given)")
    ap.add_argument("--quiet", action="store_true", default=False)
    return ap


def spec_from_args(args: argparse.Namespace) -> exp.ExperimentSpec:
    spec = exp.load(args.config) if getattr(args, "config", None) \
        else exp.ExperimentSpec()
    overrides = {FLAG_TO_FIELD[dest]: value
                 for dest, value in vars(args).items()
                 if dest in FLAG_TO_FIELD}
    # serving is the point of this CLI: default the phase ON so a bare
    # invocation serves, while --config files keep their own value
    if "serve.requests" not in overrides and not getattr(args, "config",
                                                         None):
        overrides["serve.requests"] = 64
    return exp.with_overrides(spec, overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args)
    if getattr(args, "dump_config", False):
        print(exp.to_json(spec, elide_defaults=False))
        return spec
    return exp.run(spec, device=args.device, quiet=args.quiet).serve


if __name__ == "__main__":
    main()
