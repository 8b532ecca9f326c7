"""End-to-end decentralized training CLI of the port — a thin argv -> spec
translator, the same flags as the JAX package's ``launch/train.py`` plus
``--device``.

Every flag maps to one field of :class:`repro_torch.exp.ExperimentSpec`
(``FLAG_TO_FIELD``, the reference's table); the run is
``repro_torch.exp.run(spec, device=...)``.  ``--device`` (default ``cuda``)
is a runtime argument, not a spec field, so ``--dump-config`` prints the
same JSON as the reference's CLI for the same flags.  Flags whose scenario
axis is not ported yet are accepted and raise ``NotImplementedError``
naming their ROADMAP.md item when the run is built.

``--metrics PATH`` writes the event log (the four in-step scalars of every
step, phase spans, the optimality gap; ``python -m
repro_torch.obs.report PATH`` renders it), ``--profile-dir DIR`` a
``torch.profiler`` trace of the first ``--profile-steps`` steps, and
``--checkpoint`` / ``--restore`` the arch runtime's state in the
reference's msgpack format: a checkpoint of either package restores in the
other.

``--gossip-impl pallas`` keeps the reference's meaning, the fused gossip
kernel: here all R rounds of Algorithm 2 run in one pass of the
hand-written Hopper ``gossip_mix`` kernel (its plain PyTorch version on the
CPU).  With ``--compress sign|int8`` the rounds quantize every payload with
error feedback, and the fused window is the Hopper ``quantized_gossip_mix``
kernel.

``--gossip-impl auto`` lowers the schedule to its gossip plan and sends
every round to its cheapest mix (``sun``, a matching, the complete-graph
mean, ``two_level`` pods with ``--pods``, an edge list, or a dense round);
``empty`` rounds cost nothing.  Every update rule of the reference runs:
``--algo`` dsgd, dsgt, mc_dsgt, d2, local_sgd, gt_local or personalized,
with ``--local-opt`` sgd, momentum or adam.

``--arch logreg`` runs the paper's §6 logistic regression on the host
runtime, one matrix product per round on the dense topologies (``sun``,
``random-sun``, ``ring``, ...) or the plan's mixes under ``--gossip-impl
auto``, or, with ``--topology random-sampled``, a sampled cohort of a large
fleet gossiping over an edge-list plan each round (``--gossip-impl
auto``), the whole fleet's data and state on the device.  ``--compress``,
``--hetero-alpha`` (the Dirichlet partition) and ``--telemetry`` (the
telemetry file and its manifest) apply to it.  Its oracle returns no
per-node losses, so ``--algo personalized`` raises there, as in the
reference.

The reference's federated scenario (FedAvg: local steps, then one global
average; the plan is 2×empty+1×complete):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --preset full --nodes 4 --topology federated --local-steps 2 \
        --algo local_sgd --gossip-impl auto --steps 6

Example (Figure 2's MNIST shapes, MC-DSGT R=2, int8 gossip, telemetry):
    PYTHONPATH=src python -m repro_torch.launch.train --arch logreg \
        --logreg-d 784 --logreg-m 512 --batch 32 --topology random-sun \
        --nodes 16 --algo mc_dsgt --R 2 --gamma 0.5 --compress int8 \
        --steps 20 --telemetry telem.json

Example (qwen1.5-0.5b at full width, 4 nodes stacked on one H100; add
``--compress int8`` for int8 gossip):
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --preset full --nodes 4 --algo mc_dsgt --R 2 --gossip-impl pallas \
        --steps 3

Example (256 of 100,000 clients per round, the paper's MNIST width):
    PYTHONPATH=src python -m repro_torch.launch.train --arch logreg \
        --logreg-d 784 --logreg-m 8 --batch 4 --topology random-sampled \
        --nodes 100000 --sample-k 256 --radius 0.45 --link-drop 0.2 \
        --churn 0.02 --algo mc_dsgt --R 2 --gamma 0.3 --gossip-impl auto \
        --steps 5
"""

from __future__ import annotations

import argparse

from repro_torch import exp

# flag dest -> dotted ExperimentSpec field.  This mapping IS the CLI's
# semantics (and the README migration table): parse_args collects only the
# flags actually given (argparse.SUPPRESS), and each one overrides the
# baseline spec — the dataclass defaults, or the --config file.
FLAG_TO_FIELD = {
    "arch": "model.arch",
    "preset": "model.preset",
    "logreg_d": "model.d",
    "logreg_m": "model.m",
    "steps": "run.steps",
    "nodes": "run.nodes",
    "beta": "topology.beta",
    "topology": "topology.kind",
    "algo": "algorithm.name",
    "gossip_impl": "run.gossip_impl",
    "local_opt": "algorithm.local_opt",
    "er_p": "topology.er_p",
    "radius": "topology.radius",
    "local_steps": "topology.local_steps",
    "pods": "topology.pods",
    "sample_k": "topology.sample_k",
    "delay": "algorithm.delay",
    "comm_interval": "algorithm.comm_interval",
    "link_drop": "channel.link_drop",
    "burst_loss": "channel.burst_loss",
    "churn": "channel.churn",
    "straggler": "channel.straggler",
    "telemetry": "run.telemetry",
    "compress": "compression.scheme",
    "compress_group": "compression.group",
    "compress_warmup": "compression.warmup",
    "error_feedback": "compression.error_feedback",
    "hetero_alpha": "data.hetero_alpha",
    "R": "algorithm.R",
    "gamma": "algorithm.gamma",
    "batch": "data.batch",
    "seq": "data.seq",
    "checkpoint": "run.checkpoint",
    "restore": "run.restore",
    "log_every": "run.log_every",
    "active_vocab": "data.active_vocab",
    "seed": "run.seed",
    "metrics": "obs.metrics",
    "metrics_every": "obs.every",
    "obs_names": "obs.names",
    "profile_dir": "obs.profile_dir",
    "profile_steps": "obs.profile_steps",
}


def build_parser() -> argparse.ArgumentParser:
    # SUPPRESS: a flag appears in the namespace only when explicitly given,
    # so file-provided values are overridden by flags and nothing else.
    ap = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
    ap.add_argument("--config", metavar="PATH",
                    help="baseline spec JSON (a spec or a manifest written "
                         "by a previous run); explicit flags override it")
    ap.add_argument("--dump-config", action="store_true",
                    help="print the fully-resolved spec JSON and exit "
                         "(pipe to a file, rerun with --config)")
    ap.add_argument("--arch",
                    help="registered LM architecture (repro.configs), or "
                         "'logreg' for the paper's host-runtime logistic "
                         "regression (required by --topology random-sampled)")
    ap.add_argument("--preset", choices=["reduced", "full"])
    ap.add_argument("--logreg-d", type=int, dest="logreg_d",
                    help="--arch logreg: feature dimension (default 64; "
                         "keep small at 10^5+ nodes — the dataset is "
                         "n x m x d)")
    ap.add_argument("--logreg-m", type=int, dest="logreg_m",
                    help="--arch logreg: samples per node (default 256)")
    ap.add_argument("--steps", type=int)
    ap.add_argument("--nodes", type=int)
    ap.add_argument("--beta", type=float)
    ap.add_argument("--topology", choices=list(exp.TOPOLOGIES))
    ap.add_argument("--algo", choices=list(exp.ALGORITHMS))
    ap.add_argument("--gossip-impl", choices=list(exp.GOSSIP_IMPLS),
                    help="multi-consensus path: one matrix product per "
                         "round (dense), or all R rounds fused in the Hopper "
                         "gossip_mix kernel, or quantized_gossip_mix with "
                         "--compress (pallas, the reference's name for the "
                         "fused kernel; its plain version on the CPU), or the "
                         "edge plan's scatter mixer (auto, the sampled-client "
                         "family's path with --arch logreg; auto is not "
                         "ported for the other topologies yet)")
    ap.add_argument("--local-opt", choices=sorted(exp.LOCAL_OPTS),
                    help="local-optimizer transform applied to the descent "
                         "direction (repro.optim; sgd = the paper-pure "
                         "update, no transform)")
    ap.add_argument("--er-p", type=float,
                    help="edge probability for --topology erdos-renyi")
    ap.add_argument("--radius", type=float,
                    help="unit-disk communication range for the mobility "
                         "topologies (geometric-mobility, waypoint-mobility)")
    ap.add_argument("--local-steps", type=int,
                    help="local-only rounds between averaging rounds for "
                         "--topology federated")
    ap.add_argument("--pods", type=int,
                    help="nodes per pod (pod-major order): rounds that "
                         "factor as B ⊗ J_p across pod boundaries take the "
                         "hierarchical two-level lowering under --gossip-impl "
                         "auto; --topology hierarchical builds such schedules")
    ap.add_argument("--sample-k", type=int, dest="sample_k",
                    help="clients gossiping per round for --topology "
                         "random-sampled (the sparse edge-list family: "
                         "per-round cost O(edges), n can reach 10^5..10^6)")
    ap.add_argument("--delay", type=int,
                    help="stale-window gossip: mix the payload from N steps "
                         "ago and fold only the correction into the fresh "
                         "payload, freeing XLA to overlap the collectives "
                         "with the grad computation (0 = synchronous, "
                         "bit-exact today's path)")
    ap.add_argument("--comm-interval", type=int,
                    help="mix every k driver steps, pure local updates in "
                         "between (identity mix on skipped steps; "
                         "incompatible with --compress)")
    ap.add_argument("--link-drop", type=float,
                    help="iid per-round per-link Bernoulli drop probability "
                         "(repro.sim channel degradation)")
    ap.add_argument("--burst-loss", type=float,
                    help="Gilbert-Elliott bursty loss: per-round good->bad "
                         "transition probability (bad links drop their "
                         "round; recovery 0.25/round)")
    ap.add_argument("--churn", type=float,
                    help="per-round node failure probability (a down node "
                         "loses all links; recovery 0.3/round)")
    ap.add_argument("--straggler", type=float,
                    help="per-round per-node straggler probability (a "
                         "straggler's links miss the round deadline and "
                         "are dropped)")
    ap.add_argument("--telemetry", metavar="PATH",
                    help="write the repro.sim mixing-telemetry JSON history "
                         "(consensus distance, windowed spectral gap, "
                         "realized effective diameter) to PATH")
    ap.add_argument("--compress", choices=list(exp.COMPRESSIONS),
                    help="gossip payload compression scheme: sign (1 "
                         "bit/entry + one f32 scale per group) or int8 "
                         "(absmax per group), with per-node error-feedback "
                         "residuals; none = full-precision f32 payloads")
    ap.add_argument("--compress-group", type=int,
                    help="entries per quantization scale group "
                         "(default 256)")
    ap.add_argument("--compress-warmup", type=int,
                    help="driver steps that gossip at full precision "
                         "before the compression scheme activates")
    ap.add_argument("--no-error-feedback", dest="error_feedback",
                    action="store_false",
                    help="disable the error-feedback residual (pure "
                         "quantized gossip; EF is on by default)")
    ap.add_argument("--hetero-alpha", type=float,
                    help="Dirichlet(alpha) data heterogeneity across nodes: "
                         "each node draws its token distribution from a "
                         "Dirichlet prior over the active vocab (small "
                         "alpha = highly non-iid, the federated setting)")
    ap.add_argument("--R", type=int)
    ap.add_argument("--gamma", type=float)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--seq", type=int)
    ap.add_argument("--checkpoint")
    ap.add_argument("--restore")
    ap.add_argument("--log-every", type=int)
    ap.add_argument("--active-vocab", type=int,
                    help="restrict synthetic tokens to first k ids "
                         "(learnable stream); 0 = full vocab")
    ap.add_argument("--seed", type=int)
    ap.add_argument("--metrics", metavar="PATH",
                    help="write the repro_torch.obs JSONL event log "
                         "(in-step metrics, phase spans, optimality gap) to "
                         "PATH; render it with `python -m "
                         "repro_torch.obs.report PATH`")
    ap.add_argument("--metrics-every", type=int,
                    help="host flush batch for --metrics: buffered device "
                         "scalars cross to the host in one copy per N "
                         "recorded steps (default 10)")
    ap.add_argument("--obs-names",
                    help="comma-separated in-step metric subset for "
                         f"--metrics (of: {', '.join(exp.OBS_METRICS)}); "
                         "'auto' = the update rule's default set")
    ap.add_argument("--profile-dir", metavar="DIR",
                    help="write a torch.profiler Chrome trace of the first "
                         "--profile-steps steps to DIR/trace.json")
    ap.add_argument("--profile-steps", type=int)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; raises "
                         "without a GPU unless --device cpu is given)")
    ap.add_argument("--quiet", action="store_true", default=False,
                    help="suppress progress output (event-log/telemetry "
                         "files are still written)")
    return ap


def spec_from_args(args: argparse.Namespace) -> exp.ExperimentSpec:
    """Translate a parsed namespace into a spec: start from the --config
    baseline (or the dataclass defaults) and apply each explicitly-given
    flag through its ``FLAG_TO_FIELD`` path."""
    spec = exp.load(args.config) if getattr(args, "config", None) \
        else exp.ExperimentSpec()
    overrides = {FLAG_TO_FIELD[dest]: value
                 for dest, value in vars(args).items()
                 if dest in FLAG_TO_FIELD}
    # ``--arch logreg`` selects the paper's host-runtime logistic
    # regression (model.kind), not a registered LM architecture — the
    # required model for the sparse sampled-client topologies.
    if overrides.get("model.arch") == "logreg":
        del overrides["model.arch"]
        overrides["model.kind"] = "logreg"
    return exp.with_overrides(spec, overrides)


def main(argv=None):
    args = build_parser().parse_args(argv)
    spec = spec_from_args(args)
    if getattr(args, "dump_config", False):
        print(exp.to_json(spec, elide_defaults=False))
        return spec
    return exp.run(spec, device=args.device, quiet=args.quiet).history


if __name__ == "__main__":
    main()
