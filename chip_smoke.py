"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's Hopper kernels from
``src/repro_torch/kernels/csrc`` with nvcc, holds each against its plain
PyTorch version on the card, times it at the main path's shape beside its
bound, the plain version and, where there is one, a PyTorch library call,
and then drives the main paths through the train CLI's own functions:

* slice 1, MC-DSGT (R=2) on qwen1.5-0.5b at full width, 4 nodes stacked on
  the card, 3 steps, full-precision gossip through the ``gossip_mix``
  kernel;
* slice 2, the same with error-feedback int8 gossip (``--compress int8``)
  through the ``quantized_gossip_mix`` kernel;
* slice 3, sampled-client MC-DSGT (R=2) on the paper's logistic regression
  at MNIST width (d = 784): 256 of 100,000 clients per round on a unit-disk
  graph with link drop and churn, 5 steps, the whole fleet's data and state
  on the card.  Path A takes the JAX package's route, the edge plan's
  scatter mixer (0 kernel launches); path B runs the same built scenario
  through ``run_algorithm`` with a plan whose mixer asks for the
  ``sparse_segment_mix`` kernel (``use_pallas=True``), every round on the
  kernel's staged variant, and its evals must equal path A's;
* slice 4, continuously-batched serving of a falcon-mamba-7b fleet at its
  published widths and full depth (4 members of 7.0B parameters in bf16,
  random from seeds) through ``repro_torch.serve.serve_fleet``: 8 requests
  of a 2048-token prompt and 32 new tokens on 4 slots, every mamba layer of
  every prefill through the ``linear_recurrence`` kernel
  (``use_pallas=True``); two of the requests are served again one at a
  time and must give the same tokens;
* slice 5, the same serving of a qwen1.5-0.5b fleet at its published widths
  and full depth (4 members of 464M parameters in bf16): 8 requests of a
  1920-token prompt and 128 new tokens on 4 slots, every attention layer of
  every prefill through the ``flash_attention`` kernel and of every decode
  step through ``decode_attention`` against a 2048-slot KV cache; two of the
  requests are served again one at a time and must give the same tokens;
* the serve entry point, ``repro_torch.launch.serve.main``: it trains a
  qwen1.5-0.5b fleet of 4 at full width for 2 MC-DSGT steps through
  ``gossip_mix`` and serves 8 requests of 128 + 16 tokens from it in bf16
  (``exp.run``'s serve phase, the model's plain attention, as in the
  reference);
* slice 8, the same serving of a recurrentgemma-2b fleet at its published
  widths and full depth (4 members of 2.89B parameters in bf16): 8 requests
  of a 3968-token prompt and 128 new tokens on 4 slots, every rglru layer
  of every prefill through ``linear_recurrence`` at C = 2560, every local
  attention layer (10 query heads of 256 over 1 KV head, a 2048-token
  window) of every prefill through ``flash_attention`` and of every decode
  step through ``decode_attention`` against a 2048-slot ring that has
  wrapped; two requests are served again one at a time and must give the
  same tokens;
* slice 14, the same serving of a yi-6b fleet (at its published widths,
  its depth cut to 8 of 32 layers: 4 members of 1.65B parameters, 13.2 GB
  in bf16; 32 query heads over 4 KV heads of 128) and then, that fleet
  freed, of a minitron-4b fleet (8 of 32 layers: 4 members of 2.23B, 17.8
  GB; relu2, untied embeddings, 24 query heads over 8 KV heads of 128): 8
  requests of a 1920-token prompt and 128 new tokens on 4 slots against a
  2048-slot KV cache, every attention layer of every prefill through
  ``flash_attention`` and of every decode step through ``decode_attention``
  at head_dim 128; two requests of each are served again one at a time and
  must give the same tokens;
* slice 15, the same serving of a granite-moe-3b-a800m fleet (at its
  published widths, its depth cut to 8 of 32 MoE layers since slice 16: 4
  members of 0.88B parameters, 7.05 GB in bf16; 40 experts top-8, 24
  query heads over 8 KV heads of 64): 8 requests of a 1920-token prompt
  and 128 new tokens on 4 slots against a 2048-slot KV cache, each MoE
  layer's attention through ``flash_attention`` in every prefill and
  ``decode_attention`` in every decode step; two requests are served again
  one at a time and must give the same tokens; slice 19, the same serving
  of a nemotron-4-340b fleet (at its published widths, its depth cut to 2
  of 96 layers: 2 members of 16.35B parameters, 65.38 GB in bf16; 96 query
  heads over 8 KV heads of 192, G = 12, relu2, an untied vocabulary of
  256,000), both kernels at head_dim 192 (decode on its tensor-core
  route); then slice 15's training
  paths through the train CLI (the pattern-generic arch trainer, use_pallas
  off as in the reference; MC-DSGT R=2 on 4 nodes through ``gossip_mix``):
  internvl2-1b at full width on 256 patch embeddings + 64 tokens a
  sequence, granite-moe-3b-a800m at its published widths cut to 4 layers
  (3 steps straight, then a checkpoint after 2 and a restore, the restored
  run equal to the straight one) and falcon-mamba-7b cut to 2 layers, then
  the ``examples/torch/serve_batch.py`` twin (reduced, 0 launches);
* slice 16, whisper-tiny's encoder-decoder at its published widths and
  depth (4 + 4 layers, d_model 384, 1500 frames; D = 36,448,128) through
  the train CLI: MC-DSGT R=2 on 4 nodes through ``gossip_mix``; slice 18's
  leg (f), the paper's 32 nodes in full precision through ``gossip_mix``
  (6 launches, each held to the plain version on its own
  inputs); then on 32
  nodes with int8 gossip in groups of 512 through ``quantized_gossip_mix``'s
  ring route (n past 16, a group past 256; since slice 17), every launch
  held to the plain version, and one step with sign; slice 17's leg (e),
  the same 32 nodes with bf16 trackers and residuals (``aux_dtype``)
  through ``dist.steps.make_train_step``, the kernel taking the bf16
  residuals as stored (6 launches, each held to the plain version); then
  served by hand in bf16 (4 x (1500
  frames + 64 prompt tokens), 64 greedy decode steps against the cross
  cache; no kernel), its f32 prefill + teacher-forced decode equal to the
  forward; and a reduced qwen1.5-0.5b with a logit softcap, equal on the
  card and the CPU;
* the paper's §6 on the dense host runtime, through the twins of the
  reference's examples under ``examples/torch/``: the quickstart
  (MC-DSGT <= DSGD on ``sun``), Figure 2 at its default budget (both
  protocols, the whole step-size grid; mnist-24's verdict must be "beats"
  and covtype-binary's must not be "LOSES to"), MC-DSGT on the MNIST
  protocol with int8 and sign gossip and DSGT on its Dirichlet partition,
  and the sampled-clients example at n = 100,000, whose manifest must equal
  the checked-in one.  No kernel runs there: the counts stay at 0;
* gossip planning and the federated/local-update rules: the reference's
  FedAvg run (``--algo local_sgd --topology federated --gossip-impl auto``)
  at full width over the plan 2×empty+1×complete (0 launches); MC-DSGT on
  ``ring``, every plan round dense, through ``gossip_impl='auto'`` with
  ``auto_dense='pallas'`` and through ``'pallas'`` from one init (2
  ``gossip_mix`` launches a step in each, final states equal bit for bit),
  then ``'sun'`` against ``'auto'`` on the theorem-3 schedule (equal); gt_local
  with adam on ``hierarchical`` pods of 2 at full width; and on the host
  runtime the ``examples/torch/federated.py`` twin, logreg on pods of 4
  (``two_level`` rounds), d2 on ``sun`` and personalized on ``random-sun``
  (0 launches);
* wireless mobility and the async axis: qwen1.5-0.5b at full width, 4
  nodes, on the realized waypoint-mobility schedule with 20% link drop,
  through the train CLI: MC-DSGT with a stale window of 1 through
  ``gossip_mix`` (6 launches in 3 steps; the tracker mean h̄ = ḡ⁻ held
  after every step; the final state equal to the dense mixer's), the same
  with int8 gossip through ``quantized_gossip_mix`` (6 launches, each held
  to its plain version on the stale payload) and DSGD int8 through it
  against the dense compressed mixer, ``--comm-interval 2`` (4 launches in
  4 steps, none on a skipped step), and the twins of
  ``examples/wireless_mobility.py`` and ``examples/compressed_gossip.py``
  (0 launches, their assertions holding);
* observability and checkpoints, through the train CLI: the main path
  with ``--metrics`` (the four in-step scalars of every step in the event
  log, its summary with phases and the optimality floor, the log rendered
  by ``repro_torch.obs.report``) and ``--profile-dir`` (one step's device
  time under ``obs_grad`` and ``obs_mix``), 6 ``gossip_mix`` launches;
  the same model on 2 nodes 3 steps straight against 2 steps, a
  ``--checkpoint`` of 11.1 GB and 1 step after ``--restore`` (losses
  equal, final state bit-equal or within rtol 1e-4 / atol 1e-5, the file's
  write and read GB/s), 12 launches in 6 steps; and the twins of
  ``examples/lower_bound_demo.py`` and ``examples/train_lm.py`` (0
  launches, their assertions holding);
* the spec smoke (ROADMAP Queue 1 item 13): ``repro_torch.exp.validate``
  with ``--device cuda --min-manifests 4`` (every ``examples/torch/``
  twin's SPECS cell shrunk to 2 steps, the obs smoke, the four compressed
  cells, the checked-in manifests), which must return 0, each cell's
  launches stated (0 off the ``pallas`` gossip impl); then the
  ``examples/personalized_fleet.py`` twin at its own size on Dirichlet(0.1)
  token streams, its assertions holding (0 launches).

``quantized_gossip_mix`` is checked on each of its three routes (the
first design's registers at n <= 16, the ring of clusters at n 16 to 128,
a group streamed through device memory each round at n up to 200), with
bf16 x and/or res on every route bit-equal to the f32 launch on upcast
copies, and the ring's int8 bits equal to the regs route's; it is timed on
the ring at whisper-tiny's 32-node shape in f32 and bf16, on the stream
route at PR 28's shape and at a group no cluster holds, and past 64 nodes;
``gossip_mix`` is checked at n 4 to 300 (its warp and block walks, W^T in
chunks at n = 300), both dtypes, in place; its geometry and compiled
resources are
printed, and it is timed at the main shape, at whisper-tiny's 32-node
shape (leg (f)'s path) and, timed only, at n = 128 and with bf16 x.
``flash_attention`` and ``decode_attention`` are checked at head_dim 32 to
256 (192 since slice 19) and decode at G up to 33, each row group of a G >
16 launch bit-equal to its rows launched alone.
``linear_recurrence`` is checked bit-equal on each of its three routes
(a ring of time tiles filled by TMA or by cp.async, and the loop) and
prints its route, geometry and compiled resources at both serve shapes.
Slices 1 and 2 launch their kernel 2 times per step (the x and h windows),
path B 4 times (one per round), the falcon-mamba serve path 64 times per
prefill (one per layer; decode feeds one token and takes no kernel), the
qwen serve path ``flash_attention`` 24 times per prefill and
``decode_attention`` 24 times per slot and token, the serve CLI path
``gossip_mix`` 2 times per step and nothing else, the recurrentgemma serve
path ``linear_recurrence`` 18 and ``flash_attention`` 8 times per prefill
and ``decode_attention`` 8 times per slot and token, the yi-6b and
minitron-4b serve paths ``flash_attention`` 8 times per prefill and
``decode_attention`` 8 times per slot and token, the granite-moe serve path
8 times each (one attention layer a MoE layer), the nemotron serve path 2
times each, the slice-15
training legs ``gossip_mix`` 2 times per step, the slice-16 legs
``gossip_mix`` (4 nodes) and ``quantized_gossip_mix`` (32 nodes) 2 times
per step and nothing in serving or the softcap leg, leg (f) ``gossip_mix``
2 times per step, the wireless legs the
gossip kernels 2 times per mixing step, the observability and
checkpoint legs ``gossip_mix`` 2 times per step; the counts are set to 0
just before a path and read just after it.  It prints the card, its total
wall time, one JSON line of per-kernel numbers (a second ``gossip_mix`` row
for the planning path, three rows for the wireless legs, two for the
observability and checkpoint legs, three for the slice-15 training legs,
two for the slice-16 legs (``quantized_gossip_mix`` timed at the 32-node
shape on its ring route), one for slice 17's leg (e), one for slice 18's
leg (f) (``gossip_mix`` timed at the 32-node shape), three rows at the
recurrentgemma shapes, then the last
eight: the attention kernels at yi-6b's and minitron-4b's head_dim 128, at
granite-moe-3b-a800m's head_dim 64 with G = 3 and at nemotron-4-340b's
head_dim 192 with G = 12; and, under ``timed_only``, the timings at shapes
no path launches, decode at G = 48 among them), and last
``{"ok": true, "device": {...}}``.
Any failed phase exits non-zero; so does a machine without a CUDA device or
a directory without the repository.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and float32
# outside the tensor cores (the kernel's FMA).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
MAIN = dict(n=4, R=2, D=463_987_712)   # qwen1.5-0.5b flat state, 4 nodes
STEPS = 3
MAIN_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "4",
             "--algo", "mc_dsgt", "--R", "2", "--gossip-impl", "pallas",
             "--steps", str(STEPS), "--device", "cuda"]
COMPRESSED_ARGV = MAIN_ARGV + ["--compress", "int8"]
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # rtol = atol, see check_kernel
# quantized_gossip_mix against its plain version: after round 1 the two sum
# the mix in other orders, and a one-ulp difference can flip one entry's
# int8 rounding (or the sign of a value at 0), which moves it by one
# quantization step.  Up to this fraction of the entries may do so: in the
# small cases (worst reading 3.2e-4, at n=16, R=4), and at the main shape
# (reading 1.4e-6, 5,085 of 3.7e9 entries).  Flips cannot hide a fault:
# see qcompare for what else holds every entry.
MAX_FLIPS = 1e-3
MAIN_MAX_FLIPS = 1e-5
# A result stored in bf16: one f32 ulp of difference may round it to the
# neighbouring bf16 value, 2^-8 of it (as tests/test_torch_rules.py holds
# bf16 residuals); such entries count as flipped beyond this rtol.
BF16_RTOL = 2.0 ** -7
GROUP = 256                  # the default compression group
# Slice 3: examples/sampled_clients.py's scenario at the paper's MNIST width
# (configs/logreg_paper.py), through the train CLI.
SAMPLED_STEPS = 5
SAMPLED_ARGV = ["--arch", "logreg", "--logreg-d", "784", "--logreg-m", "8",
                "--batch", "4", "--topology", "random-sampled", "--nodes",
                "100000", "--sample-k", "256", "--radius", "0.45",
                "--link-drop", "0.2", "--churn", "0.02", "--algo", "mc_dsgt",
                "--R", "2", "--gamma", "0.3", "--gossip-impl", "auto",
                "--steps", str(SAMPLED_STEPS), "--device", "cuda"]
# sparse_segment_mix against its plain version: the same f32 products, each
# segment summed in the kernel's edge order (FMA) against index_add_'s
# atomics.  The inputs are gossip rounds: a receiver's weights sum to less
# than 1 (Metropolis), so partial sums stay of the order of x and the two
# orders differ by a few ulps of that.  (With weights U(0, 1), 513 edges
# into one segment drift to partial sums of ~10 and differed by 1.1e-5.)
STOL = 1e-5
# Slice 4: falcon-mamba-7b (configs/falcon_mamba_7b.py, hf:tiiuae/falcon-mamba-7b)
# served from a fleet of 4; the prompt meets the kernel's tiling condition.
SERVE = dict(requests=8, batch=4, prompt_len=2048, max_new=32, fleet=4,
             routing="user-affinity", dtype="bf16", seed=0)
FALCON_PARAMS = 7_006_326_784            # per member, from the config's shapes
LINREC_MAIN = (1, 2048, 8192 * 16)       # (B, S, d_inner·N) of one prefill
SEQUENTIAL_RIDS = (0, 7)                 # served again one at a time
# Slice 5: qwen1.5-0.5b (configs/qwen1_5_0_5b.py, hf:Qwen/Qwen1.5-0.5B) served
# from a fleet of 4.  The prompt is a multiple of 128 and prompt + new
# tokens (the cache length C) a multiple of 256, the tiling both attention
# kernels take.
QSERVE = dict(requests=8, batch=4, prompt_len=1920, max_new=128, fleet=4,
              routing="user-affinity", dtype="bf16", seed=0)
QWEN_PARAMS = 463_987_712                # per member, from the config's shapes
FLASH_MAIN = (1, 1920, 16, 16, 64)       # (B, S, H, KV, hd) of one prefill
DECODE_MAIN = (1, 2048, 16, 1, 64)       # (B, C, J, G, hd) of one decode layer
# Slice 8: recurrentgemma-2b (configs/recurrentgemma_2b.py, hf:google/
# recurrentgemma-2b, arXiv:2402.19427) served from a fleet of 4: 26 layers,
# 8 units of (rglru, rglru, attn) + 2 rglru, MQA (10 query heads of 256 over
# 1 KV head), a 2048-token window over a 2048-slot ring.  The prompt is a
# multiple of 128 and longer than the window, so every prefill runs the
# windowed flash path and wraps the ring; prompt + new = 4096 is within the
# model's 8192-token training context.
RGSERVE = dict(requests=8, batch=4, prompt_len=3968, max_new=128, fleet=4,
               routing="user-affinity", dtype="bf16", seed=0)
RG_PARAMS = 2_894_574_080                # per member, the reference's count
RG_WINDOW = 2048
FLASH_RG = (1, 3968, 10, 1, 256)         # (B, S, H, KV, hd) of one prefill
DECODE_RG = (1, 2048, 1, 10, 256)        # (B, C, J, G, hd) of one decode
LINREC_RG = (1, 3968, 2560)              # (B, S, lru_width) of one layer
# Slice 14: yi-6b (configs/yi_6b.py, arXiv:2403.04652; 32 query heads over 4
# KV heads of 128, G = 8) and minitron-4b (configs/minitron_4b.py,
# arXiv:2407.14679; relu2 with no gate, untied embeddings, 24 query heads
# over 8 KV heads of 128, G = 3) served from fleets of 4 at their published
# widths and full depth: the first serve paths at head_dim 128, both
# kernels on their SIMT routes.  As qwen's: a 1920-token prompt (a multiple
# of 128) and prompt + new tokens = 2048 cache slots (a multiple of 256, the
# tiling both kernels take; so 128 new tokens, not fewer).  minitron keeps
# prefill_last_only off, as its config does: a prefill unembeds all 1920
# positions (0.98 GB of bf16 logits).  Their depth is cut to HD128_LAYERS
# of their 32 layers (the widths, and so every kernel shape, unchanged),
# so that the smoke, which grows a phase a slice, stays well inside its
# time limit: the two paths took 102-110 s at full depth.
YSERVE = dict(requests=8, batch=4, prompt_len=1920, max_new=128, fleet=4,
              routing="user-affinity", dtype="bf16", seed=0)
MSERVE = dict(YSERVE)
HD128_LAYERS = 8
YI_PARAMS = 1_646_333_952                # per member at HD128_LAYERS layers
MINITRON_PARAMS = 2_227_227_648          # per member (untied: 2 x 786M)
FLASH_YI = (1, 1920, 32, 4, 128)         # (B, S, H, KV, hd) of one prefill
DECODE_YI = (1, 2048, 4, 8, 128)         # (B, C, J, G, hd) of one decode
FLASH_MT = (1, 1920, 24, 8, 128)
DECODE_MT = (1, 2048, 8, 3, 128)
# Slice 15: granite-moe-3b-a800m (configs/granite_moe_3b_a800m.py,
# hf:ibm-granite/granite-3.0-1b-a400m-base family; 32 MoE layers of 40
# experts top-8 with d_ff 512, 24 query heads over 8 KV heads of 64, G = 3)
# served from a fleet of 4 at its published widths, as qwen's: a 1920-token
# prompt and a 2048-slot cache.  Each MoE layer runs one attention layer, so
# the kernels launch once a layer a prefill and once a layer a slot-token.
# Its depth is cut to GRANITE_SERVE_LAYERS of its 32 layers (every kernel
# shape unchanged) since slice 16, so that the smoke stays inside its time
# limit: the path took 107.9-130.3 s at full depth, most of it host-bound
# decode, and the smoke 904.5 s with it.
GSERVE = dict(YSERVE)
GRANITE_SERVE_LAYERS = 8
GRANITE_PARAMS = 881_326_080             # per member at GRANITE_SERVE_LAYERS
FLASH_GR = (1, 1920, 24, 8, 64)          # (B, S, H, KV, hd) of one prefill
DECODE_GR = (1, 2048, 8, 3, 64)          # (B, C, J, G, hd) of one decode
# Slice 19: nemotron-4-340b (configs/nemotron_4_340b.py, arXiv:2402.16819;
# d_model 18,432, 96 query heads over 8 KV heads of 192, G = 12, relu2 with
# d_ff 73,728, an untied vocabulary of 256,000) served at its published
# widths from a fleet of 2, its depth cut to NEMOTRON_LAYERS of its 96
# layers: 16.35B parameters a member, 65.38 GB for the fleet in bf16 (4
# members of 1 layer would take 103 GB, 2 of 3 layers 79.2 GB).  The yi-6b
# path's traffic on 2 members: a 1920-token prompt and a 2048-slot cache,
# both kernels at head_dim 192 (decode on its tensor-core route).
NSERVE = dict(YSERVE, fleet=2)
NEMOTRON_LAYERS = 2
NEMOTRON_PARAMS = 16_345_294_848         # per member at NEMOTRON_LAYERS
FLASH_NM = (1, 1920, 96, 8, 192)         # (B, S, H, KV, hd) of one prefill
DECODE_NM = (1, 2048, 8, 12, 192)        # (B, C, J, G, hd) of one decode
# decode_attention past 16 query rows a KV head, timed only (no shipped
# config has G > 16): nemotron's 96 query heads over 2 KV heads, G = 48,
# three row groups
DECODE_G48 = (1, 2048, 2, 48, 192)
# Slice 15's training paths, through the train CLI (use_pallas off, as the
# reference trains; the gossip through gossip_mix, 2 launches a step):
# internvl2-1b (configs/internvl2_1b.py, arXiv:2404.16821) at full width,
# each sequence 256 patch embeddings of the stub frontend and 64 text
# tokens (--seq 320; at the CLI's default 64 no text would be left);
# granite-moe-3b-a800m and falcon-mamba-7b at their published widths with
# the depth cut to TRAIN_LAYERS (a 4-node state of all 32 or 64 layers
# does not fit one card), registered under "<arch>-<L>l".
VLM_ARGV = ["--arch", "internvl2-1b", "--preset", "full", "--nodes", "4",
            "--algo", "mc_dsgt", "--R", "2", "--gossip-impl", "pallas",
            "--batch", "2", "--seq", "320", "--steps", str(STEPS),
            "--device", "cuda"]
TRAIN_LAYERS = {"granite-moe-3b-a800m": 4, "falcon-mamba-7b": 2}
TRAIN_D = {"granite-moe-3b-a800m": 478_414_848, "falcon-mamba-7b": 476_966_912}
# Slice 16: whisper-tiny (configs/whisper_tiny.py, arXiv:2212.04356), the
# encoder-decoder at its published widths and depth (4 + 4 layers, d_model
# 384, 6 heads of 64, vocab 51,865, 1500 frames of the stub frontend, D =
# 36,448,128), through the train CLI (use_pallas is read by no layer of the
# encoder-decoder, in either package, so no attention kernel runs): (a) 4
# nodes through gossip_mix; (b) 32 nodes with int8 gossip in groups of 512
# through quantized_gossip_mix's tile route (its state, 36,448,768 columns
# aligned to the group, is 4.67 GB an (n, D) f32 tensor), every launch held
# to the plain version, then one step with sign; (c) served by hand in
# bf16 (serve_fleet refuses audio, as the reference's engine does): 4
# sequences of 1500 frames, a 64-token prefill and 64 greedy decode steps
# against the cross cache; (d) a reduced qwen1.5-0.5b with a logit softcap
# of 30, prefill and decode on the card against the CPU; (f) 32 nodes in
# f32 through gossip_mix (its (32, D) state is 4.67 GB).
WHISPER_D = 36_448_128
WHISPER_D_ALIGNED = 36_448_768          # each leaf aligned to the group
WHISPER_GROUP = 512
WHISPER_ARGV = ["--arch", "whisper-tiny", "--preset", "full", "--algo",
                "mc_dsgt", "--R", "2", "--gossip-impl", "pallas",
                "--device", "cuda"]
WHISPER_NODES = 32
WSERVE = dict(batch=4, prompt_len=64, max_new=64)
# quantized_gossip_mix's stream route timed at the 32-node state's width
# where PR 28 timed it (group 1024; since slice 17 the ring takes that
# shape, in clusters of 8, and the stream route is launched there by name),
# and at group 4096, which no cluster holds (2 MB a group)
STREAM_GROUP = 1024
STREAM_D = 1024 * 35_594
WIDE_GROUP = 4096
WIDE_GROUP_D = 4096 * 8898
# the ring past 64 nodes, timed at one shape of as many bytes as whisper's
# 32-node state: n = 128, group 256 (clusters of 8 blocks of 32 columns, W
# read from device memory)
PAST64_NODES = 128
PAST64_D = 256 * 35_594
# gossip_mix timed past the 32 nodes no path exceeds, at as many bytes as
# whisper's 32-node f32 state: n = 128, where the FMAs bound it
GOSSIP_WIDE_NODES = 128
GOSSIP_WIDE_D = 9_112_064
# Each gossip_mix launch of whisper leg (f) is held to its plain version on
# three windows of this many columns (first, middle, last)
MIX_CHECK_COLS = 1 << 20
SOFTCAP = 30.0
# Predictions for the slice-14 and slice-15 phases (yi-6b's and
# minitron-4b's at HD128_LAYERS), written before their first run on the
# card (PERF.md §6) and printed beside the readings:
# peak device memory in GB (the fleet, one member's prefill activations and
# logits, the slots' caches; or the training state) and each phase's wall
# seconds.
PREDICTED = {"yi-6b": {"peak_gb": (15, 17.5), "wall_s": (15, 40)},
             "minitron-4b": {"peak_gb": (19.5, 22), "wall_s": (15, 40)},
             "spec smoke": {"wall_s": (40, 120)},
             # granite at GRANITE_SERVE_LAYERS (slice 16): 7.05 GB of
             # weights, the MoE's prefill buffers, four 2048-slot caches
             "granite-moe-3b-a800m": {"peak_gb": (7.5, 10),
                                      "wall_s": (20, 45)},
             "internvl2-1b train": {"peak_gb": (30, 45),
                                    "wall_s": (20, 60)},
             "arch train": {"wall_s": (90, 240)},
             # slice 16, written before the phase's first run on the card
             # (PERF.md §6): leg (a) holds 4 (4, D) f32 tensors and the activations
             # of 2 x 1500 frames; leg (b) x, h, g_prev, two residuals and
             # the gradient buffer at 4.67 GB each
             "whisper (a)": {"peak_gb": (2.5, 8), "s_step": (0.1, 0.6)},
             "whisper (b)": {"peak_gb": (28, 40), "s_step": (0.8, 3.0)},
             # slice 17, written before leg (e)'s first run on the card
             # (PERF.md §6): (b)'s 25.720 GB less h, g_prev and both
             # residuals halved (4 x 2.33 GB) and with no f32 copies; a step
             # host-bound as (b)'s
             "whisper (e)": {"peak_gb": (14, 19), "s_step": (2.5, 5.0)},
             # slice 18, written before leg (f)'s first run on the card
             # (PERF.md §6): (b)'s 25.720 GB less its two f32 residuals
             # (2 x 4.67 GB), plus the check's 0.4 GB of windows; a step
             # host-bound as (b)'s (the 2 mixes ~8 ms of it)
             "whisper (f)": {"peak_gb": (15.5, 18.5), "s_step": (2.5, 4.5)},
             "whisper serve": {"prefill_tok_s": (5_000, 40_000),
                               "decode_tok_s": (800, 3_000)},
             "whisper": {"wall_s": (30, 90)},
             # slice 19, written before the phase's first run on the card
             # (PERF.md §6): the 65.38 GB fleet, one prefill's activations
             # and 1920 x 256,000 bf16 logits (~1 GB), four 2048-slot
             # caches; the draw, 254 decode steps of 4 slots at ~7 ms of
             # weights a slot, the re-serve and the profile
             "nemotron-4-340b": {"peak_gb": (66.5, 70), "wall_s": (20, 50)}}
# The serve CLI path: the port's launch/serve.py trains a qwen1.5-0.5b fleet
# at full width (2 MC-DSGT steps through gossip_mix) and serves it.
SERVE_CLI_STEPS = 2
SERVE_CLI_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes",
                  "4", "--algo", "mc_dsgt", "--gossip-impl", "pallas",
                  "--steps", str(SERVE_CLI_STEPS), "--requests", "8",
                  "--serve-batch", "4", "--prompt-len", "128", "--max-new",
                  "16", "--dtype", "bf16"]
# The paper's §6 on the dense host runtime: the twins of the reference's
# quickstart, Figure 2 and sampled-clients examples (examples/torch/), then
# MC-DSGT (R=2) on Figure 2's MNIST protocol (configs/logreg_paper.py) with
# compressed gossip and DSGT on its Dirichlet partition, S6_STEPS each.
# None of it reaches a kernel (the reference's logreg runtime reaches no
# Pallas kernel either).  The telemetry bytes of the compressed runs: 4
# rounds a step, all 16 nodes send, 784 entries and 4 group scales
# (tests/test_torch_logreg.py pins them on the CPU).
S6_STEPS = 20
# Figure 2's grid: dsgd and dsgt at 2 step sizes each, mc_dsgt at the
# distinct ones of {g, g R/2, g R}: 2 for MNIST (R=2), 3 for COVTYPE (R=4)
FIG2_RUNS = 13
S6_BYTES_TOTAL = {"int8": 1_024_000, "sign": 145_920}
S6_MANIFEST = "experiments/manifests/sampled_clients_100k.json"
# Gossip planning and the federated/local-update rules: the reference's
# federated run (repro/launch/train.py:24-25) at full width, FedAvg over
# the plan 2×empty+1×complete; MC-DSGT R=2 on ring (every plan round dense)
# through gossip_impl 'auto' with auto_dense 'pallas' and through 'pallas',
# PLAN_STEPS each, then 'sun' against 'auto' on the theorem-3 schedule,
# SUN_STEPS each (one full-width model shared); gt_local with adam on
# hierarchical pods of 2 (matching rounds and a complete round); the
# federated twin, logreg on hierarchical pods of 4 (two_level rounds), d2 on
# sun and personalized on random-sun on the host runtime.
FEDAVG_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "4",
               "--topology", "federated", "--local-steps", "2", "--algo",
               "local_sgd", "--gossip-impl", "auto", "--steps", "6"]
GT_ADAM_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes",
                "4", "--topology", "hierarchical", "--pods", "2", "--algo",
                "gt_local", "--local-opt", "adam", "--gossip-impl", "auto",
                "--steps", "4"]
HIER_ARGV = ["--arch", "logreg", "--topology", "hierarchical", "--nodes",
             "16", "--pods", "4", "--algo", "mc_dsgt", "--R", "2",
             "--gossip-impl", "auto", "--steps", "20", "--quiet"]
PLAN_STEPS = 3
SUN_STEPS = 2
# The wireless / async phase: qwen1.5-0.5b at full width, 4 nodes, on the
# realized waypoint-mobility schedule of examples/wireless_mobility.py
# (radius 0.45; 20% iid link drop, repaired), with the stale window
# (--delay 1) and the mixing cadence (--comm-interval 2).
WIRELESS_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes",
                 "4", "--topology", "waypoint-mobility", "--radius", "0.45",
                 "--link-drop", "0.2", "--delay", "1", "--device", "cuda"]
DELAYED_ARGV = WIRELESS_ARGV + ["--algo", "mc_dsgt", "--R", "2", "--steps",
                                str(STEPS)]
DSGD_DELAYED_ARGV = WIRELESS_ARGV + ["--algo", "dsgd", "--compress", "int8",
                                     "--steps", str(STEPS)]
INTERVAL_STEPS = 4
INTERVAL_ARGV = WIRELESS_ARGV + ["--algo", "mc_dsgt", "--R", "2",
                                 "--comm-interval", "2", "--gossip-impl",
                                 "pallas", "--steps", str(INTERVAL_STEPS)]
# The observability/checkpoint phase's checkpoint leg: the main path's
# model and rule on 2 nodes (beta 0.5, the sun schedule's limit at n = 2),
# so that one checkpoint (x, h, g_prev) is 11.1 GB instead of 22.3.
CKPT_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "full", "--nodes", "2",
             "--beta", "0.5", "--algo", "mc_dsgt", "--R", "2",
             "--gossip-impl", "pallas", "--device", "cuda"]
# Each quantized_gossip_mix launch of leg (b) is held to its plain version on
# three windows of this many columns (first, middle, last; group-aligned):
# the kernel quantizes and mixes each group of columns on its own.
QCHECK_COLS = GROUP * 4096
# The tracker mean under delay: h̄ = ḡ⁻ holds exactly in real arithmetic
# (the repaired matrices are symmetric, so doubly stochastic, and each
# stale correction Mix(s) − s is mean-free).  In f32 each rounding moves an
# entry by at most 2^-24 of its value, and with S the largest |h|, |g⁻| or
# |s| its column has held, one delayed step rounds values of at most 2S (h
# − g⁻), 3S (+ g), S (the kernel's 2 rounds of 4 products: 8 roundings),
# 4S (+ Mix(s)) and 5S (− s), 22 S in all; the f32 copy of W moves each
# column sum of a round by at most 4 · 2^-24 (8 S for the window), and the
# warm start's f32 mean adds ~2 S once.  So the node means may drift by
# TRACKER_ROUNDINGS · 2^-24 · S per step, per column.
TRACKER_ROUNDINGS = 32
# H100 SXM dense bf16 tensor-core peak and L2 size (NVIDIA data sheet): the
# attention kernels' operations are bf16 products on the main path, and
# their inputs (8-16 MB) would stay in L2 from one timed call to the next,
# where the serve path finds them cold.
BF16_FLOPS_PER_S = 989e12
L2_BYTES = 50e6
# flash_attention and decode_attention against their plain versions: f32
# sums in another order; bf16 as the JAX kernel tests allow (the plain
# versions round the scores q.k to bf16 before the f32 softmax, as the JAX
# oracles do, and the normalised p; the kernels keep the scores in f32 and
# round the unnormalised p; both round the output).  rtol = atol, except for
# bf16 at the serve path's shapes (Sk or C in the thousands), where most
# outputs average hundreds of keys and |o| is ~0.03-0.05, half of an atol of
# 2e-2: there atol is SERVE_ATOL_BF16[kernel], and acompare prints the
# smallest atol each such check would pass at.  A score rounded to bf16
# moves by up to ~2^-9 of |q.k| (~0.006 after the scale), so prefill rows
# with few effective keys differ by ~5e-3 at |o| ~0.01; decode rows, over
# 1000 keys or more, by ~1e-3.  PERF.md keeps the readings behind both.
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
SERVE_ATOL_BF16 = {"flash_attention": 1e-2, "decode_attention": 2e-3}


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def timed(fn, reps: int) -> float:
    """Mean device ms of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm-up call)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# gossip_mix's check: node counts across both walks (the warp walk, W^T
# resident, to 200; the block walk at 300, W^T in chunks of 64 rows and two
# TMA boxes a stage), each at two widths: about 1M columns up to 33 nodes
# and 100K past (every block's ring still wraps many times)
GOSSIP_CHECK_NODES = (4, 16, 32, 33, 64, 65, 128, 200, 300)


def check_kernel(torch, gossip_matmul, ref, gossip):
    """gossip_mix against its plain version over node counts 4 to 300 (both
    walks: GOSSIP_CHECK_NODES), R 1/2/4, both dtypes, a ragged D (odd: rows
    TMA cannot take, filled by copies) and a D divisible by 4 (TMA boxes),
    out of place and in place.  f32: rtol = atol = 1e-5 (sums of n products
    in another order, over the collapsed W); bf16: 1e-2 (one bf16 rounding
    of the output, 2^-8 relative, on values of order 1-4)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, walks = 0, set()

    def held(got, want, dtype):
        torch.cuda.synchronize()
        tol = TOL[str(dtype).split(".")[1]]
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)

    for n in GOSSIP_CHECK_NODES:
        for R in (1, 2, 4):
            ws = torch.from_numpy(gossip.theorem3_weight_schedule(
                n, 1 - 1 / n).stacked(0, R)).cuda()
            for D in ((1_000_003, 1_000_004) if n <= 33 else
                      (100_003, 100_004)):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(n, D, device="cuda",
                                    generator=gen).to(dtype)
                    want = ref.gossip_mix_ref(ws, x)
                    held(gossip_matmul.gossip_mix(ws, x), want, dtype)
                    gossip_matmul.gossip_mix(ws, x, out=x)  # in place
                    held(x, want, dtype)
                    g = gossip_matmul.launch_geometry(n, D, R,
                                                      x.element_size())
                    walks.add("warp" if g["wp"] else "block")
                    cases += 1
    if len(walks) != 2:
        fail(f"gossip_mix check reached the walks {sorted(walks)}")
    print(f"kernel check: gossip_mix == plain on {cases} cases "
          f"(n {'/'.join(map(str, GOSSIP_CHECK_NODES))}, R 1/2/4, D "
          f"1,000,003/1,000,004 to 33 nodes and 100,003/100,004 past, f32 "
          f"rtol=atol={TOL['float32']}, bf16 "
          f"rtol=atol={TOL['bfloat16']}, out of place and in place; walks "
          f"{sorted(walks)})", flush=True)


def print_gossip_resources(torch, gossip_matmul):
    """gossip_mix's launch_geometry and compiled resources at the shapes
    the smoke times and at n = 300 (the block walk, W^T in chunks)."""
    for n, D, R, dtype in ((MAIN["n"], MAIN["D"], 2, torch.float32),
                           (WHISPER_NODES, WHISPER_D, 2, torch.float32),
                           (WHISPER_NODES, WHISPER_D, 2, torch.bfloat16),
                           (GOSSIP_WIDE_NODES, GOSSIP_WIDE_D, 2,
                            torch.float32),
                           (300, 1_000_004, 2, torch.float32)):
        g = gossip_matmul.launch_geometry(n, D, R, dtype.itemsize)
        print(f"gossip_mix at n={n} D={D:,} R={R} "
              f"{str(dtype).split('.')[1]}: geometry {g}  resources "
              f"{gossip_matmul.resources(g, dtype)}", flush=True)


def check_rows(torch, got, want, what: str, tol: float = TOL["float32"]
               ) -> float:
    """``got`` against ``want`` at rtol = atol = ``tol`` (f32's by default),
    one row at a time (a whole-tensor comparison at the main shape would
    need several 7.4 GB temporaries); returns the largest absolute
    error."""
    torch.cuda.synchronize()
    err = 0.0
    for i in range(got.shape[0]):
        torch.testing.assert_close(got[i], want[i], rtol=tol, atol=tol,
                                   msg=lambda m: f"{what}, row {i}: {m}")
        err = max(err, float((got[i].float() - want[i].float()).abs().max()))
    return err


def time_kernel(torch, gossip_matmul, ref, gossip, n=MAIN["n"], D=MAIN["D"],
                label="main shape", dtype=None, rounds_=2) -> dict:
    """The kernel at a path's shape (the main path's by default; x f32
    unless ``dtype`` says otherwise), held to its plain version out of place
    and in place (the paths mix in place), then timed beside its bound, the
    plain version and torch.linalg.multi_dot (the library yardstick: one
    pass of the product W_{R-1} ... W_0, on W cast to x's dtype).  Its
    bound counts the function's least work: X read and out written once,
    and 2 n^2 D operations for the collapsed product plus 2 (R-1) n^3 to
    collapse W (chaining the R rounds would take R times the first).
    ``rounds`` timing rounds, alternating kernel, plain and multi_dot."""
    dtype = dtype or torch.float32
    dname = str(dtype).split(".")[1]
    R = MAIN["R"]
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(
        n, 0.75 if n == 4 else 1 - 1 / n).stacked(0, R)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(n, D, device="cuda", generator=gen).to(dtype)
    want = ref.gossip_mix_ref(ws, x)
    out = torch.empty_like(x)
    tol = TOL[dname]
    gossip_matmul.gossip_mix(ws, x, out=out)
    max_err = check_rows(torch, out, want, f"{label}, out of place", tol)
    x2 = x.clone()
    gossip_matmul.gossip_mix(ws, x2, out=x2)
    max_err = max(max_err, check_rows(torch, x2, want, f"{label}, in place",
                                      tol))
    del want, x2
    wl = ws.to(dtype)
    rounds = {"ms": [], "plain_ms": [], "library_ms": []}
    for _ in range(rounds_):  # alternate: a drift in clocks hits all three
        rounds["ms"].append(timed(
            lambda: gossip_matmul.gossip_mix(ws, x, out=out), 10))
        rounds["plain_ms"].append(timed(lambda: ref.gossip_mix_ref(ws, x), 3))
        rounds["library_ms"].append(timed(
            lambda: torch.linalg.multi_dot([*wl.flip(0), x]), 3))
    del x, out
    torch.cuda.empty_cache()
    # W once, X read, out written
    nbytes = R * n * n * 4 + 2 * n * D * dtype.itemsize
    flops = 2 * n * n * D + 2 * (R - 1) * n ** 3
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    geo = gossip_matmul.launch_geometry(n, D, R, dtype.itemsize)
    res = {k: min(v) for k, v in rounds.items()}
    res.update(max_abs_err=max_err, bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               shape=f"ws ({R},{n},{n}) f32, x ({n},{D}) {dname}",
               geometry=geo, resources=gossip_matmul.resources(geo, dtype))
    print(f"gossip_mix at {res['shape']}: == plain out of place and in place "
          f"({dname} rtol=atol={tol}, row by row)", flush=True)
    print(f"gossip_mix at {res['shape']} ({label}): kernel {res['ms']:.4f} "
          f"ms ({res['bound_ms'] / res['ms']:.1%} of its bound)  plain "
          f"{res['plain_ms']:.4f} ms  multi_dot {res['library_ms']:.4f} ms  "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_by']})  "
          f"max_abs_err {max_err:.3e}  walk {'warp' if geo['wp'] else 'block'}"
          f"  rounds {rounds}",
          flush=True)
    return res


def flips(got, want, rtol: float = 1e-5, atol: float = 1e-5) -> int:
    """Entries of ``got`` beyond rtol/atol of ``want`` (row by row)."""
    return sum(int(((g - w).abs() > atol + rtol * w.abs()).sum())
               for g, w in zip(got, want))


def qcompare(torch, what, x, res, got, want, R, scheme, group, ef):
    """The kernel's (x, res) result ``got`` against the plain version's
    ``want`` on the inputs ``x``, ``res`` (all (n, C), C a multiple of
    ``group``; each pair f32 or bf16).  Returns (entries beyond rtol = atol
    = 1e-5, or beyond rtol = BF16_RTOL for a bf16 result, largest absolute
    error), and fails unless every entry is bounded:

    * int8: each entry is within max(1, 2R - 3) quantization steps of its
      group (plus 1e-5, and one bf16 step, 2^-7 of it, where it is stored
      in bf16).  Round 1 is exact, a flip in a later round moves
      one entry by one step, and each round after it can carry that on and
      flip once more (two steps).  The step is bounded by (max|x| + R
      max|res|) / 127 over the group's columns of all nodes: mixing with a
      stochastic W takes convex combinations, and a round adds at most
      max|res| (EF off) or half a step (EF on) to |x + res|.
    * error feedback on: W is column-stochastic and deq + res = x + res in
      every round, so the node sum of each column of x + res is kept
      whatever flips; the kernel's is held to the input's at rtol = atol =
      1e-5 (float64 sums), plus, for results stored in bf16, the roundings
      of the stores (bf16's unit roundoff, 2^-8, of each stored
      |value|)."""
    n, C = x.shape
    tol = 1e-5
    xf, rf = x.float(), res.float()
    if scheme == "int8":
        def amax(t):
            return t.abs().view(n, C // group, group).amax(dim=(0, 2))
        steps = max(1, 2 * R - 3) * (amax(xf) + R * amax(rf)) / 127
        limit = steps.repeat_interleave(group) + tol
    bad, err = 0, 0.0
    rounding = 0.0
    for g, w, name in zip(got, want, ("x", "res")):
        bf16 = g.dtype == torch.bfloat16
        g, w = g.float(), w.float()
        d = (g - w).abs()
        rtol = BF16_RTOL if bf16 else tol
        bad += int((d > tol + rtol * w.abs()).sum())
        err = max(err, float(d.max()))
        if bf16:
            rounding = rounding + 2.0 ** -8 * g.double().abs().sum(0)
        if scheme == "int8":
            lim = limit + (BF16_RTOL * w.abs() if bf16 else 0.0)
            if bool((d > lim).any()):
                over = float((d / lim).max())
                fail(f"{what}: a {name} entry is off by {over:.3f} times "
                     "its bound of max(1, 2R - 3) int8 steps")
    if ef:
        kept = (got[0].double() + got[1].double()).sum(0)
        want_sum = (x.double() + res.double()).sum(0)
        slack = (kept - want_sum).abs() - tol - tol * want_sum.abs()
        if bool((slack > rounding).any()):
            fail(f"{what}: node sums of x + res not kept (worst excess "
                 f"{float((slack - rounding).max()):.3e})")
    return bad, err


def qcase(torch, quantized_gossip, ref, ws, x, res, kw, what) -> int:
    """One quantized_gossip_mix case against its plain version: R = 1 held
    tightly (int8's residual exactly: max, division, rint and the product
    are exact; the mixed x and sign's scale, a sum in another order, at
    rtol = atol = 1e-5); from R = 2 on up to MAX_FLIPS of the entries may
    flip; every case passes qcompare's bounds, and in place gives the same
    bits as out of place.  Returns the flipped entries (R >= 2; 0 for R =
    1)."""
    R = ws.shape[0]
    scheme, group, ef = kw["scheme"], kw["group"], kw["error_feedback"]
    o, r = quantized_gossip.quantized_gossip_mix(ws, x, res, **kw)
    wo, wr = ref.quantized_gossip_mix_ref(ws, x, res, **kw)
    torch.cuda.synchronize()
    bad, _ = qcompare(torch, what, x, res, (o, r), (wo, wr), R, scheme,
                      group, ef)
    if R == 1:
        if scheme == "int8" or not ef:
            if not torch.equal(r, wr):
                fail(f"{what}: residual not exact")
        else:
            torch.testing.assert_close(r, wr, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(o, wo, rtol=1e-5, atol=1e-5)
        bad = 0
    elif bad > MAX_FLIPS * 2 * o.numel():
        fail(f"{what}: {bad} entries beyond rtol=atol=1e-5")
    xi, ri = x.clone(), res.clone()
    quantized_gossip.quantized_gossip_mix(ws, xi, ri, out=xi, res_out=ri,
                                          **kw)
    torch.cuda.synchronize()
    if not (torch.equal(xi, o) and torch.equal(ri, r)):
        fail(f"{what}: in place differs from out of place")
    return bad


# The wide routes' cases (n, group, D): n past the regs route's 16 and
# groups that are not powers of two or wider than 256; D an odd number of
# groups, so a lone block's tile of several groups ends part empty.  The
# ring takes all but (64, 4096), which no cluster holds (the stream route).
QWIDE_CASES = ((17, 384, 384 * 1001), (32, 512, 512 * 601),
               (64, 384, 384 * 401), (16, 1024, 1024 * 301),
               (32, 1024, 1024 * 201), (64, 4096, 4096 * 51))
# Slice 17's inputs: past 64 nodes (the ring with W in shared memory at 65
# and 96, read from device memory at 128; two units a thread at (128, 512)
# and at (17, 3072), whose 96 column groups put a thread's units in other
# columns; the stream route at 200 nodes), at R 1 and 2.
QPAST64_CASES = ((65, 256, 256 * 1001), (96, 256, 256 * 501),
                 (128, 256, 256 * 401), (128, 512, 512 * 201),
                 (200, 4096, 4096 * 9), (17, 3072, 3072 * 81))
# bf16 x and/or res on each route: (n, group, D, route the shape takes)
QBF16_CASES = ((4, 256, 256 * 4001, "regs"), (16, 8, 8 * 30_001, "regs"),
               (32, 512, 512 * 601, "ring"), (17, 384, 384 * 1001, "ring"),
               (4, 3, 3 * 20_001, "ring"), (64, 4096, 4096 * 51, "stream"),
               (200, 4096, 4096 * 9, "stream"))
# int8 on the ring against the regs route, where both take the shape
QREGS_RING_CASES = ((16, 256, 256 * 4001), (4, 64, 64 * 16_001),
                    (8, 128, 128 * 8001))


def check_qkernel(torch, quantized_gossip, ref, gossip):
    """quantized_gossip_mix against its plain version (qcase) over both
    schemes, error feedback on and off, out of place and in place: on the
    regs route at R 1/2/4, n 4 and 16 (16 uses the one-column path, 4 the
    16-byte one), group 256 and 8, a D whose last block is partial; on the
    ring and stream routes at R 1/2 over QWIDE_CASES (n 17, 32, 64; group
    384, 512, 1024, 4096) and QPAST64_CASES (n 65 to 200), each case's
    route as launch_geometry names it."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases, worst, routes = 0, 0.0, {}
    shapes = [(n, R, group, D) for n in (4, 16) for R in (1, 2, 4)
              for group, D in ((GROUP, 1_000_192), (8, 1_000_008))]
    shapes += [(n, R, group, D) for n, group, D in QWIDE_CASES + QPAST64_CASES
               for R in (1, 2)]
    for n, R, group, D in shapes:
        ws = torch.from_numpy(gossip.theorem3_weight_schedule(
            n, 1 - 1 / n).stacked(0, R)).cuda()
        route = quantized_gossip.launch_geometry(n, group, D, R)["route"]
        routes.setdefault(route, set()).add((n, group))
        x = torch.randn(n, D, device="cuda", generator=gen)
        res = 0.1 * torch.randn(n, D, device="cuda", generator=gen)
        for scheme in ("sign", "int8"):
            for ef in (True, False):
                kw = dict(scheme=scheme, group=group, error_feedback=ef)
                what = (f"n={n} R={R} group={group} {scheme} ef={ef} "
                        f"({route})")
                bad = qcase(torch, quantized_gossip, ref, ws, x, res, kw,
                            what)
                if R > 1:
                    worst = max(worst, bad / (2 * x.numel()))
                cases += 1
        del x, res
    if set(routes) != {"regs", "ring", "stream"}:
        fail(f"quantized_gossip_mix check reached the routes {routes}")
    print(f"kernel check: quantized_gossip_mix == plain on {cases} cases "
          f"(sign/int8, EF on/off; regs route n 4/16, R 1/2/4, group "
          f"{GROUP}/8, D 1,000,192/1,000,008; routes {routes} at R 1/2; R=1 "
          f"rtol=atol=1e-5, int8 residual exact; R>=2 flipped entries at most "
          f"{MAX_FLIPS:.0e}, worst {worst:.2e}, int8 each within "
          f"max(1, 2R-3) steps; EF on: node sums of x + res kept at "
          f"rtol=atol=1e-5; in place == out of place bit for bit)",
          flush=True)


def check_qkernel_inputs(torch, quantized_gossip, ref, gossip):
    """Slice 17's bit-for-bit checks of quantized_gossip_mix: bf16 x and/or
    res on every route (QBF16_CASES; R 2, both schemes, EF on and off) give
    the f32 launch's bits on upcast copies, cast back, in place as out of
    place; int8 on the ring (launched by name) gives the regs route's bits
    (QREGS_RING_CASES, R 1 and 2, EF on and off), and so does the stream
    route; a rerun of each gives the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf, f32 = torch.bfloat16, torch.float32
    cases = 0
    for n, group, D, route in QBF16_CASES:
        R = 2
        ws = torch.from_numpy(gossip.theorem3_weight_schedule(
            n, 1 - 1 / n).stacked(0, R)).cuda()
        x0 = torch.randn(n, D, device="cuda", generator=gen)
        r0 = 0.1 * torch.randn(n, D, device="cuda", generator=gen)
        for xdt, rdt in ((bf, bf), (f32, bf), (bf, f32)):
            x, res = x0.to(xdt), r0.to(rdt)
            got = quantized_gossip.launch_geometry(
                n, group, D, R, x.element_size(), res.element_size())
            if got["route"] != route:
                fail(f"bf16 check: ({n}, {group}) took {got['route']}, not "
                     f"{route}")
            for scheme in ("sign", "int8"):
                for ef in (True, False):
                    kw = dict(scheme=scheme, group=group, error_feedback=ef)
                    what = (f"bf16 check n={n} group={group} {xdt}/{rdt} "
                            f"{scheme} ef={ef} ({route})")
                    o, r = quantized_gossip.quantized_gossip_mix(ws, x, res,
                                                                 **kw)
                    o32, r32 = quantized_gossip.quantized_gossip_mix(
                        ws, x.float(), res.float(), **kw)
                    xi, ri = x.clone(), res.clone()
                    quantized_gossip.quantized_gossip_mix(
                        ws, xi, ri, out=xi, res_out=ri, **kw)
                    o2, r2 = quantized_gossip.quantized_gossip_mix(ws, x, res,
                                                                   **kw)
                    torch.cuda.synchronize()
                    if not (torch.equal(o, o32.to(xdt))
                            and torch.equal(r, r32.to(rdt))):
                        fail(f"{what}: not the f32 launch's bits on upcast "
                             "copies")
                    if not (torch.equal(xi, o) and torch.equal(ri, r)):
                        fail(f"{what}: in place differs from out of place")
                    if not (torch.equal(o2, o) and torch.equal(r2, r)):
                        fail(f"{what}: a rerun gave other bits")
                    cases += 1
        del x0, r0, x, res
    for n, group, D in QREGS_RING_CASES:
        for R in (1, 2):
            ws = torch.from_numpy(gossip.theorem3_weight_schedule(
                n, 1 - 1 / n).stacked(0, R)).cuda()
            x = torch.randn(n, D, device="cuda", generator=gen)
            res = 0.1 * torch.randn(n, D, device="cuda", generator=gen)
            for ef in (True, False):
                kw = dict(scheme="int8", group=group, error_feedback=ef)
                outs = {route: quantized_gossip._launch_route(
                    ws, x, res, route, **kw)
                    for route in ("regs", "ring", "stream")}
                torch.cuda.synchronize()
                for route in ("ring", "stream"):
                    if not all(torch.equal(a_, b_) for a_, b_ in
                               zip(outs[route], outs["regs"])):
                        fail(f"int8 n={n} group={group} R={R} ef={ef}: the "
                             f"{route} route differs from the regs route")
                cases += 1
    print(f"kernel check: quantized_gossip_mix bit for bit on {cases} cases: "
          f"bf16 x and/or res == the f32 launch on upcast copies, cast back, "
          f"on every route ({[(c[0], c[1], c[3]) for c in QBF16_CASES]}; "
          f"in place and reruns equal); int8 ring == stream == regs at "
          f"{QREGS_RING_CASES} (R 1/2, EF on/off)", flush=True)


def time_qkernel(torch, quantized_gossip, ref, gossip, n=MAIN["n"],
                 D=MAIN["D"], group=GROUP, label="main shape", route=None,
                 dtypes=("float32", "float32")) -> dict:
    """quantized_gossip_mix at a path's shape (int8, error feedback, R = 2;
    the main path's by default: n = 4, group 256, the regs route; ``route``
    launches that route instead of launch_geometry's pick; ``dtypes`` those
    of x and res).  Held to its plain version column chunk by column chunk
    (the plain version is column-separable at group granularity, and whole
    it would hold ~6 more (n, D) temporaries) with qcompare's bounds
    and at most MAIN_MAX_FLIPS flipped entries (bf16 results: MAX_FLIPS at
    rtol BF16_RTOL), and bf16 launches bit for bit to the f32 launch on
    upcast copies, cast back.  Then in place against out of
    place, and timed beside its bound (each input read and each output
    written once, in its dtype) and the plain version (no single PyTorch
    call computes this function, so there is no library time)."""
    R = MAIN["R"]
    xdt, rdt = (getattr(torch, d) for d in dtypes)
    kw = dict(scheme="int8", group=group, error_feedback=True)

    def mix(*args, **k):
        if route is None:
            return quantized_gossip.quantized_gossip_mix(*args, **kw, **k)
        return quantized_gossip._launch_route(*args, route, **kw, **k)
    ws = torch.from_numpy(gossip.theorem3_weight_schedule(
        n, 0.75 if n == 4 else 1 - 1 / n).stacked(0, R)).cuda()
    ex, er = (torch.finfo(t).bits // 8 for t in (xdt, rdt))
    geo = quantized_gossip._geometry(n, group, D, R, ex, er, route)
    gen = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn(n, D, device="cuda", generator=gen).to(xdt)
    res = (0.1 * torch.randn(n, D, device="cuda", generator=gen)).to(rdt)
    out, res_out = mix(ws, x, res)
    torch.cuda.synchronize()
    bad, err = 0, 0.0
    chunk = group * (GROUP * 65_536 * MAIN["n"] // (group * n))
    for a in range(0, D, chunk):
        cols = slice(a, a + chunk)
        want = ref.quantized_gossip_mix_ref(ws, x[:, cols], res[:, cols],
                                            **kw)
        b, e = qcompare(torch, f"{label}, columns {a}+", x[:, cols],
                        res[:, cols], (out[:, cols], res_out[:, cols]),
                        want, R, kw["scheme"], group, kw["error_feedback"])
        bad, err = bad + b, max(err, e)
    del want
    limit = MAIN_MAX_FLIPS if xdt == rdt == torch.float32 else MAX_FLIPS
    if bad > limit * 2 * n * D:
        fail(f"quantized_gossip_mix at the {label}: {bad} flipped entries")
    held = (f"== plain up to {bad} flipped of {2 * n * D} entries (limit "
            f"{limit:.0e}; bf16 results at rtol {BF16_RTOL}), each within "
            f"one int8 step of its group, max_abs_err {err:.3e}; node sums "
            "of x + res kept")
    if xdt != torch.float32 or rdt != torch.float32:
        o32, r32 = mix(ws, x.float(), res.float())
        for i in range(n):
            if not (torch.equal(out[i], o32[i].to(xdt))
                    and torch.equal(res_out[i], r32[i].to(rdt))):
                fail(f"quantized_gossip_mix at the {label}: row {i} of the "
                     f"{dtypes} launch differs from the f32 launch on "
                     "upcast copies, cast back")
        del o32, r32
        held += "; == the f32 launch on upcast copies, cast back, bit for bit"
    xi, ri = x.clone(), res.clone()
    mix(ws, xi, ri, out=xi, res_out=ri)
    torch.cuda.synchronize()
    if not (torch.equal(xi, out) and torch.equal(ri, res_out)):
        fail(f"quantized_gossip_mix at the {label}: in place differs from "
             "out of place")
    del xi, ri, out, res_out
    torch.cuda.empty_cache()
    rounds = {"ms": [], "plain_ms": []}
    for _ in range(2):   # alternate, so a drift in clocks hits both
        rounds["ms"].append(timed(
            lambda: mix(ws, x, res, out=x, res_out=res), 10))
        rounds["plain_ms"].append(timed(
            lambda: ref.quantized_gossip_mix_ref(ws, x, res, **kw), 3))
    del x, res
    torch.cuda.empty_cache()
    # x and res each read once and written once in their dtypes, W once;
    # per column and round 2n^2 flops of mixing and ~8n of quantization
    # (add, abs, reduce, divide, round, clip, multiply, subtract)
    nbytes = R * n * n * 4 + 2 * n * D * (ex + er)
    flops = 2 * R * n * n * D + 8 * R * n * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    res_ = {k: min(v) for k, v in rounds.items()}
    names = {"float32": "f32", "bfloat16": "bf16"}
    res_.update(max_abs_err=err, flipped=bad, library_ms=None,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                shape=f"ws ({R},{n},{n}) f32, x ({n},{D}) {names[dtypes[0]]}"
                      f", res {names[dtypes[1]]}, int8, group {group}, EF on",
                route=geo["route"],
                geometry={k: geo[k] for k in (
                    "units", "cluster", "cols", "stages", "w_smem",
                    "slab", "npad", "threads", "smem") if k in geo})
    if geo["route"] != "regs":
        res_["resources"] = quantized_gossip.resources(geo, "int8")
    print(f"quantized_gossip_mix at {res_['shape']} ({label}): {held}; in "
          f"place == out of place; route {res_['route']} {res_['geometry']} "
          f"{res_.get('resources', '')}", flush=True)
    print(f"quantized_gossip_mix at {res_['shape']} ({label}): kernel "
          f"{res_['ms']:.4f} ms  plain {res_['plain_ms']:.4f} ms  library "
          f"none  bound {res_['bound_ms']:.4f} ms ({res_['bound_by']})  "
          f"rounds {rounds}", flush=True)
    return res_


def check_small_run(torch, exp):
    """A reduced run on the card two ways: the fused kernel path against
    the dense path (one plain matmul per round).  Same init, same data."""
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "run.steps": 2, "run.nodes": 4, "algorithm.R": 2})
    fused = exp.run(exp.with_field(spec, "run.gossip_impl", "pallas"),
                    device="cuda", quiet=True)
    dense = exp.run(exp.with_field(spec, "run.gossip_impl", "dense"),
                    device="cuda", quiet=True)
    lf = [h["loss"] for h in fused.history]
    ld = [h["loss"] for h in dense.history]
    if not all(math.isfinite(v) for v in lf):
        fail(f"reduced run losses not finite: {lf}")
    torch.testing.assert_close(torch.tensor(lf), torch.tensor(ld),
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fused.state.x, dense.state.x, rtol=1e-4,
                               atol=1e-5)
    print(f"reduced run on the card: pallas losses {lf} == dense {ld}",
          flush=True)


def check_small_compressed_run(torch, exp):
    """A reduced compressed run on the card, both schemes: the fused
    kernel path against the dense compressed path (quantize, then one
    plain matmul per round).  Same init, same data; the states may differ
    by flipped quantizations (MAX_FLIPS), the losses at rtol 1e-4."""
    for scheme in ("sign", "int8"):
        spec = exp.with_overrides(exp.ExperimentSpec(), {
            "run.steps": 2, "run.nodes": 4, "algorithm.R": 2,
            "compression.scheme": scheme})
        fused = exp.run(exp.with_field(spec, "run.gossip_impl", "pallas"),
                        device="cuda", quiet=True)
        dense = exp.run(exp.with_field(spec, "run.gossip_impl", "dense"),
                        device="cuda", quiet=True)
        lf = [h["loss"] for h in fused.history]
        ld = [h["loss"] for h in dense.history]
        if not all(math.isfinite(v) for v in lf):
            fail(f"reduced {scheme} run losses not finite: {lf}")
        torch.testing.assert_close(torch.tensor(lf), torch.tensor(ld),
                                   rtol=1e-4, atol=1e-5)
        bad = sum(flips(a, b, rtol=1e-4) for a, b in (
            (fused.state.x, dense.state.x),
            (fused.state.res[0], dense.state.res[0]),
            (fused.state.res[1], dense.state.res[1])))
        if bad > MAX_FLIPS * 3 * fused.state.x.numel():
            fail(f"reduced {scheme} run: {bad} state entries beyond "
                 "rtol=1e-4 atol=1e-5")
        print(f"reduced {scheme} run on the card: pallas losses {lf} == "
              f"dense {ld}; x, res_x, res_h agree up to {bad} flipped "
              "entries", flush=True)


def profile_step(torch, exp, steps, scheme: str = "none"):
    """Where one full-width MC-DSGT step's device time goes: torch.profiler
    over one step after a warm-up step; device time summed by kernel.
    ``scheme`` 'int8' profiles the compressed step."""
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "model.preset": "full", "run.nodes": 4, "algorithm.R": 2,
        "run.gossip_impl": "pallas", "compression.scheme": scheme})
    built = exp.build(spec, device="cuda")
    init, warm, step = steps.make_train_step(
        built.model, built.cfg, algo="mc_dsgt", gamma=spec.algorithm.gamma,
        R=2, gossip_impl="pallas", compression=built.rule.compression)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = warm(init(built.model.init(gen, torch.float32, "cuda"), 4),
                 built.stream.batch_at(0))
    W = torch.from_numpy(built.schedule.stacked(0, built.wps)).cuda()
    state, _ = step(state, built.stream.batch_at(1), W)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        state, out = step(state, built.stream.batch_at(2), W)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    del state, out
    torch.cuda.empty_cache()
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    mix = sum(ms for k, ms, _ in kernels if "gossip_mix" in k)
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    print(f"profile of one step (compression {scheme}): wall {wall_ms:.3f} ms"
          f"  device busy {busy:.3f} ms (idle share {1 - busy / wall_ms:.4f})"
          f"  mix kernels {mix:.3f} ms  top kernels (ms, calls): "
          + "; ".join(f"{k[:60]} {ms:.3f} x{c}" for k, ms, c in top),
          flush=True)


def scompare(torch, what, got, want):
    """delta of the kernel against the plain version at rtol = atol =
    STOL; returns the largest absolute error."""
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=STOL, atol=STOL,
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def round_weights(torch, seg, S, gen):
    """Edge weights as a gossip round has them: nonnegative, each segment's
    (receiver's) sum below 1, like Metropolis weights."""
    w = torch.rand(seg.numel(), device=seg.device, generator=gen)
    sums = torch.zeros(S + 1, device=seg.device).index_add_(0, seg, w)
    return w / (sums[seg] + torch.rand((), device=seg.device,
                                       generator=gen) + 0.01)


def launch_counted(torch, sparse_gossip, x, layout, variant: str, what: str):
    """sparse_segment_mix(x, *layout), failing unless it launched the
    ``variant`` kernel once (and unless launch_geometry chose it)."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    S = layout.offsets.numel() - 1
    geo = sparse_gossip.launch_geometry(layout.rows.numel(), x.shape[1], S,
                                        x.dtype, sms)
    counts = sparse_gossip.sparse_segment_mix.variants
    before = dict(counts)
    got = sparse_gossip.sparse_segment_mix(x, *layout)
    ran = [k for k in counts if counts[k] != before[k]]
    if geo["variant"] != variant or ran != [variant] or \
            counts[variant] != before[variant] + 1:
        fail(f"sparse_segment_mix {what}: expected one {variant} launch, "
             f"geometry {geo}, launched {ran}")
    return got


def check_skernel(torch, sparse_gossip, ref, ops):
    """sparse_segment_mix against its plain version over E 0/1/511/513/27,000
    edges, D 1/7/128/784/1000 (odd widths take the one-column copies), S
    1/7/256 segments, f32 and bf16 x, with repeated src, dst and seg (drawn
    from small ranges) and padded edges (seg = S: in no segment); a rerun
    gives the same bits.  With src drawn from 3,000 nodes, the rounds of
    27,000 edges touch more rows than the staged variant takes in f32 and
    run the gather variant; the rest run the staged one.  Then rounds of
    exactly max_staged_rows - 1, max_staged_rows and max_staged_rows + 1
    distinct rows, f32 and bf16: staged, staged, gather.  Weights are a
    gossip round's: w >= 0 with each segment's sum in (0, 1).  Then whole
    padded rounds, laid out as the plan stages them (pad edges w = 0, src =
    dst = seg = 0; pad slots = n), through ops.sparse_gossip_mix's kernel
    and plain routes."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    n, cases, err = 3000, 0, 0.0
    ran = {"staged": 0, "gather": 0}
    for E in (0, 1, 511, 513, 27_000):
        for D in (1, 7, 128, 784, 1000):
            for S in (1, 7, 256):
                for dtype in (torch.float32, torch.bfloat16):
                    x = torch.randn(n, D, device="cuda", generator=gen
                                    ).to(dtype)
                    src = torch.randint(0, n, (E,), device="cuda",
                                        generator=gen)
                    dst = torch.randint(0, 64, (E,), device="cuda",
                                        generator=gen)
                    seg = torch.randint(0, S + 1, (E,), device="cuda",
                                        generator=gen)   # S = padding
                    w = round_weights(torch, seg, S, gen)
                    keep = seg < S
                    want = ref.sparse_gossip_mix_ref(
                        seg[keep], w[keep], x[src[keep]], x[dst[keep]], S)
                    layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
                    variant = sparse_gossip.launch_geometry(
                        layout.rows.numel(), D, S, dtype, sms)["variant"]
                    what = f"E={E} D={D} S={S} {dtype}"
                    got = launch_counted(torch, sparse_gossip, x, layout,
                                         variant, what)
                    err = max(err, scompare(torch, what, got, want))
                    if not torch.equal(
                            got, sparse_gossip.sparse_segment_mix(x, *layout)):
                        fail(f"sparse_segment_mix {what}: a rerun differs")
                    ran[variant] += 1
                    cases += 1
    if not all(ran.values()):
        fail(f"sparse_segment_mix case grid left a variant out: {ran}")
    n_lim = 4000
    for dtype in (torch.float32, torch.bfloat16):
        lim = sparse_gossip.max_staged_rows(dtype)
        for U, variant in ((lim - 1, "staged"), (lim, "staged"),
                           (lim + 1, "gather")):
            E, S, D = 2 * U + 1000, 256, 784
            ids = torch.randperm(n_lim, device="cuda", generator=gen)[:U]
            pick = torch.randint(0, U, (2, E), device="cuda", generator=gen)
            pick[0, :U] = torch.arange(U, device="cuda")  # every id a sender
            src, dst = ids[pick[0]], ids[pick[1]]
            seg = torch.randint(0, S, (E,), device="cuda", generator=gen)
            w = round_weights(torch, seg, S, gen)
            x = torch.randn(n_lim, D, device="cuda", generator=gen).to(dtype)
            layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
            what = f"U={U} (limit {lim}) {dtype}"
            if layout.rows.numel() != U:
                fail(f"sparse_segment_mix {what}: layout has "
                     f"{layout.rows.numel()} rows")
            got = launch_counted(torch, sparse_gossip, x, layout, variant,
                                 what)
            want = ref.sparse_gossip_mix_ref(seg, w, x[src], x[dst], S)
            err = max(err, scompare(torch, what, got, want))
            if not torch.equal(got,
                               sparse_gossip.sparse_segment_mix(x, *layout)):
                fail(f"sparse_segment_mix {what}: a rerun differs")
            cases += 1
    for S_real, E_real, D in ((1, 1, 784), (200, 20_000, 784), (7, 0, 5)):
        smax, emax = 256, 27_000
        x = torch.randn(n, D, device="cuda", generator=gen)
        src = torch.zeros(emax, dtype=torch.int64, device="cuda")
        dst, seg = src.clone(), src.clone()
        w = torch.zeros(emax, device="cuda")
        slots = torch.full((smax,), n, dtype=torch.int64, device="cuda")
        slots[:S_real] = torch.randperm(n, device="cuda", generator=gen
                                        )[:S_real].sort().values
        seg[:E_real] = torch.randint(0, S_real, (E_real,), device="cuda",
                                     generator=gen)
        src[:E_real] = torch.randint(0, n, (E_real,), device="cuda",
                                     generator=gen)
        dst[:E_real] = slots[seg[:E_real]]
        w[:E_real] = round_weights(torch, seg[:E_real], S_real, gen)
        args = (src, dst, w, seg, slots)
        got = ops.sparse_gossip_mix(x.clone(), *args, use_pallas=True)
        want = ops.sparse_gossip_mix(x.clone(), *args, use_pallas=False)
        err = max(err, scompare(torch, f"padded round S={S_real} "
                                f"E={E_real} D={D}", got, want))
        cases += 1
    print(f"kernel check: sparse_segment_mix == plain on {cases} cases (E "
          f"0/1/511/513/27,000, D 1/7/128/784/1000, S 1/7/256, f32 and bf16, "
          f"repeated ids, padded edges: {ran['staged']} staged, "
          f"{ran['gather']} gather; U = max_staged_rows - 1, + 0, + 1 in f32 "
          f"({sparse_gossip.max_staged_rows(torch.float32)}) and bf16 "
          f"({sparse_gossip.max_staged_rows(torch.bfloat16)}): staged, "
          f"staged, gather; 3 padded rounds through ops.sparse_gossip_mix, "
          f"pad slots = n; rtol=atol={STOL}; reruns bit-equal) max_abs_err "
          f"{err:.3e}", flush=True)


def round_arrays(torch, plan, tensors, r):
    """Round ``r`` of a staged edge plan cut to its realized edges and
    receivers, int64 indices on the card: (src, dst, w, seg, S)."""
    import numpy as np
    e = int(plan.edges_per_round[r])
    S = int(np.unique(plan.round(r).dst).size)
    return (tensors["esrc"][r, :e].long(), tensors["edst"][r, :e].long(),
            tensors["ew"][r, :e], tensors["seg"][r, :e].long(), S)


def round_csr(torch, src, dst, w, seg, S, n):
    """One round as an (S, n) CSR matrix, +w at (seg, src) and -w at (seg,
    dst): torch.sparse.mm of it with x is the round's delta."""
    idx = torch.stack([torch.cat([seg, seg]), torch.cat([src, dst])])
    return torch.sparse_coo_tensor(idx, torch.cat([w, -w]), (S, n),
                                   check_invariants=False
                                   ).coalesce().to_sparse_csr()


def time_skernel(torch, sparse_gossip, ref, driver, plan, x, rounds) -> dict:
    """sparse_segment_mix at the main path's shape: each of the ``rounds``
    rounds path A ran, on its final state ``x`` (100,000 x 784 f32), laid
    out as the mixer lays it out, must take the staged variant, equal the
    plain version at rtol = atol = STOL and give the same bits on a rerun.
    The times come from ``examples/torch/sparse_compare.py`` on this
    checkout, run in a process of its own on the same rounds (their edge
    counts must agree): per round, device time under torch.profiler
    (``device_ms``, 20 calls each) of the kernel and of torch.sparse.mm on
    the round's (S, n) CSR matrix in turns, kernel, library, library,
    kernel; the plain version's device time (gathers + index_add_); the
    wrapper's host µs per call.  Late in this process the profiler leaves
    out the records of a session's first launches, at times all of them
    (PERF.md §7); a fresh process has lost none.  The bound counts this
    round's data: the distinct rows of x read, delta written, the edge
    arrays; and 3·E·D f32 operations."""
    tensors = driver.stage_plan(plan, device="cuda")
    n, D = x.shape
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    err, err_lib, t_b, t_o = 0.0, 0.0, 0.0, 0.0
    edges, longest, walks, urows, bound = [], [], [], [], []
    for r in rounds:
        src, dst, w, seg, S = round_arrays(torch, plan, tensors, r)
        layout = sparse_gossip.segment_layout(src, dst, w, seg, S)
        U = layout.rows.numel()
        geo = sparse_gossip.launch_geometry(U, D, S, x.dtype, sms)
        what = f"main shape, round {r}"
        got = launch_counted(torch, sparse_gossip, x, layout, "staged", what)
        want = ref.sparse_gossip_mix_ref(seg, w, x[src], x[dst], S)
        err = max(err, scompare(torch, what, got, want))
        if not torch.equal(got, sparse_gossip.sparse_segment_mix(x, *layout)):
            fail(f"sparse_segment_mix {what}: a rerun differs")
        A = round_csr(torch, src, dst, w, seg, S, n)
        err_lib = max(err_lib,
                      float((torch.sparse.mm(A, x) - want).abs().max()))
        E = src.numel()
        nbytes = U * D * 4 + S * D * 4 + E * (8 + 8 + 4) + (S + 1) * 8
        tb, to = nbytes / HBM_BYTES_PER_S, 3 * E * D / FP32_FLOPS_PER_S
        bound.append(max(tb, to) * 1e3)
        t_b, t_o = t_b + tb, t_o + to
        edges.append(E)
        urows.append(U)
        longest.append(int(layout.offsets.diff().max()))
        walks.append(int(ref.staged_warp_edges_ref(
            layout.offsets, geo["grid"][1] * sparse_gossip.WARPS).max()))
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples/torch/sparse_compare.py"),
         "--src", str(ROOT / "src"), "--rounds", str(len(edges))],
        capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        fail(f"sparse_compare.py exited {out.returncode}: "
             f"{out.stderr[-2000:]}")
    timing = json.loads(out.stdout.strip().splitlines()[-1])
    if timing["edges"] != edges:
        fail(f"sparse_compare.py timed rounds of {timing['edges']} edges, "
             f"path A mixed {edges}")
    res = {k: timing[k] for k in ("ms", "plain_ms", "library_ms", "host_us")}
    res.update(bound_ms=sum(bound) / len(bound), max_abs_err=err,
               bound_by="bytes" if t_b >= t_o else "operations",
               variant="staged", geometry=geo,
               resources=sparse_gossip.resources("staged", x.dtype,
                                                 geo["vec"], U),
               shape=f"x ({n},{D}) f32, {len(edges)} rounds of "
                     f"{min(edges)}-{max(edges)} edges (mean "
                     f"{sum(edges) / len(edges):.0f}), {min(urows)}-"
                     f"{max(urows)} distinct rows")
    print(f"sparse_segment_mix at {res['shape']}: staged on every round "
          f"(last geometry {geo}; resources {res['resources']}), == plain "
          f"(rtol=atol={STOL}), max_abs_err {err:.3e}, reruns bit-equal; "
          f"torch.sparse.mm max |diff| {err_lib:.3e}", flush=True)
    print(f"sparse_segment_mix per round (mean of {len(edges)}), device ms "
          f"under torch.profiler in a fresh process (sparse_compare.py): "
          f"kernel {res['ms']:.6f}  plain {res['plain_ms']:.6f}  "
          f"torch.sparse.mm {res['library_ms']:.6f}  bound "
          f"{res['bound_ms']:.6f} ({res['bound_by']}); wrapper host "
          f"{res['host_us']:.2f} us per call; per round kernel "
          f"{[round(v, 6) for v in timing['per_round_ms']]} library "
          f"{[round(v, 6) for v in timing['per_round_library_ms']]}; edges "
          f"of the longest segment {longest}; edges of the longest warp "
          f"walk {walks}; launches the profiler did not record, per timing "
          f"{timing['lost']}; sessions that recorded none and were run "
          f"again {timing['empty_sessions']}", flush=True)
    return res


def sampled_paths(torch, train, exp, alg, driver, sparse, counters):
    """Slice 3's main path twice on one built scenario.  A: the train CLI's
    spec through exp.run (the scatter mixer, the JAX package's route): 5
    finite steps and evals, 0 sparse_segment_mix launches.  B: the same
    Result.built through run_algorithm with a plan whose mixer asks for the
    kernel: 4 launches per step, evals equal to A's within rtol 1e-4.  The
    oracle's generator is reseeded with run.seed for B, so both draw the
    same minibatch indices in the same order."""
    import numpy as np
    spec = train.spec_from_args(train.build_parser().parse_args(SAMPLED_ARGV))
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = exp.run(spec, device="cuda", quiet=True)
    wall = time.perf_counter() - t0
    launches_a = {k: c.launches for k, c in counters.items()}
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    built, tl = res.built, res.telemetry.history
    evals = [v for _, v in res.history]
    if len(tl) != SAMPLED_STEPS or len(evals) != SAMPLED_STEPS or not all(
            math.isfinite(v) for v in evals + [h["consensus"] for h in tl]):
        fail(f"sampled path A not {SAMPLED_STEPS} finite steps: {tl} "
             f"{res.history}")
    if not bool(res.state.x.isfinite().all()):
        fail("sampled path A: state not finite")
    if any(launches_a.values()):
        fail(f"sampled path A (scatter mixer) launched kernels: {launches_a}")
    t0 = time.perf_counter()
    driver.stage_plan(built.plan, device="cuda")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    real = built.realized
    print(f"sampled path A: {' '.join(SAMPLED_ARGV)}", flush=True)
    print(f"sampled path A: host staging s: schedule (realize + faults) "
          f"{built.seconds['schedule']:.3f}  plan {built.seconds['plan']:.3f}"
          f"  stage to card {stage_s:.3f}  dataset "
          f"{built.seconds['data']:.3f}; run {wall:.3f} s in all", flush=True)
    print(f"sampled path A: step s {[h['sec'] for h in tl]}  grad_norm2 "
          f"{evals}  consensus {[h['consensus'] for h in tl]}  spectral gap "
          f"{[h['spectral_gap'] for h in tl]}  edges/round "
          f"{real['edges_per_round']}  senders/round "
          f"{real['senders_per_round']}  period {real['period']}  peak device "
          f"memory {peak_a:.3f} GB  launches {launches_a}", flush=True)

    class KernelPlan(sparse.SparseGossipPlan):
        """The built plan; its mixer asks for the segment-sum kernel."""

        def make_mixer(self, **kw):
            return super().make_mixer(**kw, use_pallas=True)

    plan = KernelPlan(**{f.name: getattr(built.plan, f.name)
                         for f in dataclasses.fields(built.plan)})
    rec = sparse.SparseTelemetryRecorder(built.schedule, wps=built.wps)
    gen = torch.Generator(device="cuda").manual_seed(spec.run.seed)
    variants = counters["sparse_segment_mix"].variants
    for c in counters.values():
        c.launches = 0
    variants.update(staged=0, gather=0)
    torch.cuda.reset_peak_memory_stats()
    state_b, hist_b = driver.run_algorithm(
        alg.from_rule(built.rule), built.x0, built.grad_fn, built.schedule,
        spec.run.steps, gen, eval_fn=built.eval_fn,
        eval_every=spec.run.eval_every, gossip_impl="auto", plan=plan,
        telemetry=rec)
    launches_b = {k: c.launches for k, c in counters.items()}
    peak_b = torch.cuda.max_memory_allocated() / 1e9
    evals_b = [v for _, v in hist_b]
    if launches_b["sparse_segment_mix"] != 4 * SAMPLED_STEPS or sum(
            launches_b.values()) != launches_b["sparse_segment_mix"]:
        fail(f"sampled path B launched {launches_b} over {SAMPLED_STEPS} "
             "MC-DSGT steps; its 4 rounds per step need 4 sparse_segment_mix")
    if variants != {"staged": 4 * SAMPLED_STEPS, "gather": 0}:
        fail(f"sampled path B: sparse_segment_mix variants {variants}; every "
             "round must take the staged one")
    if not all(math.isfinite(v) for v in evals_b):
        fail(f"sampled path B evals not finite: {evals_b}")
    torch.testing.assert_close(torch.tensor(evals_b), torch.tensor(evals),
                               rtol=1e-4, atol=0.0)
    print(f"sampled path B (sparse_segment_mix): step s "
          f"{[h['sec'] for h in rec.history]}  grad_norm2 {evals_b} == path "
          f"A's at rtol 1e-4 (generator reseeded with run.seed, same draws)"
          f"  consensus {[h['consensus'] for h in rec.history]}  peak device "
          f"memory {peak_b:.3f} GB  launches {launches_b}, by variant "
          f"{variants}", flush=True)
    del state_b
    profile_sampled(torch, alg, driver, built, plan, spec)
    rounds = range(built.wps * SAMPLED_STEPS)   # the rounds the runs mixed
    return res, plan, rounds, {"launches": launches_b["sparse_segment_mix"],
                               "peak_gb": peak_b}


def profile_sampled(torch, alg, driver, built, plan, spec):
    """Where path B's device time goes: torch.profiler over a whole run
    (warm start, 5 steps, an eval and the telemetry's host work after
    each), device time summed by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(spec.run.seed)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        driver.run_algorithm(
            alg.from_rule(built.rule), built.x0, built.grad_fn,
            built.schedule, spec.run.steps, gen, eval_fn=built.eval_fn,
            gossip_impl="auto", plan=plan)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    print(f"profile of sampled path B ({spec.run.steps} steps, warm start "
          f"and evals): wall {wall_ms:.3f} ms  device busy {busy:.3f} ms "
          f"(idle share {1 - busy / wall_ms:.4f})  kernels "
          f"{sum(c for _, _, c in kernels)}  top kernels (ms, calls): "
          + "; ".join(f"{k[:60]} {ms:.3f} x{c}" for k, ms, c in top),
          flush=True)


def lequal(torch, what, got, want) -> float:
    """The kernel's (h_all, h_last) bit-equal to the plain version's;
    returns the largest absolute difference (0.0)."""
    torch.cuda.synchronize()
    err = 0.0
    for g, w, name in zip(got, want, ("h_all", "h_last")):
        err = max(err, float((g - w).abs().max())) if g.numel() else err
        if not torch.equal(g, w):
            fail(f"linear_recurrence {what}: {name} differs from the plain "
                 f"version by up to {err:.3e}")
    return err


# (B, S, C, dtype, offset) beyond check_lkernel's grid: recurrentgemma's C
# and ragged neighbours (2564 takes TMA in f32 and cp.async in bf16, 4099
# cp.async in f32 and the loop in bf16) and falcon's at a short S; the ring's
# tails at C = 2560 (S 1, 63 and 65 about one 64-step tile, 3968 the serve
# prompt: 62 tiles through an 8-stage ring); B = 3; views offset by one
# element (not 16-byte aligned: cp.async in f32, the loop in bf16 and at
# falcon's width)
LKERNEL_CASES = (
    [(1, 70, C, dt, 0) for C in (2560, 2564, 4099, 131_072)
     for dt in ("float32", "bfloat16")]
    + [(1, S, 2560, dt, 0) for S in (1, 63, 65, 3968)
       for dt in ("float32", "bfloat16")]
    + [(3, 130, 2560, dt, 0) for dt in ("float32", "bfloat16")]
    + [(B, S, C, dt, 1) for B, S, C in ((3, 65, 2560), (1, 70, 131_072))
       for dt in ("float32", "bfloat16")])


def check_lkernel(torch, linear_recurrence, ref):
    """linear_recurrence against its plain version over S 1/7/128/300 (7
    and 300 leave a tail after the loop's 8-step load batches and the
    ring's 64-step tiles), C 1/5/512/4099 (bf16 at an odd C takes the
    loop), B 1/3, f32 and bf16 inputs, a in (0, 1) as
    mamba's exp(dt·A) is, then the LKERNEL_CASES: bit-equal, and a rerun
    gives the same bits.  Fails unless the cases reach all three routes
    (the TMA ring, the cp.async ring, the loop)."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    cases = [(B, S, C, dt, 0) for B in (1, 3) for S in (1, 7, 128, 300)
             for C in (1, 5, 512, 4099) for dt in ("float32", "bfloat16")]
    routes = {}
    for B, S, C, dt, off in cases + LKERNEL_CASES:
        dtype = getattr(torch, dt)
        n = B * S * C + off
        a = torch.rand(n, device="cuda", generator=gen).to(dtype)[off:]
        b = torch.randn(n, device="cuda", generator=gen).to(dtype)[off:]
        a, b = a.view(B, S, C), b.view(B, S, C)
        geo = linear_recurrence.geometry_for(a, b)
        got = linear_recurrence.linear_recurrence(a, b)
        what = (f"B={B} S={S} C={C} {dt}{' offset view' if off else ''} "
                f"({geo['route']}, cb {geo['cb']}, {geo['stages']} stages)")
        lequal(torch, what, got, ref.linear_recurrence_ref(a, b))
        lequal(torch, what + " rerun",
               linear_recurrence.linear_recurrence(a, b), got)
        routes[geo["route"]] = routes.get(geo["route"], 0) + 1
    if set(routes) != {"tma", "cp.async", "loop"}:
        fail(f"linear_recurrence check reached the routes {routes}, not all "
             "three")
    print(f"kernel check: linear_recurrence bit-equal to plain on "
          f"{len(cases)} cases (B 1/3, S 1/7/128/300, C 1/5/512/4099, f32 "
          f"and bf16, a in (0, 1)) and {len(LKERNEL_CASES)} more (C "
          f"2560/2564/4099/131072, S 1/63/65/3968, B 3, offset views); "
          f"reruns bit-equal; cases per route {routes}", flush=True)


def time_lkernel(torch, linear_recurrence, ref, shape=LINREC_MAIN,
                 what: str = "one falcon-mamba prefill") -> dict:
    """linear_recurrence at ``shape`` (B, S, C) f32 (one falcon-mamba
    prefill's (1, 2048, 131072), or one recurrentgemma rglru layer's (1,
    3968, 2560)): its route, geometry and compiled resources printed,
    bit-equal to the plain version and on a rerun, then timed beside its
    bound and the plain version.  No single PyTorch call
    computes a linear recurrence, so there is no library time."""
    B, S, C = shape
    gen = torch.Generator(device="cuda").manual_seed(7)
    a = torch.rand(B, S, C, device="cuda", generator=gen)
    b = torch.randn(B, S, C, device="cuda", generator=gen)
    geometry = linear_recurrence.geometry_for(a, b)
    resources = linear_recurrence.resources(geometry, a.dtype)
    if resources["dynamic_smem"] != geometry["smem"] \
            or resources["threads"] != geometry["block"]:
        fail(f"linear_recurrence at {shape}: the wrapper's geometry "
             f"{geometry} and the compiled kernel's launch {resources} "
             "disagree")
    print(f"linear_recurrence f32 at {shape} ({what}): route "
          f"{geometry['route']}, geometry {geometry}, compiled {resources}",
          flush=True)
    got = linear_recurrence.linear_recurrence(a, b)
    err = lequal(torch, f"at {what}'s shape", got,
                 ref.linear_recurrence_ref(a, b))
    lequal(torch, f"at {what}'s shape, rerun",
           linear_recurrence.linear_recurrence(a, b), got)
    del got
    torch.cuda.empty_cache()
    rounds = {"ms": [], "plain_ms": []}
    for _ in range(2):   # alternate, so a drift in clocks hits both
        rounds["ms"].append(timed(
            lambda: linear_recurrence.linear_recurrence(a, b), 20))
        rounds["plain_ms"].append(timed(
            lambda: ref.linear_recurrence_ref(a, b), 3))
    del a, b
    torch.cuda.empty_cache()
    # a and b read once, h_all and h_last written once; a multiply and an
    # add per element
    nbytes = 3 * B * S * C * 4 + B * C * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * B * S * C / FP32_FLOPS_PER_S
    res = {k: min(v) for k, v in rounds.items()}
    res.update(max_abs_err=err, library_ms=None,
               bound_ms=max(t_bytes, t_ops) * 1e3,
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               shape=f"a, b ({B},{S},{C}) f32 -> h_all f32, h_last ({B},{C})",
               variant=geometry["route"], geometry=geometry,
               resources=resources)
    print(f"linear_recurrence at {res['shape']}: bit-equal to plain, rerun "
          "bit-equal", flush=True)
    print(f"linear_recurrence at {res['shape']}: kernel {res['ms']:.4f} ms  "
          f"plain {res['plain_ms']:.4f} ms  library none  bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})  rounds {rounds}",
          flush=True)
    return res


def device_ms(torch, fn, reps: int, sessions: int = 3) -> float:
    """Mean device ms of ``fn`` per call: the time of the CUDA kernels it
    runs under torch.profiler over ``reps`` calls after a warm-up call.
    Unlike ``timed`` it leaves out the gaps while the host issues the next
    launch, which are longer than a decode step's kernel.

    Per kernel, its mean recorded launch times its launches a call (its
    recorded count over ``reps``, rounded up), summed over the kernels: a
    launch the profiler did not record does not lower the time.
    ``device_ms.lost`` keeps how many launches were not recorded, and
    ``device_ms.lost_total`` their sum over the process.  A session that
    recorded no kernel at all is run again, up to ``sessions`` in all
    (``device_ms.empty_sessions`` counts them over the process); if every
    one is empty the run fails."""
    import torch.profiler as tp
    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with tp.profile(activities=[tp.ProfilerActivity.CPU,
                                    tp.ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.count > 0]
        if events:
            break
        device_ms.empty_sessions += 1
    else:
        fail(f"device_ms: the profiler recorded no kernel in {reps} calls, "
             f"in each of {sessions} sessions")
    us, lost = 0.0, 0
    for e in events:
        per_call = -(-e.count // reps)
        us += e.self_device_time_total / e.count * per_call
        lost += per_call * reps - e.count
    device_ms.lost = lost
    device_ms.lost_total += lost
    return us / 1e3


device_ms.lost_total = 0
device_ms.empty_sessions = 0


def acompare(torch, what, got, want, serve: str = "") -> float:
    """An attention kernel's output against its plain version's at rtol =
    atol = ATOL[dtype]; for bf16 at a serve shape of the kernel named
    ``serve``, atol SERVE_ATOL_BF16[serve].  Returns the largest absolute
    error."""
    torch.cuda.synchronize()
    rtol = ATOL[str(got.dtype).split(".")[1]]
    bf16_serve = bool(serve) and got.dtype == torch.bfloat16
    atol = SERVE_ATOL_BF16[serve] if bf16_serve else rtol
    diff = (got.float() - want.float()).abs()
    if bf16_serve:
        need = float((diff - rtol * want.float().abs()).max())
        print(f"{what}: bf16 at rtol {rtol}: smallest atol that passes "
              f"{need:.3e} (held at {atol})", flush=True)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return float(diff.max())


FLASH_CASES = [
    # (B, Sq, Sk, H, KV, hd, causal, window)
    (1, 16, 16, 4, 4, 64, True, 0),          # the reduced model's prompt
    (2, 128, 128, 6, 3, 64, True, 0),        # G = 2, ragged head count
    (1, 256, 256, 8, 1, 128, True, 64),      # G = 8, window
    (2, 384, 384, 4, 2, 32, True, 0),        # hd 32
    (1, 128, 128, 2, 2, 128, False, 0),      # bidirectional
    (1, 512, 512, 4, 4, 64, True, 200),      # window off the 64-key tiles
    (1, 256, 128, 2, 1, 64, True, 64),       # rows with no valid key
    (1, 128, 256, 2, 2, 64, True, 0),        # Sk > Sq
    (1, 1920, 1920, 16, 16, 64, True, 0),    # the serve path's prefill
    (1, 128, 128, 10, 1, 256, True, 48),     # hd 256, G = 10 (MQA)
    (2, 384, 384, 4, 2, 256, True, 100),     # hd 256, window off the tiles
    (1, 256, 128, 2, 1, 256, True, 64),      # hd 256, rows with no valid key
    (1, 3968, 3968, 10, 1, 256, True, 2048),  # recurrentgemma's prefill
    (1, 128, 128, 12, 1, 192, True, 0),      # hd 192, G = 12 (nemotron's)
    (2, 384, 384, 24, 2, 192, True, 100),    # hd 192, window off the tiles
    (1, 256, 128, 12, 1, 192, True, 64),     # hd 192, rows with no valid key
    (1, 128, 256, 24, 2, 192, False, 0),     # hd 192, Sk > Sq, bidirectional
]
DECODE_CASES = [
    # (B, C, J, G, hd, window, filled, pos)
    (2, 256, 2, 2, 64, 0, 256, 255),         # full cache
    (1, 512, 1, 8, 64, 0, 300, 299),         # kpos -1 tail, G = 8
    (2, 256, 2, 4, 128, 128, 256, 400),      # ring wrapped, window
    (1, 128, 4, 1, 32, 0, 128, 127),         # hd 32
    (1, 128, 2, 2, 64, 0, 0, 5),             # empty cache: every slot masked
    (1, 256, 2, 16, 128, 0, 256, 255),       # G = 16, the most it takes
    (3, 2048, 16, 1, 64, 1000, 2048, 2047),  # window, B = 3
    (1, 2048, 16, 1, 64, 0, 1921, 1920),     # the serve path's first decode
    (1, 2048, 16, 1, 64, 0, 200, 199),       # 8 splits, 7 with no valid slot
    (1, 2048, 1, 10, 256, 2048, 2048, 4000),  # recurrentgemma: ring wrapped
    (1, 2048, 1, 10, 256, 2048, 200, 199),   # hd 256, splits with no slot
    (1, 256, 1, 16, 256, 0, 256, 255),       # hd 256, G = 16
    (2, 512, 2, 10, 256, 300, 512, 700),     # hd 256, B 2, ring, window
    (1, 256, 1, 10, 256, 0, 0, 5),           # hd 256, empty cache
    (1, 256, 2, 12, 192, 0, 256, 255),       # hd 192, G = 12 (nemotron's)
    (1, 2048, 8, 12, 192, 0, 1921, 1920),    # nemotron's first decode
    (2, 512, 2, 12, 192, 300, 512, 700),     # hd 192, B 2, ring, window
    (1, 256, 1, 12, 192, 0, 0, 5),           # hd 192, empty cache
    (1, 256, 2, 20, 64, 0, 256, 255),        # G = 20: two row groups
    (1, 512, 1, 33, 64, 128, 512, 700),      # G = 33, ring, window
    (1, 256, 2, 20, 192, 0, 200, 199),       # hd 192, G = 20, kpos -1 tail
    (1, 2048, 1, 33, 192, 0, 2048, 2047),    # hd 192, G = 33, 8 splits
]


def ring_kpos(torch, C, filled, pos, window):
    """tests/test_kernels.py:164-168: the ring's absolute positions once it
    has wrapped, else 0 .. filled - 1 and -1 for the empty tail."""
    c = torch.arange(C, device="cuda")
    if window and pos >= C:
        base = pos - C + 1
        return ((c - base % C) % C + base).int()
    return torch.where(c < filled, c, -1).int()


def check_fkernel(torch, flash_attention, ref) -> dict:
    """flash_attention against its plain version over FLASH_CASES in f32 and
    bf16 (G 1/2/8/10/12, hd 32/64/128/192/256, window on and off, causal and
    not, rows with no valid key, Sk > Sq, the serve paths' prefills); a
    rerun gives the same bits.  Returns the largest absolute error by
    dtype."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    err = {}
    for B, Sq, Sk, H, KV, hd, causal, window in FLASH_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen
                            ).to(dtype)
            k = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen
                            ).to(dtype)
            v = torch.randn(B, Sk, KV, hd, device="cuda", generator=gen
                            ).to(dtype)
            kw = dict(causal=causal, window=window)
            got = flash_attention.flash_attention(q, k, v, **kw)
            what = (f"flash_attention B={B} Sq={Sq} Sk={Sk} H={H} KV={KV} "
                    f"hd={hd} {kw} {dtype}")
            e = acompare(torch, what, got, ref.attention_ref(q, k, v, **kw),
                         serve="flash_attention" if Sk >= FLASH_MAIN[1]
                         else "")
            name = str(dtype).split(".")[1]
            err[name] = max(err.get(name, 0.0), e)
            if not torch.equal(got, flash_attention.flash_attention(q, k, v,
                                                                    **kw)):
                fail(f"{what}: a rerun differs")
    print(f"kernel check: flash_attention == plain on {2 * len(FLASH_CASES)} "
          f"cases (G 1/2/8/10/12, hd 32/64/128/192/256, window "
          f"0/48/64/100/200/2048, "
          f"causal and not, rows with no valid key, Sk > Sq, (1, 1920, 16, "
          f"64), (1, 3968, 10 over 1, 256); f32 and bf16 at rtol=atol {ATOL}, "
          f"bf16 atol {SERVE_ATOL_BF16['flash_attention']} at Sk >= 1920; "
          f"reruns bit-equal) max_abs_err {err}",
          flush=True)
    return err


def check_dkernel(torch, decode_attention, ref) -> dict:
    """decode_attention against its plain version over DECODE_CASES in f32
    and bf16 (G 1/2/4/8/10/12/16/20/33, hd 32/64/128/192/256, window on and
    off, a ring that has wrapped, a kpos -1 tail, an empty cache, the serve
    paths' first decodes, a cache whose later splits hold no valid slot); a
    rerun gives the same bits, and at G > 16 each row group's rows are the
    bits of the same rows launched alone.  Returns the largest absolute
    error by dtype."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    err = {}
    for B, C, J, G, hd, window, filled, pos in DECODE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, 1, J, G, hd, device="cuda", generator=gen
                            ).to(dtype)
            k = torch.randn(B, C, J, hd, device="cuda", generator=gen
                            ).to(dtype)
            v = torch.randn(B, C, J, hd, device="cuda", generator=gen
                            ).to(dtype)
            kpos = ring_kpos(torch, C, filled, pos, window)
            got = decode_attention.decode_attention(q, k, v, kpos, pos,
                                                    window=window)
            what = (f"decode_attention B={B} C={C} J={J} G={G} hd={hd} "
                    f"window={window} filled={filled} pos={pos} {dtype}")
            e = acompare(torch, what, got, ref.decode_attention_ref(
                q, k, v, kpos, pos, window=window),
                         serve="decode_attention" if C >= DECODE_MAIN[1]
                         else "")
            name = str(dtype).split(".")[1]
            err[name] = max(err.get(name, 0.0), e)
            if not torch.equal(got, decode_attention.decode_attention(
                    q, k, v, kpos, pos, window=window)):
                fail(f"{what}: a rerun differs")
            step = decode_attention.ROW_GROUP
            for g0 in range(0, G, step) if G > step else ():
                g1 = min(G, g0 + step)
                alone = decode_attention.decode_attention(
                    q[:, :, :, g0:g1], k, v, kpos, pos, window=window)
                if not torch.equal(got.view(B, 1, J, G, hd)[:, :, :, g0:g1],
                                   alone.view(B, 1, J, g1 - g0, hd)):
                    fail(f"{what}: rows {g0}..{g1 - 1} differ from the same "
                         "rows launched alone")
    print(f"kernel check: decode_attention == plain on "
          f"{2 * len(DECODE_CASES)} cases (G 1/2/4/8/10/12/16/20/33, hd "
          f"32/64/128/192/256, window 0/128/300/1000/2048, rings wrapped, "
          f"kpos -1 tail, empty cache, splits with no valid slot, C = 2048; "
          f"f32 and bf16 at rtol=atol {ATOL}, bf16 atol "
          f"{SERVE_ATOL_BF16['decode_attention']} at C = 2048; reruns "
          f"bit-equal; at G > 16 every row group bit-equal to its rows "
          f"launched alone) max_abs_err {err}", flush=True)
    return err


def print_attention_resources(torch, flash_attention, decode_attention):
    """What each attention kernel compiled to (registers, spilled bytes,
    static and dynamic shared memory, from cudaFuncGetAttributes) and how it
    launches at the main paths' shapes (grid, block, cluster, and decode's
    route): qwen1.5's hd 64, recurrentgemma's hd 256, yi-6b's and
    minitron-4b's hd 128, nemotron-4-340b's hd 192, and decode at G = 48
    (three row groups)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for B, S, H, _, hd in (FLASH_MAIN, FLASH_RG, FLASH_YI, FLASH_MT,
                           FLASH_NM):
        for dtype in (torch.bfloat16, torch.float32):
            print(f"flash_attention {str(dtype).split('.')[1]} hd {hd}: "
                  f"{flash_attention.resources(hd, dtype)} at "
                  f"{(B, S, H, hd)}: "
                  f"{flash_attention.launch_geometry(B, S, H, hd, dtype)}",
                  flush=True)
    for B, C, J, G, hd in (DECODE_MAIN, DECODE_RG, DECODE_YI, DECODE_MT,
                           DECODE_NM, DECODE_G48):
        for dtype in (torch.bfloat16, torch.float32):
            geometry = decode_attention.launch_geometry(B, J, C, hd, dtype,
                                                        sms, G)
            print(f"decode_attention {str(dtype).split('.')[1]} hd {hd}: "
                  f"{decode_attention.resources(hd, dtype)} at "
                  f"{(B, C, J, G, hd)}: {geometry}", flush=True)


def host_us(torch, fn, n: int = 1000) -> float:
    """Host microseconds per call of ``fn`` (a kernel wrapper) over ``n``
    calls, time.perf_counter around the calls; the device drains after the
    clock stops.  Timed where the kernel is shorter than a call's host work,
    so that the launch queue never fills and blocks the host."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def cold_copies(tensors: tuple, n_calls: int) -> list:
    """Copies of ``tensors`` that, used one after another, cover more than
    twice the L2 cache, so that each of ``n_calls`` timed calls reads its
    inputs from device memory."""
    nbytes = sum(t.nbytes for t in tensors)
    n = max(2, math.ceil(2 * L2_BYTES / nbytes))
    sets = [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(n - 1)]
    return [sets[i % n] for i in range(n_calls + 1)]   # + the warm-up call


def device_ms_cold(torch, fn, tensors: tuple, reps: int) -> float:
    """device_ms of ``fn(*inputs)``, each call on the next of cold_copies,
    round and round (a session device_ms runs again takes reps more)."""
    inputs = itertools.cycle(cold_copies(tensors, reps))
    return device_ms(torch, lambda: fn(*next(inputs)), reps)


def attention_bound(nbytes: int, flops: int) -> dict:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def window_pairs(S: int, window: int) -> int:
    """Unmasked (query, key) pairs of one head of causal attention over S
    positions, within ``window`` keys when it is set: sum of min(i + 1, w)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def time_fkernel(torch, flash_attention, ref, shape=FLASH_MAIN,
                 window: int = 0,
                 what: str = "one qwen prefill layer") -> dict:
    """flash_attention at ``shape`` (B, S, H, KV, hd) bf16, causal (qwen's
    (1, 1920, 16, 16, 64), yi-6b's (1, 1920, 32, 4, 128), minitron-4b's (1,
    1920, 24, 8, 128), nemotron-4-340b's (1, 1920, 96, 8, 192), or
    recurrentgemma's (1, 3968, 10, 1, 256) with a
    2048-key window): held to its plain version, then timed (device time,
    inputs cold in L2 as on the serve path) beside its bound, the plain
    version and torch's scaled_dot_product_attention (causal, or with the
    window's boolean mask, on (B, H, S, hd) copies made outside the timed
    region; a yardstick only, never on the path).  The bound counts the
    unmasked (query, key) pairs a head needs (``window_pairs``), 2 products
    of 2·hd flops each at the bf16 tensor-core rate, and q, k, v read and o
    written once."""
    import torch.nn.functional as F
    B, S, H, KV, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(10)
    q = torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(B, S, KV, hd, device="cuda", generator=gen
                        ).bfloat16() for _ in range(2))
    kw = dict(window=window)
    want = ref.attention_ref(q, k, v, **kw)
    err = acompare(torch, f"flash_attention at {what}'s shape",
                   flash_attention.flash_attention(q, k, v, **kw), want,
                   serve="flash_attention")
    qkv_t = tuple(t.transpose(1, 2).contiguous() for t in (q, k, v))
    i = torch.arange(S, device="cuda")
    mask = ((i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
            if window else None)

    def sdpa(qt, kt, vt):
        if mask is None:
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                  enable_gqa=H != KV)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=H != KV)
    err_lib = float((sdpa(*qkv_t).transpose(1, 2).float() - want.float())
                    .abs().max())

    def kernel(q_, k_, v_):
        return flash_attention.flash_attention(q_, k_, v_, **kw)

    def plain(q_, k_, v_):
        return ref.attention_ref(q_, k_, v_, **kw)
    rounds = {"ms": [], "plain_ms": [], "library_ms": [], "warm_ms": []}
    for _ in range(2):   # alternate, so a drift in clocks hits all of them
        rounds["ms"].append(device_ms_cold(torch, kernel, (q, k, v), 20))
        rounds["plain_ms"].append(device_ms_cold(torch, plain, (q, k, v), 5))
        rounds["library_ms"].append(device_ms_cold(torch, sdpa, qkv_t, 20))
        rounds["warm_ms"].append(device_ms(torch, lambda: kernel(q, k, v),
                                           20))
    small = tuple(t[:, :128] for t in (q, k, v))
    host = host_us(torch, lambda: kernel(*small))
    del q, k, v, qkv_t, want, small, mask
    torch.cuda.empty_cache()
    res = {k_: min(v_) for k_, v_ in rounds.items()}
    res.update(attention_bound(2 * B * S * (H + KV) * hd * 2,
                               4 * B * H * hd * window_pairs(S, window)))
    res.update(max_abs_err=err, wrapper_host_us=host,
               shape=f"q ({B},{S},{H},{hd}), k, v ({B},{S},{KV},{hd}) bf16, "
                     f"causal" + (f", window {window}" if window else ""))
    print(f"flash_attention at {res['shape']}: == plain (rtol "
          f"{ATOL['bfloat16']}, atol "
          f"{SERVE_ATOL_BF16['flash_attention']}), max_abs_err {err:.3e}; "
          f"scaled_dot_product_attention max |diff| {err_lib:.3e}",
          flush=True)
    print(f"flash_attention at {res['shape']}: kernel {res['ms']:.4f} ms "
          f"(L2 warm {res['warm_ms']:.4f})  plain {res['plain_ms']:.4f} ms  "
          f"scaled_dot_product_attention {res['library_ms']:.4f} ms  bound "
          f"{res['bound_ms']:.4f} ms ({res['bound_by']})  rounds {rounds}",
          flush=True)
    print(f"flash_attention wrapper: {host:.2f} host us per call (1000 "
          f"calls at ({B},128,{H},{hd}) bf16)", flush=True)
    return res


def time_dkernel(torch, decode_attention, ref, shape=DECODE_MAIN,
                 window: int = 0, what: str = "one qwen decode layer"
                 ) -> dict:
    """decode_attention at ``shape`` (B, C, J, G, hd) bf16 against a full
    cache (qwen's q (1, 1, 16, 1, 64), yi-6b's (1, 1, 4, 8, 128),
    minitron-4b's (1, 1, 8, 3, 128), nemotron-4-340b's (1, 1, 8, 12, 192)
    or G = 48's (1, 1, 2, 48, 192) and a 2048-slot cache at pos 2047; or
    recurrentgemma's q (1, 1, 1, 10, 256) and a 2048-slot ring, wrapped, at
    pos 4000 with a 2048-token window): held to its plain version, then
    timed (device time, the cache cold in L2 as on the serve path, where
    the layer's weights pass through L2 between two reads of it) beside its
    bound, the plain version and torch's scaled_dot_product_attention with
    a boolean mask from kpos (a yardstick only, never on the path).  The
    bound counts every slot (all valid): k and v read once, 4·G·hd flops
    per slot and head."""
    import torch.nn.functional as F
    B, C, J, G, hd = shape
    gen = torch.Generator(device="cuda").manual_seed(11)
    q = torch.randn(B, 1, J, G, hd, device="cuda", generator=gen).bfloat16()
    k, v = (torch.randn(B, C, J, hd, device="cuda", generator=gen).bfloat16()
            for _ in range(2))
    pos = 4000 if window else C - 1
    kpos = ring_kpos(torch, C, C, pos, window)
    want = ref.decode_attention_ref(q, k, v, kpos, pos, window=window)
    err = acompare(torch, f"decode_attention at {what}'s shape",
                   decode_attention.decode_attention(q, k, v, kpos, pos,
                                                     window=window), want,
                   serve="decode_attention")
    qt = q.reshape(B, J * G, 1, hd)
    kv_t = tuple(t.transpose(1, 2).contiguous() for t in (k, v))
    valid = (kpos >= 0) & (kpos <= pos)
    if window:
        valid &= kpos > pos - window
    if int(valid.sum()) != C:
        fail(f"decode_attention timing at {shape}: {int(valid.sum())} of {C} "
             "slots valid; the bound counts all")
    mask = valid[None, None, None, :]

    def sdpa(kt, vt):
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=G > 1)
    err_lib = float((sdpa(*kv_t).reshape(want.shape).float() - want.float())
                    .abs().max())

    def kernel(k_, v_):
        return decode_attention.decode_attention(q, k_, v_, kpos, pos,
                                                 window=window)

    def plain(k_, v_):
        return ref.decode_attention_ref(q, k_, v_, kpos, pos, window=window)
    rounds = {"ms": [], "plain_ms": [], "library_ms": [], "warm_ms": []}
    for _ in range(2):   # alternate, so a drift in clocks hits all of them
        rounds["ms"].append(device_ms_cold(torch, kernel, (k, v), 100))
        rounds["plain_ms"].append(device_ms_cold(torch, plain, (k, v), 50))
        rounds["library_ms"].append(device_ms_cold(torch, sdpa, kv_t, 100))
        rounds["warm_ms"].append(device_ms(torch, lambda: kernel(k, v), 100))
    host = host_us(torch, lambda: kernel(k, v))
    del q, k, v, kv_t, want
    torch.cuda.empty_cache()
    res = {k_: min(v_) for k_, v_ in rounds.items()}
    res.update(attention_bound(2 * B * C * J * hd * 2 + 2 * B * J * G * hd * 2
                               + C * 4, 4 * B * J * G * C * hd))
    res.update(max_abs_err=err, wrapper_host_us=host,
               shape=f"q ({B},1,{J},{G},{hd}), k, v ({B},{C},{J},{hd}) bf16, "
                     + (f"ring wrapped at pos {pos}, window {window}, "
                        if window else "") + "every slot valid")
    print(f"decode_attention at {res['shape']}: == plain (rtol "
          f"{ATOL['bfloat16']}, atol "
          f"{SERVE_ATOL_BF16['decode_attention']}), max_abs_err {err:.3e}; "
          f"scaled_dot_product_attention max |diff| {err_lib:.3e}",
          flush=True)
    print(f"decode_attention at {res['shape']}: kernel {res['ms']:.5f} ms "
          f"(L2 warm {res['warm_ms']:.5f})  plain {res['plain_ms']:.5f} ms  "
          f"scaled_dot_product_attention {res['library_ms']:.5f} ms  bound "
          f"{res['bound_ms']:.5f} ms ({res['bound_by']})  rounds {rounds}",
          flush=True)
    print(f"decode_attention wrapper: {host:.2f} host us per call (1000 "
          f"calls at {what}'s shape)", flush=True)
    return res


def draw_fleet(torch, models, configs, tree, arch: str, n_params: int,
               members: int, layers: int = 0):
    """``arch`` with use_pallas on (and ``layers`` layers when given), and a
    fleet of ``members`` drawn from seeds 0, 1, ... layer by layer straight
    into one bf16 tensor per leaf with a leading fleet axis (mamba's A_log
    f32, as the init makes it)."""
    cfg = dataclasses.replace(configs.get(arch), use_pallas=True)
    if layers:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = models.build(cfg)
    t0 = time.perf_counter()
    fleet = model.empty(torch.bfloat16, "cuda", lead=(members,))
    for i in range(members):
        model.init(torch.Generator(device="cuda").manual_seed(i),
                   torch.bfloat16, "cuda",
                   out=tree.map(lambda t: t[i], fleet))
    torch.cuda.synchronize()
    count = sum(t[0].numel() for _, t in tree.items(fleet))
    if count != n_params:
        fail(f"{arch} has {count} parameters, not {n_params}")
    gb = sum(t.nbytes for _, t in tree.items(fleet)) / 1e9
    print(f"{arch} fleet: {members} x {count} parameters, {gb:.3f} GB on the "
          f"card, drawn in {time.perf_counter() - t0:.2f} s", flush=True)
    return model, fleet


def serve_path(torch, exp, serve, ops, linear_recurrence, ref, model, fleet,
               counters) -> dict:
    """Slice 4's main path: serve_fleet over the falcon-mamba fleet with
    every kernel's count from 0.  It must complete 8 requests of 32 tokens
    with 64 linear_recurrence launches per prefill and no other kernel.  The
    (a, b) the first prefill feeds its first layer's kernel are kept (the
    tensors themselves, 2.1 GB at the full size, held through the run) and
    the kernel is held bit-equal to its plain version on them afterwards."""
    spec = exp.ServeSpec(**SERVE)
    captured = []
    real = ops.linear_recurrence

    def capture(a, b, **kw):
        if not captured:
            captured.append((a, b))
        return real(a, b, **kw)

    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ops.linear_recurrence = capture
    try:
        res = serve.serve_fleet(model, fleet, spec)
    finally:
        ops.linear_recurrence = real
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = model.cfg.num_layers * SERVE["requests"]
    if launches["linear_recurrence"] != want or sum(launches.values()) != want:
        fail(f"serve path launched {launches}; {SERVE['requests']} prefills "
             f"of {model.cfg.num_layers} mamba layers need {want} "
             "linear_recurrence and nothing else")
    done = res.completed
    vocab = model.cfg.vocab_size
    if [c["rid"] for c in done] != list(range(SERVE["requests"])) or any(
            len(c["tokens"]) != SERVE["max_new"]
            or not all(0 <= t < vocab for t in c["tokens"]) for c in done):
        fail(f"serve path did not complete {SERVE['requests']} requests of "
             f"{SERVE['max_new']} tokens: {done}")
    a, b = captured[0]
    held_gb = (a.nbytes + b.nbytes) / 1e9
    route = linear_recurrence.geometry_for(a, b)["route"]
    got = linear_recurrence.linear_recurrence(a, b)
    lequal(torch, "on the serve path's first layer inputs", got,
           ref.linear_recurrence_ref(a, b))
    shape = tuple(a.shape)
    del captured, a, b, got
    torch.cuda.empty_cache()
    print(f"serve path: falcon-mamba-7b, {spec}", flush=True)
    print(f"serve path: throughput {res.throughput}  peak device memory "
          f"{peak_gb:.3f} GB (with the {held_gb:.3f} GB of captured kernel "
          f"inputs)  "
          f"launches {launches}  nodes {[c['node'] for c in done]}  tokens of "
          f"rid 0 {done[0]['tokens']}", flush=True)
    print(f"kernel check: linear_recurrence bit-equal to plain on the serve "
          f"path's first layer inputs {shape} (route {route})", flush=True)
    return {"launches": launches["linear_recurrence"], "peak_gb": peak_gb,
            "completed": done}


def layer_kinds(cfg) -> dict:
    """How many layers of each kind the config stacks (units + remainder);
    an ``"attn"`` and a ``"moe"`` layer each run one attention layer."""
    units, rem = cfg.units_and_rem
    kinds = list(cfg.pattern) * units + list(cfg.pattern[:rem])
    return {k: kinds.count(k) for k in sorted(set(kinds))}


def attention_serve_path(torch, exp, serve, ops, flash_attention,
                         decode_attention, linear_recurrence, ref, model,
                         fleet, counters, sv: dict, label: str) -> dict:
    """Slice 5's and slice 8's main paths (and slices 14-15's): serve_fleet
    over the fleet with every kernel's count from 0.  It must complete
    ``sv['requests']`` requests of ``sv['max_new']`` tokens with exactly
    one flash_attention launch per attention (or MoE) layer and prefill, one
    decode_attention launch per attention layer, slot and token after the
    first, one linear_recurrence launch per rglru layer and prefill (a
    decode step's one token takes the chunked scan), and no other kernel.
    The inputs of the first prefill's first attention layer (q, k, v), of
    the first decode step's first attention layer (q and a copy of the
    cache it read) and of the first prefill's first rglru layer (a, b) are
    kept, and each kernel is held to its plain version on them
    afterwards."""
    spec = exp.ServeSpec(**sv)
    captured = {}
    real = {"attention": ops.attention, "decode": ops.decode_attention,
            "linrec": ops.linear_recurrence}

    def capture_attention(q, k, v, **kw):
        captured.setdefault("flash", (q, k, v, kw))
        return real["attention"](q, k, v, **kw)

    def capture_decode(q, k, v, kpos, pos, **kw):
        if "decode" not in captured:
            captured["decode"] = (q, k.clone(), v.clone(), kpos.clone(), pos,
                                  kw)
        return real["decode"](q, k, v, kpos, pos, **kw)

    def capture_linrec(a, b):
        captured.setdefault("linrec", (a, b))
        return real["linrec"](a, b)

    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    ops.attention, ops.decode_attention = capture_attention, capture_decode
    ops.linear_recurrence = capture_linrec
    try:
        res = serve.serve_fleet(model, fleet, spec)
    finally:
        ops.attention, ops.decode_attention = real["attention"], real["decode"]
        ops.linear_recurrence = real["linrec"]
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kinds, n = layer_kinds(model.cfg), sv["requests"]
    attn_layers = kinds.get("attn", 0) + kinds.get("moe", 0)
    want = {"flash_attention": attn_layers * n,
            "decode_attention": attn_layers * n * (sv["max_new"] - 1),
            "linear_recurrence": kinds.get("rglru", 0) * n}
    want = {k: w for k, w in want.items() if w}
    if any(launches[k] != w for k, w in want.items()) or \
            sum(launches.values()) != sum(want.values()):
        fail(f"{label} launched {launches}; {n} prefills and "
             f"{n * (sv['max_new'] - 1)} slot-token decodes of {kinds} layers "
             f"need {want} and nothing else")
    done = res.completed
    vocab = model.cfg.vocab_size
    if [c["rid"] for c in done] != list(range(n)) or any(
            len(c["tokens"]) != sv["max_new"]
            or not all(0 <= t < vocab for t in c["tokens"]) for c in done):
        fail(f"{label} did not complete {n} requests of {sv['max_new']} "
             f"tokens: {done}")
    q, k, v, kw = captured["flash"]
    err_f = acompare(torch, "flash_attention on the serve path's first layer "
                     "inputs", flash_attention.flash_attention(q, k, v, **kw),
                     ref.attention_ref(q, k, v, **kw),
                     serve="flash_attention")
    f_shape = (tuple(q.shape), tuple(k.shape), kw)
    q, k, v, kpos, pos, kw = captured["decode"]
    err_d = acompare(torch, "decode_attention on the serve path's first "
                     "decode inputs", decode_attention.decode_attention(
                         q, k, v, kpos, pos, **kw),
                     ref.decode_attention_ref(q, k, v, kpos, pos, **kw),
                     serve="decode_attention")
    d_shape = (tuple(q.shape), tuple(k.shape), pos,
               int((kpos >= 0).sum()), kw)
    checks = (f"kernel check: flash_attention == plain on the serve path's "
              f"first layer inputs {f_shape} (max_abs_err {err_f:.3e}); "
              f"decode_attention == plain on its first decode's (q, cache, "
              f"pos, filled slots) {d_shape} (max_abs_err {err_d:.3e})")
    errs = {"flash_attention": err_f, "decode_attention": err_d}
    if "linrec" in captured:
        a, b = captured["linrec"]
        errs["linear_recurrence"] = lequal(
            torch, "on the serve path's first rglru layer inputs",
            linear_recurrence.linear_recurrence(a, b),
            ref.linear_recurrence_ref(a, b))
        checks += (f"; linear_recurrence bit-equal to plain on its first "
                   f"rglru layer's inputs {tuple(a.shape)} {a.dtype} (route "
                   f"{linear_recurrence.geometry_for(a, b)['route']})")
        del a, b
    del captured, q, k, v, kpos
    torch.cuda.empty_cache()
    print(f"{label}: {model.cfg.name}, {spec}", flush=True)
    print(f"{label}: throughput {res.throughput}  peak device memory "
          f"{peak_gb:.3f} GB  launches {launches}  nodes "
          f"{[c['node'] for c in done]}  tokens of rid 0 {done[0]['tokens']}",
          flush=True)
    print(checks, flush=True)
    return {"launches": launches, "peak_gb": peak_gb, "completed": done,
            "max_abs_err": errs, "throughput": res.throughput}


def serve_cli_path(torch, serve_cli, counters) -> dict:
    """The serve entry point: ``repro_torch.launch.serve.main`` on
    SERVE_CLI_ARGV (on the card, its default device) trains a qwen1.5-0.5b
    fleet of 4 at full width for SERVE_CLI_STEPS MC-DSGT steps through
    gossip_mix (2 launches a step) and serves 8 requests from it in bf16,
    through the model's plain attention (the trained config's use_pallas is
    off, as in the reference): every count from 0, gossip_mix alone
    launched, all 8 requests completed."""
    for c in counters.values():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = serve_cli.main(list(SERVE_CLI_ARGV))
    wall = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if launches["gossip_mix"] != 2 * SERVE_CLI_STEPS or \
            sum(launches.values()) != 2 * SERVE_CLI_STEPS:
        fail(f"serve CLI path launched {launches}; {SERVE_CLI_STEPS} MC-DSGT "
             "steps need 2 gossip_mix each and nothing else")
    done = res.completed
    if [c["rid"] for c in done] != list(range(8)) or any(
            len(c["tokens"]) != 16 for c in done):
        fail(f"serve CLI path did not complete 8 requests of 16 tokens: "
             f"{done}")
    print(f"serve CLI path: python -m repro_torch.launch.serve "
          f"{' '.join(SERVE_CLI_ARGV)}", flush=True)
    print(f"serve CLI path: throughput {res.throughput}  wall {wall:.2f} s "
          f"(training and serving)  peak device memory {peak_gb:.3f} GB  "
          f"launches {launches} ({launches['gossip_mix'] / SERVE_CLI_STEPS:g} "
          f"gossip_mix per step)  tokens of rid 0 {done[0]['tokens']}",
          flush=True)
    return {"launches": launches, "peak_gb": peak_gb,
            "throughput": res.throughput}


def serve_alone(torch, model, fleet, tree, req, max_new):
    """One request served alone, batch 1: prefill, then one token at a
    time, each the argmax of the last logits."""
    params = tree.map(lambda t: t[req.node], fleet)
    cache = model.init_cache(1, len(req.prompt) + max_new, torch.bfloat16,
                             "cuda")
    prompt = torch.as_tensor(req.prompt, device="cuda").long()[None]
    logits, cache = model.prefill(params, {"tokens": prompt}, cache)
    toks = [int(torch.argmax(logits[0, -1]))]
    while len(toks) < max_new:
        cur = torch.full((1, 1), toks[-1], dtype=torch.long, device="cuda")
        logits, cache = model.decode_step(params, cur, cache,
                                          len(req.prompt) + len(toks) - 1)
        toks.append(int(torch.argmax(logits[0, -1])))
    return toks


def check_sequential(torch, exp, serve, model, fleet, tree, completed,
                     sv: dict):
    """Continuous batching == one request at a time, token for token, for
    SEQUENTIAL_RIDS (a first-wave and a second-wave request) of the serve
    spec ``sv``.  The serve dtype is bf16, so the fleet's bf16 leaves are
    what serve_fleet used; mamba's A_log is cast as it does."""
    reqs = serve.synth_requests(exp.ServeSpec(**sv), fleet=sv["fleet"],
                                vocab=model.cfg.vocab_size)
    cast = tree.map(lambda t: t.to(torch.bfloat16), fleet)
    for rid in SEQUENTIAL_RIDS:
        alone = serve_alone(torch, model, cast, tree, reqs[rid],
                            sv["max_new"])
        if alone != completed[rid]["tokens"]:
            fail(f"rid {rid}: continuous batching gave "
                 f"{completed[rid]['tokens']}, alone {alone}")
    print(f"continuous batching == one at a time, token for token, for rids "
          f"{SEQUENTIAL_RIDS}", flush=True)


def profile_once(torch, fn) -> tuple:
    """``fn()`` under torch.profiler, synchronised: (wall ms, [(kernel,
    device ms, calls)] of every kernel with device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [(e.key, e.self_device_time_total / 1e3, e.count)
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and e.self_device_time_total > 0]


def profile_serve(torch, model, fleet, tree, sv: dict, kernels: tuple):
    """Where one prefill's and one decode step's device time goes:
    torch.profiler over each (after the main path warmed everything),
    device time summed by kernel, and the share of ``kernels``."""
    params = tree.map(lambda t: t[0].to(torch.bfloat16), fleet)
    S = sv["prompt_len"]
    cache = model.init_cache(1, S + sv["max_new"], torch.bfloat16, "cuda")
    prompt = torch.randint(0, model.cfg.vocab_size, (1, S), device="cuda")
    steps = {"prefill": lambda: model.prefill(params, {"tokens": prompt},
                                              cache),
             "decode step": lambda: model.decode_step(params, prompt[:, :1],
                                                      cache, S)}
    for what, fn in steps.items():
        wall_ms, found = profile_once(torch, fn)
        busy = sum(ms for _, ms, _ in found)
        ours = {name: sum(ms for k, ms, _ in found if name in k)
                for name in kernels}
        top = sorted(found, key=lambda k: -k[1])[:10]
        print(f"profile of one {what} ({model.cfg.name}, bf16, prompt {S}): "
              f"wall {wall_ms:.3f} ms  device busy {busy:.3f} ms (idle share "
              f"{1 - busy / wall_ms:.4f})  "
              + "  ".join(f"{n} {ms:.3f} ms" for n, ms in ours.items())
              + f"  kernels {sum(c for _, _, c in found)}  top kernels (ms, "
              "calls): " + "; ".join(f"{k[:60]} {ms:.3f} x{c}"
                                     for k, ms, c in top), flush=True)


def load_twin(name: str):
    """``examples/torch/<name>.py``, the port's twin of a reference
    example, as a module (``repro_torch`` already on the path)."""
    import importlib.util
    path = ROOT / "examples" / "torch" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"twin_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan_label(plan) -> str:
    """A plan's kinds as run lengths, e.g. 2×empty+1×complete."""
    return "+".join(f"{plan.kinds.count(k)}×{k}"
                    for k in dict.fromkeys(plan.kinds))


def planned_cli_run(torch, train, exp, argv, counters, what: str) -> dict:
    """:func:`cli_run` of ``argv`` with no kernel launched (the plan's
    rounds are structured or the einsum, as the reference's 'auto'
    default); prints the plan."""
    run = cli_run(torch, train, exp, argv, counters, what)
    if any(run["launches"].values()):
        fail(f"{what} launched kernels: {run['launches']}")
    plan = run["plan"]
    print(f"{what}: plan {plan_label(plan)} ({plan.dispatch})", flush=True)
    return {"plan": plan_label(plan), "secs": run["secs"],
            "peak_gb": run["peak_gb"]}


def planned_steps(torch, exp, driver, dsteps, built, params, steps: int,
                  counters, losses=None, **kw):
    """``steps`` full-width MC-DSGT steps of ``dsteps.make_train_step(...,
    **kw)`` from ``params`` on ``built``'s schedule, plan and batches,
    staged and looped by the driver as ``exp.run`` does; every count from 0
    just before the loop; each step's loss appended to ``losses`` when
    given.  Returns (state, launches, step seconds)."""
    impl = kw["gossip_impl"]
    init, warm, step = dsteps.make_train_step(
        built.model, built.cfg, algo="mc_dsgt", gamma=built.rule.gamma, R=2,
        plan=built.plan, **kw)
    # the loop holds the only reference to the warm-started state: a step
    # that stores its trackers anew (aux_dtype) then frees the old ones
    first = [warm(init(params, built.spec.run.nodes),
                  built.stream.batch_at(0))]
    if impl == "auto":
        staged = driver.stage(built.schedule, wps=built.wps, device="cuda",
                              impl="auto", plan=built.plan)
        step_fn = driver.bind_step(staged, step)
    else:
        masks = staged = None
        if impl == "sun":
            # the sun impl takes the window's center masks (the plan's)
            masks = torch.from_numpy(built.plan.tensors()["center_mask"])
            staged = driver.StagedGossip(masks.cuda(), built.plan.period,
                                         built.wps)
        else:
            staged = driver.stage(built.schedule, wps=built.wps,
                                  device="cuda")
        step_fn = driver.bind_step(
            staged, lambda state, batch, W, t: step(state, batch, W))
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    secs = []
    state, _ = driver.run_loop(
        step_fn, first.pop(), steps=steps, wps=built.wps, period=staged.period,
        extra_fn=lambda k: built.stream.batch_at(k + 1),
        record=lambda k, t, s, out, dt: (
            secs.append(dt), losses is None or losses.append(
                float(out["loss"]))) and None,
        sync=torch.cuda.synchronize)
    # a sum is finite only if every entry is, and makes no temporary of the
    # state's size (isfinite() would make three, 11 GB at full width)
    if not all(math.isfinite(float(t.sum()))
               for t in (state.x, state.h, state.g_prev)):
        fail(f"planned steps ({kw}) gave a non-finite state")
    return state, {k: c.launches for k, c in counters.items()}, secs


def states_equal(torch, what, a, b):
    """x, h and g_prev of two runs equal bit for bit."""
    for f in ("x", "h", "g_prev"):
        if not torch.equal(getattr(a, f), getattr(b, f)):
            diff = float((getattr(a, f) - getattr(b, f)).abs().max())
            fail(f"{what}: {f} differs (max |diff| {diff})")


def mixing_equality(torch, exp, driver, dsteps, counters) -> dict:
    """Planning (b) and (c): MC-DSGT R=2 at full width from one init and
    the same batches, through two gossip impls each, their final states
    compared bit for bit."""
    out = {}
    base = exp.with_overrides(exp.ExperimentSpec(), {
        "model.preset": "full", "run.nodes": 4, "algorithm.R": 2,
        "run.gossip_impl": "auto", "topology.kind": "ring"})
    built = exp.build(base, device="cuda")
    if set(built.plan.kinds) != {"dense"}:
        fail(f"planning (b): ring plan {built.plan.kinds} is not all dense")
    params = built.model.init(torch.Generator(device="cuda").manual_seed(0),
                              torch.float32, "cuda")
    runs = {}
    for name, kw in (("auto+pallas", dict(gossip_impl="auto",
                                          auto_dense="pallas")),
                     ("pallas", dict(gossip_impl="pallas"))):
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        held = "the parameters" + (", the first run's state" if runs else "")
        state, launches, secs = planned_steps(
            torch, exp, driver, dsteps, built, params, PLAN_STEPS, counters,
            **kw)
        if launches["gossip_mix"] != 2 * PLAN_STEPS or \
                sum(launches.values()) != 2 * PLAN_STEPS:
            fail(f"planning (b) {name}: launches {launches}; "
                 f"{PLAN_STEPS} MC-DSGT steps need 2 gossip_mix each")
        runs[name] = state
        print(f"planning (b) mc_dsgt R=2 on ring ({plan_label(built.plan)}) "
              f"via {name}: step s {secs}  peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB "
              f"({held_gb:.3f} GB held before the run: {held})  launches "
              f"{launches}", flush=True)
        out[name] = {"launches": launches["gossip_mix"], "secs": secs,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del state
    states_equal(torch, "planning (b) auto+pallas vs pallas",
                 runs["auto+pallas"], runs["pallas"])
    print("planning (b): final x, h, g_prev of auto+pallas == pallas, bit "
          "for bit", flush=True)
    runs.clear()
    gc.collect()
    torch.cuda.empty_cache()

    sun = exp.build(exp.with_field(base, "topology.kind", "sun"),
                    device="cuda")
    delta = sun.plan.rounds[0].delta
    for name, kw in (("sun", dict(gossip_impl="sun", sun_delta=delta)),
                     ("auto", dict(gossip_impl="auto"))):
        state, launches, secs = planned_steps(
            torch, exp, driver, dsteps, sun, params, SUN_STEPS, counters,
            **kw)
        if any(launches.values()):
            fail(f"planning (c) {name} launched kernels: {launches}")
        runs[name] = state
        print(f"planning (c) mc_dsgt R=2 on sun ({plan_label(sun.plan)}) via "
              f"{name}: step s {secs}", flush=True)
        del state
    states_equal(torch, "planning (c) sun vs auto", runs["sun"],
                 runs["auto"])
    print("planning (c): final x, h, g_prev of sun == auto, bit for bit",
          flush=True)
    del runs, params, built, sun
    gc.collect()
    torch.cuda.empty_cache()
    return out


def planning_phase(torch, train, exp, alg, driver, dsteps, data, counters
                   ) -> dict:
    """Gossip planning and the federated/local-update rules on the card:
    (a) the reference's FedAvg run at full width (plan 2×empty+1×complete,
    0 launches); (b) MC-DSGT on ring through 'auto' with auto_dense
    'pallas' and through 'pallas', PLAN_STEPS steps each from one init and
    the same batches: gossip_mix 2 launches a step in each, the final x, h,
    g_prev equal bit for bit; (c) 'sun' against 'auto' on the theorem-3
    schedule, SUN_STEPS steps each, equal; (d) gt_local with adam on
    hierarchical pods at full width, finite, its peak; (e) on the host
    runtime the federated twin, logreg on hierarchical pods of 4 (a plan
    of two_level rounds), d2 on sun and personalized on random-sun, 0
    launches."""
    t_phase = time.perf_counter()
    out = {"fedavg": planned_cli_run(torch, train, exp, FEDAVG_ARGV,
                                     counters, "planning (a) FedAvg")}
    if out["fedavg"]["plan"] != "2×empty+1×complete":
        fail(f"planning (a): plan {out['fedavg']['plan']}")
    gc.collect()
    torch.cuda.empty_cache()

    out.update(mixing_equality(torch, exp, driver, dsteps, counters))

    out["gt_adam"] = planned_cli_run(torch, train, exp, GT_ADAM_ARGV,
                                     counters, "planning (d) gt_local+adam")
    gc.collect()
    torch.cuda.empty_cache()

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    fed = load_twin("federated").main(["--quiet"])
    print(f"planning (e) federated twin: {fed}  wall "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if fed["schedules"]["fedavg(local=4)"]["plan"] != "4xempty+1xcomplete":
        fail(f"planning (e): federated twin plans {fed['schedules']}")
    with RunTimer(exp) as rt:
        hist = train.main(list(HIER_ARGV))
    plan = rt.results[-1].built.plan
    if "two_level" not in plan.kinds or not all(
            math.isfinite(v) for _, v in hist):
        fail(f"planning (e) hierarchical: plan {plan.kinds}, evals {hist}")
    print(f"planning (e) logreg mc_dsgt on hierarchical n=16 pods 4: plan "
          f"{plan_label(plan)}  grad_sq {hist[-1][1]:.6g} at "
          f"T={hist[-1][0]}  {rt.runs[-1][1]:.3f} s", flush=True)
    d2 = exp.run(exp.with_overrides(exp.ExperimentSpec(), {
        "model.kind": "logreg", "topology.kind": "sun", "run.nodes": 16,
        "algorithm.name": "d2", "algorithm.gamma": 0.2,
        "run.gossip_impl": "auto", "run.steps": 20}), device="cuda",
        quiet=True)
    if not all(math.isfinite(v) for _, v in d2.history):
        fail(f"planning (e) d2 on sun: {d2.history}")
    print(f"planning (e) logreg d2 on sun (plan {plan_label(d2.built.plan)}):"
          f" grad_sq {d2.history[-1][1]:.6g} at T={d2.history[-1][0]}",
          flush=True)
    n, d = 16, 64
    sched = exp.build_topology(exp.TopologySpec(kind="random-sun"), n,
                               horizon=64, seed=0)
    pplan = sched.plan(0, sched.period, personalized=True)
    H, y = data.logreg_dataset(n, 256, d, seed=0, device="cuda")
    loss_i, _, stoch, _, gnorm2 = data.logreg_loss_and_grad(rho=0.1)

    def oracle(xs, gen):
        """(per-node full-batch losses, minibatch gradients)"""
        losses = torch.stack([loss_i(xs[i], H[i], y[i]) for i in range(n)])
        return losses, stoch(xs, H, y, gen, 16)

    gen = torch.Generator(device="cuda").manual_seed(0)
    pstate, phist = driver.run_algorithm(
        alg.personalized(0.3, 2.0), torch.zeros((n, d), device="cuda"),
        oracle, sched, 40, gen, eval_fn=lambda xb: gnorm2(xb, H, y),
        eval_every=39, gossip_impl="auto", plan=pplan)
    spread = float((pstate.x - pstate.x.mean(dim=0)).norm())
    if not all(math.isfinite(v) for _, v in phist) or not math.isfinite(
            spread):
        fail(f"planning (e) personalized: {phist}")
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches.values()):
        fail(f"planning (e) launched kernels: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"planning (e) personalized on random-sun (plan "
          f"{plan_label(pplan)}): grad_sq of x̄ {phist[-1][1]:.6g} at "
          f"T={phist[-1][0]}, node spread ||x - x̄|| {spread:.4g}; launches "
          f"over (e) {launches}; phase wall {wall:.3f} s", flush=True)
    out["wall_s"] = wall
    return out


class RunTimer:
    """Wraps ``exp.run`` while a twin runs: each call's spec, wall seconds
    (its build included, the device synchronized by the loop) and final
    eval, so the twins' own code stays the reference's."""

    def __init__(self, exp):
        self.exp, self.runs, self.results = exp, [], []

    def __enter__(self):
        inner = self.inner = self.exp.run

        def run(spec, **kw):
            t0 = time.perf_counter()
            res = inner(spec, **kw)
            self.runs.append((spec, time.perf_counter() - t0, res.history))
            self.results.append(res)
            return res

        self.exp.run = run
        return self

    def __exit__(self, *exc):
        self.exp.run = self.inner

    def per(self, key) -> dict:
        """{key(spec): (seconds, steps)} summed over the runs."""
        out = {}
        for spec, sec, _ in self.runs:
            s, n = out.get(key(spec), (0.0, 0))
            out[key(spec)] = (s + sec, n + spec.run.steps)
        return out


def logreg_phase(torch, exp, counters) -> dict:
    """The paper's §6 on the card through the twins of the reference's
    examples: (a) the quickstart's three algorithms at equal budget, its
    assertion MC-DSGT <= DSGD; (b) Figure 2 at its default 400-round
    budget, both protocols and the whole step-size grid (13 runs), CSVs
    into a temporary directory: mnist-24 must read "beats", covtype-binary
    anything but "LOSES to"; (c) MC-DSGT (R=2) on the MNIST protocol with
    int8 and sign gossip (group 256, error feedback), finite, with the
    pinned telemetry bytes; (d) DSGT on the MNIST protocol's Dirichlet
    partition (alpha 0.1), finite; (e) the sampled-clients twin at n =
    100,000, its manifest equal to the checked-in one key for key; (f) no
    kernel launched over (a)-(e)."""
    import os
    import tempfile
    for c in counters.values():
        c.launches = 0
    t_phase = time.perf_counter()
    qs = load_twin("quickstart")
    with RunTimer(exp) as rt:
        t0 = time.perf_counter()
        try:
            results = qs.main(["--quiet"])
        except AssertionError as e:
            fail(f"§6 quickstart: {e}")
        wall = time.perf_counter() - t0
    per = rt.per(lambda spec: spec.algorithm.name)
    for name, g in results.items():
        sec, steps = per[name]
        print(f"§6 (a) quickstart {name}: grad_sq {g:.6g} at T={qs.T_BUDGET}"
              f"  {steps} steps {sec:.3f} s ({sec / steps * 1e3:.4f} ms/step,"
              " build included)", flush=True)
    print(f"§6 (a) quickstart: MC-DSGT <= DSGD holds "
          f"({results['mc_dsgt']:.6g} <= {results['dsgd']:.6g}); wall "
          f"{wall:.3f} s", flush=True)

    fig = load_twin("paper_figure2")
    with tempfile.TemporaryDirectory() as out, RunTimer(exp) as rt:
        t0 = time.perf_counter()
        curves = fig.main(["--out", out, "--quiet"])
        wall_fig = time.perf_counter() - t0
        csvs = sorted(os.listdir(out))
    if csvs != ["figure2_covtype-binary.csv", "figure2_mnist-24.csv"]:
        fail(f"§6 Figure 2 wrote {csvs}")
    if len(rt.runs) != FIG2_RUNS:
        fail(f"§6 Figure 2 ran {len(rt.runs)} cells, not the grid's "
             f"{FIG2_RUNS}")
    per = rt.per(lambda spec: spec.model.d)
    verdicts = {}
    for lc in (fig.MNIST, fig.COVTYPE):
        word, mc, dsgd = fig.verdict(curves[lc.name])
        verdicts[lc.name] = word
        sec, steps = per[lc.d]
        print(f"§6 (b) Figure 2 {lc.name}: MC-DSGT {word} DSGD ({mc:.6g} vs "
              f"{dsgd:.6g}); finals "
              f"{ {k: v[-1][1] for k, v in curves[lc.name].items()} }; "
              f"{steps} steps in {sec:.3f} s ({sec / steps * 1e3:.4f} "
              "ms/step, builds included)", flush=True)
    if verdicts[fig.MNIST.name] != "beats":
        fail(f"§6 Figure 2 mnist-24: MC-DSGT {verdicts[fig.MNIST.name]} "
             "DSGD; the reference's verdict is 'beats'")
    if verdicts[fig.COVTYPE.name] == "LOSES to":
        fail("§6 Figure 2 covtype-binary: MC-DSGT LOSES to DSGD")
    print(f"§6 (b) Figure 2: wall {wall_fig:.3f} s for {FIG2_RUNS} runs",
          flush=True)

    mnist = exp.with_field(fig.SPECS["mnist_mc_dsgt"], "run.steps", S6_STEPS)
    for scheme in ("int8", "sign"):
        spec = exp.with_field(mnist, "compression.scheme", scheme)
        t0 = time.perf_counter()
        res = exp.run(spec, device="cuda", quiet=True)
        sec = time.perf_counter() - t0
        evals = [v for _, v in res.history]
        if not all(math.isfinite(v) for v in evals) or not bool(
                res.state.x.isfinite().all()):
            fail(f"§6 (c) MNIST MC-DSGT {scheme}: not finite: {evals}")
        got = res.telemetry.bytes_total
        if got != S6_BYTES_TOTAL[scheme]:
            fail(f"§6 (c) MNIST MC-DSGT {scheme}: telemetry bytes {got}, "
                 f"want {S6_BYTES_TOTAL[scheme]}")
        print(f"§6 (c) MNIST MC-DSGT R=2 {scheme} gossip: grad_sq "
              f"{evals[-1]:.6g} at T={res.history[-1][0]}  bytes_total {got}"
              f"  {S6_STEPS} steps {sec:.3f} s", flush=True)
    spec = exp.with_overrides(fig.base_spec(fig.MNIST), {
        "algorithm.name": "dsgt", "algorithm.gamma": 0.5,
        "run.steps": S6_STEPS, "data.hetero_alpha": 0.1})
    res = exp.run(spec, device="cuda", quiet=True)
    evals = [v for _, v in res.history]
    if not all(math.isfinite(v) for v in evals):
        fail(f"§6 (d) MNIST DSGT on Dirichlet data: not finite: {evals}")
    print(f"§6 (d) MNIST DSGT, Dirichlet(0.1) partition: grad_sq "
          f"{evals[-1]:.6g} at T={res.history[-1][0]}", flush=True)

    sc = load_twin("sampled_clients")
    want = json.loads((ROOT / S6_MANIFEST).read_text())
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as out:
        os.chdir(out)   # the spec names its telemetry file relatively
        try:
            t0 = time.perf_counter()
            res = sc.main(["--quiet"])
            wall_sc = time.perf_counter() - t0
            got = json.loads(Path(sc.TELEMETRY + ".spec.json").read_text())
            telem = json.loads(Path(sc.TELEMETRY).read_text())
        finally:
            os.chdir(cwd)
    for key in ("format", "spec", "spec_hash", "realized"):
        if got.get(key) != want[key]:
            fail(f"§6 (e) sampled-clients manifest {key!r}: {got.get(key)} "
                 f"!= {S6_MANIFEST}'s {want[key]}")
    if len(telem["history"]) != sc.STEPS:
        fail(f"§6 (e) telemetry file holds {len(telem['history'])} records")
    print(f"§6 (e) sampled clients n={sc.N:,} k={sc.K}: manifest == "
          f"{S6_MANIFEST} (edges/round {got['realized']['edges_per_round']},"
          f" senders/round {got['realized']['senders_per_round']}); "
          f"grad_sq {res.history[-1][1]:.6g}  bytes_total "
          f"{res.telemetry.bytes_total}  wall {wall_sc:.3f} s", flush=True)

    launches = {k: c.launches for k, c in counters.items()}
    if any(launches.values()):
        fail(f"§6 phase launched kernels: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"§6 (f) kernel launches over the phase: {launches}; phase wall "
          f"{wall:.3f} s", flush=True)
    return {"wall_s": wall, "verdicts": verdicts}


class StepHook:
    """Calls ``fn(k, state)`` after every step of the arch runs started
    inside the block, through the mixing-telemetry recorder's ``record``
    (the wireless scenario gives every run one), so the train CLI's own
    loop is what runs."""

    def __init__(self, recorder_cls, fn):
        self.cls, self.fn = recorder_cls, fn

    def __enter__(self):
        real = self.real = self.cls.record
        fn = self.fn

        def record(rec, k, t, state, out, dt):
            fn(k, state)
            return real(rec, k, t, state, out, dt)

        self.cls.record = record
        return self

    def __exit__(self, *exc):
        self.cls.record = self.real


def tracker_mean_gap(torch, state, steps: int, scale):
    """(largest |mean h − mean g⁻| over the columns, its largest ratio to
    the column's bound TRACKER_ROUNDINGS · steps · 2^-24 · S), node means in
    float64, 2^24 columns at a time (whole, the float64 copies would take
    30 GB).  ``scale`` (D,) keeps each column's S, the largest |h|, |g⁻| or
    |s| seen after any step so far, and is updated in place."""
    h, gp = state.h, state.g_prev
    slot = state.buf[1][0]
    gap_max, worst = 0.0, 0.0
    chunk = 1 << 24
    for a in range(0, h.shape[1], chunk):
        cols = slice(a, a + chunk)
        hc, gc = h[:, cols], gp[:, cols]
        gap = (hc.double().mean(0) - gc.double().mean(0)).abs()
        sc = scale[cols]
        for t in (hc, gc, slot[:, cols]):
            torch.maximum(sc, t.abs().amax(0), out=sc)
        bound = TRACKER_ROUNDINGS * steps * 2.0 ** -24 * sc.double()
        gap_max = max(gap_max, float(gap.max()))
        worst = max(worst, float((gap / bound.clamp_min(1e-300)).max()))
    return gap_max, worst


def held_qmix(torch, ref, real, what: str, checks: list):
    """A stand-in for ``ops.quantized_gossip_mix`` that runs ``real`` (the
    kernel's wrapper) and holds each launch to the plain version on its own
    inputs, three windows of QCHECK_COLS columns (first, middle, last;
    aligned to the call's group: the kernel quantizes and mixes each group
    on its own) by qcompare (the int8 step bound, node sums of x + res, at
    most MAX_FLIPS flipped entries); appends (flipped, max error) per
    window to ``checks``."""
    def held(ws, x, res, **kw):
        D, g = x.shape[1], kw["group"]
        mid = (D // 2) // g * g
        windows = [slice(a_, a_ + QCHECK_COLS) for a_ in
                   (0, mid, D - QCHECK_COLS)]
        inputs = [(x[:, w].clone(), res[:, w].clone()) for w in windows]
        result = real(ws, x, res, **kw)
        R = ws.shape[0]
        for w, (xi, ri) in zip(windows, inputs):
            want = ref.quantized_gossip_mix_ref(
                ws, xi, ri, scheme=kw["scheme"], group=g,
                error_feedback=kw["error_feedback"])
            bad, err = qcompare(torch, f"{what} launch {len(checks) // 3}, "
                                f"columns {w.start}+", xi, ri,
                                (result[0][:, w], result[1][:, w]), want, R,
                                kw["scheme"], g, kw["error_feedback"])
            if bad > MAX_FLIPS * 2 * xi.numel():
                fail(f"{what}: {bad} flipped entries in columns "
                     f"{w.start}+ of launch {len(checks) // 3}")
            checks.append((bad, err))
        return result
    return held


def held_mix(torch, ref, real, what: str, checks: list):
    """A stand-in for ``ops.gossip_mix`` that runs ``real`` and holds each
    kernel launch to the plain version on its own inputs: three windows of
    MIX_CHECK_COLS columns (first, middle, last), copied before the launch
    (the trainer mixes in place), row by row at f32 rtol = atol = 1e-5
    (check_rows); appends each window's largest error to ``checks``."""
    def held(ws, x, *, use_kernel=False, out=None):
        if not use_kernel:   # the plain route launches nothing
            return real(ws, x, use_kernel=use_kernel, out=out)
        D = x.shape[1]
        windows = [slice(a_, a_ + MIX_CHECK_COLS) for a_ in
                   (0, D // 2, D - MIX_CHECK_COLS)]
        inputs = [x[:, w].clone() for w in windows]
        result = real(ws, x, use_kernel=True, out=out)
        for w, xi in zip(windows, inputs):
            checks.append(check_rows(
                torch, result[:, w], ref.gossip_mix_ref(ws, xi),
                f"{what} launch {len(checks) // 3}, columns {w.start}+"))
        return result
    return held


def cli_run(torch, train, exp, argv, counters, what: str, smi: str = "",
            on_step=None, keep=()) -> dict:
    """``train.main(argv)`` on the card with every count from 0 and
    ``on_step`` = (recorder class, fn) calling ``fn(k, state)`` after each
    step: finite losses and consensus; returns the launches, losses, step
    seconds, peak memory, the plan, the telemetry history, the final state
    and, copied to the host, its tensors named in ``keep`` (x, h, g_prev,
    res_x), so that the next run has the card to itself once the caller
    drops the state."""
    for c in counters.values():
        c.launches = 0
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    with RunTimer(exp) as rt:
        if on_step is None:
            history = train.main(list(argv))
        else:
            with StepHook(on_step[0], on_step[1]):
                history = train.main(list(argv))
    launches = {k: c.launches for k, c in counters.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    res = rt.results.pop()
    rt.results.clear()
    if not history or not all(math.isfinite(h["loss"])
                              and math.isfinite(h["consensus"])
                              for h in history):
        fail(f"{what}: history not finite: {history}")
    state = res.state
    kept = {f: (state.res[0] if f == "res_x" else getattr(state, f)).cpu()
            for f in keep}
    out = {"launches": launches, "losses": [h["loss"] for h in history],
           "secs": [h["sec"] for h in history], "peak_gb": peak_gb,
           "plan": res.built.plan, "kept": kept, "state": state,
           "telemetry": res.telemetry.history if res.telemetry else None}
    print(f"{what}: python -m repro_torch.launch.train {' '.join(argv)}",
          flush=True)
    print(f"{what}: losses {out['losses']}  step s {out['secs']}  peak "
          f"device memory {peak_gb:.3f} GB ({held_gb:.3f} GB held before the "
          f"run{'; ' + smi if smi else ''})  launches {launches}", flush=True)
    return out


def rows_close(torch, what, got, kept, rtol, atol) -> tuple:
    """A final state on the card against one kept on the host, row by row:
    (entries beyond rtol/atol, largest absolute error)."""
    bad, err = 0, 0.0
    for i in range(got.shape[0]):
        w = kept[i].to(got.device)
        d = (got[i] - w).abs()
        bad += int((d > atol + rtol * w.abs()).sum())
        err = max(err, float(d.max()))
        del w, d
    return bad, err


def node_sums_close(torch, what, x, res, kept_x, kept_res, tol=1e-5):
    """Each column's node sum of x + res (float64, 2^24 columns at a time)
    against the kept run's at rtol = atol = ``tol``."""
    chunk = 1 << 24
    for a in range(0, x.shape[1], chunk):
        cols = slice(a, a + chunk)
        got = x[:, cols].double().sum(0) + res[:, cols].double().sum(0)
        want = (kept_x[:, cols].to(x.device).double().sum(0)
                + kept_res[:, cols].to(x.device).double().sum(0))
        torch.testing.assert_close(
            got, want, rtol=tol, atol=tol,
            msg=lambda m: f"{what}: node sums of x + res, columns {a}+: {m}")


def wireless_phase(torch, train, exp, ops, ref, sim_telemetry, counters,
                   smi: str) -> dict:
    """ROADMAP Queue 1 items 5 and 7 on the card, each leg through the
    train CLI at full width on the realized waypoint-mobility schedule
    with 20% link drop:

    (a) MC-DSGT R=2 with --delay 1 through gossip_mix (6 launches in 3
        steps); after every step the float64 node means of h and g⁻ agree
        within TRACKER_ROUNDINGS · steps · 2^-24 of each column's scale; the
        final x, h, g⁻ equal the same run through --gossip-impl dense (the
        plain mixer, from the same init and batches) at rtol 1e-4 / atol
        1e-5;
    (b) the same with --compress int8 through quantized_gossip_mix (6
        launches): each launch, on the stale payload, held to the plain
        version on three column windows by qcompare (the int8 step bound,
        node sums of x + res, at most MAX_FLIPS flipped entries).  The dense
        compressed mixer of an MC-DSGT state would not fit on the card
        beside it (seven (n, D) states and its quantization temporaries), so
        the run-level comparison with dense is DSGD's: DSGD int8 --delay 1
        through pallas (3 launches) against dense (0), the final x and
        res_x within rtol 1e-4 / atol 1e-5 up to MAX_FLIPS flipped entries
        and their node sums of x + res_x at rtol = atol = 1e-5;
    (c) --comm-interval 2 inside the stale window, 4 steps through
        gossip_mix: 2 launches on steps 0 and 2, none on 1 and 3;
    (d) the twins of examples/wireless_mobility.py and
        examples/compressed_gossip.py at their default budgets on the host
        runtime, 0 launches, their own assertions holding."""
    t_phase = time.perf_counter()
    out = {}
    recorder = sim_telemetry.TelemetryRecorder

    # (a) the delayed window through gossip_mix, held to the dense mixer
    gaps, scale = [], []

    def tracker_mean(k, state):
        if not scale:
            scale.append(torch.zeros(state.h.shape[1], device=state.h.device))
        gap, ratio = tracker_mean_gap(torch, state, k + 1, scale[0])
        gaps.append((gap, ratio))
        if ratio > 1.0:
            fail(f"wireless (a) step {k}: node means of h and g_prev differ "
                 f"by {gap:.3e}, {ratio:.2f} times the rounding bound")

    a = cli_run(torch, train, exp, DELAYED_ARGV + ["--gossip-impl",
                                                        "pallas"],
                     counters, "wireless (a) delayed mc_dsgt via pallas", smi,
                     on_step=(recorder, tracker_mean),
                     keep=("x", "h", "g_prev"))
    if a["launches"]["gossip_mix"] != 2 * STEPS or \
            sum(a["launches"].values()) != 2 * STEPS:
        fail(f"wireless (a): launches {a['launches']}; {STEPS} delayed "
             "MC-DSGT steps need 2 gossip_mix each")
    stale = [t.get("stale_gap") for t in a["telemetry"]]
    kept = a.pop("kept")
    del a["state"], scale[:]
    print(f"wireless (a): tracker mean |h̄ − ḡ⁻| per step "
          f"{[g for g, _ in gaps]} (at most {max(r for _, r in gaps):.3f} of "
          f"the rounding bound); telemetry stale_gap {stale}, spectral_gap "
          f"{[t['spectral_gap'] for t in a['telemetry']]}, kinds "
          f"{[t['kinds'] for t in a['telemetry']]}", flush=True)
    d = cli_run(torch, train, exp, DELAYED_ARGV + ["--gossip-impl",
                                                        "dense"],
                     counters, "wireless (a) delayed mc_dsgt via dense", smi)
    if any(d["launches"].values()):
        fail(f"wireless (a) dense launched kernels: {d['launches']}")
    errs = {}
    for f in ("x", "h", "g_prev"):
        bad, errs[f] = rows_close(torch, f, getattr(d["state"], f), kept[f],
                                  1e-4, 1e-5)
        if bad:
            fail(f"wireless (a): final {f} of pallas and dense differ at "
                 f"{bad} entries beyond rtol 1e-4 / atol 1e-5")
    del d["state"], kept
    print(f"wireless (a): final x, h, g_prev of pallas == dense at rtol 1e-4 "
          f"/ atol 1e-5 (max |diff| {errs}); losses {a['losses']} vs "
          f"{d['losses']}", flush=True)
    out["a"] = {k: a[k] for k in ("launches", "secs", "peak_gb")}
    out["a"]["stale_gap"] = stale
    out["a_dense"] = {k: d[k] for k in ("secs", "peak_gb")}

    # (b) compressed and delayed through quantized_gossip_mix
    real = ops.quantized_gossip_mix
    checks = []
    ops.quantized_gossip_mix = held_qmix(torch, ref, real, "wireless (b)",
                                         checks)
    try:
        b = cli_run(torch, train, exp,
                         DELAYED_ARGV + ["--gossip-impl", "pallas",
                                         "--compress", "int8"],
                         counters, "wireless (b) delayed mc_dsgt int8 via "
                         "pallas", smi)
    finally:
        ops.quantized_gossip_mix = real
    del b["state"]
    if b["launches"]["quantized_gossip_mix"] != 2 * STEPS or \
            sum(b["launches"].values()) != 2 * STEPS:
        fail(f"wireless (b): launches {b['launches']}; {STEPS} compressed "
             "MC-DSGT steps need 2 quantized_gossip_mix each")
    print(f"wireless (b): every quantized_gossip_mix launch == plain on its "
          f"stale payload's first, middle and last {QCHECK_COLS:,} columns "
          f"(qcompare: int8 step bound, node sums of x + res; flipped "
          f"entries and max |diff| per window {checks})", flush=True)
    bp = cli_run(torch, train, exp,
                      DSGD_DELAYED_ARGV + ["--gossip-impl", "pallas"],
                      counters, "wireless (b) delayed dsgd int8 via pallas",
                      smi, keep=("x", "res_x"))
    kept = bp.pop("kept")
    del bp["state"]
    if bp["launches"]["quantized_gossip_mix"] != STEPS or \
            sum(bp["launches"].values()) != STEPS:
        fail(f"wireless (b) dsgd: launches {bp['launches']}")
    bd = cli_run(torch, train, exp,
                      DSGD_DELAYED_ARGV + ["--gossip-impl", "dense"],
                      counters, "wireless (b) delayed dsgd int8 via dense",
                      smi)
    if any(bd["launches"].values()):
        fail(f"wireless (b) dense launched kernels: {bd['launches']}")
    st = bd.pop("state")
    flipped = {}
    for f, got in (("x", st.x), ("res_x", st.res[0])):
        bad, err = rows_close(torch, f, got, kept[f], 1e-4, 1e-5)
        flipped[f] = (bad, err)
        if bad > MAX_FLIPS * got.numel():
            fail(f"wireless (b) dsgd: final {f} of pallas and dense differ "
                 f"at {bad} entries beyond rtol 1e-4 / atol 1e-5")
    node_sums_close(torch, "wireless (b) dsgd", st.x, st.res[0], kept["x"],
                    kept["res_x"])
    del st, kept, got
    print(f"wireless (b): dsgd final x, res_x of pallas == dense up to "
          f"flipped entries (count, max |diff|: {flipped}); node sums of "
          f"x + res_x kept at 1e-5", flush=True)
    out["b"] = {k: b[k] for k in ("launches", "secs", "peak_gb")}
    out["b_dsgd"] = {k: bp[k] for k in ("launches", "secs", "peak_gb")}
    out["b_dsgd_dense"] = {"secs": bd["secs"], "peak_gb": bd["peak_gb"]}

    # (c) comm_interval: no launch on a skipped step
    per_step = []
    c = cli_run(torch, train, exp, INTERVAL_ARGV, counters,
                     "wireless (c) comm_interval 2, delay 1, via pallas", smi,
                     on_step=(recorder, lambda k, state: per_step.append(
                         counters["gossip_mix"].launches)))
    del c["state"]
    if per_step != [2, 2, 4, 4] or sum(c["launches"].values()) != 4:
        fail(f"wireless (c): gossip_mix launches after each step "
             f"{per_step}, all {c['launches']}; want [2, 2, 4, 4]")
    print(f"wireless (c): gossip_mix launches after each step {per_step} "
          "(none on the skipped steps 1 and 3)", flush=True)
    out["c"] = {k: c[k] for k in ("launches", "secs", "peak_gb")}
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the two twins on the host runtime
    for cnt in counters.values():
        cnt.launches = 0
    for name in ("wireless_mobility", "compressed_gossip"):
        twin = load_twin(name)
        t0 = time.perf_counter()
        with RunTimer(exp) as rt:
            try:
                result = twin.main([])
            except AssertionError as e:
                fail(f"wireless (d) {name}: {e}")
        wall = time.perf_counter() - t0
        stale = [t.get("stale_gap") for r in rt.results
                 for t in r.telemetry.history[-1:]]
        rt.results.clear()
        print(f"wireless (d) {name} twin: {result}; runs {len(rt.runs)}, "
              f"wall {wall:.3f} s; stale_gap of each run's last step "
              f"{stale} (no delay: the recorder emits none)", flush=True)
        out[name] = {"wall_s": wall}
    launches = {k: cnt.launches for k, cnt in counters.items()}
    if any(launches.values()):
        fail(f"wireless (d) launched kernels: {launches}")
    wall = time.perf_counter() - t_phase
    print(f"wireless (d) kernel launches over the twins: {launches}; phase "
          f"wall {wall:.3f} s", flush=True)
    out["wall_s"] = wall
    return out


def profile_split(path: str) -> dict:
    """The device time of the steps in a ``--profile-dir`` Chrome trace,
    split by the range the host was in when it launched each kernel (its
    runtime or driver call, matched by correlation id): ``obs_grad`` (the
    oracle), ``obs_mix`` (the gossip window) or neither (the update, the
    obs norms, the pre-mix copy), counting only launches inside an
    ``obs:step`` span (the warm start's grad is outside every one).  Also
    the ``obs:step`` spans' host ms.  Sums of kernel, memcpy and memset
    durations in ms."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]

    def spans(name):
        return [(e["ts"], e["ts"] + e["dur"]) for e in events
                if e.get("cat") == "user_annotation" and e["name"] == name]

    step, grad, mix = spans("obs:step"), spans("obs_grad"), spans("obs_mix")
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}

    def inside(ts, rs):
        return any(a <= ts <= b for a, b in rs)

    out = {"steps": len(step), "grad_ms": 0.0, "mix_ms": 0.0,
           "other_ms": 0.0, "kernels": 0, "unmatched": 0,
           "step_host_ms": sum(b - a for a, b in step) / 1e3}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        if ts is None:
            out["unmatched"] += 1
            continue
        if not inside(ts, step):
            continue
        key = ("grad_ms" if inside(ts, grad) else
               "mix_ms" if inside(ts, mix) else "other_ms")
        out[key] += e["dur"] / 1e3
        out["kernels"] += 1
    return out


class Stopwatch:
    """Times every call of ``obj.name`` made inside the block (the port's
    own functions keep running; only the clock is added)."""

    def __init__(self, obj, name: str):
        self.obj, self.name, self.seconds = obj, name, []

    def __enter__(self):
        real = self.real = getattr(self.obj, self.name)

        def timed_call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return real(*args, **kwargs)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        setattr(self.obj, self.name, timed_call)
        return self

    def __exit__(self, *exc):
        setattr(self.obj, self.name, self.real)


def restore_leg(torch, train, exp, ckpt, argv, counters, label: str,
                smi: str, tmp: str) -> dict:
    """Checkpoint and restore through the train CLI on ``argv`` (MC-DSGT
    R=2 through gossip_mix): 3 steps straight, then 2 steps with
    --checkpoint and 1 more with --restore: losses equal, and the final x,
    h, g_prev bit-equal to the straight run's (or, failing that, within
    rtol 1e-4 / atol 1e-5, and the line says which held); the file's size,
    the free disk before writing, and the write and read seconds; the file
    deleted after the comparison (a failure still fails); 12 launches in 6
    steps and nothing else."""
    import os
    import shutil
    ck = os.path.join(tmp, "ck.msgpack")
    straight = cli_run(torch, train, exp, argv + ["--steps", "3"],
                       counters, f"{label} 3 steps straight", smi,
                       keep=("x", "h", "g_prev"))
    kept = straight.pop("kept")
    del straight["state"]
    free_gb = shutil.disk_usage(tmp).free / 1e9
    try:
        with Stopwatch(ckpt, "save_checkpoint") as w:
            first = cli_run(torch, train, exp, argv + [
                "--steps", "2", "--checkpoint", ck], counters,
                f"{label} 2 steps + --checkpoint", smi)
        del first["state"]
        size_gb = os.path.getsize(ck) / 1e9
        with Stopwatch(ckpt, "load_checkpoint") as r:
            rest = cli_run(torch, train, exp, argv + [
                "--steps", "1", "--restore", ck], counters,
                f"{label} --restore + 1 step", smi)
    finally:
        for f in (ck, ck + ".spec.json", ck + ".tmp"):
            if os.path.exists(f):
                os.remove(f)
    launches = sum(x["launches"]["gossip_mix"]
                   for x in (straight, first, rest))
    if launches != 12 or any(sum(x["launches"].values()) != 2 * len(
            x["losses"]) for x in (straight, first, rest)):
        fail(f"{label}: launches "
             f"{[x['launches'] for x in (straight, first, rest)]}; 6 MC-DSGT "
             "steps need 12 gossip_mix and nothing else")
    if first["losses"] + rest["losses"] != straight["losses"]:
        fail(f"{label}: losses {first['losses']} + {rest['losses']} != "
             f"the straight run's {straight['losses']}")
    held, errs = "bit-equal", {}
    for f in ("x", "h", "g_prev"):
        bad, errs[f] = rows_close(torch, f, getattr(rest["state"], f),
                                  kept[f], 0.0, 0.0)
        if bad:
            held = "within rtol 1e-4 / atol 1e-5 (not bit-equal)"
            bad, _ = rows_close(torch, f, getattr(rest["state"], f),
                                kept[f], 1e-4, 1e-5)
            if bad:
                fail(f"{label}: restored {f} differs from the straight run "
                     f"at {bad} entries beyond rtol 1e-4 / atol 1e-5")
    del rest["state"], kept
    wsec, rsec = sum(w.seconds), sum(r.seconds)
    print(f"{label}: checkpoint {size_gb:.3f} GB (free disk before writing "
          f"{free_gb:.1f} GB) written in {wsec:.3f} s ({size_gb / wsec:.3f} "
          f"GB/s), read in {rsec:.3f} s ({size_gb / rsec:.3f} GB/s); losses "
          f"{first['losses']} + {rest['losses']} == {straight['losses']}; "
          f"final x, h, g_prev {held} (max |diff| {errs}); {launches} "
          "gossip_mix launches in 6 steps; the file deleted", flush=True)
    return {"launches": launches, "size_gb": size_gb, "write_s": wsec,
            "read_s": rsec, "free_gb": free_gb, "held": held,
            "losses": straight["losses"],
            "secs": straight["secs"] + first["secs"] + rest["secs"],
            "peak_gb": max(x["peak_gb"] for x in (straight, first, rest))}


def obs_phase(torch, train, exp, counters, smi: str, main_secs) -> dict:
    """ROADMAP Queue 1 items 4 and 10 on the card, through the train CLI:

    (a) the main path with observability on: qwen1.5-0.5b at full width, 4
        nodes, MC-DSGT R=2 through gossip_mix, 3 steps, with --metrics
        (flushed every 2 steps), --profile-dir and --profile-steps 1: 6
        gossip_mix launches; the event log holds 1 meta event, 3 step
        events carrying the four in-step scalars (finite) and 1 summary
        with its phases and an optimality record whose floor is > 0; s/step
        and the peak beside the main path's; from the profile, the device
        ms of one step under obs_grad and under obs_mix (profile_split);
        the log rendered by repro_torch.obs.report;
    (b) checkpoint and restore at full width on 2 nodes (beta 0.5, the sun
        schedule's limit; the file is 2 × D × 4 B × 3 streams = 11.1 GB):
        3 steps straight, then 2 steps with --checkpoint and 1 more with
        --restore: losses equal, and the final x, h, g_prev bit-equal to
        the straight run's (or, failing that, within rtol 1e-4 / atol 1e-5,
        and the line says which held); the file's size, the free disk
        before writing, and the write and read seconds; the file deleted
        after the comparison (a failure still fails); 12 launches in 6
        steps;
    (c) the twins of examples/lower_bound_demo.py (its cap assertion; the
        max prog per 8 rounds against the cap) and examples/train_lm.py
        (its default reduced preset, 200 steps, with --metrics: the loss
        improves, the log renders), 0 launches."""
    import os
    import tempfile
    from repro_torch import checkpoint as ckpt
    from repro_torch.obs import metrics as obs_metrics, report as obs_report

    t_phase = time.perf_counter()
    out = {}
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch, prefix="obs_phase_") as tmp:
        # (a) observability on the main path
        log, prof = os.path.join(tmp, "run.jsonl"), os.path.join(tmp, "prof")
        a = cli_run(torch, train, exp, MAIN_ARGV + [
            "--metrics", log, "--metrics-every", "2", "--profile-dir", prof,
            "--profile-steps", "1"], counters, "obs (a) main path + --metrics "
            "--profile-dir", smi)
        del a["state"]
        if a["launches"]["gossip_mix"] != 2 * STEPS or \
                sum(a["launches"].values()) != 2 * STEPS:
            fail(f"obs (a): launches {a['launches']}; {STEPS} MC-DSGT steps "
                 "need 2 gossip_mix each")
        events = obs_metrics.read_events(log)
        kinds = [e["event"] for e in events]
        if kinds != ["meta"] + ["step"] * STEPS + ["summary"]:
            fail(f"obs (a): event log holds {kinds}")
        scalars = [{m: e.get(m) for m in obs_metrics.OBS_METRICS}
                   for e in events[1:-1]]
        if not all(v is not None and math.isfinite(v)
                   for sc in scalars for v in sc.values()):
            fail(f"obs (a): in-step scalars not all finite: {scalars}")
        summary = events[-1]
        opt = summary.get("optimality") or {}
        if not (opt.get("floor") or 0) > 0 or "step" not in summary.get(
                "phases", {}):
            fail(f"obs (a): summary lacks phases or a floor > 0: {summary}")
        split = profile_split(os.path.join(prof, "trace.json"))
        if split["steps"] != 1 or split["kernels"] == 0:
            fail(f"obs (a): the profile holds no step's kernels: {split}")
        print(f"obs (a): scalars per step {scalars}", flush=True)
        print(f"obs (a): s/step {a['secs']} against the main path's "
              f"{main_secs} (same process); peak {a['peak_gb']:.3f} GB",
              flush=True)
        print(f"obs (a): profile of step 0: device ms under obs_grad "
              f"{split['grad_ms']:.3f}, obs_mix {split['mix_ms']:.3f}, "
              f"neither {split['other_ms']:.3f} ({split['kernels']} kernels, "
              f"{split['unmatched']} not matched to a launch; the step's "
              f"host span {split['step_host_ms']:.3f} ms)", flush=True)
        print(obs_report.render(events), flush=True)
        out["a"] = {k: a[k] for k in ("launches", "secs", "peak_gb")}
        out["a"]["profile"] = split

        # (b) checkpoint and restore at full width, 2 nodes
        out["b"] = restore_leg(torch, train, exp, ckpt, CKPT_ARGV, counters,
                               "obs (b)", smi, tmp)

        # (c) the twins
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            progress = load_twin("lower_bound_demo").main(
                ["--device", "cuda", "--quiet"])
        except AssertionError as e:
            fail(f"obs (c) lower_bound_demo: {e}")
        demo_s = time.perf_counter() - t0
        print(f"obs (c) lower_bound_demo: (round, T, max_prog, cap) "
              f"{progress}; {demo_s:.3f} s", flush=True)
        lm_log = os.path.join(tmp, "lm.jsonl")
        t0 = time.perf_counter()
        history = load_twin("train_lm").main([
            "--device", "cuda", "--metrics", lm_log, "--checkpoint",
            os.path.join(tmp, "lm.msgpack"), "--quiet"])
        lm_s = time.perf_counter() - t0
        if not history[-1]["loss"] < history[0]["loss"]:
            fail(f"obs (c) train_lm: loss did not improve: {history}")
        launches = {k: c.launches for k, c in counters.items()}
        if any(launches.values()):
            fail(f"obs (c): the twins launched kernels: {launches}")
        print(f"obs (c) train_lm: loss {history[0]['loss']:.4f} -> "
              f"{history[-1]['loss']:.4f} in 200 steps, {lm_s:.3f} s; "
              f"launches {launches}", flush=True)
        print(obs_report.render(obs_metrics.read_events(lm_log)), flush=True)
        out["c"] = {"demo_s": demo_s, "train_lm_s": lm_s}
    wall = time.perf_counter() - t_phase
    print(f"obs phase wall {wall:.3f} s", flush=True)
    out["wall"] = wall
    return out


def predicted(what: str, key: str, value: float) -> str:
    """``value`` beside its PREDICTED range, and whether it fell inside."""
    lo, hi = PREDICTED[what][key]
    return (f"{value:.3f} (predicted {lo}-{hi}: "
            f"{'inside' if lo <= value <= hi else 'outside'})")


def attention_serve_phase(torch, exp, serve, ops, flash_attention,
                          decode_attention, linear_recurrence, ref, models,
                          configs, tree, counters, arch: str, n_params: int,
                          sv: dict, label: str, layers: int = 0) -> dict:
    """One attention serve path: a fleet of ``arch`` drawn at its
    published widths and full depth in bf16, served through
    :func:`attention_serve_path`, two requests served again one at a time
    and token-equal, one prefill's and one decode step's profile (with
    ``linear_recurrence`` where the model has rglru layers); then the fleet
    is freed.  Its peak memory and wall are printed, beside their
    predictions for the paths PREDICTED names.  ``layers`` cuts the
    depth (0: the config's)."""
    t0 = time.perf_counter()
    model, fleet = draw_fleet(torch, models, configs, tree, arch, n_params,
                              sv["fleet"], layers)
    out = attention_serve_path(torch, exp, serve, ops, flash_attention,
                               decode_attention, linear_recurrence, ref,
                               model, fleet, counters, sv, label)
    check_sequential(torch, exp, serve, model, fleet, tree, out["completed"],
                     sv)
    recurrent = ("linear_recurrence",) if "rglru" in layer_kinds(
        model.cfg) else ()
    profile_serve(torch, model, fleet, tree, sv,
                  recurrent + ("flash_attention", "decode_attention"))
    del model, fleet
    gc.collect()
    torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    if arch in PREDICTED:
        print(f"{label}: peak device memory "
              f"{predicted(arch, 'peak_gb', out['peak_gb'])} GB  wall "
              f"{predicted(arch, 'wall_s', wall)} s (draw, serve, re-serve, "
              "profile)", flush=True)
    else:
        print(f"{label}: wall {wall:.3f} s (draw, serve, re-serve, "
              "profile)", flush=True)
    return out


def spec_smoke_phase(torch, exp, counters) -> dict:
    """Queue 1 item 13 on the card: (a) the port's spec smoke,
    ``repro_torch.exp.validate.main`` with ``--device cuda --min-manifests
    4`` (every example twin's SPECS cell shrunk to 2 steps, the obs smoke,
    the four compressed cells, the four checked-in manifests), which must
    return 0; each cell's kernel launches are counted from 0 and stated,
    and a cell that is not on the ``pallas`` gossip impl must launch none
    (the cells are reduced and their models run use_pallas off).  (b) the
    ``examples/personalized_fleet.py`` twin at its own size (16 nodes,
    Dirichlet(0.1) streams, T = 60 for each fleet, 64 requests served), its
    assertions holding: the personalized per-node loss below MC-DSGT's, 64
    requests, each user pinned to one node; 0 launches."""
    from repro_torch.exp import validate
    t_phase = time.perf_counter()
    cells = []
    real = validate._run

    def counted(spec, **kw):
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        try:
            return real(spec, **kw)
        finally:
            cells.append((exp.spec_hash(spec), spec,
                          {k: c.launches for k, c in counters.items()
                           if c.launches}, time.perf_counter() - t0))

    validate._run = counted
    try:
        rc = validate.main(["--examples", str(ROOT / "examples" / "torch"),
                            "--manifests",
                            str(ROOT / "experiments" / "manifests" /
                                "*.json"),
                            "--device", "cuda", "--min-manifests", "4"])
    finally:
        validate._run = real
    if rc != 0:
        fail(f"spec smoke (a): repro_torch.exp.validate returned {rc}")
    for h, spec, launched, sec in cells:
        print(f"spec smoke (a) [{h}] {spec.model.kind}"
              f"{'/' + spec.model.arch if spec.model.kind == 'arch' else ''} "
              f"{spec.algorithm.name} on {spec.topology.kind} "
              f"({spec.run.gossip_impl}, {spec.run.nodes} nodes): launches "
              f"{launched or 0}  {sec:.3f} s", flush=True)
        if launched and spec.run.gossip_impl != "pallas":
            fail(f"spec smoke (a) [{h}] launched {launched} off the pallas "
                 "gossip impl")
    wall_a = time.perf_counter() - t_phase
    print(f"spec smoke (a): validate returned 0 over {len(cells)} runs, "
          f"launches {sum(sum(l.values()) for _, _, l, _ in cells)}; wall "
          f"{wall_a:.3f} s", flush=True)

    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    twin = load_twin("personalized_fleet")
    try:
        res = twin.main(["--device", "cuda", "--quiet"])
    except AssertionError as e:
        fail(f"spec smoke (b) personalized_fleet: {e}")
    wall_b = time.perf_counter() - t0
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches.values()):
        fail(f"spec smoke (b) personalized_fleet launched {launches}")
    print(f"spec smoke (b) personalized_fleet: per-node loss personalized "
          f"{res['personalized']:.6g} < mc_dsgt {res['mc_dsgt']:.6g}; served "
          f"{res['throughput']}; each user on one node; launches 0; wall "
          f"{wall_b:.3f} s", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"spec smoke phase: wall {predicted('spec smoke', 'wall_s', wall)} "
          "s", flush=True)
    return {"cells": len(cells), "personalized": res}


def cut_depth(models, configs, tree, arch: str) -> str:
    """``arch`` at its published widths with TRAIN_LAYERS[arch] layers,
    registered as "<arch>-<L>l" so the train CLI resolves it; fails unless
    its parameter count is TRAIN_D[arch].  Returns the name."""
    L = TRAIN_LAYERS[arch]
    cfg = dataclasses.replace(configs.get(arch), name=f"{arch}-{L}l",
                              num_layers=L)
    D = sum(math.prod(s) for _, s in tree.items(models.build(cfg).shapes))
    if D != TRAIN_D[arch]:
        fail(f"{cfg.name} has {D} parameters, not {TRAIN_D[arch]}")
    configs.register(cfg)
    return cfg.name


def arch_train_phase(torch, train, exp, models, configs, tree, counters,
                     smi: str) -> dict:
    """Slice 15's training paths on the card, through the train CLI: the
    pattern-generic arch trainer (use_pallas off, as the reference trains:
    no kernel has a backward), MC-DSGT R=2 on 4 nodes, the gossip through
    gossip_mix, 2 launches a step and nothing else:

    (b) internvl2-1b at full width (D = 493,753,344), each node's batch 2 x
        (256 patch embeddings + 64 text tokens), 3 steps: finite losses, 6
        launches, the peak beside its prediction and s/step;
    (c) granite-moe-3b-a800m at its published widths (40 experts top-8, so
        the routing and its backward run at their real shape), depth cut to
        4 layers (D = 478,414,848): 3 steps straight, then 2 with
        --checkpoint and 1 after --restore (restore_leg: the restored run
        equal to the straight one);
    (d) falcon-mamba-7b at its published widths, depth cut to 2 layers (D =
        476,966,912), 3 steps; then the examples/torch/serve_batch.py twin
        (a reduced falcon-mamba fleet of 4 trained 3 steps on the dense
        mixer, 16 requests of 48 + 16 tokens served on 8 slots): 0
        launches, every request completed."""
    import tempfile
    from repro_torch import checkpoint as ckpt
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    b = cli_run(torch, train, exp, VLM_ARGV, counters,
                "arch train (b) internvl2-1b", smi)
    D = b.pop("state").x.shape[1]
    if D != 493_753_344 or len(b["losses"]) != STEPS:
        fail(f"arch train (b): D {D}, {len(b['losses'])} steps")
    if b["launches"]["gossip_mix"] != 2 * STEPS or \
            sum(b["launches"].values()) != 2 * STEPS:
        fail(f"arch train (b): launches {b['launches']}; {STEPS} MC-DSGT "
             "steps need 2 gossip_mix each and nothing else")
    wall = time.perf_counter() - t0
    print(f"arch train (b) internvl2-1b: peak device memory "
          f"{predicted('internvl2-1b train', 'peak_gb', b['peak_gb'])} GB  "
          f"s/step {b['secs']}  wall "
          f"{predicted('internvl2-1b train', 'wall_s', wall)} s", flush=True)
    out["b"] = {k: b[k] for k in ("launches", "losses", "secs", "peak_gb")}
    gossip = ["--preset", "full", "--nodes", "4", "--algo", "mc_dsgt", "--R",
              "2", "--gossip-impl", "pallas", "--device", "cuda"]
    name = cut_depth(models, configs, tree, "granite-moe-3b-a800m")
    scratch = ROOT / "build"
    scratch.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch,
                                     prefix="arch_train_") as tmp:
        out["c"] = restore_leg(torch, train, exp, ckpt,
                               ["--arch", name] + gossip, counters,
                               f"arch train (c) {name}", smi, tmp)
    name = cut_depth(models, configs, tree, "falcon-mamba-7b")
    d = cli_run(torch, train, exp, ["--arch", name, "--steps", str(STEPS)]
                + gossip, counters, f"arch train (d) {name}", smi)
    del d["state"]
    if d["launches"]["gossip_mix"] != 2 * STEPS or \
            sum(d["launches"].values()) != 2 * STEPS:
        fail(f"arch train (d): launches {d['launches']}; {STEPS} MC-DSGT "
             "steps need 2 gossip_mix each and nothing else")
    out["d"] = {k: d[k] for k in ("launches", "losses", "secs", "peak_gb")}
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    res = load_twin("serve_batch").main(["--device", "cuda"])
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches.values()) or len(res.completed) != 16 or any(
            len(c["tokens"]) != 16 for c in res.completed):
        fail(f"arch train (d) serve_batch twin: launches {launches}, "
             f"completed {res.completed}")
    print(f"arch train (d) serve_batch twin: {res.throughput}; launches 0; "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    wall = time.perf_counter() - t_phase
    print(f"arch train phase: wall "
          f"{predicted('arch train', 'wall_s', wall)} s", flush=True)
    out["wall"] = wall
    return out


def whisper_phase(torch, train, exp, ops, ref, models, configs, tree,
                  driver, dsteps, counters, smi: str) -> dict:
    """Slice 16 on the card (see WHISPER_ARGV's note):

    (a) whisper-tiny at full width on 4 nodes, MC-DSGT R=2, 3 steps
        through the train CLI: 6 gossip_mix launches and nothing else,
        finite losses; s/step and peak memory beside their predictions;
    (b) the same on 32 nodes with --compress int8 --compress-group 512: 6
        quantized_gossip_mix launches on the tile route and nothing else,
        each held to the plain version on its own inputs (held_qmix); then
        one step with --compress sign (2 launches, held likewise);
    (c) whisper-tiny served in bf16 from seeded weights, 4 sequences: the
        encoder over 1500 frames and a 64-token prefill, then 64 greedy
        decode steps against the self ring and the cross cache: 0 launches
        of every kernel; prefill and decode tok/s, a profile of one prefill
        and one decode step (idle share); in f32 from the same weights,
        prefill + teacher-forced decode logits == the train-mode forward's
        at rtol 5e-2 / atol 5e-3 (the reference's own check,
        tests/test_archs_smoke.py);
    (d) a reduced qwen1.5-0.5b with logit_softcap 30 in f32: prefill of 16
        tokens and 4 decode steps on the card == the same run on the CPU
        within 1e-4, 0 launches;
    (e) (slice 17, run between (b) and (c)) (b)'s run with aux_dtype bf16,
        through dist.steps.make_train_step as the reference's
        launch/hillclimb.py reaches aux_dtype (whisper_bf16_leg);
    (f) (slice 18, run between (a) and (b)) the 32 nodes in full precision
        through gossip_mix (whisper_f32_leg)."""
    t_phase = time.perf_counter()
    out = {}
    # (a)
    a = cli_run(torch, train, exp, WHISPER_ARGV + ["--nodes", "4", "--steps",
                                                   str(STEPS)],
                counters, "whisper (a) 4 nodes", smi)
    D = a.pop("state").x.shape[1]
    if D != WHISPER_D or len(a["losses"]) != STEPS:
        fail(f"whisper (a): D {D}, {len(a['losses'])} steps")
    if a["launches"]["gossip_mix"] != 2 * STEPS or \
            sum(a["launches"].values()) != 2 * STEPS:
        fail(f"whisper (a): launches {a['launches']}; {STEPS} MC-DSGT steps "
             "need 2 gossip_mix each and nothing else")
    print(f"whisper (a): peak device memory "
          f"{predicted('whisper (a)', 'peak_gb', a['peak_gb'])} GB  s/step "
          f"{predicted('whisper (a)', 's_step', statistics.median(a['secs']))}"
          f" (median of {a['secs']})", flush=True)
    out["a"] = {k: a[k] for k in ("launches", "losses", "secs", "peak_gb")}
    out["f"] = whisper_f32_leg(torch, train, exp, ops, ref, counters, smi)
    gc.collect()
    torch.cuda.empty_cache()
    # (b)
    real = ops.quantized_gossip_mix
    for scheme, steps_ in (("int8", STEPS), ("sign", 1)):
        checks = []
        ops.quantized_gossip_mix = held_qmix(torch, ref, real,
                                             f"whisper (b) {scheme}", checks)
        try:
            b = cli_run(torch, train, exp, WHISPER_ARGV + [
                "--nodes", str(WHISPER_NODES), "--compress", scheme,
                "--compress-group", str(WHISPER_GROUP), "--steps",
                str(steps_)], counters,
                f"whisper (b) {WHISPER_NODES} nodes {scheme}", smi)
        finally:
            ops.quantized_gossip_mix = real
        state = b.pop("state")
        if state.x.shape[0] != WHISPER_NODES or len(checks) != 3 * 2 * steps_:
            fail(f"whisper (b) {scheme}: state {tuple(state.x.shape)}, "
                 f"{len(checks)} windows checked")
        del state
        if b["launches"]["quantized_gossip_mix"] != 2 * steps_ or \
                sum(b["launches"].values()) != 2 * steps_:
            fail(f"whisper (b) {scheme}: launches {b['launches']}; "
                 f"{steps_} compressed MC-DSGT steps need 2 "
                 "quantized_gossip_mix each and nothing else")
        print(f"whisper (b) {scheme}: every quantized_gossip_mix launch == "
              f"plain on its first, middle and last {QCHECK_COLS:,} columns "
              f"(flipped entries and max |diff| per window {checks})",
              flush=True)
        if scheme == "int8":
            s_step = statistics.median(b["secs"])
            print(f"whisper (b): peak device memory "
                  f"{predicted('whisper (b)', 'peak_gb', b['peak_gb'])} GB  "
                  f"s/step {predicted('whisper (b)', 's_step', s_step)} "
                  f"(median of {b['secs']})", flush=True)
        out[f"b_{scheme}"] = {k: b[k] for k in ("launches", "losses", "secs",
                                                "peak_gb")}
    gc.collect()
    torch.cuda.empty_cache()
    out["e"] = whisper_bf16_leg(torch, exp, ops, ref, driver, dsteps,
                                counters)
    gc.collect()
    torch.cuda.empty_cache()
    out["c"] = whisper_serve_leg(torch, models, configs, tree, counters)
    out["d"] = softcap_leg(torch, models, configs, tree, counters)
    wall = time.perf_counter() - t_phase
    print(f"whisper phase: wall {predicted('whisper', 'wall_s', wall)} s",
          flush=True)
    out["wall"] = wall
    return out


def whisper_f32_leg(torch, train, exp, ops, ref, counters, smi: str) -> dict:
    """Leg (f) of whisper_phase: whisper-tiny at full width and depth on
    WHISPER_NODES nodes, MC-DSGT R=2 in full precision, STEPS steps through
    the train CLI (the reference's arch trainer runs the same argv): 2
    gossip_mix launches a step at n = 32 (the warp walk) and nothing else,
    each held to the plain version on its own inputs (held_mix); finite
    losses; s/step and peak memory beside their predictions."""
    checks = []
    real = ops.gossip_mix
    ops.gossip_mix = held_mix(torch, ref, real, "whisper (f)", checks)
    try:
        f = cli_run(torch, train, exp, WHISPER_ARGV + [
            "--nodes", str(WHISPER_NODES), "--steps", str(STEPS)], counters,
            f"whisper (f) {WHISPER_NODES} nodes f32", smi)
    finally:
        ops.gossip_mix = real
    state = f.pop("state")
    if state.x.shape != (WHISPER_NODES, WHISPER_D) or len(f["losses"]) != \
            STEPS:
        fail(f"whisper (f): state {tuple(state.x.shape)}, "
             f"{len(f['losses'])} steps")
    del state
    if f["launches"]["gossip_mix"] != 2 * STEPS or \
            sum(f["launches"].values()) != 2 * STEPS or \
            len(checks) != 3 * 2 * STEPS:
        fail(f"whisper (f): launches {f['launches']}, {len(checks)} windows "
             f"checked; {STEPS} MC-DSGT steps need 2 gossip_mix each and "
             "nothing else")
    s_step = statistics.median(f["secs"])
    print(f"whisper (f): every gossip_mix launch == plain on its first, "
          f"middle and last {MIX_CHECK_COLS:,} columns (f32 rtol=atol="
          f"{TOL['float32']}; max |diff| per window {checks})", flush=True)
    print(f"whisper (f): peak device memory "
          f"{predicted('whisper (f)', 'peak_gb', f['peak_gb'])} GB  s/step "
          f"{predicted('whisper (f)', 's_step', s_step)} (median of "
          f"{f['secs']})", flush=True)
    return {k: f[k] for k in ("launches", "losses", "secs", "peak_gb")}


def whisper_bf16_leg(torch, exp, ops, ref, driver, dsteps, counters) -> dict:
    """Leg (e) of whisper_phase: whisper-tiny at full width and depth on
    WHISPER_NODES nodes, MC-DSGT R=2, int8 gossip in groups of
    WHISPER_GROUP, with aux_dtype bf16 (h, g_prev and both residuals stored
    in bf16), STEPS steps on the spec's schedule and batches through
    dist.steps.make_train_step (the reference's train CLI has no flag for
    aux_dtype).  The kernel takes each bf16 residual as stored, beside the
    f32 stream it mixes (x, and the tracker's payload h + g - g_prev): 2
    quantized_gossip_mix launches a step and nothing else, each held to the
    plain version on its own inputs (held_qmix); finite losses; s/step and
    peak memory beside their predictions."""
    spec = exp.with_overrides(exp.ExperimentSpec(), {
        "model.arch": "whisper-tiny", "model.preset": "full",
        "run.nodes": WHISPER_NODES, "algorithm.R": 2,
        "run.gossip_impl": "pallas", "compression.scheme": "int8",
        "compression.group": WHISPER_GROUP})
    built = exp.build(spec, device="cuda")
    params = built.model.init(torch.Generator(device="cuda").manual_seed(0),
                              torch.float32, "cuda")
    checks, losses, by_dtype = [], [], {}
    real = ops.quantized_gossip_mix
    held = held_qmix(torch, ref, real, "whisper (e)", checks)

    def counted(ws, x, res, **kw):
        key = (str(x.dtype).split(".")[1], str(res.dtype).split(".")[1])
        by_dtype[key] = by_dtype.get(key, 0) + 1
        return held(ws, x, res, **kw)
    ops.quantized_gossip_mix = counted
    try:
        torch.cuda.reset_peak_memory_stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        state, launches, secs = planned_steps(
            torch, exp, driver, dsteps, built, params, STEPS, counters,
            losses=losses, gossip_impl="pallas",
            compression=built.rule.compression, aux_dtype=torch.bfloat16)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        ops.quantized_gossip_mix = real
    dtypes = {f: str(getattr(state, f).dtype).split(".")[1]
              for f in ("x", "h", "g_prev")}
    dtypes.update(res_x=str(state.res[0].dtype).split(".")[1],
                  res_h=str(state.res[1].dtype).split(".")[1])
    if dtypes != {"x": "float32", "h": "bfloat16", "g_prev": "bfloat16",
                  "res_x": "bfloat16", "res_h": "bfloat16"}:
        fail(f"whisper (e): state dtypes {dtypes}")
    if state.x.shape != (WHISPER_NODES, WHISPER_D_ALIGNED):
        fail(f"whisper (e): state {tuple(state.x.shape)}")
    del state
    if launches["quantized_gossip_mix"] != 2 * STEPS or \
            sum(launches.values()) != 2 * STEPS or \
            len(checks) != 3 * 2 * STEPS:
        fail(f"whisper (e): launches {launches}, {len(checks)} windows "
             f"checked; {STEPS} compressed MC-DSGT steps need 2 "
             "quantized_gossip_mix each and nothing else")
    if len(losses) != STEPS or not all(map(math.isfinite, losses)):
        fail(f"whisper (e): losses {losses}")
    # both streams mix in f32 beside a bf16 residual: x, and the tracker's
    # payload h + g - g_prev, taken in the gradient's precision (MC-DSGT's
    # correction rides in the mix) before h is stored cast
    if by_dtype != {("float32", "bfloat16"): 2 * STEPS}:
        fail(f"whisper (e): launches by (x, res) dtype {by_dtype}")
    s_step = statistics.median(secs)
    print(f"whisper (e) {WHISPER_NODES} nodes int8 aux_dtype bf16 via "
          f"make_train_step: losses {losses}  step s {secs}  launches "
          f"{launches}; state dtypes {dtypes}; every quantized_gossip_mix "
          f"launch == plain on its first, middle and last {QCHECK_COLS:,} "
          f"columns (flipped entries and max |diff| per window {checks})",
          flush=True)
    print(f"whisper (e): peak device memory "
          f"{predicted('whisper (e)', 'peak_gb', peak_gb)} GB ({held_gb:.3f} "
          f"GB held before the run)  s/step "
          f"{predicted('whisper (e)', 's_step', s_step)} (median of {secs})",
          flush=True)
    del params, built
    return {"launches": launches, "losses": losses, "secs": secs,
            "peak_gb": peak_gb, "by_dtype": by_dtype}


def whisper_serve_leg(torch, models, configs, tree, counters) -> dict:
    """Leg (c) of whisper_phase."""
    from repro_torch.models import encdec
    cfg = configs.get("whisper-tiny")
    model = models.build(cfg)
    B, P, new = WSERVE["batch"], WSERVE["prompt_len"], WSERVE["max_new"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, torch.bfloat16, "cuda")
    frames = 0.02 * torch.randn(B, cfg.encoder_seq, cfg.d_model,
                                generator=gen, device="cuda")
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")
    batch = {"tokens": prompt, "frames": frames.to(torch.bfloat16)}

    def serve():
        cache = model.init_cache(B, P + new, torch.bfloat16, "cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(params, batch, cache)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        toks = [logits[:, -1].argmax(-1)]
        for i in range(new):
            logits, cache = model.decode_step(params, toks[-1][:, None],
                                              cache, P + i)
            toks.append(logits[:, -1].argmax(-1))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return torch.stack(toks[:new], 1), cache, t1 - t0, t2 - t1

    serve()                         # warm-up: first-call costs
    for c in counters.values():
        c.launches = 0
    gen_toks, cache, t_pre, t_dec = serve()
    launches = {k: c.launches for k, c in counters.items()}
    if any(launches.values()):
        fail(f"whisper (c): launches {launches}; the encoder-decoder reaches "
             "no kernel")
    res = {"prefill_tok_s": B * P / t_pre, "decode_tok_s": B * new / t_dec,
           "prefill_s": t_pre, "decode_s": t_dec, "launches": launches}
    steps = {"prefill": lambda: model.prefill(params, batch, model.init_cache(
                 B, P + new, torch.bfloat16, "cuda")),
             "decode step": lambda: model.decode_step(
                 params, gen_toks[:, :1], cache, P + new - 1)}
    for what, fn in steps.items():
        wall_ms, found = profile_once(torch, fn)
        busy = sum(ms for _, ms, _ in found)
        res[f"{what.split()[0]}_idle"] = 1 - busy / wall_ms
        top = sorted(found, key=lambda k: -k[1])[:6]
        print(f"whisper (c) profile of one {what} (bf16, {B} x ({P} tokens "
              f"+ {cfg.encoder_seq} frames)): wall {wall_ms:.3f} ms  device "
              f"busy {busy:.3f} ms (idle share {1 - busy / wall_ms:.4f})  "
              f"kernels {sum(c for _, _, c in found)}  top (ms, calls): "
              + "; ".join(f"{k[:50]} {ms:.3f} x{c}" for k, ms, c in top),
              flush=True)
    del cache
    # the teacher-forced check in f32 from the same weights
    p32 = tree.map(lambda t: t.float(), params)
    seq = torch.cat([prompt, gen_toks], 1)
    full = encdec.forward(p32, cfg, seq, frames)
    c32 = model.init_cache(B, P + new, torch.float32, "cuda")
    logits, c32 = model.prefill(p32, {"tokens": prompt, "frames": frames},
                                c32)
    err = float((logits[:, 0] - full[:, P - 1]).abs().max())
    torch.testing.assert_close(logits[:, 0], full[:, P - 1], rtol=5e-2,
                               atol=5e-3)
    for t in range(P, P + new):
        logits, c32 = model.decode_step(p32, seq[:, t:t + 1], c32, t)
        torch.testing.assert_close(
            logits[:, 0], full[:, t], rtol=5e-2, atol=5e-3,
            msg=lambda m: f"whisper (c) decode {t}: {m}")
        err = max(err, float((logits[:, 0] - full[:, t]).abs().max()))
    res["teacher_forced_max_abs_err"] = err
    rates = {k: predicted("whisper serve", k, res[k])
             for k in ("prefill_tok_s", "decode_tok_s")}
    print(f"whisper (c) serve: {B} x ({cfg.encoder_seq} frames + {P}-token "
          f"prefill + {new} greedy decode steps), bf16: prefill "
          f"{rates['prefill_tok_s']} tok/s, decode {rates['decode_tok_s']} "
          f"tok/s; launches {launches}; f32 teacher-forced prefill + decode "
          f"== forward (rtol 5e-2, atol 5e-3; max |diff| {err:.3e})",
          flush=True)
    del params, p32, full, c32
    gc.collect()
    torch.cuda.empty_cache()
    return res


def softcap_leg(torch, models, configs, tree, counters) -> dict:
    """Leg (d) of whisper_phase."""
    cfg = dataclasses.replace(configs.get("qwen1.5-0.5b").reduced(),
                              logit_softcap=SOFTCAP)
    model = models.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 20),
                           generator=torch.Generator().manual_seed(1))

    def run(dev):
        p = tree.map(lambda t: t.to(dev), params)
        cache = model.init_cache(2, 20, torch.float32, dev)
        outs = [model.prefill(p, {"tokens": tokens[:, :16].to(dev)},
                              cache)[0]]
        for t in range(16, 20):
            outs.append(model.decode_step(p, tokens[:, t:t + 1].to(dev),
                                          cache, t)[0])
        return torch.cat([o.cpu() for o in outs], 1)

    for c in counters.values():
        c.launches = 0
    got = run("cuda")
    launches = {k: c.launches for k, c in counters.items()}
    want = run("cpu")
    err = float((got - want).abs().max())
    if any(launches.values()) or err > 1e-4:
        fail(f"whisper (d) softcap: launches {launches}, max |cuda - cpu| "
             f"{err:.3e} (limit 1e-4)")
    print(f"whisper (d): reduced qwen1.5-0.5b with logit_softcap {SOFTCAP}, "
          f"f32 prefill of 16 + 4 decode steps on the card == on the CPU "
          f"(max |diff| {err:.3e} <= 1e-4); launches {launches}", flush=True)
    return {"max_abs_err": err, "launches": launches}


def main_path(torch, train, argv, counter, name: str) -> dict:
    """Drive one main path through the train CLI with ``counter`` (a
    kernel wrapper's launch count) set to 0 just before it and read just
    after; fail unless it ran STEPS finite steps at 2 launches per step."""
    counter.launches = 0
    torch.cuda.reset_peak_memory_stats()
    history = train.main(argv)
    launches = counter.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    if len(history) != STEPS or not all(
            math.isfinite(h["loss"]) and math.isfinite(h["consensus"])
            for h in history):
        fail(f"{name} path history not {STEPS} finite steps: {history}")
    if launches != 2 * STEPS:
        fail(f"{name} launched {launches} times over {STEPS} MC-DSGT steps; "
             "the x and h windows need 2 per step")
    secs = [h["sec"] for h in history]
    print(f"main path ({name}): {' '.join(argv)}", flush=True)
    print(f"main path ({name}): losses {losses}  step s {secs}  peak device "
          f"memory {peak_gb:.3f} GB  {name} launches {launches}", flush=True)
    return {"launches": launches, "peak_gb": peak_gb, "secs": secs}


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch finds no CUDA device")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs, data, exp, models, serve, sparse, tree
    from repro_torch.core import algorithms as alg, compress, driver, gossip
    from repro_torch.dist import steps
    from repro_torch.kernels import (build, decode_attention,
                                     flash_attention, gossip_matmul,
                                     linear_recurrence, ops, quantized_gossip,
                                     ref, sparse_gossip)
    from repro_torch.launch import serve as serve_cli, train
    from repro_torch.sim import telemetry as sim_telemetry

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__}  CUDA {torch.version.cuda}  "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t_start = t0 = time.perf_counter()
    walls = {}

    def lap(name: str):
        """The wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        walls[name] = round(now - lap.t, 1)
        lap.t = now
    lap.t = t_start
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s "
          f"(nvcc per source, in parallel: {build.BUILD_SECONDS})", flush=True)

    check_kernel(torch, gossip_matmul, ref, gossip)
    kern = time_kernel(torch, gossip_matmul, ref, gossip)
    check_qkernel(torch, quantized_gossip, ref, gossip)
    check_qkernel_inputs(torch, quantized_gossip, ref, gossip)
    qkern = time_qkernel(torch, quantized_gossip, ref, gossip)
    if steps.flat_layout(models.build(configs.get("whisper-tiny")),
                         compress.CompressionConfig(
                             scheme="int8", group=WHISPER_GROUP)
                         ).size != WHISPER_D_ALIGNED:
        fail("whisper-tiny's 32-node state is not WHISPER_D_ALIGNED wide")
    wshape = dict(n=WHISPER_NODES, D=WHISPER_D_ALIGNED, group=WHISPER_GROUP)
    qkern_w = time_qkernel(torch, quantized_gossip, ref, gossip, **wshape,
                           label="whisper-tiny 32-node shape")
    # whisper (e)'s launches (an f32 stream beside a bf16 residual), and
    # x and res both in bf16 (timed only: no path mixes a bf16 stream)
    qkern_wb = {dt: time_qkernel(torch, quantized_gossip, ref, gossip,
                                 **wshape, dtypes=dt,
                                 label=f"whisper-tiny 32-node shape, {dt}")
                for dt in (("float32", "bfloat16"), ("bfloat16", "bfloat16"))}
    # the stream route where PR 28 timed it (group 1024, which the ring
    # takes since slice 17), launched by name, and the ring there; the
    # stream route where launch_geometry picks it (group 4096); the ring
    # past 64 nodes (no path of the smoke reaches these)
    qkern_s = {
        label: time_qkernel(torch, quantized_gossip, ref, gossip,
                            n=n_, D=D_, group=g_, route=route_, label=label)
        for label, n_, D_, g_, route_ in (
            ("stream route at the 32-node width, group 1024", WHISPER_NODES,
             STREAM_D, STREAM_GROUP, "stream"),
            ("ring route at the 32-node width, group 1024", WHISPER_NODES,
             STREAM_D, STREAM_GROUP, None),
            ("stream route at the 32-node width, group 4096", WHISPER_NODES,
             WIDE_GROUP_D, WIDE_GROUP, None),
            (f"ring route past 64 nodes, n = {PAST64_NODES}", PAST64_NODES,
             PAST64_D, GROUP, None))}
    # gossip_mix at whisper-tiny's 32-node f32 shape (leg (f)'s path), and
    # timed only: at n = 128 (FMA-bound) and with bf16 x at 32 nodes
    print_gossip_resources(torch, gossip_matmul)
    kern_w = time_kernel(torch, gossip_matmul, ref, gossip, n=WHISPER_NODES,
                         D=WHISPER_D, label="whisper-tiny 32-node shape")
    kern_wide = time_kernel(torch, gossip_matmul, ref, gossip,
                            n=GOSSIP_WIDE_NODES, D=GOSSIP_WIDE_D,
                            label=f"n = {GOSSIP_WIDE_NODES}", rounds_=1)
    kern_wb = time_kernel(torch, gossip_matmul, ref, gossip, n=WHISPER_NODES,
                          D=WHISPER_D, dtype=torch.bfloat16,
                          label="whisper-tiny 32-node shape, bf16 x",
                          rounds_=1)
    check_skernel(torch, sparse_gossip, ref, ops)
    check_lkernel(torch, linear_recurrence, ref)
    lkern = time_lkernel(torch, linear_recurrence, ref)
    lkern_rg = time_lkernel(torch, linear_recurrence, ref, LINREC_RG,
                            "one recurrentgemma rglru layer")
    print_attention_resources(torch, flash_attention, decode_attention)
    check_fkernel(torch, flash_attention, ref)
    fkern = time_fkernel(torch, flash_attention, ref)
    fkern_rg = time_fkernel(torch, flash_attention, ref, FLASH_RG, RG_WINDOW,
                            "one recurrentgemma prefill layer")
    fkern_yi = time_fkernel(torch, flash_attention, ref, FLASH_YI, 0,
                            "one yi-6b prefill layer")
    fkern_mt = time_fkernel(torch, flash_attention, ref, FLASH_MT, 0,
                            "one minitron-4b prefill layer")
    check_dkernel(torch, decode_attention, ref)
    dkern = time_dkernel(torch, decode_attention, ref)
    dkern_rg = time_dkernel(torch, decode_attention, ref, DECODE_RG,
                            RG_WINDOW, "one recurrentgemma decode layer")
    dkern_yi = time_dkernel(torch, decode_attention, ref, DECODE_YI, 0,
                            "one yi-6b decode layer")
    dkern_mt = time_dkernel(torch, decode_attention, ref, DECODE_MT, 0,
                            "one minitron-4b decode layer")
    fkern_gr = time_fkernel(torch, flash_attention, ref, FLASH_GR, 0,
                            "one granite-moe-3b-a800m prefill layer")
    dkern_gr = time_dkernel(torch, decode_attention, ref, DECODE_GR, 0,
                            "one granite-moe-3b-a800m decode layer")
    fkern_nm = time_fkernel(torch, flash_attention, ref, FLASH_NM, 0,
                            "one nemotron-4-340b prefill layer")
    dkern_nm = time_dkernel(torch, decode_attention, ref, DECODE_NM, 0,
                            "one nemotron-4-340b decode layer")
    dkern_g48 = time_dkernel(torch, decode_attention, ref, DECODE_G48, 0,
                             "a G = 48 decode layer")
    print(f"device_ms: launches the profiler did not record in the kernel "
          f"timings above: {device_ms.lost_total}; sessions that recorded "
          f"none and were run again: {device_ms.empty_sessions}", flush=True)
    lap("build, kernel checks and timings")
    check_small_run(torch, exp)
    check_small_compressed_run(torch, exp)

    # the main paths: each kernel's count from 0 just before its path
    lap("small runs")
    plain = main_path(torch, train, MAIN_ARGV, gossip_matmul.gossip_mix,
                      "gossip_mix")
    profile_step(torch, exp, steps)
    gossip_matmul.gossip_mix.launches = 0
    comp = main_path(torch, train, COMPRESSED_ARGV,
                     quantized_gossip.quantized_gossip_mix,
                     "quantized_gossip_mix")
    if gossip_matmul.gossip_mix.launches:
        fail("the compressed path (no warmup) launched gossip_mix")
    D = MAIN["D"]
    print(f"int8 payload per node and round: "
          f"{compress.payload_bytes(D, 'int8', GROUP)} bytes against "
          f"{compress.payload_bytes(D, 'none')} in f32 (the wire format's "
          "price; one card moves no bytes between nodes)", flush=True)
    profile_step(torch, exp, steps, scheme="int8")

    lap("main paths (slices 1-2)")
    counters = {"gossip_mix": gossip_matmul.gossip_mix,
                "quantized_gossip_mix": quantized_gossip.quantized_gossip_mix,
                "sparse_segment_mix": sparse_gossip.sparse_segment_mix,
                "linear_recurrence": linear_recurrence.linear_recurrence,
                "flash_attention": flash_attention.flash_attention,
                "decode_attention": decode_attention.decode_attention}
    res_a, plan, rounds, sampled = sampled_paths(torch, train, exp, alg,
                                                 driver, sparse, counters)
    skern = time_skernel(torch, sparse_gossip, ref, driver, plan,
                         res_a.state.x, rounds)
    del res_a, plan
    gc.collect()
    torch.cuda.empty_cache()

    lap("sampled paths (slice 3)")
    model, fleet = draw_fleet(torch, models, configs, tree, "falcon-mamba-7b",
                              FALCON_PARAMS, SERVE["fleet"])
    served = serve_path(torch, exp, serve, ops, linear_recurrence, ref, model,
                        fleet, counters)
    check_sequential(torch, exp, serve, model, fleet, tree,
                     served["completed"], SERVE)
    profile_serve(torch, model, fleet, tree, SERVE, ("linear_recurrence",))
    del model, fleet
    gc.collect()
    torch.cuda.empty_cache()

    lap("falcon-mamba-7b serve")
    phase = (torch, exp, serve, ops, flash_attention, decode_attention,
             linear_recurrence, ref, models, configs, tree, counters)
    qserved = attention_serve_phase(*phase, "qwen1.5-0.5b", QWEN_PARAMS,
                                    QSERVE, "qwen serve path")

    lap("qwen1.5-0.5b serve")
    served_cli = serve_cli_path(torch, serve_cli, counters)
    gc.collect()
    torch.cuda.empty_cache()

    lap("serve CLI")
    rgserved = attention_serve_phase(*phase, "recurrentgemma-2b", RG_PARAMS,
                                     RGSERVE, "recurrentgemma serve path")

    lap("recurrentgemma-2b serve")
    dense_served = {
        arch: attention_serve_phase(*phase, arch, n_params, sv,
                                    f"{arch} serve path", HD128_LAYERS)
        for arch, n_params, sv in (("yi-6b", YI_PARAMS, YSERVE),
                                   ("minitron-4b", MINITRON_PARAMS, MSERVE))}

    lap("yi-6b and minitron-4b serve")
    gserved = attention_serve_phase(*phase, "granite-moe-3b-a800m",
                                    GRANITE_PARAMS, GSERVE,
                                    "granite-moe-3b-a800m serve path",
                                    GRANITE_SERVE_LAYERS)
    lap("granite-moe-3b-a800m serve")
    nserved = attention_serve_phase(*phase, "nemotron-4-340b",
                                    NEMOTRON_PARAMS, NSERVE,
                                    "nemotron-4-340b serve path",
                                    NEMOTRON_LAYERS)
    lap("nemotron-4-340b serve")
    trained = arch_train_phase(torch, train, exp, models, configs, tree,
                               counters, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("arch train (internvl2-1b, granite-moe, falcon-mamba)")
    whispered = whisper_phase(torch, train, exp, ops, ref, models, configs,
                              tree, driver, steps, counters, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("whisper-tiny (slice 16)")
    logreg_phase(torch, exp, counters)
    gc.collect()
    torch.cuda.empty_cache()
    lap("§6")
    planned = planning_phase(torch, train, exp, alg, driver, steps, data,
                             counters)
    gc.collect()
    torch.cuda.empty_cache()
    lap("planning")
    wireless = wireless_phase(torch, train, exp, ops, ref, sim_telemetry,
                              counters, smi)
    gc.collect()
    torch.cuda.empty_cache()
    lap("wireless/async")
    observed = obs_phase(torch, train, exp, counters, smi, plain["secs"])
    gc.collect()
    torch.cuda.empty_cache()
    lap("obs and checkpoints")
    spec_smoke_phase(torch, exp, counters)

    rows = [
        {"name": "gossip_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/gossip_mix.cu",
         "replaces": "src/repro/kernels/gossip_matmul.py:36",
         "launches": plain["launches"],
         "launches_per_step": plain["launches"] / STEPS,
         "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
         "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
         "bound_by": kern["bound_by"], "library_ms": kern["library_ms"],
         "shape": kern["shape"], "geometry": kern["geometry"],
         "resources": kern["resources"]},
        {"name": "quantized_gossip_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/quantized_gossip_mix.cu",
         "replaces": "src/repro/kernels/quantized_gossip.py:62",
         "launches": comp["launches"],
         "launches_per_step": comp["launches"] / STEPS,
         "max_abs_err": qkern["max_abs_err"], "ms": qkern["ms"],
         "plain_ms": qkern["plain_ms"], "bound_ms": qkern["bound_ms"],
         "bound_by": qkern["bound_by"], "library_ms": qkern["library_ms"],
         "shape": qkern["shape"]},
        {"name": "sparse_segment_mix", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_segment_mix.cu",
         "replaces": "src/repro/kernels/sparse_gossip.py:51",
         "launches": sampled["launches"],
         "launches_per_step": sampled["launches"] / SAMPLED_STEPS,
         "max_abs_err": skern["max_abs_err"], "ms": skern["ms"],
         "plain_ms": skern["plain_ms"], "bound_ms": skern["bound_ms"],
         "bound_by": skern["bound_by"], "library_ms": skern["library_ms"],
         "shape": skern["shape"], "wrapper_host_us": skern["host_us"],
         "variant": skern["variant"], "resources": skern["resources"],
         "timed": "device time under torch.profiler per round (each "
         "kernel's mean recorded launch times its launches a call), kernel "
         "and library in turns (k, l, l, k), mean over the rounds of path A, "
         "in a fresh process (examples/torch/sparse_compare.py); library = "
         "torch.sparse.mm (CSR)"},
        {"name": "linear_recurrence", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/linear_recurrence.cu",
         "replaces": "src/repro/kernels/linear_recurrence.py:50",
         "launches": served["launches"],
         "launches_per_prefill": served["launches"] / SERVE["requests"],
         "max_abs_err": lkern["max_abs_err"], "ms": lkern["ms"],
         "plain_ms": lkern["plain_ms"], "bound_ms": lkern["bound_ms"],
         "bound_by": lkern["bound_by"], "library_ms": lkern["library_ms"],
         "shape": lkern["shape"], "variant": lkern["variant"],
         "geometry": lkern["geometry"], "resources": lkern["resources"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:74",
         "launches": qserved["launches"]["flash_attention"],
         "launches_per_prefill":
             qserved["launches"]["flash_attention"] / QSERVE["requests"],
         "max_abs_err": fkern["max_abs_err"], "ms": fkern["ms"],
         "plain_ms": fkern["plain_ms"], "bound_ms": fkern["bound_ms"],
         "bound_by": fkern["bound_by"], "library_ms": fkern["library_ms"],
         "shape": fkern["shape"], "wrapper_host_us": fkern["wrapper_host_us"],
         "timed": "device time under "
         "torch.profiler, inputs cold in L2; library = "
         "scaled_dot_product_attention"},
        {"name": "decode_attention", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
         "replaces": "src/repro/kernels/decode_attention.py:69",
         "launches": qserved["launches"]["decode_attention"],
         "launches_per_slot_token":
             qserved["launches"]["decode_attention"]
             / (QSERVE["requests"] * (QSERVE["max_new"] - 1)),
         "max_abs_err": dkern["max_abs_err"], "ms": dkern["ms"],
         "plain_ms": dkern["plain_ms"], "bound_ms": dkern["bound_ms"],
         "bound_by": dkern["bound_by"], "library_ms": dkern["library_ms"],
         "shape": dkern["shape"], "wrapper_host_us": dkern["wrapper_host_us"],
         "timed": "device time under "
         "torch.profiler, the cache cold in L2; library = "
         "scaled_dot_product_attention with a boolean mask from kpos"},
    ]
    # gossip_mix on the gossip-planning path: MC-DSGT through
    # gossip_impl='auto', auto_dense='pallas' on ring (the same kernel at
    # the same shape as the first row)
    base = rows[0]
    rows.append({**{k: base[k] for k in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "path": "gossip planning: mc_dsgt on ring, auto + auto_dense=pallas",
        "launches": planned["auto+pallas"]["launches"],
        "launches_per_step": planned["auto+pallas"]["launches"]
        / PLAN_STEPS})
    # the two gossip kernels on the wireless / async path: the stale window
    # mixed through them on the realized waypoint-mobility schedule (the
    # same kernels at the same shapes as the first two rows)
    for i, path, leg, steps_ in (
            (0, "wireless/async (a): delayed mc_dsgt, waypoint mobility, 20% "
             "link drop", "a", STEPS),
            (1, "wireless/async (b): delayed mc_dsgt int8, waypoint mobility, "
             "20% link drop", "b", STEPS),
            (0, "wireless/async (c): comm_interval 2 in a delay of 1", "c",
             INTERVAL_STEPS)):
        base = rows[i]
        rows.append({**{k: base[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            "path": path, "launches": wireless[leg]["launches"][base["name"]],
            "launches_per_step": wireless[leg]["launches"][base["name"]]
            / steps_})
    # gossip_mix on the observability and checkpoint legs: (a) the main
    # path with --metrics and --profile-dir, (b) 3 + 2 + 1 steps on 2
    # nodes (the kernel at n = 2, as the first row's at n = 4 otherwise)
    base = rows[0]
    for path, launches, steps_ in (
            ("obs (a): main path with --metrics and --profile-dir",
             observed["a"]["launches"]["gossip_mix"], STEPS),
            ("checkpoint (b): 2 nodes, 3 straight + 2 with --checkpoint + "
             "1 after --restore", observed["b"]["launches"], 6)):
        rows.append({**{k: base[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            "path": path, "launches": launches,
            "launches_per_step": launches / steps_})
    # gossip_mix on slice 15's training paths: internvl2-1b, and granite-moe
    # and falcon-mamba at their published widths, depth cut (the kernel at
    # n = 4 and D ~ 0.48-0.49 G, the first row's at 0.46 G)
    base = rows[0]
    for path, launches, steps_ in (
            ("arch train (b): internvl2-1b, full width",
             trained["b"]["launches"]["gossip_mix"], STEPS),
            ("arch train (c): granite-moe-3b-a800m, 4 layers, 3 straight + "
             "2 with --checkpoint + 1 after --restore",
             trained["c"]["launches"], 6),
            ("arch train (d): falcon-mamba-7b, 2 layers",
             trained["d"]["launches"]["gossip_mix"], STEPS)):
        rows.append({**{k: base[k] for k in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
            "path": path, "launches": launches,
            "launches_per_step": launches / steps_})
    # slice 16: gossip_mix on whisper-tiny's 4-node training (the kernel at
    # n = 4, D = 36.4M), and quantized_gossip_mix on its 32-node int8
    # training, timed at that shape on its ring route (since slice 17)
    base = rows[0]
    rows.append({**{k: base[k] for k in (
        "name", "route", "source", "replaces", "max_abs_err", "ms",
        "plain_ms", "bound_ms", "bound_by", "library_ms", "shape")},
        "path": "whisper (a): whisper-tiny, 4 nodes",
        "launches": whispered["a"]["launches"]["gossip_mix"],
        "launches_per_step": whispered["a"]["launches"]["gossip_mix"]
        / STEPS})
    # slice 18: gossip_mix on whisper-tiny's 32-node f32 training, timed
    # at that shape
    gkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "geometry", "resources")
    n_ = whispered["f"]["launches"]["gossip_mix"]
    rows.append({**{k: base[k] for k in ("name", "route", "source",
                                         "replaces")},
                 "path": f"whisper (f): whisper-tiny, {WHISPER_NODES} nodes, "
                 f"f32 ({STEPS} steps)",
                 "launches": n_, "launches_per_step": n_ / STEPS,
                 **{k: kern_w[k] for k in gkeys}})
    base = rows[1]
    qkeys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "geometry", "resources")
    launches = (whispered["b_int8"]["launches"]["quantized_gossip_mix"]
                + whispered["b_sign"]["launches"]["quantized_gossip_mix"])
    rows.append({**{k: base[k] for k in ("name", "route", "source",
                                         "replaces")},
                 "path": f"whisper (b): whisper-tiny, {WHISPER_NODES} nodes, "
                 f"int8 ({STEPS} steps) then sign (1), group "
                 f"{WHISPER_GROUP}",
                 "launches": launches, "launches_per_step": launches
                 / (STEPS + 1),
                 **{k: qkern_w[k] for k in qkeys},
                 "variant": qkern_w["route"]})
    # slice 17: whisper (e), aux_dtype bf16: every launch an f32 stream
    # beside a bf16 residual, timed at that shape
    dt = ("float32", "bfloat16")
    kern = qkern_wb[dt]
    n_ = whispered["e"]["by_dtype"][dt]
    rows.append({**{k: base[k] for k in ("name", "route", "source",
                                         "replaces")},
                 "path": f"whisper (e): whisper-tiny, {WHISPER_NODES} nodes, "
                 f"int8, aux_dtype bf16 ({STEPS} steps)",
                 "launches": n_, "launches_per_step": n_ / STEPS,
                 **{k: kern[k] for k in qkeys}, "variant": kern["route"]})
    # the same three kernels at recurrentgemma-2b's serve shapes, then the
    # attention kernels at yi-6b's and minitron-4b's (head_dim 128) and at
    # granite-moe-3b-a800m's (head_dim 64, G = 3)
    for path, served_, sv, kerns in (
            ("recurrentgemma-2b serve", rgserved, RGSERVE,
             (("linear_recurrence", lkern_rg), ("flash_attention", fkern_rg),
              ("decode_attention", dkern_rg))),
            ("yi-6b serve", dense_served["yi-6b"], YSERVE,
             (("flash_attention", fkern_yi), ("decode_attention", dkern_yi))),
            ("minitron-4b serve", dense_served["minitron-4b"], MSERVE,
             (("flash_attention", fkern_mt),
              ("decode_attention", dkern_mt))),
            ("granite-moe-3b-a800m serve", gserved, GSERVE,
             (("flash_attention", fkern_gr),
              ("decode_attention", dkern_gr))),
            ("nemotron-4-340b serve", nserved, NSERVE,
             (("flash_attention", fkern_nm),
              ("decode_attention", dkern_nm)))):
        n, new = sv["requests"], sv["max_new"]
        for name, kern in kerns:
            per, unit = ((n * (new - 1), "launches_per_slot_token")
                         if name == "decode_attention"
                         else (n, "launches_per_prefill"))
            base = next(r for r in rows if r["name"] == name)
            row = {k: base[k] for k in ("name", "route", "source",
                                        "replaces")}
            row.update(
                path=path, launches=served_["launches"][name],
                max_abs_err=kern["max_abs_err"], ms=kern["ms"],
                plain_ms=kern["plain_ms"], bound_ms=kern["bound_ms"],
                bound_by=kern["bound_by"], library_ms=kern["library_ms"],
                shape=kern["shape"])
            row[unit] = served_["launches"][name] / per
            if "geometry" in kern:
                row.update({k: kern[k] for k in ("variant", "geometry",
                                                 "resources")})
            if "wrapper_host_us" in kern:
                row.update(wrapper_host_us=kern["wrapper_host_us"],
                           timed=base["timed"])
            rows.append(row)
    # timed only: the kernels at shapes no path of the smoke launches
    qkern_s["whisper-tiny 32-node shape, x and res bf16"] = \
        qkern_wb["bfloat16", "bfloat16"]
    timed_only = [{"name": "quantized_gossip_mix", "path": label,
                   **{k: kern[k] for k in qkeys}, "variant": kern["route"]}
                  for label, kern in qkern_s.items()]
    timed_only += [{"name": "gossip_mix", "path": label,
                    **{k: kern[k] for k in gkeys}}
                   for label, kern in (
                       (f"n = {GOSSIP_WIDE_NODES} at whisper-tiny's 32-node "
                        "bytes", kern_wide),
                       ("whisper-tiny's 32-node shape, bf16 x", kern_wb))]
    timed_only.append({"name": "decode_attention",
                       "path": "G = 48 (three row groups), hd 192",
                       **{k: dkern_g48[k] for k in (
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms", "shape",
                           "wrapper_host_us")}})
    lap("spec smoke")
    print(f"chip_smoke phase walls (s): {walls}", flush=True)
    print(f"chip_smoke wall time {time.perf_counter() - t_start:.1f} s "
          "(kernels' build included)", flush=True)
    print(json.dumps({"kernels": rows, "timed_only": timed_only}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
