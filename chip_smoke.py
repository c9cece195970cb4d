#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py              # every phase, then the result line
    python3 chip_smoke.py --kernels    # phases 1 and 2 only, no result line
    python3 chip_smoke.py --sharded    # phase 1 and the sharded phase only
    python3 chip_smoke.py --sec5       # phase 1 and the Sec. V phase only
    python3 chip_smoke.py --lm-sharded # phase 1 and the sharded LM step only
    python3 chip_smoke.py --train llama-3.2-vision-90b,mixtral-8x22b
                                       # phase 1 and those training phases
    python3 chip_smoke.py --warm-flex  # compile the flex_attention library
                                       # calls into build/'s caches, exit

Run from the root of a checkout; it needs one CUDA card and `nvcc` (the
kernels are built from src/repro_torch/kernels/csrc at first use). Phases:

  1. set-up: card name and power limit, deterministic cuBLAS, TF32 off,
     kernel build (timed), and the HGMMA (tensor-core) and UTMALDG (TMA
     load) instructions of each flash-attention (forward and backward) and
     SSD-chunk function in the built library's SASS (cuobjdump runs beside
     the later phases and is read before the result line): the run fails
     if a bf16 tensor-core instantiation has no HGMMA, a TMA-fed one (kernel
     8 at D 64 / 128, the SSD chunk) no UTMALDG, or one of the seven
     tensor-core kernels (kernel 8's warp-specialised one at D 64 / 128 and
     its D 256 one, the backward's dk/dv and dq at D 64 / 128 and at D 256,
     where the two warpgroups of a block split D, the SSD chunk) is
     missing; ptxas's registers, spills and stack frames of the LM kernels
     and of the round's mask, histogram, aggregate and masked-update
     kernels (every instantiation), and where it serialized a kernel's
     wgmma instructions;
  2. every kernel against its plain PyTorch version at the main paths'
     shapes (LeNet packed: R = 1024; C in {1, 3, 8} for the round's masks,
     every C from 1 to 33 for the weighted aggregate, with zero-weight
     clients holding NaN at the front, in the middle, at the end or
     everywhere and with non-unit and subnormal weights, C in {1, 3, 8, 10,
     16, 33} for the rank sort (also with a subnormal weight, which must
     sort its client last as weight 0 does) and the unweighted aggregate;
     the masked update with keep-masks, masks of other values and NaN and
     inf in w),
     bit for bit, with its per-call time, its device time, the plain
     version's time, its bound and, where one PyTorch call computes the
     same function, that call's time; and the contract that the unweighted
     aggregate equals the weighted one with unit weights. The histogram
     also repeats ten calls bit for bit and is timed on round 0's all-zero
     q; the weighted aggregate is also timed at the slices' own mixes (8
     clients with 2 padding, 10 clients); the histogram, the
     shared-threshold mask, the weighted aggregate and the masked update
     also at R = 65,536, where bytes decide; kernels 1-4 also at
     ResNet-20's packed shape (R = 2,304, its prunable mask, spec C's 4
     clients); the aggregate kernels (weighted, unweighted, masked update)
     also on subnormal gradients, with products that round up to FLT_MIN;
  3. the pruned-FedSGD path: the paper's pipeline on synthetic-mnist (10
     clients, sigma = 5) with the `proposed` AO schedule at E0 = 25 J,
     T0 = 15 s over 40 rounds, LeNet from a seeded init, trained once by
     the packed backend (its default: 32-round blocks on CUDA graphs,
     kernel launches counted with the replays) and once by the reference
     backend; parameters must agree bit for bit, the broadcast gradient as
     values, and test accuracy at the last round must exceed 0.2; then five
     packed rounds of one round a dispatch under torch.profiler (device
     busy time, top kernels);
  4. the attack slice (the JAX package's benchmarks/robust_aggregation.py
     cell at a 30 % attack): 10 clients, sigma = 1, `fixed_selection` at
     unbounded budgets over 60 rounds, every client selected every round,
     three of them uploading 10x their gradient (ScaledMalicious, exact),
     under the mean, the coordinate-wise median and the trimmed mean
     (beta = 0.35), each on both backends: parameters and losses bit for
     bit, the counters exact (180 corrupt-but-finite uploads; 480 excluded,
     360 trimmed), the rank sort launched every round of the robust packed
     runs, and the robust reducers ahead of the attacked mean at round 59;
  5. fault axes, 10 rounds each on the attack slice's set-up, packed against
     reference bit for bit with equal counters: mixed dropout + NaN uploads
     and NaN uploads alone on the mean path (the quarantine and zero
     weights in the aggregate kernel), Gaussian poison under norm
     clipping, sign flips under multi-Krum with channel noise;
  6. the entry points that no trainer path calls: one FedSGD step of the
     unweighted aggregate over ten clients' uploads at the trained attack
     model, and the pruned-checkpoint masked update, packed and per leaf;
  7. the quickstart through the experiment API (repro_torch.api): spec A
     is examples/quickstart.py's (`proposed_exact`, E0 = 250 J, T0 = 150
     s, one client a round), spec B the same with `proposed` at 25 J / 15
     s (8 clients a round, per-client lambda), 40 rounds of LeNet each,
     run three ways: "auto" (32-round blocks, each round a CUDA-graph
     replay), one round a dispatch and the reference backend; parameters
     bit for bit, v as values, equal histories, no batch uploaded by the
     blocks, graph replays (with the eager round each capture follows)
     equal to the block rounds, each round kernel once a round on both
     packed paths; a timed 4-round window of each packed path, its first
     round profiled (device busy, idle share, the host's CUDA calls a
     round); kill
     after round 20's checkpoint and `resume_from_checkpoint`, bit for bit
     the uninterrupted blocked run;
     then (34.) the paper's Sec. V comparison (benchmarks/common.py's six
     SCHEMES at examples/feel_paper_reproduction.py's settings: 10
     clients, sigma = 1, E0 = 4 J, T0 = 40 s, LeNet, 60 rounds, evaluation
     every 25) at seed 0 as one sweep through repro_torch.api.run_sweep,
     32-round blocks on CUDA graphs: every scheme's schedule as run, rounds
     completed and budgets spent bit for bit the JAX reference's
     (tests/torch_fixtures/sec5_jax.json), kernels 1-4 read for each cell
     (histogram and aggregate once a round, the two mask kernels once a
     round together), fixed_pruning (lambda = 0) and fixed_selection also
     one round a dispatch and on the reference backend, bit for bit the
     blocked run; the seed-0 table beside JAX's seed 0 and JAX's 8-seed
     mean;
  8. the paper's CIFAR-10 path through the experiment API, spec C
     (benchmarks/common.py's synthetic-cifar10 cell: 10 clients, sigma = 1,
     ResNet-20 at 272,250 coordinates packed [2304, 128], `proposed` at
     E0 = 4 J, T0 = 40 s, eta 0.1, batch 32): first ResNet-20's and
     LeNet's gradients against fp64 ones (within 1e-3 relative L2 under
     the engine's scope; TF32, the planted fault, outside it), the ReLUs
     whose input took the other sign than in fp64 beside each; FedSGD over
     50 rounds (its schedule spends past the budget, so the budget stop is
     off), FedProx (E = 2, mu 0.01) and FedAvg at E = 3 over 10 and FedDyn
     (E = 2, alpha 0.01) over 12, each three ways as in phase 7; parameters
     and FedDyn's
     state bit for bit, v as values, equal histories, the last round's
     train loss below round 0's; steady 4-round windows of FedSGD and
     FedDyn, blocked and per round (one round of each profiled); kill
     after round 10's checkpoint of the blocked FedDyn run and resume, bit
     for bit with h;
  9. fleet streaming through the experiment API (random_k: 8 clients a
     round at lambda 0.5, so kernels 2-4 prune; batch 4, 8-round blocks,
     unbounded budgets, evaluation off): (a) LeNet over a 1,000-client
     synthetic-fleet roster (24 samples a client on average), 64 rounds,
     client_store "streamed", "replicated" and the reference backend:
     parameters bit for bit, v as values, equal histories, 8 cohort
     swaps, the streamed run's graph captures equal to the replicated
     run's, kernels 2-4 once a round (their launches go into the kernels
     line as `fleet_launches`); kill after round 32's checkpoint of a
     streamed run and resume, bit for bit; (b) FedDyn (E = 2, alpha 0.01)
     over 32 rounds of the same roster, streamed == replicated bit for bit,
     h included; (c) ResNet-20 at full width over a 50,000-client
     synthetic-fleet-cifar roster (2 samples a client on average), 32
     rounds, client_store "auto": its ~1.8 GB replicated estimate is over
     the 1 GiB budget, so it must stream; env build s, ms a round, H2D
     bytes, peak cohort bytes (per sample within 4x of (a)'s), prefetch
     stall and captures printed;
 10. the sweep service: four cells, (synthetic-mnist, lenet) and
     (synthetic-cifar10, resnet) zipped over seeds 0 and 1, 10 rounds
     each, run with workers=1 and workers=2 (two ResNet cells in flight):
     per-run JSONL byte-identical, one environment build per group; then
     a sweep killed during its third cell and resumed with workers=2,
     byte-identical again;
     then (24.) the sharded client axis: two gloo ranks spawned on the
     card (torch.multiprocessing, a file:// rendezvous) after the kernels
     are built, each running spec B cut to 12 rounds (4-round blocks on
     capture-split CUDA graphs, and one round a dispatch), the attack
     slice's coordinate-wise median over 8 rounds, FedDyn (E = 2, alpha
     0.1) on spec B over 8 rounds and fleet (a) over 16 rounds streamed
     with sharded cohorts and replicated, beside the unsharded runs here:
     sharded blocks == sharded rounds, median and FedDyn sharded ==
     unsharded, streamed == replicated, bit for bit; the mean path's v
     the host's shard-order replay of its gathered partials bit for bit
     and w within 1e-6 of the unsharded run's; both ranks' (w, v) equal
     after every block; one collective a round; launches per rank as
     predicted (kernel 3 off the sharded mean path); each rank's cohort
     rows its own clients', at about half the unsharded cohort's bytes;
     ms a round at 1 and 2 ranks and the gather's ms a round printed;
 11. the LM stack's kernels against their plain versions in bf16 (the
     JAX package's bf16 kernel tolerance, 2e-2): flash attention at
     granite's prefill buckets and at gemma2's head dim 256 with its
     softcap in its bend, globally and under a window of 256 that masks
     keys (each branch must change the result), at whisper's heads (12/12
     of 64, g = 1), llama-vision's (64/8 of 128, g = 8) and arctic's 1024
     bucket (56/8 of 128, g = 7), decode
     attention with
     ragged positions at granite's and gemma2's cache shapes, the SSD chunk
     at mamba2's shapes; times, bounds and the library call
     (scaled_dot_product_attention; under gemma2's softcap flex_attention,
     compiled: a child process, `--warm-flex`, started after phase 2
     compiles every softcapped row's call into build/'s caches beside
     the federated phases and is waited for here) beside them, the device
     time summed
     over every kernel the wrapper launches per call;
 12. granite-3-2b at full width in bf16, its depth cut from 40 to 4
     layers (random weights, seed 0), served by the continuous-batching
     engine through the flash kernel:
     16 greedy requests of 16 tokens, prompts of 130-1000 tokens, on 8
     slots; flash launches == 4 x 16, engine tokens == a sequential
     generation over the same padded prefill (the first request of each
     bucket and one in a reused slot); the prefill's last-token
     logits in fp32 on the same weights within 1e-3 (relative L2) of the
     naive path's, with a planted fault (keys one position late) above
     that limit, and every flash launch of the bf16 prefill within 2e-2
     of the plain version on its own inputs; then a profiled window; and
     the decode kernel on the served caches, every
     layer, each row at its last request's position;
 13. mamba2-130m at full width in bf16, 6 of its 24 layers, served to
     8 requests on 4 slots
     (slots reused; tokens == a fresh sequential generation), and the SSD
     entry point on layer 0's real inputs for a 512-token prompt: its 4
     chunks in one ssd_chunk launch, within bf16 of the CPU's run and of
     the model's scan; the wgmma kernel timed on one real chunk and the
     whole entry call timed beside its bound;
     then (16.) hymba-1.5b at full width, 2 of its 32 layers (25/5
     heads of 64, window 1,024 beside the SSM mixer) and (17.)
     mixtral-8x22b at full width, 2 of its 56 layers (48/8 heads of 128,
     8 experts of top 2), served as granite is: flash launches == layers
     x 16, engine == sequential (mixtral's over the same padded prefill:
     padding shares expert capacity), every admitted hymba slot's SSM
     state and conv window zero when its prefill starts (hymba prefills
     the exact, ragged length through kernel 8), the fp32 logits check
     (mixtral's on a copy of its first two layers); then (21.)
     whisper-small at full width, 12 encoder and 4 of its 12 decoder
     layers (12/12 heads of 64: kernel
     8 at g = 1) on 8 slots, 16 requests of 16 tokens, prompts of 130-440
     tokens padded to (256, 512), and (22.) llama-3.2-vision-90b at full
     width on one group of 5 of its 100 layers (4 self layers of 64/8
     heads of 128: g = 8, and a gated cross layer) on granite's traffic,
     its gates opened to 1 before every check (at 0 the cross path adds
     nothing); each with one memory shared by every request (an encoder
     input [1, 1500, 768], a vision input [1, 1601, 8192], numpy seed 1),
     served and checked as granite is (flash launches == self layers x
     16), and another memory must move the prefill's logits; then (26.)
     gemma2-9b at full width on 4 of its 42 layers (2 local with a 4,096
     ring, 2 global; 16/8 heads of 256, softcap 50 in kernel 8, 30 on the
     logits, a tied 256,000 x 3,584 embedding) on granite's traffic cut to
     15 requests plus one of exactly 4,609 tokens, whose 4,608-token
     prefill fills its bucket with no padding, passes the window (kernel 8
     masks keys on the local layers) and wraps the local ring by 512
     positions before decode: flash launches == 4 x 16, engine ==
     sequential for each bucket's first request (the long one included)
     and one in a reused slot, the fp32 logits check on the long prompt,
     every bf16 flash launch within 2e-2 of the plain version; then (28.)
     qwen2.5-3b at full width on 4 of its 36 layers (16/2 heads of 128,
     g = 8, its q/k/v biases drawn non-zero first: both packages
     initialise them to 0; the tied 151,936-word head), and (30.) yi-9b
     at full width on 2 of its 48 layers (32/4 heads of 128, the untied
     64,000-word embedding and head), served as granite is, qwen's fp32
     prefill with the biases zeroed moving the logits past the gate's
     limit; then (32.) arctic-480b at full width on one of its 35 layers
     (128 experts of top 2 beside the dense residual MLP, 56/8 heads of
     128: g = 7; 28.1 GB of bf16), on padded buckets as mixtral's: engine
     == sequential, flash launches == 16, the init's and the engine's
     peak memory, and last the fp32 gate on the served model drawn again
     in fp32 in place of the served tree (its values the served ones,
     sampled bit for bit), comparing the logits at every prefill
     position (at one layer the last position cannot show the planted
     fault);
 14. granite-3-2b trained at full width, 6 of its 40 layers, in bf16 (random
     weights, seed 0) with masked FedSGD under the train_4k runtime
     (flash_vjp: kernel 8 with the rows' log-sum-exp forward, the
     hand-written backward kernel; chunks 512, loss chunks 256, remat):
     masks at lambda 0.3 from one warm-up gradient (threshold on the
     card; the pruned count is the count below the k-th smallest), 3
     steps at eta 1e-2 on packed batches of 4 x 4096 tokens (train_4k's
     global batch of 256 cut to one card) by the train step that holds
     only its state (weights, masks, the masked copy, the accumulator;
     each leaf's gradient taken as backward completes it); finite losses,
     pruned coordinates unchanged bit for bit (each step's against its
     input's), the last step rerun bit for bit (the first result in
     pinned host memory meanwhile), both kernels' launches exact (the
     forward twice a layer under remat); ms a step, tokens/s, peak memory
     beside the step's state; a depth-2 fp32 granite's
     flash_vjp gradient within 1e-3 relative L2 of the naive path's (the
     naive gradient streamed leaf by leaf to pinned host memory, the
     flash one compared leaf by leaf as it comes), a
     planted fault (dO one position late) above it; both kernels on layer
     0's real inputs against the blocked plain scans (bf16 2e-2; the
     backward's dq, dk, dv at their own scale, a planted fault above),
     timed beside their bounds and SDPA (forward; forward and backward;
     backward alone);
 15. mamba2-130m trained the same way (6 of 24 layers): finite losses,
     pruned coordinates unchanged, a checkpoint after step 2 restored and
     step 3 rerun from it bit for bit;
     then (18.) hymba-1.5b at full width, 2 of its 32 layers, (19.) mixtral-8x22b
     at full width on 2 layers (5.41e9 parameters, 48.7 GB of step state:
     its deepest that trains on one card; 4 microbatches) and (23.)
     whisper-small at full size (an encoder input
     [4, 1500, 768] beside each batch) and (27.) gemma2-9b at full width
     on 4 of its 42 layers (2 local + 2 global, 1.71e9 parameters,
     masks over the tied embedding too) trained with phase 14's checks,
     the kernel rows on layer 0's inputs of the last microbatch (hymba's
     SDPA given the same band as a boolean mask; under gemma2's softcap
     the library call is flex_attention, compiled, with the cap as its
     score_mod), the gradient check on a depth-2 copy (whisper's
     encoder cut to 2 layers with it; gemma2's one local and one global
     layer), and (29.) qwen2.5-3b on 4 of its 36 layers (its biases drawn
     non-zero; the masks must keep some of them; [4, 16/2, 4096, 128] at
     layer 0) and (31.) yi-9b on 2 of its 48 ([4, 32/4, 4096, 128]);
     then the bf16 backward at gemma2's head dim 256 on random
     inputs at [1, 16/8, 4096, 256], cap 50, globally and under a window
     of 1,024 (its band path at full size): dq, dk, dv within 2e-2 of
     their peaks against the blocked plain scan, dO one position late
     above, a rerun bit for bit, the D 256 wgmma kernels in the device
     trace, timed beside its bound and flex_attention; and last (33.)
     llama-3.2-vision-90b at full width on one group of 5 of its 100
     layers (4 self layers of 64/8 heads of 128 and the gated cross layer;
     6.5e9 parameters, 58.5 GB of step state) with a vision input [4,
     1601, 8192] beside each batch, 4 microbatches of 1 x 4096, its gates
     opened to 1 before the warm-up (at 0 the masks would prune every
     cross-attention coordinate and the gates), the warm-up gradient on
     one sequence (4 x 4096 in one pass does not fit): phase 14's checks, the
     masks keeping cross-attention coordinates and every gate, kernel 8
     and the backward launched for the 4 self layers only (the cross
     layer's attention stays naive, as in the JAX package), the gradient
     check on one fp32 group at 1 x 2048 (its naive path's four layers
     of fp32 scores are rematerialised together), the kernel rows at
     [1, 64/8, 4096, 128];
 25. the sharded LM train step (sharding/rules.py on DTensor): (a)
     granite-3-2b at full width, 2 of its 40 layers, one masked-FedSGD
     step of 2 x 4096 tokens on a 1 x 1 (data, model) mesh (a fake world
     of one rank), parameters and masks placed by the partition rules,
     attention through local_map into kernel 8 and the backward: loss and
     every new parameter bit for bit the unsharded step's, the kernels'
     launches equal; (b) rank 0's share of the production 16 x 16 mesh (a
     fake world of 256 ranks whose collectives move nothing) for
     granite-3-2b at full width and depth on train_4k (256 x 4096
     tokens; 16 x 4096 on rank 0): its local shards on the card, one
     warm-up step and one timed step; peak memory under 80 GiB, the
     collective counts by kind those of the dry run (launch/dryrun.py,
     its collectives pass on meta tensors, in this process after the
     step) of the same (arch, shape, mesh), kernel 8 launched layers x 2
     (remat) and the backward layers times, every local shard the rules'
     shape; ms a step, peak GiB and collectives printed; then kernel 8
     with lse and the backward at the local shape the step gives them
     (q [16, 4096, 2, 64], k / v [16, 4096, 1, 64]: 2 query heads on one
     repeated KV head, g = 2) on random inputs, held to their plain
     versions and timed as phase 14's kernel rows are;
 20. one JSON line listing the kernels (the ten TPU kernels' ports and
     the attention backward; kernels 1-4 with their launches on spec C's
     blocked runs and on each of phase 34's six schemes beside the
     slice's, every kernel with its launches on phase 9's streamed run;
     kernel 8's and the backward's launches on
     every served and trained LM path, gemma2-9b's, qwen2.5-3b's, yi-9b's,
     arctic-480b's and llama-3.2-vision-90b's training included, and the
     D 256 backward rows), then the result line.

Any failed phase exits non-zero without the result line. Without CUDA, or
without the rest of the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

T_START = time.perf_counter()      # before torch and the port are imported

# deterministic cuBLAS, and one card (the first visible): both must be set
# before torch initialises CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))
# torch.compile (only flex_attention's library rows use it) compiles in this
# process and keeps its caches under the checkout's build/
for _var, _sub in (("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(
        pathlib.Path(__file__).resolve().parent / "build" / _sub))
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import Callback  # noqa: E402
from repro_torch.core import (AOConfig, BoundConstants, ClientData,  # noqa: E402
                              CorruptUpload, FederatedTrainer, GaussianPoison,
                              MixedFaults, ParamPack, ScaledMalicious,
                              SignFlip, make_aggregator, phis, solve_p1)
from repro_torch.core.packing import LANES  # noqa: E402
from repro_torch.core.round_engine import (  # noqa: E402
    kth_smallest_threshold, replay_shard_mean)
from repro_torch.data import make_dataset, partition_by_dirichlet  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pruning_mask as pm  # noqa: E402
from repro_torch.kernels.flash_attention_bwd import (  # noqa: E402
    CORE_KERNELS as BWD_CORE, WGMMA_KERNELS as BWD_WGMMA)
from repro_torch.models import (lenet_apply, lenet_init, make_eval_fn,  # noqa: E402
                                make_loss_fn, resnet_init)
from repro_torch.wireless import (ChannelModel,  # noqa: E402
                                  GaussianAggregateNoise, SystemParams)

# (memory bytes/s, fp32 FLOP/s outside the tensor cores, dense bf16 tensor
# FLOP/s) by the device name torch reports, from NVIDIA's data sheet (H100
# SXM, 700 W)
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12, 989e12)}
SOURCE = "src/repro_torch/kernels/csrc/pruning_mask.cu"
REPLACES = {
    "importance_mask_2d": "src/repro/kernels/pruning_mask.py:50",
    "importance_mask_batched": "src/repro/kernels/pruning_mask.py:87",
    "fedsgd_aggregate_weighted": "src/repro/kernels/pruning_mask.py:189",
    "exponent_histogram": "src/repro/kernels/pruning_mask.py:334",
    "fedsgd_aggregate": "src/repro/kernels/pruning_mask.py:134",
    "client_rank_sort": "src/repro/kernels/pruning_mask.py:264",
    "masked_update_2d": "src/repro/kernels/pruning_mask.py:371",
}
# benchmarks/robust_aggregation.py's cell: ExpConfig() under a 30 %
# ScaledMalicious(scale=10, exact) attack, `fixed_selection` at E0 = T0 = 1e6
ATTACK = dict(n_clients=10, sigma=1.0, n_train=4000, n_test=800, noise=0.35,
              seed=0, rounds=60, eta=0.1, batch=32, e0=1e6, t0=1e6, rate=0.3,
              scale=10.0)
ATTACK_AGGS = (("mean", {}), ("coord_median", {}),
               ("trimmed_mean", {"beta": 0.35}))
SIZES = (1, 3, 8, 10, 16, 33)
SLICE = dict(n_clients=10, sigma=5.0, n_train=4000, n_test=800, seed=0,
             e0=25.0, t0=15.0, rounds=40, eta=0.1, batch=32)


def peaks(name: str) -> tuple[float, float]:
    if name not in PEAKS:
        raise KeyError(f"no published peaks for {name!r}: add its memory "
                       "rate and fp32 rate to PEAKS to compute bound_ms")
    return PEAKS[name]


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(outs_a, outs_b) -> float:
    err = 0.0
    for a, b in zip(outs_a, outs_b):
        a, b = a.double(), b.double()
        both = torch.isfinite(a) & torch.isfinite(b)
        if both.any():
            err = max(err, float((a - b).abs()[both].max()))
    return err


def time_ms(fn, reps: int = 200, warmup: int = 10) -> float:
    """Mean time of one call on the device's clock: CUDA events around
    `reps` back-to-back calls after `warmup` untimed ones. For a kernel
    shorter than its launch this is the wrapper's per-call cost, the rate
    at which the round can issue it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_events(prof):
    """(name, calls, device µs) of every CUDA kernel in a profile."""
    out = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = getattr(ev, "self_cuda_time_total", 0.0)
            out.append((ev.key, ev.count, float(us)))
    return out


def kernel_device_ms(fn, symbols, reps: int = 50, per_call: int = 1):
    """Device time per wrapper call: the summed duration of every CUDA
    kernel in torch.profiler's device trace whose name holds one of
    `symbols` (each kernel a wrapper may launch), over the `reps` calls of
    fn (one wrapper call each, launching `per_call` kernels). Returns (ms,
    {each kernel name that matched: its mean device µs an event}, the
    number of such kernel events). ms
    is None when the trace shows none of them, and the top device events
    are printed then. A trace with fewer events than reps x per_call has
    lost some: that is printed, and ms is the mean per event (per_call
    1: per call for the one-launch wrappers) or, for a wrapper of several
    kernels, the sum over its kernels of each one's mean per event. A
    trace with no device event at all (the profiler lost the whole trace,
    as it now and then does on the H100) is taken again, up to three
    times."""
    from torch.profiler import ProfilerActivity, profile
    if isinstance(symbols, str):
        symbols = (symbols,)
    fn()
    torch.cuda.synchronize()
    for _attempt in range(3):
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
        except (AssertionError, RuntimeError):  # no device tracing here
            return None, [], 0
        events = _device_events(prof)
        if events:
            break
        print(json.dumps({"device_trace_empty": list(symbols)}))
    hits = [(key, n, us) for key, n, us in events
            if any(sym in key for sym in symbols)]
    n_events = sum(n for _, n, _ in hits)
    names = {key[:120]: us / n for key, n, us in sorted(hits) if n}
    total_ms = sum(us for _, _, us in hits) / 1e3
    if n_events < reps * per_call:
        top = sorted(events, key=lambda e: -e[2])[:8]
        print(json.dumps({"device_trace_incomplete": list(symbols),
                          "calls": reps, "events": n_events,
                          "top_device_events": [
                              {"name": k[:120], "calls": c, "us": us}
                              for k, c, us in top]}))
        if per_call > 1:
            return sum(us / n for _, n, us in hits) / 1e3, names, n_events
        return (total_ms / n_events if n_events else None), names, n_events
    return total_ms / reps, names, n_events


def _instance(kernel: str, targs) -> str:
    """A kernel's name with its template arguments, if any: f<a,b>."""
    targs = [t for t in targs if t]
    return f"{kernel}<{','.join(targs)}>" if targs else kernel


LM_PTXAS = ("flash_attention", "flash_bwd", "decode_attention", "ssd_chunk")
# the round's kernels of the aggregate tail and the shared-threshold path
ROUND_PTXAS = ("importance_mask", "exponent_histogram", "fedsgd_aggregate",
               "masked_update")


def ptxas_report(prefixes) -> dict:
    """Registers, spill bytes and stack frame of each kernel instantiation
    whose name starts with one of `prefixes`, from the ptxas report the
    build keeps beside the library, and `wgmma_serialized` where ptxas says
    (C7515) that it serialized the kernel's wgmma instructions."""
    path = _build.ptxas_report_path()
    if not path.exists():
        return {"ptxas": "not measured: no report beside the library"}
    pattern = (r"(?<=\d)((?:" + "|".join(prefixes)
               + r")\w*?kernel)(?:I(.*?)EEv|E)")

    def instance(mangled):
        kern = re.search(pattern, mangled)
        if not kern:
            return None
        args = kern.group(2) or ""
        dtype = "bf16" if "bfloat16" in args else "fp32" \
            if args.startswith("f") else ""
        return _instance(kern.group(1),
                         [dtype, *re.findall(r"Li(\d+)E", args)])

    out, name = {}, None
    for line in path.read_text().splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            name = instance(head.group(1))
            continue
        serial = re.search(r"\(C7515\).*in the function '(\S+)'", line)
        if serial and instance(serial.group(1)):
            out.setdefault(instance(serial.group(1)),
                           {})["wgmma_serialized"] = True
        if name and "spill stores" in line:
            out.setdefault(name, {})["spill_store_bytes"] = int(
                re.search(r"(\d+) bytes spill stores", line).group(1))
            out[name]["stack_frame_bytes"] = int(
                re.search(r"(\d+) bytes stack frame", line).group(1))
        if name and "Used" in line and "registers" in line:
            out.setdefault(name, {})["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
    return out


def sass_hgmma_counts() -> dict:
    """HGMMA (wgmma) and UTMALDG (TMA load) instructions in each
    flash_attention, flash_bwd (attention backward) and ssd_chunk function
    of the built kernel library, from `cuobjdump --dump-sass`: {name:
    {"HGMMA": n, "UTMALDG": n}}."""
    tool = shutil.which("cuobjdump") or str(
        pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
        / "bin" / "cuobjdump")
    out = subprocess.run([tool, "--dump-sass", str(_build.library_path())],
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        raise RuntimeError(f"cuobjdump failed: {out.stderr.strip()}")
    counts, name = {}, None
    for line in out.stdout.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            mangled = head.group(1)
            kern = re.search(r"(?<=\d)((?:flash_attention|flash_bwd|"
                             r"ssd_chunk)\w*?kernel)[IE]", mangled)
            name = None
            if kern:
                targs = re.findall(r"Li(\d+)E", mangled)
                if "kernelIf" in mangled:
                    targs = ["float", *targs]
                name = _instance(kern.group(1), targs)
                counts[name] = {"HGMMA": 0, "UTMALDG": 0}
        elif name is not None:
            for op in ("HGMMA", "UTMALDG"):
                if op in line:
                    counts[name][op] += 1
    return counts


# kernels whose tiles come in by TMA: UTMALDG in their SASS
TMA_KERNELS = ("flash_attention_ws_kernel", "ssd_chunk_wgmma_kernel")


def hgmma_problems(sass) -> list:
    """Prints sass_hgmma_counts()'s result; a problem when a bf16 tensor-core
    kernel is missing (kernel 8's at D 64 / 128 and at D 256, the
    backward's of every head dim as BWD_WGMMA names them, the SSD chunk's),
    one has no HGMMA instruction, or a TMA-fed one (TMA_KERNELS) has no
    UTMALDG."""
    print(json.dumps({"sass": sass}))
    wgmma_fns = [k for k in sass if "wgmma" in k or k.startswith(TMA_KERNELS)]
    expected = (*sorted(set(fa.BF16_KERNELS.values())),
                *sorted({kern for pair in BWD_WGMMA.values()
                         for kern in pair}),
                "ssd_chunk_wgmma_kernel")
    missing = [kern for kern in expected
               if not any(k.startswith(kern) for k in wgmma_fns)]
    if missing or not all(sass[k]["HGMMA"] > 0 for k in wgmma_fns) or \
            not all(sass[k]["UTMALDG"] > 0 for k in wgmma_fns
                    if k.startswith(TMA_KERNELS)):
        return [f"a bf16 tensor-core kernel is missing ({missing}), has no "
                f"HGMMA instruction or, fed by TMA, no UTMALDG ({sass})"]
    return []


def slice_env(dev):
    """The slice's configuration through the port's own numpy copies."""
    c = SLICE
    ds = make_dataset("synthetic-mnist", n_train=c["n_train"],
                      n_test=c["n_test"], seed=c["seed"])
    parts = partition_by_dirichlet(ds.y_train, c["n_clients"], c["sigma"],
                                   rng=np.random.default_rng(c["seed"]))
    clients = [ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]
    test_hist = np.bincount(ds.y_test, minlength=10).astype(float)
    phi = phis(np.stack([cl.label_histogram(10) for cl in clients]),
               test_hist[None])
    sp = SystemParams.table1(c["n_clients"], dataset="mnist",
                             batch_size=c["batch"])
    ch = ChannelModel(c["n_clients"], path_loss=1e-5, seed=0)
    consts = BoundConstants(rounds_S=c["rounds"] - 1, batch_Z=c["batch"],
                            eta=c["eta"])
    sched = solve_p1(phi, c["e0"], c["t0"], ch.uplink, ch.downlink, sp,
                     consts, AOConfig(outer_iters=3, selection_method="paper",
                                      phi_coupling="mean"))
    params = lenet_init(torch.Generator().manual_seed(0), device=dev)
    return ds, clients, sp, ch, sched, params


# -- phase 2: kernels against their plain versions ----------------------------

# the redesigned kernels 4 and 2 as the device trace names them, and the
# rows of their bytes-bound shape
HIST_SYMBOL = "exponent_histogram_ticket_kernel"
MASK_SYMBOL = "importance_mask_2d_kernel"
# kernels 3 (the name holds for every instantiation) and 7 as the device
# trace names them
AGG_SYMBOL = "fedsgd_aggregate_weighted_kernel"
MASKED_SYMBOL = "masked_update_kernel"
BIG_ROWS = 65536
FLT_MIN = float(np.finfo(np.float32).tiny)


def round_up_to_flt_min(factor, n: int = LANES) -> np.ndarray:
    """Normal fp32 values whose exact product with `factor` lies just below
    FLT_MIN and rounds to FLT_MIN in fp32 (numpy, no flush), tiled to n:
    XLA flushes the products more than 2^-151 below it, keeps the rest."""
    f = np.float32(factor)
    x0 = np.float32(FLT_MIN / np.float64(f))
    xs = np.asarray([np.float32(x0 + k * np.spacing(x0))
                     for k in range(-256, 257)], np.float32)
    found = xs[(xs >= FLT_MIN) & (xs.astype(np.float64) * np.float64(f)
                                  < FLT_MIN) & (xs * f == FLT_MIN)]
    if not found.size:
        raise ValueError(f"no value rounds up to FLT_MIN at factor {f}")
    return np.resize(found, n)


# zero-weight patterns of the weighted aggregate's tests: dead clients hold
# NaN; "nonunit" has a weight of 1.0 and a subnormal one (XLA compares it
# as 0: its client is dead) among scales in [0.2, 1.9]
WEIGHT_PATTERNS = ("live", "front", "middle", "end", "everywhere", "nonunit")


def client_weights(c: int, pattern: str, rng) -> np.ndarray:
    cw = np.ones(c, np.float32)
    if pattern == "nonunit":
        cw = rng.uniform(0.2, 1.9, size=c).astype(np.float32)
        cw[c // 2] = 1.0
        cw[-1] = np.float32(3e-39) if c > 1 else cw[-1]
    elif pattern != "live":
        cw[{"front": [0], "middle": [c // 2], "end": [c - 1],
            "everywhere": list(range(c))}[pattern]] = 0.0
    return cw


def mask_of(kind: str, shape, rng) -> np.ndarray:
    """A 0/1 keep-mask, or a mask of other values (scales, one whose
    products overflow, +-0.0, subnormals)."""
    m = (rng.random(shape) < 0.6).astype(np.float32)
    if kind == "scaled":
        pool = np.asarray([0.5, -1.0, 3.0, 1e30, 0.0, -0.0, 1.0, 3e-39],
                          np.float32)
        m = rng.choice(pool, size=shape).astype(np.float32)
    return m


def subnormal_checks(dev, shape) -> dict:
    """Kernels 3, 5 and 7 against their plain versions, bit for bit, on
    gradients of scale 1e-39 (subnormal) with normal rows, rows straddling
    FLT_MIN, rows whose product with the tail's factor (1/7, 1/3, eta)
    rounds up to FLT_MIN, and zero-weight clients holding NaN: the flush of
    every sum, difference and product of the aggregate tail."""
    rng = np.random.default_rng(16)

    def arr(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    def stack(c):
        g = (1e-39 * rng.normal(size=(c,) + shape)).astype(np.float32)
        g[:, :8] = rng.normal(size=(c, 8, shape[1]))
        g[:, 8:24] = FLT_MIN * rng.uniform(-3, 3, size=(c, 16, shape[1]))
        return g

    w_np = rng.normal(size=shape).astype(np.float32)
    w_np[24:32] = 1e-39 * rng.normal(size=(8, shape[1]))
    w_np[32:40] = FLT_MIN * rng.uniform(-2, 2, size=(8, shape[1]))
    w = arr(w_np)
    out = {"fedsgd_aggregate_weighted": True, "fedsgd_aggregate": True,
           "masked_update_2d": True}
    for c in (1, 3, 8, 10, 33):
        g_np = stack(c)
        cw_np = np.ones(c, np.float32)
        if c > 1:
            cw_np[-1] = 0.0
            g_np[-1] = np.nan
        inv_np = np.float32(1.0 / cw_np.sum())
        if c == 8:                               # 7 live: inv = 1/7
            g_np[:, 40] = 0.0
            g_np[0, 40] = round_up_to_flt_min(inv_np, shape[1])
        g, cw = arr(g_np), arr(cw_np)
        inv = torch.tensor(inv_np, device=dev)
        eta = torch.tensor(np.float32(0.15), device=dev)
        out["fedsgd_aggregate_weighted"] &= all(
            bits_equal(a, b) for a, b in zip(
                pm.fedsgd_aggregate_weighted(w, g, cw, inv, eta),
                pm.fedsgd_aggregate_weighted_plain(w, g, cw, inv, eta)))
        g_np = stack(c)
        if c == 3:                               # inv = float32(1/3)
            g_np[:, 40] = 0.0
            g_np[0, 40] = round_up_to_flt_min(np.float32(1 / 3), shape[1])
        g = arr(g_np)
        out["fedsgd_aggregate"] &= all(
            bits_equal(a, b) for a, b in zip(
                pm.fedsgd_aggregate(w, g, 0.15),
                pm.fedsgd_aggregate_plain(w, g, 0.15)))
        g0 = g_np[0].copy()
        g0[41] = round_up_to_flt_min(0.02, shape[1])   # eta*g rounds up
        for kind in ("keep", "scaled"):
            m = arr(mask_of(kind, shape, rng))
            out["masked_update_2d"] &= bits_equal(
                pm.masked_update_2d(w, arr(g0), m, 0.02),
                pm.masked_update_plain(w, arr(g0), m, 0.02))
    return out


def check_kernels(dev, pack: ParamPack, card: str) -> dict:
    rng = np.random.default_rng(0)
    shape = (pack.rows, LANES)
    n = shape[0] * shape[1]
    bw, flops, _ = peaks(card)
    pr = torch.as_tensor(pack.prunable_mask(), device=dev)
    n_valid = int(pack.n_prunable)

    def arr(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=dev)

    w_np = rng.normal(size=shape).astype(np.float32)
    v_np = (1e-3 * rng.normal(size=shape)).astype(np.float32)
    v_np.reshape(-1)[::11] = 0.0                    # exact zeros: q = 0
    v_np.reshape(-1)[5::13] = 1e-25                 # q underflows: flushed
    w, v = arr(w_np), arr(v_np)
    q = pm.importance(w, v)
    results = {}
    fails = []

    def timing(call, plain_call, symbol, nbytes, nflops, library_call=None):
        """Times the wrapper, the plain version and the library call at
        these inputs, and the kernel alone on the device trace; bound from
        bytes and operations."""
        ms, plain = time_ms(call), time_ms(plain_call)
        lib = time_ms(library_call) if library_call is not None else None
        dev_ms, _, _ = kernel_device_ms(call, symbol)
        bound = max(nbytes / bw, nflops / flops) * 1e3
        return dict(ms=ms, plain_ms=plain, device_ms=dev_ms, bound_ms=bound,
                    library_ms=lib, symbol=symbol,
                    bound_by="bytes" if nbytes / bw >= nflops / flops
                    else "operations", bytes=nbytes,
                    share=bound / dev_ms if dev_ms else None)

    def record(name, ok, err, call, plain_call, symbol, nbytes, nflops,
               library_call=None):
        res = timing(call, plain_call, symbol, nbytes, nflops, library_call)
        results[name] = dict(ok=ok, max_abs_err=err, **res)
        print(json.dumps({"kernel": name, "equal": ok, "kernel_ms": res["ms"],
                          "device_ms": res["device_ms"],
                          "plain_ms": res["plain_ms"],
                          "bound_us": res["bound_ms"] * 1e3, "bytes": nbytes,
                          "library_ms": res["library_ms"],
                          "max_abs_err": err}))
        if not ok:
            fails.append(name)

    def extra_row(name, label, ok, call, plain_call, symbol, nbytes,
                  nflops):
        """Another shape of a recorded kernel: checked and timed beside the
        main path's row, listed under the kernel's "shapes"."""
        res = timing(call, plain_call, symbol, nbytes, nflops)
        results[name].setdefault("shapes", {})[label] = dict(ok=ok, **res)
        print(json.dumps({"kernel": name, "shape": label, "equal": ok,
                          **{k: res[k] for k in ("ms", "device_ms",
                                                  "plain_ms", "bound_ms",
                                                  "share")}}))
        if not ok:
            fails.append(f"{name} ({label})")

    # exponent_histogram, and the threshold search it feeds
    hk = pm.exponent_histogram(q, pr)
    hp = pm.exponent_histogram_plain(q, pr)
    ok = bits_equal(hk, hp) and int(hk.sum()) == n_valid
    ks = [0, 1, n_valid // 2, n_valid, n_valid + 7]
    for k in ks:
        a = kth_smallest_threshold(q, pr, k, coarse="histogram")
        b = kth_smallest_threshold(q, pr, k, coarse="bisect")
        ok &= bool(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   or (torch.isnan(a) & torch.isnan(b)).all())
    kv = torch.as_tensor(ks, device=dev)
    ok &= bool(torch.equal(
        torch.nan_to_num(kth_smallest_threshold(q, pr, kv, coarse="histogram")),
        torch.nan_to_num(kth_smallest_threshold(q, pr, kv, coarse="bisect"))))
    zero_q = torch.zeros_like(q)                    # round 0: v = 0
    hz = pm.exponent_histogram(zero_q, pr)
    ok_zero = bits_equal(hz, pm.exponent_histogram_plain(zero_q, pr))
    # the ticket resets: ten calls in a row give the same bits
    ok &= all(bits_equal(pm.exponent_histogram(q, pr), hp)
              for _ in range(10))
    record("exponent_histogram", bool(ok), max_abs_err([hk], [hp]),
           lambda: pm.exponent_histogram(q, pr),
           lambda: pm.exponent_histogram_plain(q, pr),
           HIST_SYMBOL, 2 * 4 * n + 4 * 256, 2 * n)
    extra_row("exponent_histogram", f"R={shape[0]}, q = 0 (round 0)",
              bool(ok_zero), lambda: pm.exponent_histogram(zero_q, pr),
              lambda: pm.exponent_histogram_plain(zero_q, pr), HIST_SYMBOL,
              2 * 4 * n + 4 * 256, 2 * n)

    # importance_mask_2d: one shared threshold, at every k of the list,
    # including nextafter(0) (a subnormal) from the all-zero round 0
    ok, err = True, 0.0
    thr_list = [kth_smallest_threshold(q, pr, k) for k in ks]
    thr_list.append(kth_smallest_threshold(zero_q, pr, n_valid // 2))
    for thr in thr_list:
        kq, km = pm.importance_mask_2d(w, v, pr, thr)
        pq, pms = pm.importance_masks_plain(w, v, pr, thr)
        ok &= bits_equal(kq, pq) and bits_equal(km, pms[0])
        err = max(err, max_abs_err([kq, km], [pq, pms[0]]))
    zero_thr = thr_list[-1]
    km0 = pm.importance_mask_2d(torch.zeros_like(w), v, pr, zero_thr)[1]
    ok &= bool((km0 == 1).all())                    # denormals are zero
    thr = thr_list[2]
    record("importance_mask_2d", bool(ok), err,
           lambda: pm.importance_mask_2d(w, v, pr, thr),
           lambda: pm.importance_masks_plain(w, v, pr, thr),
           MASK_SYMBOL, 5 * 4 * n + 4, 3 * n)

    # kernels 4 and 2 where bytes decide: R = 65,536 (32 MiB a buffer)
    big = (BIG_ROWS, LANES)
    nb = big[0] * big[1]
    wb = torch.randn(big, generator=torch.Generator().manual_seed(3)).to(dev)
    vb = 1e-3 * torch.randn(big, generator=torch.Generator().manual_seed(4)
                            ).to(dev)
    prb = (torch.rand(big, generator=torch.Generator().manual_seed(5))
           < 0.9).float().to(dev)
    qb = pm.importance(wb, vb)
    thrb = kth_smallest_threshold(qb, prb, int(prb.sum()) // 2)
    hb = pm.exponent_histogram_plain(qb, prb)
    extra_row("exponent_histogram", f"R={BIG_ROWS}",
              all(bits_equal(pm.exponent_histogram(qb, prb), hb)
                  for _ in range(3)),
              lambda: pm.exponent_histogram(qb, prb),
              lambda: pm.exponent_histogram_plain(qb, prb), HIST_SYMBOL,
              2 * 4 * nb + 4 * 256, 2 * nb)
    kq, km = pm.importance_mask_2d(wb, vb, prb, thrb)
    pq, pms = pm.importance_masks_plain(wb, vb, prb, thrb)
    extra_row("importance_mask_2d", f"R={BIG_ROWS}",
              bits_equal(kq, pq) and bits_equal(km, pms[0]),
              lambda: pm.importance_mask_2d(wb, vb, prb, thrb),
              lambda: pm.importance_masks_plain(wb, vb, prb, thrb),
              MASK_SYMBOL, 5 * 4 * nb + 4, 3 * nb)
    del wb, vb, prb, qb, kq, km, pq, pms

    # importance_mask_batched at C in {1, 3, 8}
    ok, err = True, 0.0
    for c in (1, 3, 8):
        kc = torch.as_tensor((ks * 2)[:c], device=dev)
        thr_c = kth_smallest_threshold(q, pr, kc)
        kq, km = pm.importance_mask_batched(w, v, pr, thr_c)
        pq, pms = pm.importance_masks_plain(w, v, pr, thr_c)
        ok &= bits_equal(kq, pq) and bits_equal(km, pms)
        err = max(err, max_abs_err([kq, km], [pq, pms]))
    thr8 = thr_c
    record("importance_mask_batched", bool(ok), err,
           lambda: pm.importance_mask_batched(w, v, pr, thr8),
           lambda: pm.importance_masks_plain(w, v, pr, thr8),
           "importance_masks_kernel", (4 + 8) * 4 * n + 4 * 8, (3 + 8) * n)

    # fedsgd_aggregate_weighted at every C from 1 to 33 (each instantiation
    # and the any-count path) under every weight pattern, dead clients
    # holding NaN
    ok, err = True, 0.0
    eta = torch.tensor(np.float32(0.1), device=dev)
    for c in range(1, 34):
        g_live = arr(rng.normal(size=(c,) + shape))
        for pattern in WEIGHT_PATTERNS:
            cw_np = client_weights(c, pattern, rng)
            dead = torch.as_tensor(cw_np < FLT_MIN, device=dev)
            grads = torch.where(dead[:, None, None],
                                torch.full_like(g_live, float("nan")), g_live)
            cw = arr(cw_np)
            n_live = float(cw_np[cw_np >= FLT_MIN].sum())
            inv = torch.tensor(np.float32(1.0 / n_live if n_live else 0.0),
                               device=dev)
            ko = pm.fedsgd_aggregate_weighted(w, grads, cw, inv, eta)
            po = pm.fedsgd_aggregate_weighted_plain(w, grads, cw, inv, eta)
            ok &= all(bits_equal(a, b) for a, b in zip(ko, po))
            ok &= all(bool(torch.isfinite(t).all()) for t in ko)
            err = max(err, max_abs_err(ko, po))
    g8 = arr(rng.normal(size=(8,) + shape))
    cw8 = torch.ones(8, device=dev)
    inv8 = torch.tensor(np.float32(1 / 8), device=dev)
    record("fedsgd_aggregate_weighted", bool(ok), err,
           lambda: pm.fedsgd_aggregate_weighted(w, g8, cw8, inv8, eta),
           lambda: pm.fedsgd_aggregate_weighted_plain(w, g8, cw8, inv8, eta),
           AGG_SYMBOL, (1 + 8 + 3) * 4 * n + 4 * 10, (2 * 8 + 3) * n)
    # the slices' own mixes: the pruned slice's bucket of 8 with 2 padding
    # clients (bound on the 6 live ones), the attack slice's mean over 10
    cw6 = torch.tensor([1, 1, 1, 1, 1, 1, 0, 0], dtype=torch.float32,
                       device=dev)
    g6 = g8.clone()
    g6[6:] = float("nan")
    inv6 = torch.tensor(np.float32(1 / 6), device=dev)
    extra_row("fedsgd_aggregate_weighted",
              f"R={shape[0]}, C=8, 2 zero-weight (pruned slice)",
              all(bits_equal(a, b) for a, b in zip(
                  pm.fedsgd_aggregate_weighted(w, g6, cw6, inv6, eta),
                  pm.fedsgd_aggregate_weighted_plain(w, g6, cw6, inv6, eta))),
              lambda: pm.fedsgd_aggregate_weighted(w, g6, cw6, inv6, eta),
              lambda: pm.fedsgd_aggregate_weighted_plain(w, g6, cw6, inv6,
                                                         eta),
              AGG_SYMBOL, (1 + 6 + 3) * 4 * n + 4 * 10, (2 * 6 + 3) * n)
    g10 = arr(rng.normal(size=(10,) + shape))
    cw10 = torch.ones(10, device=dev)
    inv10 = torch.tensor(np.float32(1 / 10), device=dev)
    extra_row("fedsgd_aggregate_weighted",
              f"R={shape[0]}, C=10 (attack slice, mean)",
              all(bits_equal(a, b) for a, b in zip(
                  pm.fedsgd_aggregate_weighted(w, g10, cw10, inv10, eta),
                  pm.fedsgd_aggregate_weighted_plain(w, g10, cw10, inv10,
                                                     eta))),
              lambda: pm.fedsgd_aggregate_weighted(w, g10, cw10, inv10, eta),
              lambda: pm.fedsgd_aggregate_weighted_plain(w, g10, cw10, inv10,
                                                         eta),
              AGG_SYMBOL, (1 + 10 + 3) * 4 * n + 4 * 12, (2 * 10 + 3) * n)
    # where bytes decide: R = 65,536, C = 8 all live
    gb = torch.randn((8,) + big, generator=torch.Generator().manual_seed(6)
                     ).to(dev)
    wb = torch.randn(big, generator=torch.Generator().manual_seed(7)).to(dev)
    extra_row("fedsgd_aggregate_weighted", f"R={BIG_ROWS}, C=8",
              all(bits_equal(a, b) for a, b in zip(
                  pm.fedsgd_aggregate_weighted(wb, gb, cw8, inv8, eta),
                  pm.fedsgd_aggregate_weighted_plain(wb, gb, cw8, inv8,
                                                     eta))),
              lambda: pm.fedsgd_aggregate_weighted(wb, gb, cw8, inv8, eta),
              lambda: pm.fedsgd_aggregate_weighted_plain(wb, gb, cw8, inv8,
                                                         eta),
              AGG_SYMBOL, (1 + 8 + 3) * 4 * nb + 4 * 10, (2 * 8 + 3) * nb)
    del gb

    # client_rank_sort at every C of SIZES: ties, +-0.0 and +-inf on valid
    # lanes, NaN on zero-weight clients; every rank compared (stable sort)
    ok, err = True, 0.0
    pool = np.asarray([-1.5, -0.0, 0.0, 0.25, 3.0, np.inf, -np.inf],
                      np.float32)
    stacks = {}
    for c in SIZES:
        g_np = rng.normal(size=(c,) + shape).astype(np.float32)
        tie = rng.random(g_np.shape) < 0.3
        g_np[tie] = rng.choice(pool, size=int(tie.sum()))
        cw_np = np.ones(c, np.float32)
        if c > 2:
            cw_np[[1, -1]] = 0.0
            g_np[1] = np.nan
        grads, cw = arr(g_np), arr(cw_np)
        stacks[c] = (grads, cw)
        ko = pm.client_rank_sort(grads, cw)
        po = pm.client_rank_sort_plain(grads, cw)
        ok &= bits_equal(ko, po)
        err = max(err, max_abs_err([ko], [po]))
        # a subnormal weight is dead, as XLA compares the flushed weight:
        # the client sorts last, as at weight 0
        cw_sub, cw_dead = cw_np.copy(), cw_np.copy()
        cw_sub[0], cw_dead[0] = np.float32(3e-39), 0.0
        ks = pm.client_rank_sort(grads, arr(cw_sub))
        ok &= bits_equal(ks, pm.client_rank_sort_plain(grads, arr(cw_sub)))
        ok &= bits_equal(ks, pm.client_rank_sort_plain(grads, arr(cw_dead)))
    g10, cw10 = stacks[10]
    keys10 = torch.where(cw10[:, None, None] > 0, pm.order_keys(g10),
                         torch.full(g10.shape, pm.INT32_MAX,
                                    dtype=torch.int32, device=dev))
    record("client_rank_sort", bool(ok), err,
           lambda: pm.client_rank_sort(g10, cw10),
           lambda: pm.client_rank_sort_plain(g10, cw10),
           "client_rank_sort_kernel", 2 * 10 * 4 * n + 4 * 10,
           n * 10 * 9 // 2,
           library_call=lambda: torch.sort(keys10, dim=0, stable=True))

    # fedsgd_aggregate at every C of SIZES, and its contract with the
    # weighted kernel: unit weights and inv = float32(1/C) give its bits
    ok, err = True, 0.0
    for c in SIZES:
        grads = arr(rng.normal(size=(c,) + shape))
        ko = pm.fedsgd_aggregate(w, grads, 0.1)
        po = pm.fedsgd_aggregate_plain(w, grads, 0.1)
        ok &= all(bits_equal(a, b) for a, b in zip(ko, po))
        err = max(err, max_abs_err(ko, po))
        wo = ops.packed_fedsgd_update_weighted(
            w, grads, torch.ones(c, device=dev),
            torch.tensor(np.float32(1.0 / c), device=dev), eta)
        ok &= all(bits_equal(a, b) for a, b in
                  zip(ops.packed_fedsgd_update(w, grads, 0.1), wo))
    g10 = arr(rng.normal(size=(10,) + shape))
    record("fedsgd_aggregate", bool(ok), err,
           lambda: pm.fedsgd_aggregate(w, g10, 0.1),
           lambda: pm.fedsgd_aggregate_plain(w, g10, 0.1),
           "fedsgd_aggregate_kernel", (1 + 10 + 3) * 4 * n, (9 + 3) * n)

    # masked_update_2d with keep-masks, masks of other values, NaN and inf
    # in w
    ok, err = True, 0.0
    w_odd = w.clone()
    w_odd[20, :6] = torch.tensor([np.nan, np.inf, -np.inf] * 2)
    for kind in ("keep", "scaled"):
        g = arr(rng.normal(size=shape))
        m = arr(mask_of(kind, shape, rng))
        for ww in (w, w_odd):
            ko = pm.masked_update_2d(ww, g, m, 0.05)
            po = pm.masked_update_plain(ww, g, m, 0.05)
            ok &= bits_equal(ko, po)
            err = max(err, max_abs_err([ko], [po]))
    m = arr(mask_of("keep", shape, rng))
    record("masked_update_2d", bool(ok), err,
           lambda: pm.masked_update_2d(w, g, m, 0.05),
           lambda: pm.masked_update_plain(w, g, m, 0.05),
           MASKED_SYMBOL, 4 * 4 * n, 3 * n)
    gb = torch.randn(big, generator=torch.Generator().manual_seed(8)).to(dev)
    mb = (torch.rand(big, generator=torch.Generator().manual_seed(9))
          < 0.5).float().to(dev)
    extra_row("masked_update_2d", f"R={BIG_ROWS}",
              bits_equal(pm.masked_update_2d(wb, gb, mb, 0.05),
                         pm.masked_update_plain(wb, gb, mb, 0.05)),
              lambda: pm.masked_update_2d(wb, gb, mb, 0.05),
              lambda: pm.masked_update_plain(wb, gb, mb, 0.05),
              MASKED_SYMBOL, 4 * 4 * nb, 3 * nb)
    del wb, gb, mb

    # kernels 1-4 at ResNet-20's packed shape, spec C's path: R = 2304, its
    # prunable mask (scale and bias leaves kept), lambda 0.7 as its
    # schedule gives, 4 clients a round
    rn = ParamPack.build(resnet_init(torch.Generator().manual_seed(0),
                                     device=dev))
    rs = (rn.rows, LANES)
    nr = rs[0] * rs[1]
    prr = torch.as_tensor(rn.prunable_mask(), device=dev)
    wr = arr(rng.normal(size=rs))
    vr = arr(1e-3 * rng.normal(size=rs))
    qr = pm.importance(wr, vr)
    label = f"R={rn.rows} (ResNet-20, spec C)"
    extra_row("exponent_histogram", label,
              all(bits_equal(pm.exponent_histogram(qr, prr),
                             pm.exponent_histogram_plain(qr, prr))
                  for _ in range(3)),
              lambda: pm.exponent_histogram(qr, prr),
              lambda: pm.exponent_histogram_plain(qr, prr), HIST_SYMBOL,
              2 * 4 * nr + 4 * 256, 2 * nr)
    thr_r = kth_smallest_threshold(qr, prr, int(0.7 * rn.n_prunable))
    kq, km = pm.importance_mask_2d(wr, vr, prr, thr_r)
    pq, pms = pm.importance_masks_plain(wr, vr, prr, thr_r)
    extra_row("importance_mask_2d", label,
              bits_equal(kq, pq) and bits_equal(km, pms[0]),
              lambda: pm.importance_mask_2d(wr, vr, prr, thr_r),
              lambda: pm.importance_masks_plain(wr, vr, prr, thr_r),
              MASK_SYMBOL, 5 * 4 * nr + 4, 3 * nr)
    thr_r4 = kth_smallest_threshold(qr, prr, torch.as_tensor(
        [int(f * rn.n_prunable) for f in (0.6, 0.7, 0.7, 0.8)], device=dev))
    extra_row("importance_mask_batched", label + ", C=4",
              all(bits_equal(a, b) for a, b in zip(
                  pm.importance_mask_batched(wr, vr, prr, thr_r4),
                  pm.importance_masks_plain(wr, vr, prr, thr_r4))),
              lambda: pm.importance_mask_batched(wr, vr, prr, thr_r4),
              lambda: pm.importance_masks_plain(wr, vr, prr, thr_r4),
              "importance_masks_kernel", (4 + 4) * 4 * nr + 4 * 4,
              (3 + 4) * nr)
    g4 = arr(rng.normal(size=(4,) + rs))
    cw4 = torch.ones(4, device=dev)
    inv4 = torch.tensor(np.float32(1 / 4), device=dev)
    extra_row("fedsgd_aggregate_weighted", label + ", C=4",
              all(bits_equal(a, b) for a, b in zip(
                  pm.fedsgd_aggregate_weighted(wr, g4, cw4, inv4, eta),
                  pm.fedsgd_aggregate_weighted_plain(wr, g4, cw4, inv4,
                                                     eta))),
              lambda: pm.fedsgd_aggregate_weighted(wr, g4, cw4, inv4, eta),
              lambda: pm.fedsgd_aggregate_weighted_plain(wr, g4, cw4, inv4,
                                                         eta),
              AGG_SYMBOL, (1 + 4 + 3) * 4 * nr + 4 * 6, (2 * 4 + 3) * nr)
    del wr, vr, qr, g4, kq, km, pq, pms
    for name, sub_ok in subnormal_checks(dev, shape).items():
        results[name]["subnormal_bitwise"] = sub_ok
        print(json.dumps({"kernel": name, "subnormal_input_equal": sub_ok}))
        if not sub_ok:
            fails.append(f"{name} (subnormal input)")
    if fails:
        raise AssertionError(f"kernels differ from their plain versions: "
                             f"{fails}")
    return results


# -- phase 3: the main path -----------------------------------------------------

def run_backend(backend, dev, ds, clients, sp, ch, sched, params, *,
                cfg=SLICE, evaluate=True, **scenario):
    """Train LeNet on one backend over `sched`; `scenario` reaches the
    trainer (fault_model, aggregator, channel_noise). Returns (trainer,
    history, training seconds without evaluation)."""
    loss = make_loss_fn(lenet_apply)
    eval_fn = make_eval_fn(lenet_apply, ds.x_test, ds.y_test, device=dev)
    eval_s = [0.0]

    def timed_eval(p):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = eval_fn(p)
        eval_s[0] += time.perf_counter() - t
        return out

    tr = FederatedTrainer(loss, params, clients, eta=cfg["eta"],
                          batch_size=cfg["batch"], seed=0, backend=backend,
                          device=dev, **scenario)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.run(sched, sp, ch.uplink, ch.downlink,
                  eval_fn=timed_eval if evaluate else None, eval_every=10,
                  stop_delay=cfg["t0"], stop_energy=cfg["e0"])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0 - eval_s[0]
    return tr, hist, train_s


# the port's kernels as torch.profiler names them
PORT_SYMBOLS = ("importance_masks_kernel", MASK_SYMBOL,
                AGG_SYMBOL, HIST_SYMBOL,
                "fedsgd_aggregate_kernel",
                "client_rank_sort_kernel", "client_rank_sort_generic_kernel",
                MASKED_SYMBOL)


def profile_rounds(dev, clients, sp, ch, sched, params, n=5, cfg=SLICE,
                   **scenario) -> dict:
    """Where a packed round's time goes: the first rounds of the schedule
    again, under torch.profiler (after one warm round); the device's busy
    time against the host's wall clock, the port's kernels' share, and the
    kernels that take most. `scenario` reaches the trainer."""
    from torch.profiler import ProfilerActivity, profile

    def rounds(lo, hi):
        return dataclasses.replace(sched, a=sched.a[lo:hi],
                                   lam=sched.lam[lo:hi],
                                   power=sched.power[lo:hi],
                                   freq=sched.freq[lo:hi])

    tr = FederatedTrainer(make_loss_fn(lenet_apply), params, clients,
                          eta=cfg["eta"], batch_size=cfg["batch"],
                          seed=0, backend="packed", device=dev, **scenario)
    tr.run(rounds(0, 1), sp, ch.uplink, ch.downlink)
    rest = rounds(1, n + 1)
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            tr.run(rest, sp, ch.uplink, ch.downlink)
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    except (AssertionError, RuntimeError) as err:
        return {"profile": f"not measured: {err}"}
    evs = sorted(_device_events(prof), key=lambda e: -e[2])
    busy_ms = sum(us for _, _, us in evs) / 1e3
    if not evs:
        return {"profile": "not measured: the trace shows no device time"}
    port_ms = sum(us for k, _, us in evs
                  if any(sym in k for sym in PORT_SYMBOLS)) / 1e3
    return {"profile_rounds": n, "wall_ms_per_round": wall_ms / n,
            "device_busy_ms_per_round": busy_ms / n,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "port_kernels_device_ms_per_round": port_ms / n,
            "kernel_launches_per_round": sum(c for _, c, _ in evs) / n,
            "top_kernels": [{"name": k[:120], "calls_per_round": c / n,
                             "device_ms_per_round": us / 1e3 / n}
                            for k, c, us in evs[:8]]}


# -- phases 4-6: the scenario axes ----------------------------------------------

def attack_env(dev):
    """The attack slice through the port's numpy copies, as the JAX
    package's build_environment builds it from
    benchmarks/robust_aggregation.attack_spec(ExpConfig(), ..., 0.3)."""
    c = ATTACK
    ds = make_dataset("synthetic-mnist", n_train=c["n_train"],
                      n_test=c["n_test"], noise=c["noise"], seed=c["seed"])
    parts = partition_by_dirichlet(ds.y_train, c["n_clients"], c["sigma"],
                                   rng=np.random.default_rng(c["seed"]))
    clients = [ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]
    test_hist = np.bincount(ds.y_test, minlength=10).astype(float)
    phi = phis(np.stack([cl.label_histogram(10) for cl in clients]),
               test_hist[None])
    sp = SystemParams.table1(c["n_clients"], dataset="mnist",
                             batch_size=c["batch"])
    ch = ChannelModel(c["n_clients"], path_loss=1e-5, seed=c["seed"])
    consts = BoundConstants(rounds_S=c["rounds"] - 1, batch_Z=c["batch"],
                            eta=c["eta"])
    sched = solve_p1(phi, c["e0"], c["t0"], ch.uplink, ch.downlink,
                     sp, consts, AOConfig(fix_selection=True, outer_iters=3,
                                          selection_method="paper",
                                          phi_coupling="mean"))
    params = lenet_init(torch.Generator().manual_seed(c["seed"]), device=dev)
    return ds, clients, sp, ch, sched, params


def first_rounds(sched, n):
    return dataclasses.replace(sched, a=sched.a[:n], lam=sched.lam[:n],
                               power=sched.power[:n], freq=sched.freq[:n])


def compare_backends(label, pk, ref) -> list[str]:
    """Packed against reference: parameters bit for bit, v as values,
    losses, per-round counts and counters equal."""
    (tr_pk, h_pk), (tr_ref, h_ref) = pk, ref
    problems = []
    bits = sum(int((tr_pk.params[k].view(torch.int32)
                    != tr_ref.params[k].view(torch.int32)).sum())
               for k in tr_pk.params)
    if bits:
        problems.append(f"{label}: {bits} parameter bits differ")
    for k in tr_pk.params:
        if not torch.equal(tr_pk.global_grad[k], tr_ref.global_grad[k]):
            problems.append(f"{label}: v[{k}] differs")
        if not bool(torch.isfinite(tr_pk.params[k]).all()):
            problems.append(f"{label}: non-finite parameters in {k}")
    if not np.array_equal([m.train_loss for m in h_pk],
                          [m.train_loss for m in h_ref], equal_nan=True):
        problems.append(f"{label}: per-round train losses differ")
    for f in ("n_faulted", "n_quarantined", "n_agg_adjusted"):
        if [getattr(m, f) for m in h_pk] != [getattr(m, f) for m in h_ref]:
            problems.append(f"{label}: per-round {f} differs")
    if tr_pk.fault_counters != tr_ref.fault_counters:
        problems.append(f"{label}: fault counters differ")
    if tr_pk.agg_counters != tr_ref.agg_counters:
        problems.append(f"{label}: aggregation counters differ")
    return problems


def attack_phase(dev, env):
    """60 rounds of each aggregator under the attack, both backends.
    Returns (problems, the coord_median run's launches, its packed
    trainer)."""
    c = ATTACK
    problems, acc = [], {}
    want = {"mean": {}, "coord_median": {"n_excluded": 480},
            "trimmed_mean": {"n_trimmed": 360}}
    median_launches = median_trainer = None
    for name, kw in ATTACK_AGGS:
        scenario = dict(
            fault_model=ScaledMalicious(rate=c["rate"], scale=c["scale"],
                                        seed=c["seed"], exact=True),
            aggregator=make_aggregator(name, **kw))
        pm.reset_launches()
        tr_pk, h_pk, s_pk = run_backend("packed", dev, *env, cfg=c,
                                        **scenario)
        launches = dict(pm.LAUNCHES)
        tr_ref, h_ref, s_ref = run_backend("reference", dev, *env, cfg=c,
                                           **scenario)
        n = len(h_pk)
        problems += compare_backends(f"attack/{name}", (tr_pk, h_pk),
                                     (tr_ref, h_ref))
        if n != c["rounds"]:
            problems.append(f"attack/{name}: ran {n} rounds")
        if tr_pk.fault_counters["n_corrupt_finite"] != 180:
            problems.append(f"attack/{name}: n_corrupt_finite "
                            f"{tr_pk.fault_counters['n_corrupt_finite']}")
        if tr_pk.agg_counters != want[name]:
            problems.append(f"attack/{name}: counters {tr_pk.agg_counters}")
        robust = name != "mean"
        expect = {"client_rank_sort": n if robust else 0,
                  "importance_mask_2d": n, "exponent_histogram": n,
                  "fedsgd_aggregate_weighted": 0 if robust else n}
        for k, v in expect.items():
            if launches[k] != v:
                problems.append(f"attack/{name}: {k} launched "
                                f"{launches[k]} times, expected {v}")
        acc[name] = h_pk[-1].test_accuracy
        print(json.dumps({
            "attack": name, "rounds": n, "packed_round_ms": 1e3 * s_pk / n,
            "reference_round_ms": 1e3 * s_ref / n,
            "test_accuracy": [(m.round, m.test_accuracy) for m in h_pk
                              if m.test_accuracy is not None],
            "fault_counters": tr_pk.fault_counters,
            "agg_counters": tr_pk.agg_counters, "launches": launches}))
        if name == "coord_median":
            median_launches, median_trainer = launches, tr_pk
            print(json.dumps({"attack_profile": name, **profile_rounds(
                dev, *env[1:], cfg=c, **scenario)}))
    for name in ("coord_median", "trimmed_mean"):
        if acc[name] is None or not acc[name] > 0.3:
            problems.append(f"attack/{name}: round-59 accuracy {acc[name]} "
                            "<= 0.3")
        elif not acc["mean"] <= acc[name] - 0.05:
            problems.append(f"attack: the attacked mean ({acc['mean']}) is "
                            f"not 0.05 below {name} ({acc[name]})")
    return problems, median_launches, median_trainer


def fault_phase(dev, env):
    """10 rounds of each fault axis, packed against reference."""
    ds, clients, sp, ch, sched, params = env
    env10 = (ds, clients, sp, ch, first_rounds(sched, 10), params)
    cases = [
        ("mixed+mean", dict(fault_model=MixedFaults(
            dropout_rate=0.25, corrupt_rate=0.25, seed=5)),
         ("n_dropped", "n_quarantined")),
        ("corrupt_nan+mean", dict(fault_model=CorruptUpload(
            rate=0.4, mode="nan", seed=5)), ("n_quarantined",)),
        ("gaussian_poison+norm_clip", dict(
            fault_model=GaussianPoison(rate=0.4, sigma=0.5, seed=5),
            aggregator=make_aggregator("norm_clip")), ("n_corrupt_finite",)),
        ("sign_flip+multi_krum+noise", dict(
            fault_model=SignFlip(rate=0.4, scale=2.0, seed=5),
            aggregator=make_aggregator("multi_krum", f=1),
            channel_noise=GaussianAggregateNoise(std=1e-3)),
         ("n_corrupt_finite",)),
    ]
    problems = []
    for label, scenario, bites in cases:
        pm.reset_launches()
        tr_pk, h_pk, s_pk = run_backend("packed", dev, *env10, cfg=ATTACK,
                                        evaluate=False, **scenario)
        launches = dict(pm.LAUNCHES)
        tr_ref, h_ref, s_ref = run_backend("reference", dev, *env10,
                                           cfg=ATTACK, evaluate=False,
                                           **scenario)
        problems += compare_backends(f"faults/{label}", (tr_pk, h_pk),
                                     (tr_ref, h_ref))
        for k in bites:
            if not tr_pk.fault_counters[k] > 0:
                problems.append(f"faults/{label}: {k} stayed 0")
        if "aggregator" not in scenario and \
                launches["fedsgd_aggregate_weighted"] != len(h_pk):
            problems.append(f"faults/{label}: the weighted kernel missed "
                            "rounds")
        print(json.dumps({"faults": label, "rounds": len(h_pk),
                          "packed_round_ms": 1e3 * s_pk / len(h_pk),
                          "reference_round_ms": 1e3 * s_ref / len(h_pk),
                          "fault_counters": tr_pk.fault_counters,
                          "agg_counters": tr_pk.agg_counters,
                          "launches": launches}))
    return problems


def entry_point_phase(dev, tr, env):
    """The entry points of the two kernels no trainer path calls, at the
    trained attack model: one unweighted FedSGD step over ten clients'
    uploads (one batch each), then the pruned-checkpoint update (w - eta*g)
    * mask at lambda = 0.5, packed and leaf by leaf. Returns (problems,
    launches)."""
    ds, clients, *_ = env
    eta, b = ATTACK["eta"], ATTACK["batch"]
    eng, pack = tr.engine, tr.pack
    ups = []
    for cl in clients:
        x = torch.as_tensor(cl.x[:b], device=dev)
        y = torch.as_tensor(cl.y[:b], device=dev)
        ups.append(eng._value_and_grad(tr._w, x, y,
                                       torch.ones(b, device=dev))[1])
    grads = torch.stack(ups)
    problems = []
    pm.reset_launches()
    w2, g, step = ops.packed_fedsgd_update(tr._w, grads, eta)
    q = ops.importance(w2, g)
    thr = kth_smallest_threshold(q, eng.prunable,
                                 int(0.5 * pack.n_prunable))
    _, mask = ops.packed_importance_mask(w2, g, eng.prunable, thr)
    wp = ops.packed_masked_update(w2, g, mask, eta)
    leaves = [ops.masked_update(a, gg, mm, eta) for a, gg, mm in zip(
        pack.unpack(w2).values(), pack.unpack(g).values(),
        pack.unpack(mask).values())]
    torch.cuda.synchronize()
    launches = dict(pm.LAUNCHES)
    if launches["fedsgd_aggregate"] != 1 or \
            launches["masked_update_2d"] != 1 + len(leaves):
        problems.append(f"entry points: launches {launches}")
    for a, (k, bb) in zip(leaves, pack.unpack(wp).items()):
        if not bits_equal(a.contiguous(), bb.contiguous()):
            problems.append(f"entry points: leaf {k} != packed update")
    unit = ops.packed_fedsgd_update_weighted(
        tr._w, grads, torch.ones(len(ups), device=dev),
        torch.tensor(np.float32(1.0 / len(ups)), device=dev), eng._eta)
    if not all(bits_equal(x, y) for x, y in zip((w2, g, step), unit)):
        problems.append("entry points: unweighted != unit-weighted")
    pruned = float((mask[eng.prunable > 0] == 0).float().mean())
    acc = make_eval_fn(lenet_apply, ds.x_test, ds.y_test,
                       device=dev)(pack.unpack(wp))
    if not (0.45 < pruned < 0.55 and np.isfinite(acc[0])):
        problems.append(f"entry points: pruned share {pruned}, eval {acc}")
    print(json.dumps({"entry_points": "fedsgd step + pruned checkpoint",
                      "pruned_share": pruned, "test_loss": acc[0],
                      "test_accuracy": acc[1], "launches": launches}))
    return problems, launches


# -- phase 7: the quickstart through the experiment API -------------------------

# examples/quickstart.py's spec (A) and the pruned slice's budgets and scheme
# through the same API (B); "auto" dispatch, the spec's default
QUICKSTART = dict(n_clients=10, sigma=5.0, n_train=4000, n_test=800,
                  rounds=40, eta=0.1, batch=32)
QUICK_SPECS = {"A": dict(scheme="proposed_exact", e0=250.0, t0=150.0,
                         eval_every=10),
               "B": dict(scheme="proposed", e0=25.0, t0=15.0,
                         eval_every=40)}
QUICK_WINDOW = 4          # rounds of each timed window (once 8)
# rounds of it under each profiler (CUDA, then CPU): the traces' host-side
# processing grows with their events, ~12,000 a per-round FedDyn round;
# over 8 rounds it took 111 of spec C's 240 s on an H100's host (PERF.md)
QUICK_PROFILED = 1
CKPT_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"


def quick_spec(name: str, **run):
    from repro_torch.api import (DataSpec, ExperimentSpec, ModelSpec, RunSpec,
                                 SchemeSpec, WirelessSpec)
    q, c = QUICKSTART, QUICK_SPECS[name]
    return ExperimentSpec(
        data=DataSpec(dataset="synthetic-mnist", n_clients=q["n_clients"],
                      sigma=q["sigma"], n_train=q["n_train"],
                      n_test=q["n_test"], seed=0),
        model=ModelSpec(name="lenet"),
        wireless=WirelessSpec(e0=c["e0"], t0=c["t0"], seed=0),
        scheme=SchemeSpec(name=c["scheme"], rounds=q["rounds"], eta=q["eta"],
                          batch=q["batch"]),
        run=RunSpec(seed=0, eval_every=c["eval_every"], **run))


class BlockCounter(Callback):
    """Counts the rounds that ran inside block dispatches."""

    def __init__(self):
        self.rounds = 0

    def on_block_end(self, start, n_rounds, trainer):
        self.rounds += n_rounds


class Grab(Callback):
    """Holds the trainer of the run it is passed to."""
    trainer = None

    def on_round_end(self, m, trainer):
        self.trainer = trainer


def quick_window(dev, env, spec, run_kw) -> dict:
    """Rounds 1..QUICK_WINDOW of the spec's schedule on a fresh trainer of
    one path, driven twice: first (the blocked path captures the window's
    graphs there) and again, timed on the host clock; then its first
    QUICK_PROFILED rounds under torch.profiler (CUDA): wall and
    device-busy ms a round, the idle share (against the profiled and the
    unprofiled wall), the device's kernels a round; then under the CPU
    profiler: the kernel launches, graph launches and copies the host
    issues a round."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import Experiment
    run = Experiment(dataclasses.replace(
        spec, run=dataclasses.replace(spec.run, evaluate=False,
                                      stop_on_budget=False, **run_kw))
                     ).build(env=env)
    sched = run.schedule
    win = dataclasses.replace(sched, a=sched.a[1:1 + QUICK_WINDOW],
                              lam=sched.lam[1:1 + QUICK_WINDOW],
                              power=sched.power[1:1 + QUICK_WINDOW],
                              freq=sched.freq[1:1 + QUICK_WINDOW])
    tr, ch = run.trainer, env.ch

    def drive(w=win):
        tr.run(w, env.sp, ch.uplink, ch.downlink)

    n, n_prof = QUICK_WINDOW, QUICK_PROFILED
    prof_win = dataclasses.replace(win, a=win.a[:n_prof],
                                   lam=win.lam[:n_prof],
                                   power=win.power[:n_prof],
                                   freq=win.freq[:n_prof])

    def drive_profiled():
        drive(prof_win)
    walls = []
    for _ in range(2):                # the first captures the graphs
        torch.cuda.synchronize()
        t = time.perf_counter()
        drive()
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t) / n)
    steady = {"first_ms_per_round": walls[0],
              "steady_ms_per_round": walls[1],
              "capture_s": (tr.engine.capture_seconds
                            if tr.engine is not None else 0.0)}
    t_prof = time.perf_counter()
    out = device_idle(drive_profiled)
    if "wall_ms" not in out:
        return {**steady, **out}
    out = {**steady, "profiled_rounds": n_prof,
           "profiled_wall_ms_per_round": out["wall_ms"] / n_prof,
           "device_busy_ms_per_round": out["device_busy_ms"] / n_prof,
           "device_idle_share": out["device_idle_share"],
           "device_kernels_per_round": out["kernel_launches"] / n_prof,
           "top_kernels": out["top_kernels"]}
    # idle against the unprofiled wall: CUPTI's tracing of a graph's
    # kernels stretches the profiled one
    out["device_idle_share_unprofiled"] = max(
        0.0, 1.0 - out["device_busy_ms_per_round"]
        / steady["steady_ms_per_round"])
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            drive_profiled()
            torch.cuda.synchronize()
        api = {ev.key: ev.count for ev in prof.key_averages()
               if ev.key.startswith("cuda")}
        out["host_calls_per_round"] = {
            k: api.get(k, 0) / n_prof for k in (
                "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch", "cudaMemcpyAsync")}
    except (AssertionError, RuntimeError) as err:
        out["host_calls_per_round"] = f"not measured: {err}"
    out["profiling_s"] = time.perf_counter() - t_prof   # both traces
    return out


def quickstart_phase(dev, card):
    """Specs A and B through repro_torch.api, each three ways: "auto"
    (32-round blocks on CUDA graphs), rounds_per_dispatch=1 and the
    reference backend. Parameters bit for bit across the three, v as
    values, equal histories (losses, selections, delays, energies, eval);
    on the blocked run every block round replays a graph (or is the eager
    round its graph was captured after), no batch is uploaded, and each
    round kernel launches once a round on both packed runs. Then a
    profiled window of each packed path, and kill and resume of spec A
    (checkpoints every 10 rounds, a raise after round 20's) against the
    uninterrupted blocked run, bit for bit. Returns (problems, launches of
    spec B's blocked run)."""
    from repro_torch.api import (Experiment, build_environment,
                                 resume_from_checkpoint)
    problems, rows = [], {}
    b_launches = {}
    for name in QUICK_SPECS:
        spec = quick_spec(name)
        env = build_environment(spec, device=dev)
        eval_s = [0.0]
        plain_eval = env.eval_fn

        def timed_eval(p, plain_eval=plain_eval):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = plain_eval(p)
            eval_s[0] = eval_s[0] + time.perf_counter() - t
            return out

        env = dataclasses.replace(env, eval_fn=timed_eval)
        runs = {}
        for path, run_kw in (("blocked", {}),
                             ("per_round", dict(rounds_per_dispatch=1)),
                             ("reference", dict(backend="reference"))):
            t = time.perf_counter()
            run = Experiment(dataclasses.replace(
                spec, run=dataclasses.replace(spec.run, **run_kw))
                             ).build(env=env)
            build_s = time.perf_counter() - t
            counter = BlockCounter()
            pm.reset_launches()
            eval_s[0] = 0.0
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run.run(callbacks=[counter])
            torch.cuda.synchronize()
            train_s = time.perf_counter() - t - eval_s[0]
            launches = dict(pm.LAUNCHES)
            tr = run.trainer
            n = len(res.history)
            row = {"rounds": n, "build_s": build_s,
                   "ms_per_round": 1e3 * train_s / n,
                   "card": card,
                   "final_accuracy": res.summary["final_accuracy"],
                   "block_dispatches": tr.n_block_dispatches,
                   "batch_uploads": tr.n_batch_uploads,
                   "rounds_per_dispatch": tr.rounds_per_dispatch}
            if tr.engine is not None:
                row.update(graphs_captured=tr.engine.graphs_captured,
                           capture_s=tr.engine.capture_seconds,
                           graph_replays=tr.engine.graph_replays,
                           block_rounds=counter.rounds,
                           launches={k: v for k, v in launches.items()
                                     if v})
                live = sum(1 for m in res.history if m.selected)
                for kname in ("exponent_histogram",
                              "fedsgd_aggregate_weighted"):
                    if launches[kname] != live:
                        problems.append(f"spec {name} {path}: {kname} "
                                        f"launches {launches[kname]} != "
                                        f"rounds {live}")
                masks = (launches["importance_mask_2d"]
                         + launches["importance_mask_batched"])
                if masks != live:
                    problems.append(f"spec {name} {path}: mask launches "
                                    f"{masks} != rounds {live}")
            runs[path] = (run, res)
            rows[f"{name} {path}"] = row
            print(json.dumps({"quickstart": name, "path": path, **row}))
        (rb, hb), (r1, h1), (rr, hr) = (runs[p] for p in
                                        ("blocked", "per_round",
                                         "reference"))
        row = rows[f"{name} blocked"]
        if row["rounds_per_dispatch"] != 32 or row["block_dispatches"] < 1:
            problems.append(f"spec {name}: 'auto' did not run 32-round "
                            f"blocks ({row})")
        if row["batch_uploads"] != 0:
            problems.append(f"spec {name}: the blocked run uploaded "
                            f"{row['batch_uploads']} batches")
        if row["graph_replays"] + row["graphs_captured"] != \
                row["block_rounds"] or row["graph_replays"] < 1:
            problems.append(f"spec {name}: graph replays "
                            f"{row['graph_replays']} + captures "
                            f"{row['graphs_captured']} != block rounds "
                            f"{row['block_rounds']}")
        if name == "A" and row["launches"].get("importance_mask_batched"):
            problems.append("spec A (one client a round) launched the "
                            "per-client mask kernel")
        if name == "B":
            b_launches = row["launches"]
            if not b_launches.get("importance_mask_batched"):
                problems.append("spec B never launched the per-client "
                                "mask kernel")
        for other, (ro, ho) in (("per_round", (r1, h1)),
                                ("reference", (rr, hr))):
            pb, po = rb.trainer.params, ro.trainer.params
            bits = sum(int((pb[k].view(torch.int32)
                            != po[k].view(torch.int32)).sum()) for k in pb)
            vb, vo = rb.trainer.global_grad, ro.trainer.global_grad
            if bits or not all(torch.equal(vb[k], vo[k]) for k in vb):
                problems.append(f"spec {name}: blocked != {other} "
                                f"({bits} parameter bits)")
            keys = ("round", "train_loss", "selected", "delay", "energy",
                    "cumulative_delay", "cumulative_energy", "test_loss",
                    "test_accuracy")
            if [[getattr(m, k) for k in keys] for m in hb.history] != \
                    [[getattr(m, k) for k in keys] for m in ho.history]:
                problems.append(f"spec {name}: blocked history != {other}")
        # spec A trains one non-IID client a round and stays near chance
        # on the test set (0.12-0.16); that it learns shows in its train
        # loss. Spec B is the pruned slice: phase 3's accuracy gate
        losses = np.asarray([m.train_loss for m in hb.history])
        if not np.isfinite(losses).all() or \
                not losses[-5:].mean() < losses[:5].mean():
            problems.append(f"spec {name}: the train loss did not fall "
                            f"({losses[:5].mean()} -> {losses[-5:].mean()})")
        acc = hb.summary["final_accuracy"]
        if name == "B" and not acc > 0.2:
            problems.append(f"spec {name}: final accuracy {acc} <= 0.2")
        windows = {path: quick_window(dev, env, spec, kw) for path, kw in (
            ("blocked", {}), ("per_round", dict(rounds_per_dispatch=1)))}
        print(json.dumps({"quickstart_window": name, "card": card,
                          "rounds": QUICK_WINDOW, **windows}))
        if name == "A":
            spec_a, env_a, res_a, run_a = spec, env, hb, rb

    # kill after round 20's checkpoint, then resume from the checkpoint's
    # own spec: the uninterrupted blocked run's parameters, bit for bit
    class KillAfter(Callback):
        checkpoint_every = 10

        def on_checkpoint(self, m, trainer):
            if m.round == 20:
                raise RuntimeError("simulated kill after round 20")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    spec = dataclasses.replace(spec_a, run=dataclasses.replace(
        spec_a.run, checkpoint_dir=str(CKPT_DIR), checkpoint_every=10))
    killed = False
    try:
        Experiment(spec).build(env=env_a).run(callbacks=[KillAfter()])
    except RuntimeError as err:
        killed = "simulated kill" in str(err)
    grab = Grab()
    t = time.perf_counter()
    resumed = resume_from_checkpoint(str(CKPT_DIR), callbacks=[grab],
                                     device=dev)
    resume_s = time.perf_counter() - t
    ok_hist = ([m.train_loss for m in resumed.history]
               == [m.train_loss for m in res_a.history])
    pa, pr = run_a.trainer.params, grab.trainer.params
    bits = sum(int((pa[k].view(torch.int32) != pr[k].view(torch.int32)
                    ).sum()) for k in pa)
    print(json.dumps({"quickstart_resume": "A", "killed": killed,
                      "resumed_from": resumed.summary["resumed_from"],
                      "rounds": len(resumed.history),
                      "history_equal": ok_hist,
                      "final_param_bits_differing": bits,
                      "resume_s": resume_s}))
    if not killed or resumed.summary["resumed_from"] != 20 or not ok_hist \
            or bits or len(resumed.history) != len(res_a.history):
        problems.append("spec A: kill and resume is not bit for bit")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return problems, b_launches


# -- phase 8: the paper's CIFAR-10 path (spec C) --------------------------------

# benchmarks/common.py's ExpConfig(dataset="synthetic-cifar10"): 10 clients,
# sigma = 1, ResNet-20, `proposed` at E0 = 4 J, T0 = 40 s, eta 0.1, batch 32
CIFAR = dict(n_clients=10, sigma=1.0, n_train=4000, n_test=800, e0=4.0,
             t0=40.0, eta=0.1, batch=32, eval_every=10)
# (label, local scheme, E, its kwargs, rounds). The FedSGD schedule
# spends more than the 4 J budget (47 J over 60 rounds), so the budget stop
# would end it early: it runs all its rounds; the others are feasible and
# keep the stop. Rounds cut beside the hybrid and MoE phases:
# FedSGD 60 -> 50 (at 40 its schedule takes one client a round, not 4),
# FedProx and FedAvg at E = 3 20 -> 10, FedDyn 20 -> 12 (its kill after
# round 10 and resume)
CIFAR_RUNS = (("fedsgd", "fedavg", 1, {}, 50),
              ("fedprox", "fedprox", 2, {"mu": 0.01}, 10),
              ("feddyn", "feddyn", 2, {"alpha": 0.01}, 12),
              ("fedavg_e3", "fedavg", 3, {}, 10))


def cifar_spec(label: str, **run):
    from repro_torch.api import (DataSpec, ExperimentSpec, ModelSpec, RunSpec,
                                 SchemeSpec, WirelessSpec)
    c = CIFAR
    _, local, steps, kw, rounds = next(r for r in CIFAR_RUNS
                                       if r[0] == label)
    run.setdefault("stop_on_budget", label != "fedsgd")
    return ExperimentSpec(
        data=DataSpec(dataset="synthetic-cifar10", n_clients=c["n_clients"],
                      sigma=c["sigma"], n_train=c["n_train"],
                      n_test=c["n_test"], seed=0),
        model=ModelSpec(name="resnet"),
        wireless=WirelessSpec(e0=c["e0"], t0=c["t0"], seed=0),
        scheme=SchemeSpec(name="proposed", rounds=rounds, eta=c["eta"],
                          batch=c["batch"], local_scheme=local,
                          local_steps=steps, local_kwargs=kw),
        run=RunSpec(seed=0, eval_every=c["eval_every"], **run))


def _param_bits(pa, pb) -> int:
    from repro_torch.tree import leaves
    return sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(leaves(pa), leaves(pb)))


def _h_bits(ta, tb) -> int:
    if ta._h is None or tb._h is None:
        return 0 if ta._h is tb._h else -1
    return int((ta._h.view(torch.int32) != tb._h.view(torch.int32)).sum())


def grad_and_relu_signs(params, apply, x, y, d, dtype, ctx):
    """The loss gradient of `apply` at `params` on the batch (x, y), on
    device `d` in `dtype` under the context `ctx`, as one fp64 vector on
    the CPU, and the sign of every torch.relu input (a list of boolean
    tensors on the CPU, in call order)."""
    from repro_torch.tree import leaves, unflatten
    ps = [t.to(d, dtype).requires_grad_(True) for t in leaves(params)]
    signs, relu = [], torch.relu

    def recorded(t):
        signs.append((t.detach() > 0).cpu())
        return relu(t)
    torch.relu = recorded
    try:
        with ctx():
            loss = make_loss_fn(apply)(unflatten(params, ps),
                                       x.to(d, dtype), y.to(d))
            g = torch.autograd.grad(loss, ps)
    finally:
        torch.relu = relu
    return torch.cat([t.reshape(-1).double().cpu() for t in g]), signs


def resnet_grad_accuracy(dev) -> dict:
    """ResNet-20's gradient on a CIFAR-shaped batch of 32 and LeNet's on an
    MNIST-shaped one against fp64 references taken on the CPU, as relative
    L2: under the engine's scope (exact_fp32: fp32, cuDNN's deterministic
    engines), with cuDNN off (torch's native convolution), on the CPU in
    fp32, and, the planted fault, without the scope under global TF32.
    Beside each, the ReLUs whose input took the other sign than in fp64
    (a kink flip zeroes or keeps a gradient element outright, and sets the
    reading: one flip among ~500,000 activations reads ~1e-4 to 1e-3 on
    any path; scripts/conv_scope_probe.py over six batches)."""
    import contextlib
    from repro_torch.device import exact_fp32
    from repro_torch.models import cnn

    def batch(shape):
        rng = np.random.default_rng(0)
        x = rng.normal(size=shape).astype(np.float32)
        return (torch.as_tensor(x),
                torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32)))

    models = {
        "": (resnet_init(torch.Generator().manual_seed(0), device="cpu"),
             cnn.resnet_apply, *batch((32, 32, 32, 3))),
        "lenet_": (lenet_init(torch.Generator().manual_seed(0),
                              device="cpu"), lenet_apply,
                   *batch((32, 28, 28, 1)))}

    def grad(model, d, dtype, ctx):
        return grad_and_relu_signs(*models[model], d, dtype, ctx)

    @contextlib.contextmanager
    def native():
        with exact_fp32():
            torch.backends.cudnn.enabled = False
            try:
                yield
            finally:
                torch.backends.cudnn.enabled = True

    @contextlib.contextmanager
    def tf32():
        conv = torch.backends.cudnn.conv
        prev = conv.fp32_precision
        conv.fp32_precision = "tf32"
        try:
            yield
        finally:
            conv.fp32_precision = prev

    cpu = torch.device("cpu")
    rel = {}
    for model in models:
        g64, s64 = grad(model, cpu, torch.float64, contextlib.nullcontext)
        rows = (("cuda_scoped", dev, exact_fp32),
                ("cpu_fp32", cpu, contextlib.nullcontext))
        if not model:
            rows += (("cuda_native_conv", dev, native),
                     ("cuda_tf32_unscoped", dev, tf32))
        for name, d, ctx in rows:
            g, signs = grad(model, d, torch.float32, ctx)
            rel[model + name] = float((g - g64).norm() / g64.norm())
            rel[model + name + "_relu_flips"] = sum(
                int((a != b).sum()) for a, b in zip(signs, s64))
    return rel


def cifar_phase(dev, card):
    """First ResNet-20's and LeNet's gradients against fp64
    (`resnet_grad_accuracy`: within 1e-3 relative L2 under the engine's
    scope, TF32 outside it above). Then spec C through
    repro_torch.api: FedSGD over 50 rounds, FedProx (E = 2) and FedAvg at
    E = 3 over 10 and FedDyn (E = 2) over 12, each three ways ("auto": 32-round
    blocks on CUDA graphs, one round a dispatch, the reference backend).
    Parameters and FedDyn's state bit for bit across the three, v as
    values, equal histories; the train loss of the last round below round
    0's on every run; the blocked runs replay a graph
    every block round (or capture it after the round) and upload no
    batch; kernels 2, 3 and 4 launch once a round on both packed runs
    (the masks: kernel 2 or, where a round's clients have different
    lambdas, kernel 1). Then the
    steady 4-round windows of FedSGD and FedDyn, blocked and per round,
    and kill after round 10's checkpoint of the blocked FedDyn run and
    `resume_from_checkpoint`: bit for bit, h included. Returns (problems,
    launches of each packed run)."""
    from repro_torch.api import (Experiment, build_environment,
                                 resume_from_checkpoint)
    problems, launches_by_run = [], {}
    # the phase's wall by part, host clock (where its time goes)
    parts = {}
    t = time.perf_counter()
    acc = resnet_grad_accuracy(dev)
    parts["grad_accuracy"] = time.perf_counter() - t
    print(json.dumps({"resnet20_grad_rel_l2_vs_fp64": acc, "card": card}))
    if not (acc["cuda_scoped"] < 1e-3 < acc["cuda_tf32_unscoped"]
            and acc["lenet_cuda_scoped"] < 1e-3):
        problems.append(f"ResNet-20's and LeNet's gradients against fp64: "
                        f"{acc}")
    t = time.perf_counter()
    env = build_environment(cifar_spec("fedsgd"), device=dev)
    parts["environment"] = time.perf_counter() - t
    parts["builds"] = parts["runs"] = parts["checks"] = 0.0
    keys = ("round", "train_loss", "selected", "delay", "energy",
            "cumulative_delay", "cumulative_energy", "test_loss",
            "test_accuracy")
    blocked = {}
    for label, *_ in CIFAR_RUNS:
        spec = cifar_spec(label)
        runs = {}
        for path, run_kw in (("blocked", {}),
                             ("per_round", dict(rounds_per_dispatch=1)),
                             ("reference", dict(backend="reference"))):
            t = time.perf_counter()
            run = Experiment(dataclasses.replace(
                spec, run=dataclasses.replace(spec.run, **run_kw))
                             ).build(env=env)
            build_s = time.perf_counter() - t
            parts["builds"] += build_s
            counter = BlockCounter()
            pm.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run.run(callbacks=[counter])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            parts["runs"] += wall_s
            launches = dict(pm.LAUNCHES)
            tr = run.trainer
            n = len(res.history)
            losses = [m.train_loss for m in res.history]
            row = {"rounds": n, "build_s": build_s,
                   "wall_s_with_eval": wall_s,
                   "ms_per_round_with_eval": 1e3 * wall_s / n,
                   "card": card,
                   "final_accuracy": res.summary["final_accuracy"],
                   "train_loss_first_last": [losses[0], losses[-1]],
                   "block_dispatches": tr.n_block_dispatches,
                   "batch_uploads": tr.n_batch_uploads}
            if not losses[-1] < losses[0]:
                problems.append(f"spec C {label} {path}: the train loss did "
                                f"not fall ({losses[0]} -> {losses[-1]})")
            if tr.engine is not None:
                live = sum(1 for m in res.history if m.selected)
                row.update(graphs_captured=tr.engine.graphs_captured,
                           capture_s=tr.engine.capture_seconds,
                           graph_replays=tr.engine.graph_replays,
                           block_rounds=counter.rounds,
                           launches={k: v for k, v in launches.items()
                                     if v})
                launches_by_run[f"{label} {path}"] = row["launches"]
                for kname in ("exponent_histogram",
                              "fedsgd_aggregate_weighted"):
                    if launches[kname] != live:
                        problems.append(f"spec C {label} {path}: {kname} "
                                        f"launches {launches[kname]} != "
                                        f"rounds {live}")
                if (launches["importance_mask_2d"]
                        + launches["importance_mask_batched"]) != live:
                    problems.append(f"spec C {label} {path}: mask launches "
                                    f"!= rounds {live}")
            runs[path] = (run, res)
            print(json.dumps({"cifar10": label, "path": path, **row}))
        t = time.perf_counter()
        (rb, hb) = runs["blocked"]
        blocked[label] = (spec, rb, hb)
        row_b = dict(graphs=rb.trainer.engine.graphs_captured,
                     replays=rb.trainer.engine.graph_replays,
                     uploads=rb.trainer.n_batch_uploads)
        if row_b["uploads"] or rb.trainer.n_block_dispatches < 1 or \
                row_b["replays"] < 1 or \
                row_b["graphs"] + row_b["replays"] != len(hb.history):
            problems.append(f"spec C {label}: the blocked run did not replay "
                            f"a graph every block round ({row_b})")
        for other in ("per_round", "reference"):
            ro, ho = runs[other]
            bits = _param_bits(rb.trainer.params, ro.trainer.params)
            vb, vo = rb.trainer.global_grad, ro.trainer.global_grad
            from repro_torch.tree import leaves
            v_eq = all(torch.equal(a, b) for a, b in zip(leaves(vb),
                                                         leaves(vo)))
            hbits = _h_bits(rb.trainer, ro.trainer)
            print(json.dumps({"cifar10": label, "blocked_vs": other,
                              "param_bits_differing": bits, "v_equal": v_eq,
                              "h_bits_differing": hbits}))
            if bits or not v_eq or hbits:
                problems.append(f"spec C {label}: blocked != {other} ({bits} "
                                f"parameter bits, v equal {v_eq}, {hbits} h "
                                "bits)")
            if [[getattr(m, k) for k in keys] for m in hb.history] != \
                    [[getattr(m, k) for k in keys] for m in ho.history]:
                problems.append(f"spec C {label}: blocked history != {other}")
        if label == "feddyn":
            h = rb.trainer._h
            if h is None or not float(h.abs().sum()) > 0:
                problems.append("spec C feddyn: h never moved")
        parts["checks"] += time.perf_counter() - t
    windows = {}
    for label in ("fedsgd", "feddyn"):
        t = time.perf_counter()
        spec = blocked[label][0]
        windows[label] = {path: quick_window(dev, env, spec, kw) for path, kw
                          in (("blocked", {}),
                              ("per_round", dict(rounds_per_dispatch=1)))}
        parts[f"window_{label}"] = time.perf_counter() - t
        print(json.dumps({"cifar10_window": label, "card": card,
                          "rounds": QUICK_WINDOW, **windows[label]}))
    t = time.perf_counter()

    # kill the blocked FedDyn run after round 10's checkpoint, resume from
    # the checkpoint's own spec: parameters and h bit for bit
    class KillAfter(Callback):
        checkpoint_every = 10

        def on_checkpoint(self, m, trainer):
            if m.round == 10:
                raise RuntimeError("simulated kill after round 10")

    spec_d, run_d, res_d = blocked["feddyn"]
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    spec = dataclasses.replace(spec_d, run=dataclasses.replace(
        spec_d.run, checkpoint_dir=str(CKPT_DIR), checkpoint_every=10))
    killed = False
    try:
        Experiment(spec).build(env=env).run(callbacks=[KillAfter()])
    except RuntimeError as err:
        killed = "simulated kill" in str(err)
    grab = Grab()
    resumed = resume_from_checkpoint(str(CKPT_DIR), callbacks=[grab],
                                     device=dev)
    ok_hist = ([m.train_loss for m in resumed.history]
               == [m.train_loss for m in res_d.history])
    bits = _param_bits(run_d.trainer.params, grab.trainer.params)
    hbits = _h_bits(run_d.trainer, grab.trainer)
    print(json.dumps({"cifar10_resume": "feddyn", "killed": killed,
                      "resumed_from": resumed.summary["resumed_from"],
                      "rounds": len(resumed.history),
                      "history_equal": ok_hist,
                      "final_param_bits_differing": bits,
                      "h_bits_differing": hbits,
                      "resumed_graph_replays":
                          grab.trainer.engine.graph_replays}))
    if not killed or resumed.summary["resumed_from"] != 10 or not ok_hist \
            or bits or hbits or len(resumed.history) != len(res_d.history):
        problems.append("spec C feddyn: kill and resume is not bit for bit")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    parts["kill_and_resume"] = time.perf_counter() - t
    print(json.dumps({"cifar10_phase_parts_s": parts, "card": card}))
    return problems, launches_by_run, windows


# -- phases 9-10: fleet streaming and the sweep service -------------------------

# random_k over a virtual roster: 8 clients a round at one lambda (kernels
# 2-4 prune), batch 4, unbounded budgets, 8-round blocks
FLEET = dict(k=8, lam=0.5, seed=1, batch=4, rpd=8, n_test=800)
# (a) and (b): LeNet over 1,000 clients (the JAX benchmark's parity cap,
# benchmarks/fleet_scaling.py PARITY_MAX_POP), 24 samples a client on
# average; (c): ResNet-20 over 50,000 clients, 2 a client (100,000 until
# the hybrid and MoE phases: its host-side environment build took 20 s)
FLEET_PARITY = dict(dataset="synthetic-fleet", model="lenet",
                    population=1_000, per_client=24, rounds=64)
FLEET_SCALE = dict(dataset="synthetic-fleet-cifar", model="resnet",
                   population=50_000, per_client=2, rounds=32)
FLEET_FEDDYN_ROUNDS = 32
PEAK_FLAT_FACTOR = 4.0    # benchmarks/fleet_scaling.py's flatness bound


def fleet_spec(cfg: dict, mode: str, rounds: int | None = None,
               scheme_kw=None, **run):
    from repro_torch.api import (DataSpec, ExperimentSpec, ModelSpec, RunSpec,
                                 SchemeSpec, WirelessSpec)
    f = FLEET
    return ExperimentSpec(
        data=DataSpec(dataset=cfg["dataset"], n_clients=cfg["population"],
                      n_train=cfg["per_client"] * cfg["population"],
                      n_test=f["n_test"], seed=0),
        model=ModelSpec(name=cfg["model"]),
        wireless=WirelessSpec(e0=1e12, t0=1e12, seed=0),
        scheme=SchemeSpec(name="random_k", rounds=rounds or cfg["rounds"],
                          eta=0.1, batch=f["batch"],
                          ao={"k": f["k"], "lam": f["lam"],
                              "seed": f["seed"]}, **(scheme_kw or {})),
        run=RunSpec(seed=0, evaluate=False, stop_on_budget=False,
                    rounds_per_dispatch=f["rpd"], client_store=mode, **run))


def _fleet_run(spec, env, card, label, trainer=None):
    """Build and run one fleet spec over `env` (on `trainer`, reset, when
    given), launch counts from 0; the run's row (ms a round, graphs, the
    fleet counters, launches)."""
    from repro_torch.api import Experiment
    run = Experiment(spec).build(env=env, trainer=trainer)
    counter = BlockCounter()
    pm.reset_launches()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run.run(callbacks=[counter])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t
    tr = run.trainer
    n = len(res.history)
    row = {"run": label, "card": card, "rounds": n,
           "ms_per_round": 1e3 * wall_s / n,
           "store_mode": tr.store_mode(), "streaming": tr.streaming,
           "block_dispatches": tr.n_block_dispatches,
           "batch_uploads": tr.n_batch_uploads,
           "launches": {k: v for k, v in pm.LAUNCHES.items() if v}}
    if tr.engine is not None:
        row.update(graphs_captured=tr.engine.graphs_captured,
                   graph_replays=tr.engine.graph_replays,
                   capture_s=tr.engine.capture_seconds,
                   block_rounds=counter.rounds)
    if tr.streaming:
        row["fleet"] = dict(tr.fleet_counters)
    print(json.dumps({"fleet": label, **row}))
    return run, res, row


def _round_launch_problems(label, row, live) -> list:
    c = row["launches"]
    out = [f"fleet {label}: {k} launches {c.get(k, 0)} != rounds {live}"
           for k in ("exponent_histogram", "fedsgd_aggregate_weighted")
           if c.get(k, 0) != live]
    masks = c.get("importance_mask_2d", 0) + \
        c.get("importance_mask_batched", 0)
    if masks != live:
        out.append(f"fleet {label}: mask launches {masks} != rounds {live}")
    return out


def fleet_phase(dev, card):
    """Fleet streaming through repro_torch.api (random_k, k 8, lambda 0.5,
    batch 4, 8-round blocks, evaluation off). (a) LeNet over a 1,000-client
    synthetic-fleet roster, 64 rounds, client_store "streamed",
    "replicated" and the reference backend: parameters bit for bit, v as
    values, equal histories, 8 cohort swaps, the streamed run's graph
    captures equal to the replicated run's, kernels 2-4 once a round; kill
    after round 32's checkpoint of a streamed run and resume, bit for bit.
    (b) FedDyn (E = 2, alpha 0.01) over 32 rounds of the same roster,
    streamed == replicated bit for bit, h included. (c) ResNet-20 over a
    50,000-client synthetic-fleet-cifar roster, 32 rounds, "auto": its
    replicated estimate is over the 1 GiB budget, so it streams; its peak
    cohort bytes per sample within 4x of (a)'s. Returns (problems, the
    streamed (a) run's launches)."""
    from repro_torch.api import (Experiment, build_environment,
                                 resume_from_checkpoint)
    problems = []
    keys = ("round", "train_loss", "selected", "delay", "energy",
            "cumulative_delay", "cumulative_energy")
    t = time.perf_counter()
    env = build_environment(fleet_spec(FLEET_PARITY, "streamed"), device=dev)
    env_s = time.perf_counter() - t
    runs = {}
    for label, mode, run_kw in (("streamed", "streamed", {}),
                                ("replicated", "replicated", {}),
                                ("reference", "streamed",
                                 dict(backend="reference"))):
        runs[label] = _fleet_run(fleet_spec(FLEET_PARITY, mode, **run_kw),
                                 env, card, f"parity {label}")
    (rs, hs, row_s), (rr, hr, row_r) = runs["streamed"], runs["replicated"]
    print(json.dumps({"fleet_parity_env_build_s": env_s, "card": card}))
    live = sum(1 for m in hs.history if m.selected)
    for label in ("streamed", "replicated"):
        problems += _round_launch_problems(f"parity {label}",
                                           runs[label][2], live)
    if not rs.trainer.streaming or row_s["fleet"]["n_cohort_swaps"] != 8:
        problems.append(f"fleet parity: not 8 cohort swaps ({row_s})")
    if row_s["graphs_captured"] != row_r["graphs_captured"]:
        problems.append("fleet parity: streamed captured "
                        f"{row_s['graphs_captured']} graphs, replicated "
                        f"{row_r['graphs_captured']}")
    if row_s["graphs_captured"] + row_s["graph_replays"] != \
            row_s["block_rounds"] or row_s["batch_uploads"]:
        problems.append(f"fleet parity: the streamed blocks did not replay "
                        f"a graph every round ({row_s})")
    for other in ("replicated", "reference"):
        ro, ho, _ = runs[other]
        bits = _param_bits(rs.trainer.params, ro.trainer.params)
        v_eq = all(torch.equal(rs.trainer.global_grad[k],
                               ro.trainer.global_grad[k])
                   for k in rs.trainer.params)
        same = [[getattr(m, k) for k in keys] for m in hs.history] == \
            [[getattr(m, k) for k in keys] for m in ho.history]
        print(json.dumps({"fleet_parity": f"streamed vs {other}",
                          "param_bits_differing": bits, "v_equal": v_eq,
                          "history_equal": same}))
        if bits or not v_eq or not same:
            problems.append(f"fleet parity: streamed != {other} ({bits} "
                            f"parameter bits, v equal {v_eq}, history "
                            f"equal {same})")
    fleet_launches = row_s["launches"]
    per_sample_a = rs.trainer._cohort_slots.x[0, 0].nbytes + 4
    peak_a = row_s["fleet"]["peak_cohort_bytes"]
    # the same spec again on each packed trainer, reset (the sweep's
    # trainer pool): the streamed one rebuilds its cohort store but keeps
    # its slots, so it captures nothing new; steady ms a round
    for label, (run, _, row) in (("streamed", runs["streamed"]),
                                 ("replicated", runs["replicated"])):
        want = run.trainer.pack.pack(run.trainer.params).clone()
        _, _, again = _fleet_run(run.spec, env, card, f"rerun {label}",
                                 trainer=run.trainer)
        bits = int((run.trainer.pack.pack(run.trainer.params)
                    .view(torch.int32) != want.view(torch.int32)).sum())
        if bits or again["graphs_captured"] != row["graphs_captured"] or \
                again["graph_replays"] != row["graph_replays"] + 64:
            problems.append(f"fleet rerun {label}: {bits} parameter bits "
                            f"differ, graphs {row['graphs_captured']} -> "
                            f"{again['graphs_captured']}, replays "
                            f"{row['graph_replays']} -> "
                            f"{again['graph_replays']}")

    # kill after round 32's checkpoint, resume from the checkpoint's spec
    class KillAfter(Callback):
        checkpoint_every = 16

        def on_checkpoint(self, m, trainer):
            if m.round == 32:
                raise RuntimeError("simulated kill after round 32")

    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    spec = fleet_spec(FLEET_PARITY, "streamed", checkpoint_dir=str(CKPT_DIR),
                      checkpoint_every=16)
    killed = False
    try:
        Experiment(spec).build(env=env).run(callbacks=[KillAfter()])
    except RuntimeError as err:
        killed = "simulated kill" in str(err)
    grab = Grab()
    resumed = resume_from_checkpoint(str(CKPT_DIR), callbacks=[grab],
                                     device=dev)
    ok_hist = ([m.train_loss for m in resumed.history]
               == [m.train_loss for m in hs.history])
    bits = _param_bits(rs.trainer.params, grab.trainer.params)
    print(json.dumps({"fleet_resume": "parity streamed", "killed": killed,
                      "resumed_from": resumed.summary["resumed_from"],
                      "history_equal": ok_hist,
                      "final_param_bits_differing": bits,
                      "resumed_fleet": resumed.summary.get("fleet")}))
    if not killed or resumed.summary["resumed_from"] != 32 or not ok_hist \
            or bits or "fleet" not in resumed.summary:
        problems.append("fleet parity: kill and resume is not bit for bit")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    del runs, rr, hr, grab

    # (b) FedDyn over streamed cohorts: h bit for bit
    dyn = {}
    for mode in ("streamed", "replicated"):
        dyn[mode] = _fleet_run(fleet_spec(
            FLEET_PARITY, mode, rounds=FLEET_FEDDYN_ROUNDS,
            scheme_kw=dict(local_scheme="feddyn", local_steps=2,
                           local_kwargs={"alpha": 0.01})),
            env, card, f"feddyn {mode}")
    (ds_, dh, drow), (dr, drh, drow_r) = dyn["streamed"], dyn["replicated"]
    bits = _param_bits(ds_.trainer.params, dr.trainer.params)
    hbits = _h_bits(ds_.trainer, dr.trainer)
    same = [m.train_loss for m in dh.history] == \
        [m.train_loss for m in drh.history]
    print(json.dumps({"fleet_feddyn": "streamed vs replicated",
                      "param_bits_differing": bits, "h_bits_differing": hbits,
                      "history_equal": same}))
    if bits or hbits or not same or not drow.get("fleet") or \
            drow["graphs_captured"] != drow_r["graphs_captured"]:
        problems.append(f"fleet feddyn: streamed != replicated ({bits} "
                        f"parameter bits, {hbits} h bits, history {same}, "
                        f"graphs {drow.get('graphs_captured')} / "
                        f"{drow_r.get('graphs_captured')})")
    if ds_.trainer._h is None or not float(ds_.trainer._h.abs().sum()) > 0:
        problems.append("fleet feddyn: h never moved")
    del dyn, ds_, dr
    torch.cuda.empty_cache()

    # (c) ResNet-20 over 50,000 clients: "auto" streams
    t = time.perf_counter()
    spec = fleet_spec(FLEET_SCALE, "auto")
    env_c = build_environment(spec, device=dev)
    env_c_s = time.perf_counter() - t
    run_c, res_c, row_c = _fleet_run(spec, env_c, card, "scale auto")
    tr = run_c.trainer
    per_sample_c = tr._cohort_slots.x[0, 0].nbytes + 4
    peak_c = row_c.get("fleet", {}).get("peak_cohort_bytes", 0)
    scaled = (peak_c / per_sample_c) / (peak_a / per_sample_a)
    print(json.dumps({"fleet_scale": "resnet20 x 100000", "card": card,
                      "env_build_s": env_c_s,
                      "replicated_estimate_bytes": tr.store_nbytes(),
                      "budget_bytes": tr.device_mem_budget,
                      "ms_per_round": row_c["ms_per_round"],
                      "h2d_bytes": row_c.get("fleet", {}).get("h2d_bytes"),
                      "peak_cohort_bytes": peak_c,
                      "prefetch_stall_s":
                          row_c.get("fleet", {}).get("prefetch_stall_s"),
                      "graphs_captured": row_c["graphs_captured"],
                      "graph_replays": row_c["graph_replays"],
                      "peak_per_sample_vs_parity": scaled}))
    if tr.store_mode() != "streamed" or not tr.streaming:
        problems.append(f"fleet scale: 'auto' did not stream "
                        f"({tr.store_nbytes()} bytes estimated)")
    if not scaled <= PEAK_FLAT_FACTOR:
        problems.append(f"fleet scale: peak cohort bytes per sample "
                        f"{scaled:.2f}x the parity run's")
    losses = [m.train_loss for m in res_c.history]
    if len(losses) != FLEET_SCALE["rounds"] or \
            not np.isfinite(losses).all():
        problems.append(f"fleet scale: {len(losses)} rounds, losses "
                        f"finite {np.isfinite(losses).all()}")
    problems += _round_launch_problems("scale", row_c, len(losses))
    return problems, fleet_launches


# four cells: (synthetic-mnist, lenet) and (synthetic-cifar10, resnet)
# zipped, each over seeds 0 and 1, 10 rounds
SWEEP_DIR = pathlib.Path(__file__).resolve().parent / "build" / \
    "chip_smoke_sweep"


def sweep_phase(dev, card):
    """The sweep service on the card: four cells, workers=1 and then
    workers=2 (two ResNet cells in flight at once: exact_fp32 and graph
    captures under two threads), per-run JSONL byte-identical and one
    environment build per group; then a sweep killed during its third cell
    and resumed with workers=2, byte-identical again. Returns problems."""
    from repro_torch.api import (DataSpec, ExperimentSpec, JsonlDirSink,
                                 ModelSpec, RunSpec, SchemeSpec, SweepSpec,
                                 WirelessSpec, run_sweep)
    problems = []
    base = ExperimentSpec(
        data=DataSpec(dataset="synthetic-mnist", n_clients=10, sigma=1.0,
                      n_train=4000, n_test=800, seed=0),
        model=ModelSpec(name="lenet"),
        wireless=WirelessSpec(e0=1e12, t0=1e12, seed=0),
        scheme=SchemeSpec(name="random_k", rounds=10, eta=0.1, batch=32,
                          ao={"k": 4, "lam": 0.5, "seed": 1}),
        run=RunSpec(seed=0, eval_every=5, stop_on_budget=False,
                    checkpoint_every=5))
    sw = SweepSpec(base=base, seeds=[0, 1],
                   zip={"data.dataset": ["synthetic-mnist",
                                         "synthetic-cifar10"],
                        "model.name": ["lenet", "resnet"]})

    def files(d):
        return {p.name: p.read_bytes() for p in sorted(d.glob("0*.jsonl"))}

    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    out = {}
    for workers in (1, 2):
        d = SWEEP_DIR / f"w{workers}"
        t = time.perf_counter()
        res = run_sweep(sw, sink=JsonlDirSink(str(d)), workers=workers,
                        device=dev)
        wall = time.perf_counter() - t
        out[workers] = files(d)
        row = {"workers": workers, "card": card, "cells": len(res.cells),
               "wall_s": wall, "env_builds": res.n_env_builds,
               "trainer_builds": res.n_trainer_builds,
               "errors": [e["error"] for e in res.errors],
               "final_accuracy": [r.summary["final_accuracy"] if r else None
                                  for r in res.results]}
        print(json.dumps({"sweep": row}))
        if res.errors or res.n_env_builds != 2 or len(out[workers]) != 4:
            problems.append(f"sweep workers={workers}: {row}")
    if out[1] != out[2]:
        diff = sorted(k for k in out[1] if out[1][k] != out[2].get(k))
        problems.append(f"sweep: workers 1 and 2 differ in {diff}")

    class InterruptAfterRounds(Callback):
        def __init__(self, n):
            self.n, self.seen = n, 0

        def on_round_end(self, m, trainer):
            self.seen += 1
            if self.seen >= self.n:
                raise KeyboardInterrupt

    d = SWEEP_DIR / "killed"
    interrupted = False
    try:
        run_sweep(sw, sink=JsonlDirSink(str(d)), device=dev,
                  callbacks=[InterruptAfterRounds(2 * 10 + 7)])
    except KeyboardInterrupt:
        interrupted = True
    partial = len(files(d))
    t = time.perf_counter()
    res = run_sweep(sw, sink=JsonlDirSink(str(d)), workers=2, resume=True,
                    device=dev)
    row = {"interrupted": interrupted, "files_before_resume": partial,
           "skipped": res.n_skipped, "resume_wall_s": time.perf_counter() - t,
           "byte_identical": files(d) == out[1], "card": card}
    print(json.dumps({"sweep_resume": row}))
    if not interrupted or res.n_skipped != 2 or res.errors or \
            not row["byte_identical"]:
        problems.append(f"sweep: kill and resume is not byte for byte ({row})")
    shutil.rmtree(SWEEP_DIR, ignore_errors=True)
    return problems


# -- phase 34: the paper's Sec. V comparison, the six schemes -------------------

# the schemes that also run one round a dispatch and on the reference
# backend: lambda = 0 (the k <= 0 path the card had not run) and every
# client every round (the bucket of 10)
SEC5_PATHS = ("fixed_pruning", "fixed_selection")
SEC5_KERNELS = ("importance_mask_batched", "importance_mask_2d",
                "fedsgd_aggregate_weighted", "exponent_histogram")


def sec5_module():
    """scripts/sec5_records.py: the matrix, the records and the JAX
    reference's reader."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent
                           / "scripts"))
    import sec5_records
    return sec5_records


def sec5_phase(dev, card):
    """The paper's Sec. V comparison through repro_torch.api: the six
    SCHEMES at seed 0, 60 rounds each (fixed_power stops at 5 on its
    energy budget), as one SweepSpec through run_sweep, 32-round blocks on
    CUDA graphs ("auto"), one pooled trainer re-seeded between cells. Each
    scheme's schedule as run, rounds completed and cumulative energy and
    delay equal the JAX reference's (tests/torch_fixtures/sec5_jax.json)
    bit for bit; kernels 1-4's launches are read for each cell (from 0 as
    the cell starts) and must be once a round (the masks' two kernels
    together); fixed_pruning and fixed_selection also run one round a
    dispatch and on the reference backend, equal to the blocked run bit
    for bit (parameters, v as values, history). Prints the seed-0 table
    beside JAX's seed 0 and JAX's 8-seed mean. Returns (problems,
    {scheme: launches})."""
    import repro_torch.api as api
    from repro_torch.api import (Experiment, RunSink, build_environment,
                                 run_sweep)
    sec5 = sec5_module()
    reference = sec5.load_reference()
    problems, launches, state, graphs = [], {}, {}, {}
    grab = Grab()

    class CellSink(RunSink):
        """Reads each finished cell's launches and final state; the sweep
        runs its cells in order on one thread, so the counts set to 0 here
        are the next cell's from its start."""

        def begin(self, cells, *, resume=False):
            pm.reset_launches()

        def write(self, name, result):
            scheme = result.spec["scheme"]["name"]
            launches[scheme] = {k: pm.LAUNCHES[k] for k in SEC5_KERNELS}
            tr = grab.trainer
            state[scheme] = (
                {k: v.clone() for k, v in tr.params.items()},
                {k: v.clone() for k, v in tr.global_grad.items()})
            graphs[scheme] = {"rounds_per_dispatch": tr.rounds_per_dispatch,
                              "block_dispatches": tr.n_block_dispatches,
                              "graphs_captured": tr.engine.graphs_captured,
                              "graph_replays": tr.engine.graph_replays}
            pm.reset_launches()

    sweep = sec5.sec5_sweep(api, [0])
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run_sweep(sweep, sink=CellSink(), callbacks=[grab], device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    if res.errors:
        return [f"Sec. V sweep: {e['name']}: {e['error']}"
                for e in res.errors], launches
    port = sec5.collect(res.cells, res.results)
    sched_problems = sec5.schedule_problems(port, reference)
    problems += [f"Sec. V: {p}" for p in sched_problems]
    for name, entry in port.items():
        rec = entry["runs"]["0"]
        n = rec["rounds_completed"]
        got = launches[name]
        if got["exponent_histogram"] != n or \
                got["fedsgd_aggregate_weighted"] != n or \
                got["importance_mask_2d"] + got["importance_mask_batched"] \
                != n:
            problems.append(f"Sec. V {name}: launches {got} over {n} rounds")
        losses = np.asarray(rec["train_loss"])
        if not np.isfinite(losses).all():
            problems.append(f"Sec. V {name}: non-finite train losses")
        elif n >= 20 and not losses[-5:].mean() < losses[:5].mean():
            problems.append(f"Sec. V {name}: the train loss did not fall")
        g = graphs[name]
        if g["rounds_per_dispatch"] != 32 or g["block_dispatches"] < 1:
            problems.append(f"Sec. V {name}: not 32-round blocks ({g})")
    replays = graphs[sec5.SCHEMES[-1]]["graph_replays"]
    if replays < 1:
        problems.append("Sec. V: no CUDA graph was replayed")
    for kname in SEC5_KERNELS:
        if not any(c[kname] for c in launches.values()):
            problems.append(f"Sec. V: {kname} never launched")

    # fixed_pruning and fixed_selection one round a dispatch and on the
    # reference backend: the blocked run's bits
    paths = {}
    env = build_environment(res.cells[0].spec, device=dev)
    keys = ("round", "train_loss", "selected", "delay", "energy",
            "cumulative_delay", "cumulative_energy", "test_loss",
            "test_accuracy")
    for cell, blocked in zip(res.cells, res.results):
        name = cell.spec.scheme.name
        if name not in SEC5_PATHS:
            continue
        wb, vb = state[name]
        for path, run_kw in (("per_round", dict(rounds_per_dispatch=1)),
                             ("reference", dict(backend="reference"))):
            spec = dataclasses.replace(cell.spec, run=dataclasses.replace(
                cell.spec.run, **run_kw))
            torch.cuda.synchronize()
            t = time.perf_counter()
            run = Experiment(spec).build(env=env)
            out = run.run()
            torch.cuda.synchronize()
            paths[f"{name} {path}"] = time.perf_counter() - t
            wo, vo = run.trainer.params, run.trainer.global_grad
            bits = sum(int((wb[k].view(torch.int32)
                            != wo[k].view(torch.int32)).sum()) for k in wb)
            if bits or not all(torch.equal(vb[k], vo[k]) for k in vb):
                problems.append(f"Sec. V {name}: blocked != {path} "
                                f"({bits} parameter bits)")
            if [[getattr(m, k) for k in keys] for m in blocked.history] != \
                    [[getattr(m, k) for k in keys] for m in out.history]:
                problems.append(f"Sec. V {name}: blocked history != {path}")

    # the seed-0 table beside JAX's seed 0 and JAX's 8-seed mean
    rows = {}
    for name, entry in port.items():
        mine = entry["runs"]["0"]
        ref = reference["schemes"][name]
        j0, jall = ref["runs"]["0"], sec5.summarize(ref)
        rows[name] = {
            "rounds": mine["rounds_completed"],
            "energy": mine["cumulative_energy"],
            "delay": mine["cumulative_delay"],
            "final_accuracy": mine["final_accuracy"],
            "jax_seed0_final_accuracy": j0["final_accuracy"],
            "jax_mean_final_accuracy": jall["final_accuracy"],
            "jax_std_final_accuracy": jall["final_accuracy_std"],
            "last10_train_loss": mine["last10_train_loss"],
            "jax_seed0_last10_train_loss": j0["last10_train_loss"],
            "jax_mean_last10_train_loss": jall["last10_train_loss"],
            "launches": launches[name]}
        print(f"sec5 {name:16s} rounds {mine['rounds_completed']:2d} "
              f"E {mine['cumulative_energy']:.6f} J "
              f"D {mine['cumulative_delay']:.6f} s | acc "
              f"{mine['final_accuracy']:.3f} (JAX seed 0 "
              f"{j0['final_accuracy']:.3f}, 8 seeds "
              f"{jall['final_accuracy']:.3f} +- "
              f"{jall['final_accuracy_std']:.3f}) | last-10 loss "
              f"{mine['last10_train_loss']:.4f} (JAX seed 0 "
              f"{j0['last10_train_loss']:.4f}, 8 seeds "
              f"{jall['last10_train_loss']:.4f})")
    print(json.dumps({"sec5": rows, "card": card, "sweep_s": sweep_s,
                      "graphs": graphs, "paths_s": paths,
                      "schedules": sched_problems or "bit for bit JAX's"}))
    return problems, launches


# -- phase 24: the sharded client axis, two gloo ranks sharing the card --------

SHARDS = 2
SHARD_ROUNDS = 12          # spec B's first schedule, cut from 40 rounds
SHARD_SHORT = 8            # the median and FedDyn runs
SHARD_FLEET_ROUNDS = 16    # fleet (a): two 8-round blocks
# the mean path's (w, v) against the unsharded run's, max |diff| / max |ref|
SHARD_MEAN_RTOL = 1e-6
SHARD_CASES = ("spec_b_first", "spec_b_blocked", "spec_b_rounds", "median",
               "feddyn", "fleet_streamed", "fleet_replicated")
# kernel launches a round, per rank, of each sharded run: the mean path's
# partial sums are plain torch (kernel 3 stays off it, as in the JAX
# package's sharded body); the median reduces the gathered stack
SHARD_LAUNCHES = {
    "spec_b_blocked": {"exponent_histogram": 1, "fedsgd_aggregate_weighted": 0,
                       "client_rank_sort": 0},
    "median": {"exponent_histogram": 1, "importance_mask_2d": 1,
               "client_rank_sort": 1, "fedsgd_aggregate_weighted": 0},
    # FedDyn's whole tail runs on the gathered stacks on every rank
    "feddyn": {"exponent_histogram": 1, "fedsgd_aggregate_weighted": 1}}


def shard_spec_b(rpd, shards, **scheme):
    """Spec B (phase 7), evaluation and the budget stop off, `rpd` rounds a
    dispatch, over `shards` ranks; the runs take the first rounds of its
    40-round schedule (`shard_run`: round 2 gives each client its own k,
    so kernel 1 runs)."""
    s = quick_spec("B", rounds_per_dispatch=rpd, shards=shards,
                   evaluate=False, stop_on_budget=False)
    return dataclasses.replace(s, scheme=dataclasses.replace(s.scheme,
                                                             **scheme))


_SHARD_ENVS: dict = {}


def shard_run(spec, rounds, dev, env=None, trainer=None):
    """The spec built (on `env` / `trainer` when given, else on this
    process's environment of the same data and model), its schedule cut to
    its first `rounds` rounds."""
    from repro_torch.api import Experiment, build_environment
    if env is None:
        key = (repr(spec.data), repr(spec.model), str(dev))
        env = _SHARD_ENVS.get(key)
        if env is None:
            env = _SHARD_ENVS[key] = build_environment(spec, device=dev)
    run = Experiment(spec).build(device=dev, env=env, trainer=trainer)
    if rounds is not None:
        run.schedule = first_rounds(run.schedule, rounds)
    return run


class ShardWatch(Callback):
    """After each block: the rounds it ran, a digest of (w, v), and on a
    streamed run this rank's cohort rows held against its clients'."""

    def __init__(self, clients=None):
        self.clients = clients
        self.rounds, self.digests, self.cohorts = 0, [], []

    def on_block_end(self, start, n_rounds, trainer):
        import hashlib
        self.rounds += n_rounds
        h = hashlib.sha256()
        for t in (trainer._w, trainer._v):
            h.update(t.cpu().numpy().tobytes())
        self.digests.append(h.hexdigest())
        if self.clients is None or trainer._cohorts is None:
            return
        cohort = next(iter(trainer._cohorts._live.values()))
        ids = cohort.ids_by_shard[trainer.rank] if cohort.sharded \
            else cohort.ids_by_shard[0]
        rows = cohort.x[cohort.base:cohort.base + len(ids)].cpu().numpy()
        ok = all(np.array_equal(rows[k, :len(self.clients[int(c)].y)],
                                np.asarray(self.clients[int(c)].x))
                 for k, c in enumerate(ids))
        self.cohorts.append({"ids": len(ids), "rows_ok": bool(ok),
                             "sharded": bool(cohort.sharded),
                             "local_bytes": int(cohort.local_nbytes),
                             "bytes": int(cohort.nbytes)})


def shard_case(label: str, dev, shards: int) -> dict:
    """One run of the sharded phase on this process (shards 1: the
    parent's unsharded baseline), launch counts from 0 just before it;
    spec B blocked is built again on its trainer and timed (its graphs
    captured by the first run). Returns the run's row."""
    watch = ShardWatch()
    if label == "median":
        ds, clients, sp, ch, sched, params = attack_env(dev)
        c = ATTACK
        tr = FederatedTrainer(
            make_loss_fn(lenet_apply), params, clients, eta=c["eta"],
            batch_size=c["batch"], seed=0, device=dev, shards=shards,
            rounds_per_dispatch=4,
            fault_model=ScaledMalicious(rate=c["rate"], scale=c["scale"],
                                        seed=c["seed"], exact=True),
            aggregator=make_aggregator("coord_median"))
        pm.reset_launches()
        hist = tr.run(first_rounds(sched, SHARD_SHORT), sp, ch.uplink,
                      ch.downlink, callbacks=[watch])
        launches = dict(pm.LAUNCHES)
    else:
        rounds = None
        if label.startswith("fleet"):
            spec = fleet_spec(FLEET_PARITY, label.split("_")[1],
                              rounds=SHARD_FLEET_ROUNDS, shards=shards)
        elif label == "feddyn":
            spec, rounds = shard_spec_b(4, shards, local_scheme="feddyn",
                                        local_steps=2,
                                        local_kwargs={"alpha": 0.1}), \
                SHARD_SHORT
        else:
            spec = shard_spec_b(4 if label == "spec_b_blocked" else 1,
                                shards)
            rounds = 1 if label == "spec_b_first" else SHARD_ROUNDS
        run = shard_run(spec, rounds, dev)
        if label == "fleet_streamed":
            watch.clients = run.env.clients
        pm.reset_launches()
        res = run.run(callbacks=[watch])
        launches = dict(pm.LAUNCHES)
        hist, tr = res.history, run.trainer
    _sync(dev)
    eng = tr.engine
    row = {"rounds": len(hist), "live_rounds": sum(1 for m in hist
                                                   if m.selected),
           "losses": [m.train_loss for m in hist],
           "n_agg": [m.n_agg_adjusted for m in hist],
           "w": tr._w.cpu().numpy(), "v": tr._v.cpu().numpy(),
           "h": None if tr._h is None else tr._h.cpu().numpy(),
           "digests": watch.digests, "block_rounds": watch.rounds,
           "cohorts": watch.cohorts, "launches": launches,
           "collectives": eng.collectives, "gather_s": eng.gather_seconds,
           "sync_s": eng.sync_seconds,
           "graphs_captured": eng.graphs_captured,
           "graph_replays": eng.graph_replays}
    if label == "spec_b_blocked" and eng.last_gathered is not None:
        rl = tr._w.numel()
        # the trainer's 1/n when every weighted client survived
        inv = np.float32(1.0 / float(eng.last_gathered[:, rl].sum()))
        rep = replay_shard_mean(eng.last_gathered, rl, inv)
        row["replay_bitwise"] = bool(torch.equal(
            rep.view(torch.int32), tr._v.cpu().reshape(-1).view(torch.int32)))
    if label == "spec_b_blocked":
        # the same rounds again on the same trainer (reset): every round a
        # replay of the graphs the first run captured
        run = shard_run(spec, SHARD_ROUNDS, dev, env=run.env, trainer=tr)
        c0, g0, s0 = eng.collectives, eng.gather_seconds, eng.sync_seconds
        _sync(dev)
        t = time.perf_counter()
        run.run()
        _sync(dev)
        n = len(hist)
        row["ms_per_round"] = 1e3 * (time.perf_counter() - t) / n
        row["gather_ms_per_round"] = 1e3 * (eng.gather_seconds - g0) / n
        row["copy_out_ms_per_round"] = 1e3 * (eng.sync_seconds - s0) / n
        row["timed_collectives"] = eng.collectives - c0
    return row


def spread_case(dev, shards: int) -> dict:
    """One per-client round of spec B's engine whose thresholds differ
    between the ranks' client positions (spec B's own per-client round
    gives both halves the same k list): the trainer's initial w, a seeded
    v, 16 samples of each of 8 clients, lambda spread over [0.1, 0.8].
    Launch counts from 0 just before it."""
    run = shard_run(shard_spec_b(1, shards), 1, dev)
    tr, eng = run.trainer, run.trainer.engine
    v = (1e-2 * np.random.default_rng(7).normal(size=tuple(tr._w.shape))
         ).astype(np.float32) * eng.pack.valid_mask()
    cl = run.env.clients[:8]
    xs = np.stack([np.asarray(c.x)[:16] for c in cl])
    ys = np.stack([np.asarray(c.y)[:16] for c in cl])
    c0 = eng.collectives
    pm.reset_launches()
    w2, g, losses, thr = eng.round_step(
        tr._w.clone(), torch.as_tensor(v, device=dev), xs, ys,
        np.linspace(0.1, 0.8, len(cl)))[:4]
    launches = dict(pm.LAUNCHES)
    _sync(dev)
    row = {"w": w2.cpu().numpy(), "v": g.cpu().numpy(),
           "thr": thr.cpu().numpy(), "launches": launches,
           "collectives": eng.collectives - c0}
    if eng.last_gathered is not None:
        rep = replay_shard_mean(eng.last_gathered, g.numel(),
                                np.float32(1.0 / len(cl)))
        row["replay_bitwise"] = bool(torch.equal(
            rep.view(torch.int32), g.cpu().reshape(-1).view(torch.int32)))
    return row


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def shard_ranks(group) -> dict:
    """A rank of the sharded phase: every case at the group's size on the
    shared card (the parent built the kernels)."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if group.device.type == "cuda":
        _build.load()
    out = {label: shard_case(label, group.device, group.world)
           for label in SHARD_CASES}
    out["spread"] = spread_case(group.device, group.world)
    return out


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float(np.max(np.abs(a.astype(np.float64) - b))
                 / max(float(np.max(np.abs(b))), 1e-30))


def sharded_phase(dev, card):
    """The sharded client axis (ROADMAP.md §1 item 8 (a)) on the card: two
    gloo ranks sharing it, spawned after the parent built the kernels.
    Spec B (LeNet, per-client lambda: kernels 1 and 4) over 12 rounds in
    4-round blocks on capture-split CUDA graphs and one round a dispatch,
    the attack slice's coordinate-wise median (kernel 6) and FedDyn on
    spec B over 8 rounds, and fleet (a) streamed with sharded cohorts and
    replicated over 16 rounds; the unsharded baselines run here first.
    Checks: sharded blocks == sharded rounds, median and FedDyn sharded ==
    unsharded, streamed == replicated, all bit for bit; the mean path's v
    is the host's shard-order replay of its last round's gathered partials
    bit for bit, and its (w, v) after round 0, after 12 rounds and after a
    round whose per-client thresholds differ between the ranks' positions
    (`spread_case`) within 1e-6 (of their scale) of the unsharded run's;
    both ranks' (w, v) equal after every block; one collective a round;
    the kernels' launches per rank as predicted; each rank's cohort rows
    are its sub-cohort's clients' and its bytes about 1/2 of the unsharded
    cohort's. Prints ms a round at 1 and 2 ranks, the gather's ms a round
    and the captures. Returns problems."""
    from repro_torch.launch.mesh import spawn_shards
    problems = []
    t = time.perf_counter()
    one = {label: shard_case(label, dev, 1)
           for label in ("spec_b_first", "spec_b_blocked", "median",
                         "feddyn", "fleet_streamed")}
    one["spread"] = spread_case(dev, 1)
    t_one = time.perf_counter() - t
    t = time.perf_counter()
    ranks = spawn_shards(shard_ranks, SHARDS, device=str(dev),
                         timeout_s=300, threads=None)
    t_ranks = time.perf_counter() - t
    r0 = ranks[0]

    def same(a, b):
        return a.shape == b.shape and np.array_equal(a.view(np.int32),
                                                     b.view(np.int32))

    for label in SHARD_CASES:
        a = r0[label]
        for r, other in enumerate(ranks[1:], 1):
            b = other[label]
            if a["digests"] != b["digests"] or not (
                    same(a["w"], b["w"]) and same(a["v"], b["v"])):
                problems.append(f"sharded {label}: rank {r}'s (w, v) "
                                "differ from rank 0's")
        for r, rr in enumerate(ranks):
            if rr[label]["collectives"] != rr[label]["live_rounds"]:
                problems.append(
                    f"sharded {label}: rank {r} issued "
                    f"{rr[label]['collectives']} collectives over "
                    f"{rr[label]['live_rounds']} rounds with clients")
            for k, per in SHARD_LAUNCHES.get(label, {}).items():
                want = per * rr[label]["live_rounds"]
                if rr[label]["launches"].get(k, 0) != want:
                    problems.append(f"sharded {label}: rank {r} launched "
                                    f"{k} {rr[label]['launches'].get(k, 0)} "
                                    f"times, expected {want}")
        g, b = a["graphs_captured"], a["block_rounds"]
        if b and (g < 2 or g % 2 or a["graph_replays"] != 2 * b - g):
            problems.append(f"sharded {label}: {g} graphs captured, "
                            f"{a['graph_replays']} replays over {b} block "
                            "rounds (two graphs a round)")
    blk, rnd = r0["spec_b_blocked"], r0["spec_b_rounds"]
    if not (same(blk["w"], rnd["w"]) and same(blk["v"], rnd["v"])
            and blk["losses"] == rnd["losses"]):
        problems.append("sharded spec B: blocks != rounds")
    sb = (r0["spec_b_blocked"]["launches"]["importance_mask_batched"]
          + r0["spec_b_blocked"]["launches"]["importance_mask_2d"])
    if sb != blk["live_rounds"] or \
            not r0["spec_b_blocked"]["launches"]["importance_mask_batched"]:
        problems.append(f"sharded spec B: mask launches {sb} over "
                        f"{blk['live_rounds']} rounds (kernel 1 must run)")
    if not blk.get("replay_bitwise"):
        problems.append("sharded spec B: v != the host's replay of the "
                        "gathered partials")
    # the mean path reassociates only the cross-shard sum: round 0 (a
    # shared k, kernel 2), the 12 rounds (round 2 gives each client its
    # own k, but both ranks' halves the same k list) and the spread round
    # (kernel 1 on each rank's own, different thresholds) stay within
    # 1e-6 of the unsharded run
    first, spread = r0["spec_b_first"], r0["spread"]
    rel_w = _rel(first["w"], one["spec_b_first"]["w"])
    rel_v = _rel(first["v"], one["spec_b_first"]["v"])
    run_w = _rel(blk["w"], one["spec_b_blocked"]["w"])
    run_v = _rel(blk["v"], one["spec_b_blocked"]["v"])
    spr_w = _rel(spread["w"], one["spread"]["w"])
    spr_v = _rel(spread["v"], one["spread"]["v"])
    half = len(spread["thr"]) // SHARDS
    for r, rr in enumerate(ranks):
        s = rr["spread"]
        if not (same(s["w"], spread["w"]) and same(s["v"], spread["v"])
                and same(s["thr"], one["spread"]["thr"])
                and s["collectives"] == 1 and s.get("replay_bitwise")
                and s["launches"].get("importance_mask_batched") == 1):
            problems.append(f"sharded spread round: rank {r}'s (w, v), "
                            "thresholds, collective, replay or kernel 1")
    if np.array_equal(spread["thr"][:half], spread["thr"][half:]):
        problems.append("sharded spread round: the ranks' thresholds agree")
    for what, dw, dv in (("round 0", rel_w, rel_v),
                         (f"{SHARD_ROUNDS} rounds", run_w, run_v),
                         ("the spread round", spr_w, spr_v)):
        if not (dw <= SHARD_MEAN_RTOL and dv <= SHARD_MEAN_RTOL):
            problems.append(f"sharded spec B: (w, v) after {what} {dw}, "
                            f"{dv} from the unsharded run's")
    for label in ("median", "feddyn"):
        a, b = r0[label], one[label]
        keys = ("w", "v", "h") if label == "feddyn" else ("w", "v")
        if not all(same(a[k], b[k]) for k in keys) or \
                a["losses"] != b["losses"] or a["n_agg"] != b["n_agg"]:
            problems.append(f"sharded {label}: != the unsharded run")
    st, rep = r0["fleet_streamed"], r0["fleet_replicated"]
    if not (same(st["w"], rep["w"]) and same(st["v"], rep["v"])
            and st["losses"] == rep["losses"]):
        problems.append("sharded fleet: streamed != replicated")
    unsharded_bytes = max(c["bytes"] for c in one["fleet_streamed"]["cohorts"])
    ratios = []
    for r, rr in enumerate(ranks):
        cs = rr["fleet_streamed"]["cohorts"]
        if not cs or not all(c["rows_ok"] and c["sharded"] for c in cs):
            problems.append(f"sharded fleet: rank {r}'s cohort rows")
        ratios.append(max(c["local_bytes"] for c in cs) / unsharded_bytes
                      if cs else None)
    if not all(x is not None and x <= 1.0 / SHARDS + 0.1 for x in ratios):
        problems.append(f"sharded fleet: cohort bytes a rank over the "
                        f"unsharded cohort's {ratios}")
    print(json.dumps({"sharded": {
        "card": card, "ranks": SHARDS, "backend": "gloo",
        "spec_b_ms_per_round": {"1": one["spec_b_blocked"]["ms_per_round"],
                                str(SHARDS): blk["ms_per_round"]},
        "gather_ms_per_round": blk["gather_ms_per_round"],
        "copy_out_ms_per_round": blk["copy_out_ms_per_round"],
        "timed_collectives": blk["timed_collectives"],
        "rounds": {k: r0[k]["rounds"] for k in SHARD_CASES},
        "live_rounds": {k: r0[k]["live_rounds"] for k in SHARD_CASES},
        "collectives": {k: r0[k]["collectives"] for k in SHARD_CASES},
        "graphs_captured": {k: r0[k]["graphs_captured"] for k in SHARD_CASES},
        "graph_replays": {k: r0[k]["graph_replays"] for k in SHARD_CASES},
        "launches_rank0": {k: {n: c for n, c in r0[k]["launches"].items()
                               if c} for k in SHARD_CASES},
        "spec_b_round0_vs_unsharded": {"w_rel": rel_w, "v_rel": rel_v},
        "spec_b_12_rounds_vs_unsharded": {"w_rel": run_w, "v_rel": run_v},
        "spread_round_vs_unsharded": {"w_rel": spr_w, "v_rel": spr_v},
        "replay_bitwise": blk.get("replay_bitwise"),
        "fleet_cohort_bytes_rank_over_unsharded": ratios,
        "fleet_unsharded_cohort_bytes": unsharded_bytes,
        "unsharded_s": t_one, "ranks_s": t_ranks}}))
    return problems


# -- phases 11-13: the LM stack, serving granite-3-2b and mamba2-130m ---------

LM_SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "flash_attention_bwd":
                  "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
              "decode_attention":
                  "src/repro_torch/kernels/csrc/decode_attention.cu",
              "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu"}
# the kernels each LM wrapper launches (names as in the device trace): the
# flash wrapper takes the kernel of fa.BF16_KERNELS for bf16 (warp-
# specialised at D 64 / 128, wgmma at 256), the SSD wrapper its wgmma
# kernel, and both the CUDA-core kernel for fp32
LM_SYMBOLS = {"flash_attention": (fa.CORE_KERNEL,
                                  *sorted(set(fa.BF16_KERNELS.values()))),
              "flash_attention_bwd": ("flash_bwd_",),
              "decode_attention": ("decode_attention_kernel",),
              "ssd_chunk": ("ssd_chunk_kernel", "ssd_chunk_wgmma_kernel")}
LM_REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:80",
               # no Pallas kernel: the port of the jnp backward scan
               "flash_attention_bwd": "src/repro/models/flash_vjp.py:93",
               "decode_attention": "src/repro/kernels/decode_attention.py:60",
               "ssd_chunk": "src/repro/kernels/ssd_chunk.py:49"}
# the kernel tolerance of the JAX package's tests (tests/test_kernels.py)
BF16_TOL = 2e-2
# logits_rel_l2: |kernel - naive| / |naive| over the last-token logits of
# one fp32 prefill; fp32 rounding carried through the layers stays orders
# below it, a kernel that reads the causal band one key off lands above it.
# layers: the served model's depth, cut from 40 to 4 (full width kept) so
# that the whole script ends within half its limit (PERF.md section 4,
# "Cuts"). n_sequential: how many prefill
# lengths have their first request held to sequential generation (None:
# every one)
GRANITE = dict(arch="granite-3-2b", n_requests=16, new_tokens=16,
               max_batch=8, max_seq=2048, buckets=(256, 512, 1024),
               len_lo=130, len_hi=1000, n_sequential=None,
               logits_rel_l2=1e-3, layers=4)
# hymba-1.5b at full width and depth on granite's traffic: the hybrid
# family prefills the exact prompt length (no padding into its SSM state),
# so its 16 lengths are all distinct; the first of them and a request in a
# reused slot are held to sequential generation. Its depth is cut from 32
# to 2 layers (full width kept) for the script's time; not below 2, as the
# fp32 logits check needs two layers for its planted fault to show
HYMBA = dict(GRANITE, arch="hymba-1.5b", layers=2, n_sequential=1)
# mixtral-8x22b at full width, 2 of its 56 layers (5.0 GB of bf16 a layer;
# 4 until the sharded phase needed the time); padded buckets, so its
# padding tokens share expert capacity with the prompt's, and the
# sequential generation is fed the same padded prefill. Its fp32 logits
# check runs on a copy of the same two layers (at one layer the planted
# fault cannot show: the last query sees every key, and attention does
# not see their order)
MIXTRAL = dict(GRANITE, arch="mixtral-8x22b", layers=2, logit_layers=2)
# whisper-small at full width, its encoder at full depth (12 layers) and
# its decoder cut from 12 to 4 layers for the script's time (the decode
# steps are host-bound a layer at a time): prompts under the source's
# 448-position decoder cap, all past the
# 128-token naive rule, padded to (256, 512); one random encoder input
# (numpy seed `memory_seed`) shared by every request.
# memory_rel_l2: another memory must move the bf16 prefill's logits by
# more than this relative L2 (the fp32 gate's scale; a cross path that was
# dropped moves them by exactly 0, the same bf16 ops on the same inputs)
WHISPER = dict(GRANITE, arch="whisper-small", layers=4, len_lo=130,
               len_hi=440, buckets=(256, 512), max_seq=512, memory_seed=1,
               memory_rel_l2=1e-3)
# llama-3.2-vision-90b at full width on one group (4 self layers and the
# gated cross layer, 6.5e9 parameters with the embedding, head and
# vision_proj), granite's traffic, its gates opened to `gate` before every
# check
VISION = dict(GRANITE, arch="llama-3.2-vision-90b", layers=5, memory_seed=1,
              memory_rel_l2=1e-3, gate=1.0)
# gemma2-9b at full width, 4 of its 42 layers (2 local + 2 global,
# alternating as init_params builds them), granite's traffic cut to 15
# requests and, last, one of exactly 4,609 tokens: its 4,608-token prefill
# fills the 4,608 bucket with no padding (fill_ring keeps the last window
# positions of the padded prefill, so a padded bucket past the window would
# ring padding in both packages, ROADMAP section 3), passes the 4,096-token
# window (kernel 8 masks keys on the local layers) and wraps their ring by
# 512 positions before decode. Softcap 50 in kernel 8, 30 on the logits.
GEMMA2 = dict(GRANITE, arch="gemma2-9b", layers=4, long_prompts=(4609,),
              buckets=(256, 512, 1024, 4608), max_seq=4672)
# qwen2.5-3b at full width (16/2 heads of 128, g = 8; the tied
# 151,936-word head), 4 of its 36 layers, granite's traffic. Its QKV biases
# are drawn non-zero before any check (`draw_qkv_bias`: both packages
# initialise them to 0), and the fp32 prefill with them zeroed must move
# the logits by more than the gate's limit (bias_check)
QWEN = dict(GRANITE, arch="qwen2.5-3b", layers=4, bias_check=True)
# yi-9b at full width (32/4 heads of 128, g = 8; the untied 64,000-word
# embedding and head), 2 of its 48 layers, granite's traffic
YI = dict(GRANITE, arch="yi-9b", layers=2)
# arctic-480b at full width on one of its 35 layers (128 experts, top-2,
# the dense residual MLP, 56/8 heads of 128: g = 7; 1.41e10 parameters,
# 28.1 GB of bf16),
# granite's traffic on padded buckets as mixtral's. Its fp32 gate runs
# last, on the served model drawn again in fp32 in place of the served tree
# (fp32_redraw, `_fp32_redrawn`: a 56.3 GB fp32 copy beside the bf16
# weights would not fit), and compares
# the logits at every prefill position (all_positions: at one layer the
# last position's logits cannot show the late-band fault)
ARCTIC = dict(GRANITE, arch="arctic-480b", layers=1, all_positions=True,
              fp32_redraw=True)
# qwen2.5-3b's q/k/v biases are drawn standard normal (times this scale)
# on the card from a generator seeded with `QKV_BIAS_SEED`: the scale of
# x @ wq's entries, an RMS-normed x against 1/sqrt(d_model) weights
QKV_BIAS_SCALE = 1.0
QKV_BIAS_SEED = 7
QKV_BIASES = ("bq", "bk", "bv")
# mamba2-130m at full width, served and trained on 6 of its 24 layers
# (cut for the script's time: its host-bound decode and plain-scan
# training steps scale with depth)
MAMBA = dict(n_requests=8, new_tokens=16, max_batch=4, max_seq=2048,
             len_lo=100, len_hi=600, entry_len=512, chunk=128, layers=6)


def bf16_close(a, b) -> bool:
    """|a - b| <= 2e-2 + 2e-2 |b| everywhere (the bf16 kernel tolerance),
    and the same non-finite pattern."""
    a, b = a.float(), b.float()
    if a.shape != b.shape or not torch.equal(torch.isfinite(a),
                                             torch.isfinite(b)):
        return False
    fin = torch.isfinite(b)
    return bool(((a - b).abs()[fin] <= BF16_TOL + BF16_TOL * b.abs()[fin])
                .all())


def scaled_err(a, b) -> float:
    """max |a - b| over max |b|: the error at the output's own scale, for
    outputs far below the absolute term of bf16_close (inf where the
    shapes or non-finite patterns differ)."""
    a, b = a.float(), b.float()
    if a.shape != b.shape or not torch.equal(torch.isfinite(a),
                                             torch.isfinite(b)):
        return math.inf
    fin = torch.isfinite(b)
    err = float((a - b)[fin].abs().max()) if fin.any() else 0.0
    peak = float(b[fin].abs().max()) if fin.any() else 0.0
    return err / peak if peak else (0.0 if not err else math.inf)


def measure(name, ok, err, call, plain_call, symbols, nbytes, nflops, card,
            library_call=None, per_call=1, **extra):
    """One kernel's row: per-call time, the plain version's, the library
    call's, the wrapper's kernels on the device trace (per call, and which
    symbols they were; `per_call` kernels a call), and the bound from the
    bytes (3.35 TB/s) and the live FLOPs at the bf16 tensor-core peak."""
    bw, _, bf16 = peaks(card)
    ms = time_ms(call, reps=50)
    # a plain version slower than 20 ms a call (the blocked scans of the
    # training rows) is timed on 3 calls after one warm-up, not 20 after 10
    plain = time_ms(plain_call, reps=1, warmup=1)
    plain = time_ms(plain_call, reps=20) if plain < 20.0 else \
        time_ms(plain_call, reps=3, warmup=0)
    lib = time_ms(library_call, reps=50) if library_call is not None \
        else None
    dev_ms, dev_symbols, dev_events = kernel_device_ms(
        call, symbols, reps=20, per_call=per_call)
    bound = max(nbytes / bw, nflops / bf16) * 1e3
    row = dict(ok=bool(ok), max_abs_err=err, ms=ms, plain_ms=plain,
               device_ms=dev_ms, device_symbols=dev_symbols,
               device_events=dev_events,
               bound_ms=bound, library_ms=lib,
               bound_by="bytes" if nbytes / bw >= nflops / bf16
               else "operations", bytes=nbytes, flops=nflops, **extra)
    print(json.dumps({"kernel": name, **row}))
    return row


def _abs_err(a, b) -> float:
    return max_abs_err([a.float()], [b.float()])


def causal_pairs(s: int, window: int = 0) -> int:
    """Unmasked (q, k) pairs of causal self-attention over s tokens."""
    if not window:
        return s * (s + 1) // 2
    q = np.arange(s)
    return int(np.minimum(q + 1, window).sum())


# phase 11's softcapped rows: (s, hq, hkv, d, window, cap, q scale)
GEMMA2_FLASH_ROWS = {
    "gemma2 global S1024 cap 50": (1024, 16, 8, 256, 0, 50.0, 50.0),
    "gemma2 local S1024 window 256 cap 50":
        (1024, 16, 8, 256, 256, 50.0, 50.0)}


def lm_kernel_phase(dev, card):
    """The three LM kernels against their plain versions on random bf16
    inputs at the served models' shapes: flash attention at granite's
    prefill buckets, gemma2's head dim 256 with its softcap (global and
    local layer), whisper's 512 bucket (12/12 heads of 64, g = 1),
    llama-vision's 1024 bucket (64/8 heads of 128, g = 8) and arctic's
    (56/8 heads of 128, g = 7), decode
    attention at granite's [8, 2048, 8, 64] and gemma2's head dim with
    ragged positions, the SSD chunk at mamba2's. Returns (problems, the
    flash timing rows by shape label)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(0)
    problems = []

    def rand(shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32)).to(dev, torch.bfloat16)

    # gemma2's rows: q scaled by 50 puts the scores (~N(0, 50^2)) in the
    # softcap's bend, and the local row's window is cut from gemma2's 4096
    # to 256 so that it masks keys at 1024 tokens; each row must differ
    # from the same plain call without its cap / window, or that branch
    # went unchecked
    flash_rows = {}
    for label, (s, hq, hkv, d, window, cap, q_scale) in {
            "granite S256": (256, 32, 8, 64, 0, 0.0, 1.0),
            "granite S512": (512, 32, 8, 64, 0, 0.0, 1.0),
            "granite S1024": (1024, 32, 8, 64, 0, 0.0, 1.0),
            **GEMMA2_FLASH_ROWS,
            "whisper S512": (512, 12, 12, 64, 0, 0.0, 1.0),
            "llama-vision S1024": (1024, 64, 8, 128, 0, 0.0, 1.0),
            # arctic's served bucket, g = 7
            "arctic S1024": (1024, 56, 8, 128, 0, 0.0, 1.0)}.items():
        q, k, v = rand((1, hq, s, d), q_scale), rand((1, hkv, s, d)), \
            rand((1, hkv, s, d))
        kw = dict(causal=True, window=window, cap=cap)
        out = fa.flash_attention(q, k, v, **kw)
        ref = fa.flash_attention_plain(q, k, v, **kw)
        ok = bf16_close(out, ref)
        if not ok:
            problems.append(f"flash_attention {label}: differs from plain")
        for branch, off in (("cap", dict(kw, cap=0.0)),
                            ("window", dict(kw, window=0))):
            if kw[branch] and bf16_close(
                    fa.flash_attention_plain(q, k, v, **off), ref):
                problems.append(f"flash_attention {label}: the {branch} "
                                "changes nothing at these inputs")
        # the library call: SDPA, or under a softcap flex_attention
        lib, lib_row = None, {}
        if not cap:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        else:
            lib, _, lib_row = flex_library(q, k, v, out, None, True, window,
                                           cap)
            lib_row.pop("library_bwd_ms", None)
        nbytes = 2 * (2 * hq + 2 * hkv) * s * d
        flash_rows[label] = measure(
            "flash_attention", ok, _abs_err(out, ref),
            lambda q=q, k=k, v=v, kw=kw: fa.flash_attention(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_plain(q, k, v,
                                                                  **kw),
            LM_SYMBOLS["flash_attention"], nbytes,
            4 * d * hq * causal_pairs(s, window), card, library_call=lib,
            shape=label, **lib_row)
        problems += fwd_symbol_problems(f"flash_attention {label}",
                                        flash_rows[label], d)

    # decode: ragged positions, 0 and the full cache included
    for label, (hq, hkv, d) in {"granite": (32, 8, 64),
                                "gemma2": (16, 8, 256)}.items():
        b, skv = 8, 2048
        q, k, v = rand((b, hq, 1, d)), rand((b, skv, hkv, d)), \
            rand((b, skv, hkv, d))
        pos = torch.tensor([0, 1, 130, 517, 1000, 1031, 2047, 2048],
                           dtype=torch.int32, device=dev)
        out = da.decode_attention(q, k, v, pos)
        ref = da.decode_attention_plain(q, k, v, pos)
        ok = bf16_close(out, ref) and bool((out[0] == 0).all())
        if not ok:
            problems.append(f"decode_attention {label}: differs from plain")
        live = int(pos.clamp(0, skv).sum())
        valid = (torch.arange(skv, device=dev)[None, :]
                 < pos[:, None].long())[:, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        measure(
            "decode_attention", ok, _abs_err(out, ref),
            lambda q=q, k=k, v=v, pos=pos: da.decode_attention(q, k, v, pos),
            lambda q=q, k=k, v=v, pos=pos: da.decode_attention_plain(
                q, k, v, pos),
            LM_SYMBOLS["decode_attention"],
            2 * (2 * live * hkv * d + 2 * b * hq * d) + 4 * b,
            4 * d * hq * live, card,
            library_call=lambda q=q, kt=kt, vt=vt, valid=valid:
                F.scaled_dot_product_attention(q, kt, vt, attn_mask=valid,
                                               enable_gqa=True),
            shape=f"{label} [{b}, {skv}, {hkv}, {d}] ragged",
            positions=pos.tolist())

    # ssd_chunk at mamba2's head (P 64), state (N 128), chunk 128
    x = rand((1, 128, 24, 64), 0.3)
    bb, cc = rand((1, 128, 128), 0.3), rand((1, 128, 128), 0.3)
    dt = F.softplus(rand((1, 128, 24)).float())
    a_log = torch.log(torch.linspace(1.0, 16.0, 24, device=dev))
    outs = sc.ssd_chunk(x, bb, cc, dt, a_log)
    refs = sc.ssd_chunk_plain(x, bb, cc, dt, a_log)
    ok = all(bf16_close(o, r) for o, r in zip(outs, refs))
    print(json.dumps({"kernel": "ssd_chunk", "check": "random mamba2 chunk",
                      "equal": ok, "max_abs_err": max(
                          _abs_err(o, r) for o, r in zip(outs, refs))}))
    if not ok:
        problems.append("ssd_chunk: differs from plain on a random chunk")
    return problems, flash_rows


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def _expandable_segments(on: bool) -> None:
    """New segments of the caching allocator grow and shrink in place (on)
    or keep their size (off, torch's default), the cache emptied first so
    that what follows allocates in the new kind. Llama-vision's train step
    peaks at ~74 GiB of the card's 79.2: in fixed segments the cache's
    free blocks (4.6 GiB in one run) could hold none of its cross layer's
    1.56 GiB fp32 scores. Only that phase takes them: set for the whole
    script, their page mapping cost the LM phases ~39 s on the H100."""
    torch.cuda.empty_cache()
    setting = f"expandable_segments:{on}"
    set_settings = getattr(torch._C, "_accelerator_setAllocatorSettings",
                           None) or torch.cuda.memory._set_allocator_settings
    set_settings(setting)


def _expandable_count() -> int:
    """The allocator's segments that grow in place."""
    return sum(bool(s.get("is_expandable"))
               for s in torch.cuda.memory_snapshot())


def _sequential(params, cfg, rt, eng, prompt, new, dev):
    """Sequential greedy generation of one request with a batch-one cache,
    prefilling exactly the padded bucket the engine prefills (with the
    engine's memory input)."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, 1, eng.max_seq, device=dev)
    toks = torch.as_tensor(eng.prefill_tokens(prompt), device=dev).long()
    T.prefill(params, toks[None], cache, cfg, rt, eng.extra)
    tok, pos, out = int(prompt[-1]), len(prompt) - 1, []
    for _ in range(new):
        lg, _ = T.decode_step(params, torch.tensor([[tok]], device=dev),
                              cache, pos, cfg, rt)
        tok = int(lg[0].argmax())
        out.append(tok)
        pos += 1
    return out


def drive_engine(eng):
    """run_to_completion's loop with its two halves timed on the card:
    admissions (the prefills) and decode steps."""
    t_pre = t_dec = 0.0
    steps = 0
    while True:
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        t_pre += time.perf_counter() - t
        if not eng.active and not eng.queue:
            break
        t = time.perf_counter()
        eng.step()                   # ends in a host copy of the tokens
        t_dec += time.perf_counter() - t
        steps += 1
    return t_pre, t_dec, steps


def device_idle(fn) -> dict:
    """Device busy and idle share over fn() under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    except (AssertionError, RuntimeError) as err:
        return {"profile": f"not measured: {err}"}
    evs = sorted(_device_events(prof), key=lambda e: -e[2])
    if not evs:
        return {"profile": "not measured: the trace shows no device time"}
    busy_ms = sum(us for _, _, us in evs) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": sum(c for _, c, _ in evs),
            "top_kernels": [{"name": k[:100], "calls": c,
                             "device_ms": us / 1e3}
                            for k, c, us in evs[:6]]}


def self_layers(cfg) -> int:
    """The layers whose self-attention goes through kernel 8: all but
    the vlm's cross layers (the encoder's and the cross layers' attention
    stay on the naive path, as in the JAX package)."""
    if cfg.family == "vlm":
        return cfg.num_layers // cfg.cross_attn_every * (
            cfg.cross_attn_every - 1)
    return cfg.num_layers


def draw_qkv_bias(params, dev, seed=QKV_BIAS_SEED) -> int:
    """Fill the q/k/v bias leaves of a tree (qwen2.5-3b's; both packages
    initialise them to 0, so random weights would compute nothing through
    them) with QKV_BIAS_SCALE times a standard normal draw from a
    generator on `dev` seeded with `seed`, in place. Returns the number of
    bias coordinates drawn (0 for a model without them)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    n = 0
    for leaf in bias_leaves(params):
        leaf.copy_(torch.randn(leaf.shape, generator=gen, device=dev)
                   .mul_(QKV_BIAS_SCALE))
        n += leaf.numel()
    return n


def bias_leaves(tree):
    """Every q/k/v bias leaf of a tree."""
    return (v for p, v in _paths(tree)
            if p.rsplit("/", 1)[-1] in QKV_BIASES)


def memory_input(cfg, dev, seed):
    """One memory input for every request: the audio family's encoder
    input [1, 1500, D] or the vlm's vision input [1, 1601, D], standard
    normal from numpy's `seed` in the model's type on the card, as
    launch/train.py draws it; None for the other families."""
    from repro_torch.launch.train import add_extra
    return add_extra({}, np.random.default_rng(seed), cfg, 1, dev) or None


def serve_phase(dev, card, smi, c):
    """One LM served at full width in bf16, c["layers"] deep (None: its
    config's depth), random weights from a torch.Generator seeded with 0
    on the card, by the engine with the flash kernel: c["n_requests"]
    greedy requests of c["new_tokens"] tokens on c["max_batch"] slots
    (slots reused), prompts of c["len_lo"]-c["len_hi"] tokens (numpy seed
    0) and, last, one of each length in c["long_prompts"] (if any), every
    prefill above 128 tokens, so each goes through kernel 8. The
    exact-length families (ssm, hybrid) prefill the prompt as it is; the
    others pad to c["buckets"]. The audio and vlm families serve every
    request with one memory input (`memory_input`, c["memory_seed"]),
    the vlm's gates set to c["gate"] first. Checks: flash launches exact
    (`self_layers` a prefill), engine ==
    sequential generation over the same (padded) prefill for the first
    request of each prefill length (of the first c["n_sequential"]) and
    for the first request in a reused slot, every admitted slot's SSM
    state and conv window zero when its prefill starts, and
    `prefill_logits_check`. Returns (problems,
    engine, the flash launches of the engine run, the final occupant of
    each slot)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import _state_leaves
    arch = c["arch"]
    cfg = get_config(arch)
    if c["layers"]:
        cfg = dataclasses.replace(cfg, num_layers=c["layers"])
    rt = Runtime(attn_impl="cuda")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    if "gate" in c:                      # open the cross layers' gates
        params["blocks"]["cross"]["gate"].fill_(c["gate"])
    n_bias = draw_qkv_bias(params, dev)
    extra = memory_input(cfg, dev, c.get("memory_seed", 0))
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p in _leaves(params))
    init_s = time.perf_counter() - t
    init_peak = _peak_gib()
    rng = np.random.default_rng(0)
    exact = cfg.family in ("ssm", "hybrid")
    long = tuple(c.get("long_prompts", ()))
    lens = np.concatenate([rng.integers(
        c["len_lo"], c["len_hi"] + 1,
        size=c["n_requests"] - len(long)), np.array(long, dtype=np.int64)])
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    eng = ServingEngine(params, cfg, max_batch=c["max_batch"],
                        max_seq=c["max_seq"],
                        prompt_buckets=c["buckets"],
                        rt=rt, extra=extra, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=c["new_tokens"])
    # the recurrent state of each admitted slot as its prefill starts
    state_at_prefill, real_prefill = [], T.prefill

    def watched(p, tokens, cache, *args):
        leaves = list(_state_leaves(cache))
        if leaves:
            state_at_prefill.append(max(float(x.abs().max())
                                        for x in leaves))
        return real_prefill(p, tokens, cache, *args)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    T.prefill = watched
    try:
        t_pre, t_dec, steps = drive_engine(eng)
    finally:
        T.prefill = real_prefill
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = _peak_gib()
    done = list(eng.finished)
    problems = []
    if len(done) != c["n_requests"]:
        problems.append(f"{arch}: {len(done)} of {c['n_requests']} finished")
    want = self_layers(cfg) * c["n_requests"]
    if launches["flash_attention"] != want:
        problems.append(f"{arch}: flash_attention launched "
                        f"{launches['flash_attention']} times, expected "
                        f"{want}")
    padded = sum(len(eng.prefill_tokens(pr)) for pr in prompts)
    generated = sum(len(st.generated) for st in done)
    slots_seen, reused = set(), []
    for st in sorted(done, key=lambda st: st.request.uid):
        if st.slot in slots_seen:
            reused.append(st.request.uid)
        slots_seen.add(st.slot)
    state_row = {}
    if exact:
        left = [max(float(x.abs().max()) for x in _state_leaves(row))
                for row in eng.rows]
        state_row = {"state_max_abs_at_prefill": max(state_at_prefill),
                     "state_max_abs_left_in_slots": min(left)}
        if len(state_at_prefill) != c["n_requests"] or \
                max(state_at_prefill) != 0.0 or not min(left) > 0:
            problems.append(f"{arch}: a slot's SSM state was not zero at "
                            f"its prefill ({state_row})")
    print(json.dumps({
        "serving": arch, "card": smi, "layers": cfg.num_layers,
        "params": n_params, "qkv_bias_drawn": n_bias,
        "init_s": init_s, "init_peak_gib": init_peak,
        "requests_finished": len(done),
        "prompt_tokens": int(lens.sum()), "prefill_tokens_padded": padded,
        "prefill_s": t_pre, "prefill_tokens_per_s": padded / t_pre,
        "generated_tokens": generated, "decode_s": t_dec,
        "decode_tokens_per_s": generated / t_dec, "engine_steps": steps,
        "ms_per_engine_step": 1e3 * t_dec / max(steps, 1),
        "peak_gib": peak, "requests_in_reused_slots": reused, **state_row,
        "launches": launches}))

    # engine == sequential generation over the same padded prefill, for
    # the first request of each prefill length (of the first n_sequential)
    # and the first request in a reused slot
    by_uid = {st.request.uid: st.generated for st in done}
    firsts = {}
    for uid, pr in enumerate(prompts):
        firsts.setdefault(len(eng.prefill_tokens(pr)), uid)
    check = sorted(firsts.values())[:c["n_sequential"]]
    check = sorted(set(check) | set(reused[:1]))
    for uid in check:
        seq = _sequential(params, cfg, rt, eng, prompts[uid],
                          c["new_tokens"], dev)
        if by_uid.get(uid) != seq:
            problems.append(f"{arch}: request {uid} engine tokens "
                            f"{by_uid.get(uid)} != sequential {seq}")
    print(json.dumps({"engine_vs_sequential": arch, "requests": check,
                      "equal": not any("sequential" in p for p in problems)}))

    lp, lcfg = params, cfg
    if c.get("logit_layers"):            # a copy cut in depth: views
        lcfg = dataclasses.replace(cfg, num_layers=c["logit_layers"])
        lp = dict(params, blocks=_first_layers(params["blocks"],
                                               c["logit_layers"]))
    logit_problems, logit_row = prefill_logits_check(
        lp, lcfg, eng, prompts[int(np.argmax(lens))], dev, c)
    problems += logit_problems
    print(json.dumps({**logit_row, "card": smi}))
    occupants = {}
    for st in done:                      # finish order: the last one stays
        occupants[st.slot] = st.pos
    return problems, eng, launches, occupants


def _first_layers(tree, n):
    """The first n layers of a stacked layer tree (views)."""
    return {k: _first_layers(v, n) if isinstance(v, dict) else v[:n]
            for k, v in tree.items()}


def _to_float(tree):
    return {k: _to_float(v) if isinstance(v, dict)
            else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def _paths(tree, path=""):
    """(path, leaf) of every leaf of a nested dict tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{path}/{k}")
        else:
            yield f"{path}/{k}", v


def _fp32_redrawn(params, cfg, dev, seed, sample: int = 4096):
    """The served tree in fp32 with no second copy of it on the card: a
    sample of each floating leaf is kept, the served tree is emptied in
    place (the served weights are not used after the gate; the engine
    shares this dict), the model is drawn again from `seed` (serve_phase's)
    in fp32, and each leaf that was bf16 is rounded through bf16 in place,
    a slice at a time: the served values, upcast. (Converting the 28.1 GB
    of bf16 leaf by leaf on the card ran out of memory after the earlier
    phases, 15.6 GiB of its cache reserved but unallocated; a round trip
    through pinned host memory took ~18 s.) `params` ends up holding the
    fp32 tree. Returns it and the paths whose sample differs from the
    served one (none, or the draw is not the served model's)."""
    from repro_torch.models import transformer as T
    low = {p for p, v in _paths(params) if v.dtype == torch.bfloat16}
    kept = {p: v.reshape(-1)[:sample].float() for p, v in _paths(params)
            if v.is_floating_point()}
    params.clear()
    torch.cuda.empty_cache()
    p32 = T.init_params(torch.Generator(device=dev).manual_seed(seed),
                        dataclasses.replace(cfg, dtype="float32"),
                        device=dev)
    for p, v in _paths(p32):
        if p in low:
            for part in v.view(-1).split(1 << 28):
                part.copy_(part.to(torch.bfloat16))
    params.update(p32)
    return params, [p for p, v in _paths(params)
                    if not torch.equal(v.reshape(-1)[:sample], kept[p])]


def _zero_bias(tree):
    """A copy of a layer tree's dicts with the q/k/v bias leaves zeroed
    (new tensors); every other leaf shared."""
    return {k: _zero_bias(v) if isinstance(v, dict)
            else torch.zeros_like(v) if k in QKV_BIASES else v
            for k, v in tree.items()}


def _rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def prefill_logits_check(params, cfg, eng, prompt, dev, c):
    """The served prefill's last-token logits, kernel path against the
    naive path, for the longest prompt, on `params` (the served model, or
    a copy of its first layers where its fp32 copy would not fit beside
    it). The gate is in fp32 on the same weights: in bf16 the two plain
    paths (chunked, naive) already drift apart by about the bf16
    tolerance over 40 layers, which would swamp a kernel fault. A planted
    fault (the kernel fed keys and values one position late: a one-token
    look-ahead) is read the same way and must land above the limit. A
    ragged exact-length prompt runs the chunked path as one chunk. The
    bf16 prefill itself is checked layer by layer: each flash launch
    against the plain version on the same q, k, v (bf16 2e-2). The audio
    and vlm families prefill with the engine's memory input (an fp32 copy
    of it in fp32), and the bf16 kernel path's logits with another memory
    (the next numpy seed) must differ from them by more than
    c["memory_rel_l2"]. Returns (problems, row)."""
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    toks = torch.as_tensor(eng.prefill_tokens(prompt), device=dev).long()[None]
    sound, run_stack = kops.flash_attention, T._run_stack
    hidden = {}

    def keep_hidden(x, *args, **kw):     # the stack's output, every position
        out = run_stack(x, *args, **kw)
        hidden["x"] = out[0]
        return out

    def prefill(p, pcfg, impl, flash=sound, memory=eng.extra, every=False):
        """The prefill's last-token logits [1, V], or with `every` the
        logits at every prefill position [1, S, V] (the same prefill, its
        stack's output read through the final norm and head)."""
        kops.flash_attention = flash
        if every:
            T._run_stack = keep_hidden
        try:
            cache = T.init_cache(pcfg, 1, c["max_seq"], device=dev)
            # chunks that divide the prompt (the chunked path's rule); a
            # ragged exact-length prompt runs as one chunk
            chunk = math.gcd(512, toks.shape[1])
            chunk = chunk if chunk >= 128 else toks.shape[1]
            last = T.prefill(p, toks, cache, pcfg, Runtime(
                attn_impl=impl, q_chunk=chunk, kv_chunk=chunk), memory)[0]
            if not every:
                return last
            return T._logits(p, T._final_hidden(hidden.pop("x"), p, pcfg),
                             pcfg)
        finally:
            kops.flash_attention, T._run_stack = sound, run_stack

    layers = []

    def checked(q, k, v, **kw):
        out = sound(q, k, v, **kw)
        ref = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), **kw)
        layers.append((bf16_close(out, ref.transpose(1, 2)),
                       _abs_err(out, ref.transpose(1, 2))))
        return out

    def late_band(q, k, v, **kw):
        return sound(q, k.roll(-1, 1), v.roll(-1, 1), **kw)

    bf = {impl: prefill(params, cfg, impl) for impl in ("naive", "chunked")}
    bf["cuda"] = prefill(params, cfg, "cuda", checked)
    mem_rel = None
    if eng.extra is not None:
        mem_rel = _rel_l2(prefill(params, cfg, "cuda", memory=memory_input(
            cfg, dev, c["memory_seed"] + 1)), bf["cuda"])
    # the fp32 tree: a copy, or (fp32_redraw) the served model drawn
    # again in fp32 in place of the served tree (serve_phase's seed, 0)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    redraw_diff = []
    if c.get("fp32_redraw"):
        p32, redraw_diff = _fp32_redrawn(params, cfg, dev, seed=0)
    else:
        p32 = _to_float(params)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    x32 = None if eng.extra is None else _to_float(eng.extra)
    every = bool(c.get("all_positions"))
    f32 = {impl: prefill(p32, cfg32, impl, memory=x32, every=every)
           for impl in ("naive", "cuda")}
    f32["fault"] = prefill(p32, cfg32, "cuda", late_band, memory=x32,
                           every=every)
    bias_rel = None
    if c.get("bias_check"):             # the biases zeroed: they must count
        p0 = {**p32, "blocks": _zero_bias(p32["blocks"])}
        bias_rel = _rel_l2(prefill(p0, cfg32, "cuda", memory=x32,
                                   every=every), f32["naive"])
        del p0
    gate_peak = _peak_gib()
    del p32, x32
    torch.cuda.empty_cache()
    sound_rel = _rel_l2(f32["cuda"], f32["naive"])
    fault_rel = _rel_l2(f32["fault"], f32["naive"])
    row = {"prefill_logits": f"{c['arch']} {cfg.num_layers} layers, "
                             f"{toks.shape[1]} tokens, "
                             + ("every position" if every else
                                "the last position"),
           "fp32_rel_l2_cuda_vs_naive": sound_rel,
           "fp32_rel_l2_planted_fault_vs_naive": fault_rel,
           "fp32_tolerance_rel_l2": c["logits_rel_l2"],
           "fp32_max_abs": float((f32["cuda"] - f32["naive"]).abs().max()),
           "bf16_layers_checked": len(layers),
           "bf16_layers_within_2e-2": sum(ok for ok, _ in layers),
           "bf16_layer_max_abs_err": max((e for _, e in layers), default=None),
           # bf16's own drift, for scale: not gated
           "bf16_rel_l2_cuda_vs_naive": _rel_l2(bf["cuda"], bf["naive"]),
           "bf16_rel_l2_chunked_vs_naive": _rel_l2(bf["chunked"], bf["naive"]),
           "bf16_same_argmax": bool(bf["cuda"].argmax()
                                    == bf["naive"].argmax()),
           "fp32_gate_peak_gib": gate_peak, "fp32_convert_s": convert_s}
    problems = []
    if redraw_diff:
        problems.append(f"{c['arch']}: the fp32 tree drawn again differs "
                        f"from the served one in {redraw_diff}")
    if bias_rel is not None:
        row["fp32_rel_l2_biases_zeroed_vs_naive"] = bias_rel
        if not bias_rel > c["logits_rel_l2"]:
            problems.append(f"{c['arch']}: zeroing the q/k/v biases moves "
                            f"the fp32 prefill logits by {bias_rel} (rel "
                            f"L2), not over {c['logits_rel_l2']}")
    if mem_rel is not None:
        row.update(bf16_rel_l2_other_memory=mem_rel,
                   other_memory_limit=c["memory_rel_l2"])
        if not mem_rel > c["memory_rel_l2"]:
            problems.append(f"{c['arch']}: another memory input moves the "
                            f"prefill logits by {mem_rel} (rel L2), not "
                            f"over {c['memory_rel_l2']}")
    if not (sound_rel <= c["logits_rel_l2"] < fault_rel
            and all(bool(torch.isfinite(x).all()) for x in f32.values())):
        problems.append(f"{c['arch']}: fp32 prefill logits cuda vs naive "
                        f"rel L2 "
                        f"{sound_rel}, planted fault {fault_rel}, limit "
                        f"{c['logits_rel_l2']}")
    if len(layers) != self_layers(cfg) or not all(ok for ok, _ in layers):
        problems.append(f"{c['arch']}: bf16 prefill flash launches vs plain: "
                        f"{sum(ok for ok, _ in layers)} of {len(layers)} "
                        f"within 2e-2, expected {self_layers(cfg)}")
    return problems, row


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def granite_window(eng) -> dict:
    """Device idle share of the engine over a profiled window: 8 more
    requests of 8 tokens at 300-token prompts on the served engine."""
    rng = np.random.default_rng(1)
    for _ in range(8):
        eng.submit(rng.integers(0, eng.cfg.vocab_size, size=300).astype(
            np.int32), max_new_tokens=8)
    return {"granite_profile_window": "8 requests x 8 tokens, 300-token "
            "prompts", **device_idle(eng.run_to_completion)}


def decode_entry_phase(dev, card, eng, occupants):
    """ops.decode_attention on the served engine's real layer caches
    [8, 2048, 8, 64], each row at its last request's position, every
    layer once (launches counted from 0); held to the plain version on
    every layer and to the model's decode attention on two layers."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.models import attention as attn
    import torch.nn.functional as F
    cfg = eng.cfg
    cache_k, cache_v = eng.cache["k"], eng.cache["v"]
    b = eng.max_batch
    pos_list = [int(occupants.get(s, 0)) for s in range(b)]
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.normal(size=(b, 1, cfg.num_heads,
                                          cfg.head_dim)).astype(
        np.float32)).to(dev, torch.bfloat16)
    problems, err = [], 0.0
    reset_launches()
    outs = [ops.decode_attention(q, cache_k[i], cache_v[i], pos)
            for i in range(cfg.num_layers)]
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["decode_attention"] != cfg.num_layers:
        problems.append(f"decode entry: {launches['decode_attention']} "
                        "launches")
    ok = True
    for i, out in enumerate(outs):
        ref = da.decode_attention_plain(q.transpose(1, 2), cache_k[i],
                                        cache_v[i], pos).transpose(1, 2)
        ok &= bf16_close(out, ref)
        err = max(err, _abs_err(out, ref))
        if i in (0, cfg.num_layers - 1):
            for r in range(b):
                m = attn.decode_attention(q[r:r + 1], cache_k[i, r:r + 1],
                                          cache_v[i, r:r + 1], pos_list[r])
                ok &= bf16_close(out[r:r + 1], m)
    if not ok:
        problems.append("decode entry: kernel differs from the plain version "
                        "or the model's decode attention")
    hkv, d = cfg.num_kv_heads, cfg.head_dim
    live = sum(pos_list)
    nbytes = 2 * (2 * live * hkv * d + 2 * b * cfg.num_heads * d) + 4 * b
    valid = (torch.arange(eng.max_seq, device=dev)[None, :]
             < pos[:, None].long())[:, None, None, :]
    k0t, v0t = cache_k[0].transpose(1, 2), cache_v[0].transpose(1, 2)
    qt = q.transpose(1, 2)
    row = measure(
        "decode_attention", ok, err,
        lambda: ops.decode_attention(q, cache_k[0], cache_v[0], pos),
        lambda: da.decode_attention_plain(qt, cache_k[0], cache_v[0], pos),
        LM_SYMBOLS["decode_attention"], nbytes, 4 * d * cfg.num_heads * live,
        card, library_call=lambda: F.scaled_dot_product_attention(
            qt, k0t, v0t, attn_mask=valid, enable_gqa=True),
        positions=pos_list)
    return problems, launches, row


def mamba_phase(dev, card):
    """mamba2-130m at full width in bf16, MAMBA["layers"] deep (random
    weights, seed 0 on the card): 8 greedy requests on 4 slots, so slots
    are reused;
    tokens equal a fresh-cache sequential generation. Then the SSD entry
    point, ops.ssd_chunked_pallas, on layer 0's real (x, B, C, dt) for a
    512-token prompt, held to the plain version and to the model's
    ssd_chunked with d_skip 0. Returns (problems, launches, row)."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_chunk as sc
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.models import ssm as ssm_lib
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.models.layers import rms_norm
    from repro_torch.serving import ServingEngine
    c = MAMBA
    cfg = dataclasses.replace(get_config("mamba2-130m"),
                              num_layers=c["layers"])
    rt = Runtime(attn_impl="cuda")
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    rng = np.random.default_rng(1)
    lens = rng.integers(c["len_lo"], c["len_hi"] + 1, size=c["n_requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    eng = ServingEngine(params, cfg, max_batch=c["max_batch"],
                        max_seq=c["max_seq"], rt=rt, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=c["new_tokens"])
    torch.cuda.reset_peak_memory_stats()
    t_pre, t_dec, steps = drive_engine(eng)
    done = list(eng.finished)
    problems = []
    if len(done) != c["n_requests"]:
        problems.append(f"mamba2: {len(done)} of {c['n_requests']} finished")
    reused = len(done) - len({st.slot for st in done})
    by_uid = {st.request.uid: st.generated for st in done}
    mismatched = [uid for uid, pr in enumerate(prompts)
                  if by_uid.get(uid) != _sequential(params, cfg, rt, eng, pr,
                                                    c["new_tokens"], dev)]
    if mismatched:
        problems.append(f"mamba2: engine != fresh sequential for requests "
                        f"{mismatched}")
    generated = sum(len(st.generated) for st in done)
    print(json.dumps({
        "serving": "mamba2-130m", "requests_finished": len(done),
        "slot_reuses": reused, "prompt_tokens": int(lens.sum()),
        "prefill_s": t_pre, "prefill_tokens_per_s": int(lens.sum()) / t_pre,
        "generated_tokens": generated, "decode_s": t_dec,
        "decode_tokens_per_s": generated / t_dec, "engine_steps": steps,
        "ms_per_engine_step": 1e3 * t_dec / max(steps, 1),
        "peak_gib": _peak_gib(),
        "engine_equals_sequential": not mismatched}))

    # layer 0's real SSD inputs for a 512-token prompt
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                        size=c["entry_len"]),
                           device=dev).long()[None]
    p0 = T._layer(params["blocks"], 0)
    mix = p0["mixer"]
    h = rms_norm(params["embed"][toks], p0["norm"], cfg.norm_eps)
    _, xi, b, cc, dt = ssm_lib._split_proj(h @ mix["in_proj"], cfg)
    conv, _ = ssm_lib._causal_conv(torch.cat([xi, b, cc], dim=-1),
                                   mix["conv_w"], mix["conv_b"])
    d_inner, heads, _ = ssm_lib.ssm_dims(cfg)
    xi, b, cc = torch.split(conv, [d_inner, cfg.ssm_state, cfg.ssm_state],
                            dim=-1)
    x = xi.reshape(1, c["entry_len"], heads, cfg.ssm_head_dim)
    dt = F.softplus(dt.float() + mix["dt_bias"])
    a_log = mix["a_log"]
    reset_launches()
    y, fin = ops.ssd_chunked_pallas(x, b, cc, dt, a_log, chunk=c["chunk"])
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if launches["ssd_chunk"] != 1:           # every chunk in one call
        problems.append(f"mamba2 entry: {launches['ssd_chunk']} ssd_chunk "
                        "launches, expected 1")
    y_cpu, fin_cpu = ops.ssd_chunked_pallas(
        *(t.cpu() for t in (x, b, cc, dt, a_log)), chunk=c["chunk"])
    y_m, fin_m = ssm_lib.ssd_chunked(x, b, cc, dt, a_log,
                                     torch.zeros(heads, device=dev), cfg)
    checks = {"plain": bf16_close(y.cpu(), y_cpu)
              and bf16_close(fin.cpu(), fin_cpu),
              "ssd_chunked": bf16_close(y, y_m) and bf16_close(fin, fin_m)}
    print(json.dumps({"ssd_entry": f"layer 0, {c['entry_len']} tokens",
                      "checks": checks,
                      "max_abs_err_plain": _abs_err(y.cpu(), y_cpu),
                      "max_abs_err_ssd_chunked": _abs_err(y, y_m),
                      "max_abs_y": float(y.float().abs().max()),
                      "launches": launches}))
    if not all(checks.values()):
        problems.append(f"mamba2 entry: {checks}")
    # one chunk of the real inputs, timed
    q = c["chunk"]
    xc, bc, ccc, dtc = x[:, :q], b[:, :q], cc[:, :q], dt[:, :q]
    outs = sc.ssd_chunk(xc, bc, ccc, dtc, a_log)
    refs = sc.ssd_chunk_plain(xc, bc, ccc, dtc, a_log)
    ok = all(bf16_close(o, r) for o, r in zip(outs, refs))
    if not ok:
        problems.append("ssd_chunk: differs from plain on the real chunk")
    n, p = cfg.ssm_state, cfg.ssm_head_dim
    nbytes = (2 * 2 * q * heads * p + 2 * 2 * q * n + 4 * q * heads
              + 4 * heads + 4 * heads * n * p + 4 * heads)
    tri = q * (q + 1) // 2
    nflops = 2 * tri * n + heads * (2 * tri * p + 2 * q * n * p)
    row = measure("ssd_chunk", ok,
                  max(_abs_err(o, r) for o, r in zip(outs, refs)),
                  lambda: sc.ssd_chunk(xc, bc, ccc, dtc, a_log),
                  lambda: sc.ssd_chunk_plain(xc, bc, ccc, dtc, a_log),
                  LM_SYMBOLS["ssd_chunk"], nbytes, nflops, card,
                  shape=f"mamba2 layer 0 chunk [1, {q}, {heads}, {p}], "
                        f"N {n}")
    syms = row["device_symbols"]
    if not syms or not all("ssd_chunk_wgmma_kernel" in s for s in syms):
        problems.append(f"ssd_chunk real chunk: bf16 device time from "
                        f"{syms}, not the wgmma kernel")
    # the whole entry call: the kernel over every chunk, then the host
    # recurrence; bytes are the call's inputs and outputs once (y in bf16,
    # the final [H, P, N] state in fp32), operations the chunks' and the
    # inter-chunk terms' (y_inter and the state update)
    s_len, nc = c["entry_len"], c["entry_len"] // q
    e_bytes = (2 * 2 * s_len * heads * p + 2 * 2 * s_len * n
               + 4 * s_len * heads + 4 * heads + 4 * heads * p * n)
    e_flops = nc * nflops + 2 * s_len * heads * p * n \
        + 2 * nc * heads * p * n
    zeros = torch.zeros(heads, device=dev)
    entry = measure(
        "ssd_chunk", checks["plain"], _abs_err(y.cpu(), y_cpu),
        lambda: ops.ssd_chunked_pallas(x, b, cc, dt, a_log, chunk=q),
        lambda: ssm_lib.ssd_chunked(x, b, cc, dt, a_log, zeros, cfg),
        LM_SYMBOLS["ssd_chunk"], e_bytes, e_flops, card,
        shape=f"entry call ops.ssd_chunked_pallas, {s_len} tokens, "
              f"{nc} chunks in one launch")
    # the call's device time over every kernel it launches (the host
    # recurrence's einsums, cumsums and casts beside ssd_chunk)
    call_ms, _, call_events = kernel_device_ms(
        lambda: ops.ssd_chunked_pallas(x, b, cc, dt, a_log, chunk=q), ("",),
        reps=20)
    row["entry_call"] = {k: entry[k] for k in (
        "ms", "plain_ms", "device_ms", "device_events", "bound_ms",
        "bound_by", "bytes", "flops", "max_abs_err")}
    row["entry_call"].update(call_device_ms=call_ms,
                             call_device_events=call_events)
    print(json.dumps({"ssd_entry_call": row["entry_call"]}))
    return problems, launches, row


# the training phase: granite-3-2b at full width, train_4k's length at a
# batch of 4 (its global batch of 256 cut to one card and the run's
# limit), masks at lambda 0.3 from one warm-up gradient, 3 steps
TRAIN = dict(shape="train_4k", batch=4, lam=0.3, eta=1e-2, steps=3,
             warm_batch_vlm=1, grad_depth=2, grad_batch=1, grad_seq_vlm=2048,
             grad_rel_l2=1e-3, block=512)
TRAIN_CKPT = pathlib.Path(__file__).resolve().parent / "build" / \
    "chip_smoke_train_ckpt"


def train_masks(params, cfg, rt, dev, lam, seq, batch):
    """Masks at lam from Taylor importance of a warm-up gradient on a
    random batch (numpy seed 0), through launch/train.py's own
    warmup_importance (each leaf's importance taken as backward completes
    its gradient) and build_masks (the threshold taken on the card, each
    leaf made in uint8, the build timed). Returns (uint8 masks, row,
    problems): the pruned
    count must be the count of importances below the k-th smallest, with
    k itself between that count and the count at or below it (bf16
    ties)."""
    from repro_torch.core import pruning
    from repro_torch.launch.train import synthetic_batch, warmup_importance
    from repro_torch.tree import flatten_with_path
    problems = []
    warm = synthetic_batch(np.random.default_rng(0), cfg, batch, seq, dev)
    imp = warmup_importance(params, warm, cfg, rt)
    del warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    masks = pruning.build_masks(imp, lam, dtype=torch.uint8)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    thr = pruning.global_threshold(imp, lam)          # the check's own
    prunable = [(p, q) for p, q in flatten_with_path(imp)
                if pruning.default_prunable(p)]
    n = sum(q.numel() for _, q in prunable)
    k = int(np.floor(lam * n))
    kth = float(torch.tensor(thr, dtype=prunable[0][1].dtype))
    below = sum(int((q < kth).sum()) for _, q in prunable)
    at = sum(int((q <= kth).sum()) for _, q in prunable)
    flat = dict(flatten_with_path(masks))
    pruned = sum(int((flat[p] == 0).sum()) for p, _ in prunable)
    if not (pruned == below < k <= at):
        problems.append(f"masks: pruned {pruned}, below the k-th {below}, "
                        f"k {k}, at or below {at}")
    row = {"prunable": n, "k": k, "pruned": pruned,
           "importance_dtype": str(prunable[0][1].dtype),
           "threshold": thr, "kth_value": kth, "ties_at_kth": at - below,
           "realized_lambda": pruning.actual_ratio(masks),
           "mask_build_s_on_card": build_s}
    return masks, row, problems


def _pruned_moved(new, old, masks) -> int:
    """Bits of pruned coordinates that differ between two trees."""
    from repro_torch.tree import leaves
    n = 0
    for a, b, m in zip(leaves(new), leaves(old), leaves(masks)):
        ia = a.view(torch.int16 if a.element_size() == 2 else torch.int32)
        ib = b.view(ia.dtype)
        n += int(((ia != ib) & (m == 0)).sum())
    return n


def _trees_equal(a, b) -> bool:
    from repro_torch.tree import leaves
    return all(x.shape == y.shape and bits_equal(
        x.view(torch.int16) if x.dtype == torch.bfloat16 else x,
        y.view(torch.int16) if y.dtype == torch.bfloat16 else y)
        for x, y in zip(leaves(a), leaves(b)))


def run_train_steps(box, masks, cfg, rt, dev, seq, batch, n_steps, eta,
                    ckpt_after=None):
    """n_steps masked-FedSGD steps on packed-pipeline batches (seed 0),
    each timed on the host around a synchronised step, from the tree
    taken out of the list `box` (so that the caller holds none of it: the
    initial tree is freed after the first step). Each step's pruned
    coordinates are held to its input's, bit for bit, which over the run
    holds them to the initial tree's. Returns (final params, the state
    before the last step, the last batch, losses, step seconds, the step,
    the checkpoint path written after step `ckpt_after`, the pruned bits
    that moved)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data.lm_pipeline import (PackedLMIterator, ShardSpec,
                                              SyntheticDocumentSource)
    from repro_torch.launch.steps import make_train_step, train_microbatches
    from repro_torch.launch.train import packed_batch
    it = PackedLMIterator(SyntheticDocumentSource(cfg.vocab_size, seed=0),
                          ShardSpec(0, 1), batch=batch, seq=seq)
    step = make_train_step(cfg, rt, eta=eta,
                           microbatches=train_microbatches(cfg))
    losses, secs, ckpt, moved = [], [], None, 0
    params = box.pop()
    before = last = None
    for i in range(n_steps):
        last = packed_batch(it, cfg, batch, dev)
        before = params
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss, params = step(params, masks, last)
        losses.append(float(loss))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        moved += _pruned_moved(params, before, masks)
        if ckpt_after == i + 1:
            shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
            ckpt = CheckpointManager(str(TRAIN_CKPT), keep=1)
            ckpt.save(i + 1, params)
    return params, before, last, losses, secs, step, ckpt, moved


def _to_host(tree) -> list:
    """The leaves of a tree copied to pinned host memory."""
    from repro_torch.tree import leaves
    return [torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
            for x in leaves(tree)]


def _equal_to_host(tree, host, chunk=1 << 26) -> bool:
    """Every leaf of `tree` (on the card) bit for bit the host leaf beside
    it, compared on the card a slice at a time."""
    from repro_torch.tree import leaves
    for x, h in zip(leaves(tree), host):
        if x.shape != h.shape or x.dtype != h.dtype:
            return False
        x, h = _bits(x.reshape(-1)), _bits(h.reshape(-1))
        for i in range(0, x.numel(), chunk):
            if not torch.equal(x[i:i + chunk], h[i:i + chunk].to(x.device)):
                return False
    return True


def _bits(x):
    """A bf16 or fp32 tensor viewed as integers of its width."""
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _sq_dist(a, b=None, chunk=1 << 26) -> float:
    """sum((a - b)^2) (b None: sum(a^2)) in fp64, a slice at a time (a leaf
    of mixtral's fp32 experts is 6.4 GB: its fp64 copy would not fit beside
    the trees); b may lie in host memory."""
    a = a.reshape(-1)
    b = None if b is None else b.reshape(-1)
    total = 0.0
    for i in range(0, a.numel(), chunk):
        d = a[i:i + chunk].double()
        if b is not None:
            d = d - b[i:i + chunk].to(a.device).double()
        total += float(d.square().sum())
    return total


def flash_grad_check(dev, cfg, rt):
    """A depth-2 copy of the trained model at full width in fp32 (the vlm:
    one group, 4 self layers and the gated cross layer, its gates open),
    batch 1 at train_4k's length (the vlm's naive path at 2,048: its
    group's four layers of fp32 scores are rematerialised together): the
    flash_vjp gradient (kernel 8 with lse and the backward kernel, fp32
    CUDA-core instantiations) against the naive path's autograd gradient
    (its layers rematerialised as the flash path's are), relative L2 over
    the whole tree within grad_rel_l2; a planted fault (the backward
    kernel fed dO one position late) must read above it. The naive
    gradient goes leaf by leaf, as backward completes each, into pinned
    host memory (its squares summed on the card first); the flash
    gradients are compared leaf by leaf as they come, a slice at a time,
    so no gradient tree sits on the card beside the parameters. Whisper's
    encoder is cut to the same depth, and its batch carries an encoder
    input; qwen's q/k/v biases are drawn non-zero (draw_qkv_bias), so
    their gradient leaves are compared on a live bias path."""
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.launch.steps import loss_and_leaf_grads
    from repro_torch.launch.train import batch_extra, synthetic_batch
    from repro_torch.models import flash_vjp as fv
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.tree import leaves
    c = TRAIN
    vlm = cfg.family == "vlm"
    depth = cfg.cross_attn_every if vlm else c["grad_depth"]
    cfg2 = dataclasses.replace(
        cfg, num_layers=depth, dtype="float32",
        encoder_layers=min(cfg.encoder_layers, depth))
    params = T.init_params(torch.Generator(device=dev).manual_seed(1), cfg2,
                           device=dev)
    if vlm:
        params["blocks"]["cross"]["gate"].fill_(VISION["gate"])
    n_bias = draw_qkv_bias(params, dev, QKV_BIAS_SEED + 1)
    seq = c["grad_seq_vlm"] if vlm else INPUT_SHAPES[c["shape"]].seq_len
    batch = synthetic_batch(np.random.default_rng(3), cfg2, c["grad_batch"],
                            seq, dev)
    sound = fv._kernel_bwd
    torch.cuda.reset_peak_memory_stats()

    def late(res, do, *args):
        return sound(res, do.roll(1, dims=1), *args)

    def grad(bwd, rtx, on_grad):
        fv._kernel_bwd = bwd
        try:
            return float(loss_and_leaf_grads(lambda p: T.loss_fn(
                p, batch["tokens"], batch["labels"], cfg2, rtx,
                batch_extra(batch)), params, on_grad))
        finally:
            fv._kernel_bwd = sound

    naive = [None] * len(leaves(params))
    den = [0.0]

    def keep(i, g):
        den[0] += _sq_dist(g)
        naive[i] = torch.empty(g.shape, dtype=g.dtype,
                               pin_memory=True).copy_(g)

    losses = {"naive": grad(sound, Runtime(
        attn_impl="naive", loss_chunk=rt.loss_chunk, remat=True), keep)}
    rel = {}
    for label, bwd in (("flash_vjp", sound), ("planted_fault", late)):
        num = [0.0]

        def dist(i, g, num=num):
            num[0] += _sq_dist(g, naive[i])

        losses[label] = grad(bwd, rt, dist)
        rel[label] = (num[0] / den[0]) ** 0.5
    del naive
    sound_rel, fault_rel = rel["flash_vjp"], rel["planted_fault"]
    row = {"train_grad_check": f"{cfg.name} depth {depth} fp32, "
           f"batch {c['grad_batch']} x {seq}",
           "rel_l2_flash_vjp_vs_naive": sound_rel,
           "rel_l2_planted_fault_vs_naive": fault_rel,
           "limit": c["grad_rel_l2"],
           "loss_flash_vjp": losses["flash_vjp"],
           "loss_naive": losses["naive"],
           "peak_gib": _peak_gib(),
           **({"qkv_bias_drawn": n_bias} if n_bias else {})}
    problems = []
    if not sound_rel <= c["grad_rel_l2"] < fault_rel:
        problems.append(f"{cfg.name} train: gradient rel L2 {sound_rel}, "
                        f"planted fault {fault_rel}, limit "
                        f"{c['grad_rel_l2']}")
    return problems, row


FLEX_CALL = ("flex_attention (compiled): score_mod cap * tanh(s / cap), "
             "causal band block mask, enable_gqa")


@functools.cache
def _compiled_flex():
    from torch.nn.attention.flex_attention import flex_attention
    return torch.compile(flex_attention, dynamic=False)


def _flex_calls(q, k, v, do, causal, window, cap):
    """flex_attention under torch.compile with cap * tanh(s / cap) as its
    score_mod, the causal band (kpos <= qpos, kpos > qpos - window) as its
    block mask and GQA, on kernel layout [B, H, S, D] inputs. Returns
    (forward, forward and backward, kept): kept() runs the forward once
    with its graph kept and returns (its output, the backward alone from
    that graph); it compiles the backward without donated buffers, which a
    compiled backward would free after its first call."""
    from torch.nn.attention.flex_attention import create_block_mask
    flex = _compiled_flex()
    s = q.shape[2]

    def score_mod(score, b, h, qi, ki):
        return cap * torch.tanh(score / cap)

    def mask_mod(b, h, qi, ki):
        keep = ki <= qi if causal else ki >= 0
        return keep & (ki > qi - window) if window else keep

    kw = dict(score_mod=score_mod, enable_gqa=True,
              block_mask=create_block_mask(mask_mod, None, None, s, s,
                                           device=q.device))
    req = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwd():
        return flex(q, k, v, **kw)

    def fwd_bwd():
        return torch.autograd.grad(flex(*req, **kw), req, do)

    def kept():
        with torch._functorch.config.patch(donated_buffer=False):
            out = flex(*req, **kw)

            def bwd():
                return torch.autograd.grad(out, req, do, retain_graph=True)
            bwd()
        return out, bwd

    return fwd, fwd_bwd, kept


def flex_library(q, k, v, o, do, causal, window, cap):
    """The library call of a softcapped row: flex_attention compiled
    (_flex_calls; the port never calls it) on the row's inputs. Returns
    (forward, forward and backward, extra row fields): the fields name the
    call, its forward's max |flex - o| (o: kernel 8's output on the same
    inputs, so that the call is seen to compute the same function) and,
    given the output gradient do, its backward alone, like with like as
    SDPA's (one forward with its graph kept, the gradient taken again and
    again). Without do (a forward row) the second call is None. Where
    compiling or launching fails, both calls are None and the fields hold
    the error."""
    try:
        fwd, fwd_bwd, kept = _flex_calls(q, k, v, do, causal, window, cap)
        if do is None:
            return fwd, None, dict(
                library=FLEX_CALL, library_o_max_abs_err=_abs_err(fwd(), o))
        out, bwd = kept()
        err = _abs_err(out.detach(), o)
        bwd_ms = time_ms(bwd, reps=50)
        del out, bwd
    except Exception as e:            # noqa: BLE001 - printed in the row
        return None, None, dict(
            library=FLEX_CALL, library_bwd_ms=None,
            library_error=f"{type(e).__name__}: {str(e)[:400]}")
    return fwd, fwd_bwd, dict(library=FLEX_CALL, library_o_max_abs_err=err,
                              library_bwd_ms=bwd_ms)


def warm_flex(dev):
    """--warm-flex: compiles the softcapped rows' flex_attention calls
    (phase 11's gemma2 rows, gemma2's train layer 0, the D 256 rows) at
    their shapes, layouts and settings, so that inductor's and triton's
    caches under build/ hold them when the main run compiles the same
    calls."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES

    def rand(*shape):
        return torch.randn(*shape, device=dev, dtype=torch.bfloat16)

    torch.use_deterministic_algorithms(False)           # as phase 11
    for s, hq, hkv, d, window, cap, _ in GEMMA2_FLASH_ROWS.values():
        _flex_calls(rand(1, hq, s, d), rand(1, hkv, s, d),
                    rand(1, hkv, s, d), None, True, window, cap)[0]()
    torch.use_deterministic_algorithms(True, warn_only=True)   # training
    cfg = get_config("gemma2-9b")
    c = GEMMA2_BWD
    for b, s, window, both in (
            (TRAIN["batch"], INPUT_SHAPES[TRAIN["shape"]].seq_len,
             cfg.sliding_window, True),
            *((c["b"], c["s"], w, False) for w in c["windows"])):
        q, k, v, do = (rand(b, s, h, cfg.head_dim).transpose(1, 2) for h in (
            cfg.num_heads, cfg.num_kv_heads, cfg.num_kv_heads, cfg.num_heads))
        fwd, _, kept = _flex_calls(q, k, v, do, True, window,
                                   cfg.attn_softcap)
        kept()
        if both:                 # the train layer's forward row too
            fwd()
    torch.cuda.synchronize()


def start_flex_warmup():
    """Runs warm_flex in a child process beside the federated phases
    (started after phase 2's timings), its log in build/; returns (the
    process, its start time). stop_flex_warmup waits for it."""
    import atexit
    log = pathlib.Path(__file__).resolve().parent / "build" / \
        "flex_warmup.log"
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__).resolve()),
             "--warm-flex"], stdout=f, stderr=subprocess.STDOUT)
    atexit.register(proc.kill)
    return proc, time.perf_counter()


def stop_flex_warmup(warm, timeout_s: float = 120.0) -> None:
    """Waits for the warm-up (killed after timeout_s) and prints its exit
    code and seconds. A failed warm-up costs only time: the main run then
    compiles the calls itself."""
    proc, t0 = warm
    t = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    print(json.dumps({"flex_warmup": {
        "rc": rc, "s": time.perf_counter() - t0,
        "waited_s": time.perf_counter() - t}}))


def train_kernel_rows(captured, card, smi, name):
    """Kernel 8 with lse and the backward kernel on layer 0's real bf16
    inputs of the training run, each against its plain version (the
    blocked flash_vjp_plain_fwd / _bwd, the JAX scans' translation; a
    materialised [4, 32, 4096, 4096] score tensor would not fit), timed
    beside its bound (live FLOPs at the bf16 tensor-core peak: 4 D a pair
    and head forward, 10 D backward) and the library call (forward;
    forward and backward; backward alone): SDPA, or under a softcap
    flex_attention (flex_library). The forward is held within bf16 2e-2
    (o of order 1, lse of order log S). A window shorter than the sequence (hymba's) gives SDPA
    the same band as a boolean mask. dq, dk and dv of a mean loss lie far
    below that absolute term (their peaks are printed), so each is held at
    its own scale, max |kernel - plain| <= 2e-2 max |plain|; the kernel
    fed dO one position late (a planted fault) must break that limit in
    each of the three."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention_bwd as fab
    (q, k, v, o, lse), do, (causal, window, cap) = captured
    q, k, v, o, lse, do = (t.detach() for t in (q, k, v, o, lse, do))
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    blk = TRAIN["block"]
    problems = []
    kt = [t.transpose(1, 2) for t in (q, k, v, o, do)]
    lse_k = lse.reshape(b, hq, s)
    kw = dict(causal=causal, window=window, cap=cap)
    pairs = b * hq * causal_pairs(s, window)
    # the library call: SDPA without a softcap, flex_attention with one
    lib = not cap
    flex_fwd, flex_fwd_bwd, flex_row = (None, None, {}) if lib else \
        flex_library(*kt[:4], kt[4], causal, window, cap)
    sdpa_kw = dict(is_causal=True, enable_gqa=True)
    if window and window < s:           # the same band, as a boolean mask
        pos = torch.arange(s, device=q.device)
        sdpa_kw = dict(attn_mask=(pos[None, :] <= pos[:, None])
                       & (pos[None, :] > pos[:, None] - window),
                       enable_gqa=True)

    o2, lse2 = fa.flash_attention(*kt[:3], lse=True, **kw)
    po, plse = fa.flash_vjp_plain_fwd(q, k, v, causal, window, cap, blk, blk)
    ok_f = bf16_close(o2.transpose(1, 2), po) and bf16_close(lse2, plse.reshape(
        b, hq, s)) and bits_equal(o2.transpose(1, 2).view(torch.int16),
                                  o.view(torch.int16))
    if not ok_f:
        problems.append(f"{name}: flash_attention (lse) on layer 0's training "
                        "inputs differs from the plain scan or the step's o")
    fwd = measure(
        "flash_attention", ok_f, max(_abs_err(o2.transpose(1, 2), po),
                                     _abs_err(lse2, plse.reshape(b, hq, s))),
        lambda: fa.flash_attention(*kt[:3], lse=True, **kw),
        lambda: fa.flash_vjp_plain_fwd(q, k, v, causal, window, cap, blk,
                                       blk),
        LM_SYMBOLS["flash_attention"],
        2 * (2 * hq + 2 * hkv) * b * s * d + 4 * b * hq * s, 4 * d * pairs,
        card, library_call=(lambda: F.scaled_dot_product_attention(
            *kt[:3], **sdpa_kw)) if lib else flex_fwd,
        shape=f"{name} train layer 0 [{b}, {hq}/{hkv}, {s}, {d}], window "
              f"{window}, cap {cap}, with lse",
        **{k: x for k, x in flex_row.items() if k != "library_bwd_ms"},
        nvidia_smi=smi)

    got = fab.flash_attention_bwd(*kt, lse_k, **kw)
    want = fab.flash_vjp_plain_bwd((q, k, v, o, lse), do, causal, window,
                                   cap, blk, blk)
    late = fab.flash_attention_bwd(*kt[:4], kt[4].roll(1, dims=2), lse_k,
                                   **kw)
    sound_err = [scaled_err(g.transpose(1, 2), w) for g, w in zip(got, want)]
    fault_err = [scaled_err(g.transpose(1, 2), w) for g, w in zip(late, want)]
    del late
    ok_b = max(sound_err) <= BF16_TOL < min(fault_err)
    if not ok_b:
        problems.append(f"{name}: flash_attention_bwd on layer 0's training "
                        f"inputs: dq, dk, dv at {sound_err} of their scale "
                        f"against "
                        f"the plain scan, the planted fault at {fault_err}, "
                        f"limit {BF16_TOL}")
    req = [t.detach().requires_grad_() for t in kt[:3]]

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*req, **sdpa_kw)
        return torch.autograd.grad(out, req, kt[4])

    # SDPA's backward alone, like with like: one forward with its graph
    # kept, then the gradient taken again and again from it
    sdpa_bwd_ms = None
    if lib:
        sdpa_out = F.scaled_dot_product_attention(*req, **sdpa_kw)
        sdpa_bwd_ms = time_ms(lambda: torch.autograd.grad(
            sdpa_out, req, kt[4], retain_graph=True), reps=50)
        del sdpa_out
    bwd = measure(
        "flash_attention_bwd", ok_b,
        max(_abs_err(g.transpose(1, 2), w) for g, w in zip(got, want)),
        lambda: fab.flash_attention_bwd(*kt, lse_k, **kw),
        lambda: fab.flash_vjp_plain_bwd((q, k, v, o, lse), do, causal,
                                        window, cap, blk, blk),
        LM_SYMBOLS["flash_attention_bwd"],
        2 * ((4 * hq + 4 * hkv) * b * s * d) + 4 * b * hq * s,
        10 * d * pairs, card,
        library_call=sdpa_fwd_bwd if lib else flex_fwd_bwd,
        per_call=3,
        shape=f"{name} train layer 0 [{b}, {hq}/{hkv}, {s}, {d}], window "
              f"{window}, cap {cap}",
        scaled_err_dq_dk_dv=sound_err, planted_fault_scaled_err=fault_err,
        scaled_limit=BF16_TOL,
        peak_abs_dq_dk_dv=[float(w.float().abs().max()) for w in want],
        **({"library": "scaled_dot_product_attention forward + backward",
            "library_bwd_ms": sdpa_bwd_ms} if lib else
           {**flex_row, "library": f"{flex_row['library']}, forward + "
                                   "backward"}),
        nvidia_smi=smi)
    problems += fwd_symbol_problems(f"{name}: flash_attention (lse) on layer "
                                    "0's training inputs", fwd, d)
    problems += bwd_symbol_problems(f"{name}: flash_attention_bwd on layer "
                                    "0's training inputs", bwd, d)
    return problems, fwd, bwd


def fwd_symbol_problems(label, row, d) -> list:
    """A problem unless the device trace of a bf16 kernel-8 row shows only
    the kernel of its head dim (fa.BF16_KERNELS)."""
    syms = row["device_symbols"]
    if syms and not all(f"{fa.BF16_KERNELS[d]}<" in x for x in syms):
        return [f"{label}: bf16 device time from {list(syms)}, not "
                f"{fa.BF16_KERNELS[d]}"]
    return []


def bwd_symbol_problems(label, row, d) -> list:
    """A problem unless the device trace of a bf16 backward row shows the
    wgmma kernels of its head dim (and no CUDA-core pass)."""
    syms = row["device_symbols"]
    kernels = BWD_WGMMA[d]
    if syms and not (all(any(f"{kern}<" in x for x in syms)
                         for kern in kernels)
                     and not any(kern in x for kern in BWD_CORE
                                 for x in syms)):
        return [f"{label}: bf16 device time from {list(syms)}, not "
                f"{kernels}"]
    return []


# mixtral-8x22b trains at full width on this many of its 56 layers: the
# deepest whole number whose peak stays under ~72 GiB on one card (the
# step holds weights, masks, the masked copy and the fp32 accumulator,
# 9 bytes a parameter: 48.7 GB at 2 layers, 71.1 GB at 3)
MIXTRAL_TRAIN_LAYERS = 2
# llama-3.2-vision-90b trains at full width on one group: 4 self layers and
# the gated cross layer (6.5e9 parameters with the embedding, the head and
# vision_proj; 58.5 GB of step state)
VISION_TRAIN_LAYERS = VISION["layers"]
# hymba-1.5b and granite-3-2b train at full width on 2 of 32 and 6 of 40
# layers: depth cut so that the whole script ends within its 600 s
# (PERF.md section 4, "Cuts")
HYMBA_TRAIN_LAYERS = 2
GRANITE_TRAIN_LAYERS = 6
# gemma2-9b trains at full width on 4 of its 42 layers (2 local + 2
# global): 1.71e9 parameters with the tied 256,000 x 3,584 embedding
GEMMA2_TRAIN_LAYERS = 4
# qwen2.5-3b trains at full width on 4 of its 36 layers (6.2e8 parameters
# with the tied 151,936 x 2,048 embedding), yi-9b on 2 of its 48 (8.7e8
# with the untied 64,000-word embedding and head): depth cut for the
# script's time (PERF.md section 4, "Cuts")
QWEN_TRAIN_LAYERS = 4
YI_TRAIN_LAYERS = 2


# the LM training phases in the order they run (granite-3-2b's first; mamba2
# beside it has a phase of its own), each at its depth (None: the config's)
TRAIN_LAYERS = (("granite-3-2b", GRANITE_TRAIN_LAYERS),
                ("hymba-1.5b", HYMBA_TRAIN_LAYERS),
                ("mixtral-8x22b", MIXTRAL_TRAIN_LAYERS),
                ("whisper-small", None),
                ("gemma2-9b", GEMMA2_TRAIN_LAYERS),
                ("qwen2.5-3b", QWEN_TRAIN_LAYERS),
                ("yi-9b", YI_TRAIN_LAYERS),
                ("llama-3.2-vision-90b", VISION_TRAIN_LAYERS))


# gemma2-9b's attention at train_4k's length (one sequence): 16 / 8 heads of
# 256, causal, softcap 50. At train_4k its window (4,096) binds nowhere, so
# the row is also taken under a window of 1,024, which masks keys: the band
# path of the D 256 kernels at full size
GEMMA2_BWD = dict(b=1, s=4096, hq=16, hkv=8, d=256, cap=50.0,
                  windows=(0, 1024))


def d256_bwd_row(dev, card, smi, window):
    """The bf16 attention backward at head dim 256 (the wgmma kernels that
    split D across two warpgroups, csrc/flash_attention_bwd.cu) on random
    bf16 inputs (numpy seed 0) at gemma2-9b's shape, under `window` (0:
    none), with kernel 8's o and lse: dq, dk, dv each within 2e-2 of its
    own peak against the blocked plain scan, dO one position late above
    that, a rerun bit for bit, timed beside its bound and its device
    symbols those kernels'; the library call is flex_attention on the same
    inputs (flex_library: forward and backward, and backward alone)."""
    from repro_torch.kernels import flash_attention_bwd as fab
    c = GEMMA2_BWD
    b, s, hq, hkv, d = c["b"], c["s"], c["hq"], c["hkv"], c["d"]
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, s, h, d)).astype(
        np.float32)).to(dev, torch.bfloat16).transpose(1, 2)
        for h in (hq, hkv, hkv, hq))
    kw = dict(causal=True, window=window, cap=c["cap"])
    o, lse = fa.flash_attention(q, k, v, lse=True, **kw)
    want = fab.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    got = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    again = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    rerun = all(bits_equal(x.view(torch.int16), y.view(torch.int16))
                for x, y in zip(got, again))
    del again
    late = fab.flash_attention_bwd(q, k, v, o, do.roll(1, dims=2), lse, **kw)
    sound = [scaled_err(x, w) for x, w in zip(got, want)]
    fault = [scaled_err(x, w) for x, w in zip(late, want)]
    del late
    ok = max(sound) <= BF16_TOL < min(fault) and rerun
    label = f"flash_attention_bwd at D 256, window {window}"
    _, flex_fwd_bwd, flex_row = flex_library(q, k, v, o, do, True, window,
                                             c["cap"])
    problems = [] if ok else [
        f"{label}: dq, dk, dv at {sound} of their scale, the planted fault "
        f"at {fault}, limit {BF16_TOL}, rerun bit for bit {rerun}"]
    row = measure(
        "flash_attention_bwd", ok,
        max(_abs_err(x, w) for x, w in zip(got, want)),
        lambda: fab.flash_attention_bwd(q, k, v, o, do, lse, **kw),
        lambda: fab.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw),
        LM_SYMBOLS["flash_attention_bwd"],
        2 * ((4 * hq + 4 * hkv) * b * s * d) + 4 * b * hq * s,
        10 * d * b * hq * causal_pairs(s, window), card, per_call=3,
        shape=f"gemma2-9b head dim 256 [{b}, {hq}/{hkv}, {s}, {d}], cap "
        f"{c['cap']}, window {window}, random inputs",
        scaled_err_dq_dk_dv=sound, planted_fault_scaled_err=fault,
        scaled_limit=BF16_TOL, rerun_bitwise=rerun,
        library_call=flex_fwd_bwd,
        **{**flex_row, "library": f"{flex_row['library']}, forward + "
                                  "backward"}, nvidia_smi=smi)
    problems += bwd_symbol_problems(label, row, d)
    return problems, row


def lm_train_phase(dev, card, smi, arch, layers=None):
    """An LM at full width in bf16 (random weights, seed 0 on the card),
    at its config's depth or `layers` deep, trained with masked FedSGD
    under specialize's train_4k runtime (flash_vjp, chunks 512, loss_chunk
    256, remat) and its train_microbatches: masks at lambda 0.3 from one
    warm-up gradient, 3 steps at eta 1e-2 on packed batches of 4 x 4096
    tokens (the audio and vlm families' with launch/train.py's memory
    input beside them); finite losses, pruned coordinates unchanged bit
    for bit (each step's against its input's), the last step rerun from
    its state bit for bit (the first result waits in pinned host memory
    meanwhile), the launches of both attention kernels exact (kernel 8
    twice a self-attention layer a gradient, remat; the backward once; a
    gradient for the warm-up and for each microbatch of each step); then
    the gradient check and the kernel rows on layer 0's real inputs of
    the last microbatch. A model with q/k/v biases (qwen) has them drawn
    non-zero first (draw_qkv_bias), and the masks must keep some of them.
    The vlm's gates are opened to VISION["gate"] before the warm-up (at 0
    the cross-attention projections get no gradient, so their importance
    and the gates' own are 0 and the masks would prune them all, the
    gates for good): the masks must keep some cross-attention coordinates
    and every gate; the vlm's phase runs on segments that grow in place
    (`_expandable_segments`). `card` is torch's device name (the peaks'
    key), `smi` nvidia-smi's name and power limit, printed beside every
    number.
    Returns (problems, launches, (forward row, backward row))."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.launch.steps import specialize, train_microbatches
    from repro_torch.models import flash_vjp as fv
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves
    c = TRAIN
    shape = INPUT_SHAPES[c["shape"]]
    base = get_config(arch)
    if layers:
        base = dataclasses.replace(base, num_layers=layers)
    cfg, rt = specialize(base, shape)
    seq, batch, mb = shape.seq_len, c["batch"], train_microbatches(cfg)
    grow = cfg.family == "vlm"
    if grow:
        _expandable_segments(True)
    # the vlm's warm-up gradient is taken on one sequence: at 4 x 4096 in
    # one pass its group's rematerialised activations, with the cross
    # layer's fp32 scores [4, 64, 4096, 1601], do not fit beside the model
    warm_batch = c["warm_batch_vlm"] if cfg.family == "vlm" else batch
    walls = {}
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    n_bias = draw_qkv_bias(params, dev)
    if cfg.family == "vlm":
        params["blocks"]["cross"]["gate"].fill_(VISION["gate"])
    captured = {}
    sound = fv._kernel_bwd

    def keep_last(res, do, *args):      # the last call of a backward: layer 0
        captured["args"] = (res, do, args)
        return sound(res, do, *args)

    problems = []
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fv._kernel_bwd = keep_last
    try:
        masks, mask_row, mask_problems = train_masks(
            params, cfg, rt, dev, c["lam"], seq, warm_batch)
        walls["init_and_warmup"] = time.perf_counter() - t
        # the steps take the tree over: nothing here holds the initial one
        box = [params]
        del params
        final, before, last, losses, secs, step, _, moved = run_train_steps(
            box, masks, cfg, rt, dev, seq, batch, c["steps"], c["eta"])
    finally:
        fv._kernel_bwd = sound
    problems += mask_problems
    # the q/k/v biases (qwen's) are prunable: drawn non-zero, some of them
    # must survive the masks, or training keeps them at 0
    bias_kept = sum(int(m.sum()) for m in bias_leaves(masks))
    if n_bias and not bias_kept:
        problems.append(f"{arch} train: the masks keep none of the "
                        f"{n_bias} q/k/v bias coordinates")
    vlm_row = {}
    if cfg.family == "vlm":
        cross = masks["blocks"]["cross"]
        vlm_row = {"gates_open_at": VISION["gate"],
                   "cross_attn_kept": sum(int(m.sum()) for m in
                                          leaves(cross["cross"])),
                   "cross_attn_coordinates": sum(m.numel() for m in
                                                 leaves(cross["cross"])),
                   "gates_pruned": int((cross["gate"] == 0).sum())}
        if not vlm_row["cross_attn_kept"] or vlm_row["gates_pruned"]:
            problems.append(f"{arch} train: the masks keep "
                            f"{vlm_row['cross_attn_kept']} cross-attention "
                            f"coordinates and prune "
                            f"{vlm_row['gates_pruned']} gates")
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = _peak_gib()
    peak_reserved = torch.cuda.max_memory_reserved() / 2**30
    if grow:
        vlm_row["expandable_segments"] = _expandable_count()
        if not vlm_row["expandable_segments"]:
            problems.append(f"{arch} train: no segment grows in place")
    grads = 1 + c["steps"] * mb
    want = {"flash_attention": 2 * self_layers(cfg) * grads,  # remat: twice
            "flash_attention_bwd": self_layers(cfg) * grads}
    for kname, n in want.items():
        if launches[kname] != n:
            problems.append(f"{arch} train: {kname} launched "
                            f"{launches[kname]} times, expected {n}")
    if not all(np.isfinite(losses)):
        problems.append(f"{arch} train: losses {losses}")
    if moved:
        problems.append(f"{arch} train: {moved} pruned coordinates moved")
    walls["steps"] = float(np.sum(secs))
    t = time.perf_counter()
    # the rerun: the first result waits in host memory, so that the card
    # holds one tree beside the step's state
    final_host = _to_host(final)
    del final
    torch.cuda.reset_peak_memory_stats()
    _, again = step(before, masks, last)
    rerun_peak = _peak_gib()
    rerun_equal = _equal_to_host(again, final_host)
    if not rerun_equal:
        problems.append(f"{arch} train: the last step rerun differs")
    del again, before, final_host
    walls["rerun"] = time.perf_counter() - t
    n_params = T.param_count(cfg)
    acc_bytes = 2 if n_params > 100e9 else 4
    tokens = batch * seq
    print(json.dumps({
        "train": arch, "card": smi, "layers": cfg.num_layers,
        "params": n_params,
        "active_params": T.active_param_count(cfg),
        "runtime": dataclasses.asdict(rt), "batch": batch, "seq": seq,
        "microbatches": mb, "warm_batch": warm_batch, **mask_row,
        **({"qkv_bias_drawn": n_bias, "qkv_bias_kept": bias_kept}
           if n_bias else {}), **vlm_row,
        "losses": losses, "step_s": secs,
        "ms_per_step": 1e3 * float(np.mean(secs[1:])),
        "tokens_per_s": tokens / float(np.mean(secs[1:])),
        "peak_gib": peak, "peak_reserved_gib": peak_reserved,
        "rerun_peak_gib": rerun_peak,
        # weights, masks, the masked copy and the accumulator
        "step_state_gib": n_params * (2 + 1 + 2 + acc_bytes) / 2**30,
        "launches": {k: launches[k] for k in want},
        "pruned_bits_moved": moved, "rerun_bitwise": rerun_equal}))
    del masks, last
    torch.cuda.empty_cache()
    t = time.perf_counter()
    g_problems, g_row = flash_grad_check(dev, cfg, rt)
    walls["grad_check"] = time.perf_counter() - t
    print(json.dumps({**g_row, "card": smi}))
    problems += g_problems
    torch.cuda.empty_cache()
    t = time.perf_counter()
    k_problems, fwd_row, bwd_row = train_kernel_rows(captured["args"], card,
                                                     smi, arch)
    walls["kernel_rows"] = time.perf_counter() - t
    print(json.dumps({"train_phase_s": arch, **walls}))
    problems += k_problems
    captured.clear()
    torch.cuda.empty_cache()
    if grow:
        _expandable_segments(False)
    return problems, launches, (fwd_row, bwd_row)


def mamba_train_phase(dev, smi):
    """mamba2-130m at full width in bf16, MAMBA["layers"] deep, trained at
    the same shape (4 x 4096 tokens, specialize's train runtime, lambda
    0.3, eta 1e-2): 3 steps,
    finite losses, pruned coordinates unchanged bit for bit, and a
    checkpoint after step 2 restored and step 3 rerun from it bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.launch.steps import specialize
    from repro_torch.models import transformer as T
    c = TRAIN
    shape = INPUT_SHAPES[c["shape"]]
    cfg, rt = specialize(dataclasses.replace(
        get_config("mamba2-130m"), num_layers=MAMBA["layers"]), shape)
    seq, batch = shape.seq_len, c["batch"]
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    torch.cuda.reset_peak_memory_stats()
    masks, mask_row, problems = train_masks(params, cfg, rt, dev, c["lam"],
                                            seq, batch)
    final, _, last, losses, secs, step, mgr, moved = run_train_steps(
        [params], masks, cfg, rt, dev, seq, batch, c["steps"], c["eta"],
        ckpt_after=c["steps"] - 1)
    peak = _peak_gib()
    if not all(np.isfinite(losses)):
        problems.append(f"mamba2 train: losses {losses}")
    moved += _pruned_moved(final, params, masks)
    if moved:
        problems.append(f"mamba2 train: {moved} pruned coordinates moved")
    restored, meta = mgr.restore(params)
    _, again = step(restored, masks, last)
    resumed = meta["step"] == c["steps"] - 1 and _trees_equal(again, final)
    if not resumed:
        problems.append("mamba2 train: step 3 from the checkpoint differs")
    shutil.rmtree(TRAIN_CKPT, ignore_errors=True)
    print(json.dumps({
        "train": "mamba2-130m", "card": smi, "params": T.param_count(cfg),
        "batch": batch,
        "seq": seq, **mask_row, "losses": losses, "step_s": secs,
        "ms_per_step": 1e3 * float(np.mean(secs[1:])),
        "tokens_per_s": batch * seq / float(np.mean(secs[1:])),
        "peak_gib": peak, "pruned_bits_moved": moved,
        "checkpoint_resume_bitwise": resumed}))
    return problems


# phase 25: the sharded LM train step (sharding/rules.py, DTensor)
LM_SHARDED = dict(arch="granite-3-2b", one_layers=2, one_batch=2,
                  mesh=(16, 16), lam=0.3, card_gib=80.0)
FLASH_KERNELS = ("flash_attention", "flash_attention_bwd")


def _local_random(meta, dev, gen, kind, vocab=None):
    """A random tensor of `meta`'s shape (a local shard) on the card:
    normal * 0.02 in its dtype ("param"), a {0, 1} uint8 mask kept with
    probability 1 - lambda ("mask"), or token ids below `vocab`
    ("tokens")."""
    shape = tuple(meta.shape)
    if kind == "param":
        return (torch.randn(shape, generator=gen, device=dev) * 0.02).to(
            meta.dtype)
    if kind == "mask":
        return (torch.rand(shape, generator=gen, device=dev)
                >= LM_SHARDED["lam"]).to(torch.uint8)
    return torch.randint(0, vocab, shape, generator=gen, device=dev,
                         dtype=torch.int32)


def lm_sharded_one(dev, smi):
    """(a) granite-3-2b at full width, LM_SHARDED["one_layers"] of its 40
    layers, in bf16 under the train_4k runtime (flash_vjp, remat), one
    masked-FedSGD step on a batch of one_batch x 4096 random tokens: the
    unsharded step, then the same tensors as DTensors placed by the
    partition rules over a 1 x 1 (data, model) mesh on a fake world of one
    rank (no data moves), the step through local_map and the kernels.
    Loss and every new parameter bit for bit; kernel 8's and the
    backward's launches equal. Returns (problems, row, sharded
    launches)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    from repro_torch.tree import leaves, tree_map
    from torch.distributed.device_mesh import init_device_mesh
    c = LM_SHARDED
    shape = INPUT_SHAPES["train_4k"]
    cfg, rt = steps.specialize(dataclasses.replace(
        get_config(c["arch"]), num_layers=c["one_layers"]), shape)
    gen = torch.Generator(device=dev).manual_seed(1)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    masks = tree_map(lambda w: _local_random(w, dev, gen, "mask"), params)
    tok = _local_random(torch.empty(c["one_batch"], shape.seq_len + 1,
                                    device="meta"), dev, gen, "tokens",
                        cfg.vocab_size)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    step = steps.make_train_step(cfg, rt)
    reset_launches()
    loss0, new0 = step(params, masks, batch)
    torch.cuda.synchronize()
    plain = {k: LAUNCHES[k] for k in FLASH_KERNELS}
    fake_world(1)
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data",
                                                                "model"))
    pol = rules.make_policy(cfg, mesh, "train")
    specs = rules.param_specs(cfg, pol, params)
    dp = rules.distribute(params, specs, mesh)
    dm = rules.distribute(masks, specs, mesh)
    db = rules.distribute(batch, {k: rules.batch_spec(v.shape[0], pol)
                                  for k, v in batch.items()}, mesh)
    reset_launches()
    with rules.set_mesh(mesh):
        loss1, new1 = step(dp, dm, db)
    torch.cuda.synchronize()
    sharded = {k: LAUNCHES[k] for k in FLASH_KERNELS}
    loss_eq = torch.equal(loss0, loss1.to_local())
    differ = sum(not torch.equal(a, b.to_local())
                 for a, b in zip(leaves(new0), leaves(new1)))
    problems = []
    if not loss_eq or differ:
        problems.append(f"lm sharded 1x1: loss equal {loss_eq}, {differ} "
                        "parameter leaves differ from the unsharded step")
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers}
    if sharded != plain or plain != want:
        problems.append(f"lm sharded 1x1: launches {sharded}, unsharded "
                        f"{plain}, expected {want}")
    row = {"lm_sharded": "1x1", "card": smi, "arch": c["arch"],
           "layers": cfg.num_layers, "batch": c["one_batch"],
           "seq": shape.seq_len, "loss": float(loss0),
           "loss_bitwise": loss_eq, "param_leaves_differing": differ,
           "launches": sharded, "unsharded_launches": plain}
    print(json.dumps(row))
    return problems, row, sharded


def lm_sharded_rank0(dev, card, smi):
    """(b) rank 0's share of the production 16 x 16 mesh: granite-3-2b at
    full width and depth, train_4k (256 x 4096 tokens), a fake world of
    256 ranks (every collective completes at once and moves nothing, so
    the values of gathered shards are not meaningful). Rank 0's local
    shards of the parameters, masks and batch (16 x 4096 tokens on the
    data axis) are random tensors on the card, placed by the rules; one
    warm-up step, then one timed step under CommDebugMode. Checks: peak
    memory under the card's 80 GiB, the collective counts those of the
    dry run (launch/dryrun.py, its collectives pass on the meta device,
    run here after the step) for the same (arch, shape, mesh), the
    launches layers x 2 (remat) for kernel 8 and layers for the backward,
    every local shard's shape the rules'. Then kernel 8 with lse and the
    backward at the local shape this path gives them (layer 0's, read
    from the step: granite's 32 / 8 heads on 16 model ranks are 2 query
    heads on one repeated KV head, g = 2), on random inputs of that shape
    held against their plain versions (train_kernel_rows). Returns
    (problems, row, launches, (forward row, backward row))."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models import flash_vjp as fv
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding import rules
    from repro_torch.tree import flatten_with_path, leaves, unflatten
    c = LM_SHARDED
    os.environ.pop("REPRO_FORCE_MESH", None)
    shape = INPUT_SHAPES["train_4k"]
    cfg, rt = steps.specialize(get_config(c["arch"]), shape)
    dryrun.fake_world(math.prod(c["mesh"]))
    mesh = make_production_mesh(device_type=dev.type)
    pol = rules.make_policy(cfg, mesh, "train")
    shapes = rules.param_shapes(cfg)
    specs = rules.param_specs(cfg, pol, shapes)
    spec_list = [s for _, s in rules.spec_leaves(specs)]
    gen = torch.Generator(device=dev).manual_seed(0)

    def shard(tree, sp, kind, vocab=None):
        out = []
        for (_, t), s in zip(flatten_with_path(tree), sp):
            loc = torch.empty(rules.local_shape(t.shape, s, mesh),
                              dtype=t.dtype, device="meta")
            out.append(DTensor.from_local(
                _local_random(loc, dev, gen, kind, vocab), mesh,
                rules.placements(s, mesh), run_check=False,
                shape=t.shape, stride=torch.empty(t.shape,
                                                  device="meta").stride()))
        return unflatten(tree, out)

    torch.cuda.reset_peak_memory_stats()
    dp = shard(shapes, spec_list, "param")
    dm = shard(shapes, spec_list, "mask")
    bmeta = steps.batch_specs(cfg, shape, with_labels=True)
    bspec = [rules.batch_spec(v.shape[0], pol) for v in bmeta.values()]
    db = shard(bmeta, bspec, "tokens", cfg.vocab_size)
    step = steps.make_train_step(cfg, rt)
    captured, sound = {}, fv._kernel_bwd

    def keep_last(res, do, *args):      # the last call of a backward: layer 0
        captured["shapes"] = [tuple(t.shape) for t in (*res, do)]
        captured["args"] = args
        return sound(res, do, *args)

    with rules.set_mesh(mesh):
        step(dp, dm, db)                                  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        comm = dryrun.comm_counter()
        fv._kernel_bwd = keep_last
        t = time.perf_counter()
        try:
            with comm:
                loss, new = step(dp, dm, db)
            torch.cuda.synchronize()
        finally:
            fv._kernel_bwd = sound
        ms = 1e3 * (time.perf_counter() - t)
    launches = {k: LAUNCHES[k] for k in FLASH_KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = dryrun.collective_stats(comm)["counts"]
    problems = []
    bad_shapes = [p for (p, w), s in zip(flatten_with_path(new), spec_list)
                  if tuple(w.to_local().shape) != rules.local_shape(
                      w.shape, s, mesh)
                  or tuple(w.placements) != rules.placements(s, mesh)]
    bad_shapes += [p for (p, w), s in zip(flatten_with_path(dm), spec_list)
                   if tuple(w.to_local().shape) != rules.local_shape(
                       w.shape, s, mesh)]
    bad_shapes += [k for (k, w), s in zip(db.items(), bspec)
                   if tuple(w.to_local().shape) != rules.local_shape(
                       w.shape, s, mesh)]
    if bad_shapes:
        problems.append(f"lm sharded 16x16: local shards off the rules' "
                        f"shapes: {bad_shapes[:5]}")
    want = {"flash_attention": 2 * cfg.num_layers,
            "flash_attention_bwd": cfg.num_layers}
    if launches != want:
        problems.append(f"lm sharded 16x16: launches {launches}, expected "
                        f"{want}")
    if not peak < c["card_gib"]:
        problems.append(f"lm sharded 16x16: peak {peak:.2f} GiB")
    del dp, dm, db, new, loss
    torch.cuda.empty_cache()
    # the dry run's collectives pass (launch/dryrun.run_one's first pass)
    # on meta tensors, in this process's fake world of 256
    t = time.perf_counter()
    lowered, _ = dryrun.lower_step(c["arch"], "train_4k")
    dry_comm = dryrun.comm_counter()
    with dry_comm:
        lowered.run()
    dry = dryrun.collective_stats(dry_comm)["counts"]
    dry_s = time.perf_counter() - t
    del lowered
    if dry != counts:
        problems.append(f"lm sharded 16x16: collectives {counts}, the dry "
                        f"run's {dry}")
    # kernel 8 and the backward at layer 0's local shapes: q [16, 4096, 2,
    # 64], k / v [16, 4096, 1, 64]
    hq = cfg.num_heads // c["mesh"][1]
    want_q = (shape.global_batch // c["mesh"][0], shape.seq_len, hq,
              cfg.head_dim)
    want_kv = want_q[:2] + (1, cfg.head_dim)
    got = captured.get("shapes")
    if not got or got[0] != want_q or got[1] != want_kv or \
            got[2] != want_kv:
        problems.append(f"lm sharded 16x16: layer 0's attention shapes "
                        f"{got}, expected q {want_q}, k / v {want_kv}")
    rng = np.random.default_rng(0)
    q, k, v, do = (torch.from_numpy(rng.normal(size=sh).astype(
        np.float32)).to(dev, torch.bfloat16)
        for sh in (want_q, want_kv, want_kv, want_q))
    causal, window, cap = captured.get("args", (True, 0, 0.0))
    o, lse = fv._kernel_fwd(q, k, v, causal, window, cap)
    k_problems, fwd_row, bwd_row = train_kernel_rows(
        ((q, k, v, o, lse), do, (causal, window, cap)), card, smi,
        f"{c['arch']} 16x16 rank 0 (random inputs)")
    problems += k_problems
    row = {"lm_sharded": "16x16 rank 0", "card": smi, "arch": c["arch"],
           "layers": cfg.num_layers, "global_batch": shape.global_batch,
           "local_batch": rules.local_shape(
               (shape.global_batch, shape.seq_len), bspec[0], mesh)[0],
           "seq": shape.seq_len, "ms_per_step": ms, "peak_gib": peak,
           "collectives": counts,
           "collective_bytes": dryrun.collective_stats(comm)["bytes_by_kind"],
           "dry_run_collectives": dry, "dry_run_s": dry_s,
           "launches": launches, "layer0_attention_shapes": got}
    print(json.dumps(row))
    return problems, row, launches, (fwd_row, bwd_row)


def lm_sharded_phase(dev, card, smi):
    """Phase 25: (a) lm_sharded_one, (b) lm_sharded_rank0; the fake process
    group is taken down after each. Returns (problems, launches by part,
    (b)'s kernel rows or None)."""
    import traceback

    import torch.distributed as dist
    problems, launches, rows = [], {}, None
    for part, fn, args in (("1x1", lm_sharded_one, (dev, smi)),
                           ("16x16_rank0", lm_sharded_rank0,
                            (dev, card, smi))):
        # a part that raises fails the phase with its traceback, and the
        # other part still runs
        try:
            p, _, launches[part], *more = fn(*args)
            problems += p
            rows = more[0] if more else rows
        except Exception:
            problems.append(f"lm sharded {part} raised:\n"
                            + traceback.format_exc())
            launches[part] = {k: 0 for k in FLASH_KERNELS}
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            torch.cuda.empty_cache()
    return problems, launches, rows


def _short(arch: str) -> str:
    return arch.split("-")[0]


def _row_summary(row: dict) -> dict:
    """A kernel row's numbers for the kernels line."""
    return {k: row[k] for k in (
        "ok", "ms", "plain_ms", "device_ms", "bound_ms", "bound_by",
        "library_ms", "max_abs_err", "shape", "scaled_err_dq_dk_dv",
        "library_bwd_ms", "library_o_max_abs_err", "library_error")
        if k in row}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", action="store_true",
                        help="set-up and the kernels against their plain "
                             "versions (phases 1 and 2) only; no result line")
    parser.add_argument("--sharded", action="store_true",
                        help="set-up and the sharded client axis (phase 24) "
                             "only; no result line")
    parser.add_argument("--lm-sharded", action="store_true",
                        help="set-up and the sharded LM train step (phase "
                             "25) only; no result line")
    parser.add_argument("--train", metavar="ARCH[,ARCH]",
                        help="set-up and the named LM training phases only "
                             "(the kernels line of just those); no result "
                             "line")
    parser.add_argument("--sec5", action="store_true",
                        help="set-up and the Sec. V comparison (phase 34) "
                             "only; no result line")
    parser.add_argument("--warm-flex", action="store_true",
                        help="compile the flex_attention library calls "
                             "into build/'s caches (warm_flex) and exit; "
                             "the full run starts it itself")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print("chip_smoke: expected exactly one visible card, got "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    print(card)
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")
    if args.warm_flex:
        warm_flex(dev)
        return 0

    walls = {"imports_and_setup": time.perf_counter() - T_START}
    t = time.perf_counter()
    _build.load()
    walls["build"] = time.perf_counter() - t
    print(f"kernels built in {walls['build']:.2f} s "
          f"({_build.library_path().name})")
    print(json.dumps({"ptxas_lm": ptxas_report(LM_PTXAS)}))
    print(json.dumps({"ptxas_round": ptxas_report(ROUND_PTXAS)}))
    # the bf16 flash (forward, backward) and SSD kernels must run on the
    # tensor cores: HGMMA in the SASS of every wgmma instantiation, read by
    # cuobjdump beside the phases and checked before the result line
    sass_job = ThreadPoolExecutor(max_workers=1).submit(sass_hgmma_counts)
    if args.lm_sharded:
        torch.use_deterministic_algorithms(True, warn_only=True)
        t = time.perf_counter()
        problems, _, _ = lm_sharded_phase(dev, name, card)
        walls["lm_sharded_train_step"] = time.perf_counter() - t
        print(json.dumps({"phase_wall_s": walls}))
        problems += hgmma_problems(sass_job.result())
        if problems:
            print("chip_smoke FAILED: " + "; ".join(problems),
                  file=sys.stderr)
        return 1 if problems else 0
    if args.train:
        torch.use_deterministic_algorithms(True, warn_only=True)
        problems, depth = [], dict(TRAIN_LAYERS)
        for arch in args.train.split(","):
            t = time.perf_counter()
            tr_problems, tr_launches, _ = lm_train_phase(
                dev, name, card, arch, depth.get(arch))
            problems += tr_problems
            walls[f"{arch}_train"] = time.perf_counter() - t
            print(json.dumps({"train_launches": arch, **{
                k: tr_launches[k] for k in FLASH_KERNELS}}))
        print(json.dumps({"phase_wall_s": walls}))
        problems += hgmma_problems(sass_job.result())
        if problems:
            print("chip_smoke FAILED: " + "; ".join(problems),
                  file=sys.stderr)
        return 1 if problems else 0
    if args.sec5:
        t = time.perf_counter()
        problems, _ = sec5_phase(dev, card)
        walls["sec5_comparison"] = time.perf_counter() - t
        print(json.dumps({"phase_wall_s": walls}))
        sass_job.result()
        if problems:
            print("chip_smoke FAILED: " + "; ".join(problems),
                  file=sys.stderr)
        return 1 if problems else 0
    if args.sharded:
        t = time.perf_counter()
        problems = sharded_phase(dev, card)
        walls["sharded_client_axis"] = time.perf_counter() - t
        print(json.dumps({"phase_wall_s": walls}))
        sass_job.result()
        if problems:
            print("chip_smoke FAILED: " + "; ".join(problems),
                  file=sys.stderr)
        return 1 if problems else 0

    t = time.perf_counter()
    ds, clients, sp, ch, sched, params = slice_env(dev)
    pack = ParamPack.build(params)
    kernels = check_kernels(dev, pack, name)
    walls["kernels"] = time.perf_counter() - t
    if args.kernels:
        print(json.dumps({"phase_wall_s": walls}))
        sass = hgmma_problems(sass_job.result())
        if sass:
            print("chip_smoke FAILED: " + "; ".join(sass), file=sys.stderr)
        return 1 if sass else 0
    # the softcapped rows' library calls compile beside the federated
    # phases, in a child process that fills the compile caches
    flex_warm = start_flex_warmup()

    # the pruned-FedSGD path, packed backend: counts from this run only
    t = time.perf_counter()
    pm.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    tr_pk, h_pk, s_pk = run_backend("packed", dev, ds, clients, sp, ch,
                                    sched, params)
    launches = dict(pm.LAUNCHES)
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    tr_ref, h_ref, s_ref = run_backend("reference", dev, ds, clients, sp, ch,
                                       sched, params)
    n_rounds = len(h_pk)
    print(json.dumps({"rounds": n_rounds,
                      "packed_round_ms": 1e3 * s_pk / n_rounds,
                      "reference_round_ms": 1e3 * s_ref / n_rounds,
                      "packed_peak_mib": peak_mib, "launches": launches}))
    evals = [(m.round, m.test_accuracy) for m in h_pk
             if m.test_accuracy is not None]
    print(json.dumps({"test_accuracy": evals,
                      "train_loss_last": h_pk[-1].train_loss}))

    problems = []
    if n_rounds != SLICE["rounds"]:
        problems.append(f"ran {n_rounds} rounds, expected {SLICE['rounds']}")
    if launches["exponent_histogram"] != n_rounds:
        problems.append("exponent_histogram launches != rounds")
    if launches["fedsgd_aggregate_weighted"] != n_rounds:
        problems.append("fedsgd_aggregate_weighted launches != rounds")
    if (launches["importance_mask_2d"]
            + launches["importance_mask_batched"]) != n_rounds:
        problems.append("mask launches != rounds")
    if launches["importance_mask_batched"] < 1:
        problems.append("the per-client mask kernel never ran")
    # parameters bit for bit; the broadcast gradient v as values, the
    # packages' packed-vs-reference contract: a pruned coordinate's masked
    # gradient can be -0.0 and the packed sum starts from +0.0
    w_bits = v_zero_signs = 0
    for key in tr_pk.params:
        a, b = tr_pk.params[key], tr_ref.params[key]
        w_bits += int((a.view(torch.int32) != b.view(torch.int32)).sum())
        va, vb = tr_pk.global_grad[key], tr_ref.global_grad[key]
        if not torch.equal(va, vb):
            problems.append(f"packed != reference in v[{key}]")
        v_zero_signs += int((va.view(torch.int32)
                             != vb.view(torch.int32)).sum())
        for x in (a, va):
            if x.shape != b.shape or not bool(torch.isfinite(x).all()):
                problems.append(f"bad shape or non-finite values in {key}")
    if w_bits:
        problems.append(f"{w_bits} parameter bits differ between backends")
    if [m.train_loss for m in h_pk] != [m.train_loss for m in h_ref]:
        problems.append("per-round train losses differ between backends")
    final_acc = h_pk[-1].test_accuracy
    if final_acc is None or not final_acc > 0.2:
        problems.append(f"round-{n_rounds - 1} accuracy {final_acc} <= 0.2")
    print(json.dumps({"packed_vs_reference": "differ" if problems
                      else "params bitwise, v equal",
                      "param_bits_differing": w_bits,
                      "v_signed_zero_differences": v_zero_signs,
                      "final_accuracy": final_acc}))
    # the per-round path's profile, the series of earlier runs; the
    # blocked path's is the quickstart phase's
    print(json.dumps({"path": "per-round", **profile_rounds(
        dev, clients, sp, ch, sched, params, rounds_per_dispatch=1)}))
    walls["pruned_fedsgd_path"] = time.perf_counter() - t

    t = time.perf_counter()
    env = attack_env(dev)
    attack_problems, median_launches, median_tr = attack_phase(dev, env)
    problems += attack_problems
    walls["attack_slice"] = time.perf_counter() - t
    t = time.perf_counter()
    problems += fault_phase(dev, env)
    walls["fault_axes"] = time.perf_counter() - t
    t = time.perf_counter()
    entry_problems, entry_launches = entry_point_phase(dev, median_tr, env)
    problems += entry_problems
    walls["entry_points"] = time.perf_counter() - t
    t = time.perf_counter()
    quick_problems, quick_launches = quickstart_phase(dev, card)
    problems += quick_problems
    walls["quickstart_api"] = time.perf_counter() - t
    t = time.perf_counter()
    sec5_problems, sec5_launches = sec5_phase(dev, card)
    problems += sec5_problems
    walls["sec5_comparison"] = time.perf_counter() - t
    print(json.dumps({"phase_wall_s": {"sec5_comparison":
                                       walls["sec5_comparison"]}}))
    t = time.perf_counter()
    cifar_problems, cifar_launches, _ = cifar_phase(dev, card)
    problems += cifar_problems
    walls["cifar10_resnet20"] = time.perf_counter() - t
    print(json.dumps({"phase_wall_s": {"cifar10_resnet20":
                                       walls["cifar10_resnet20"]}}))
    # spec C's own path: every round kernel of it launched in each of its
    # packed runs (counts from 0 just before each run); its schedules give
    # every client of a round one lambda, so kernel 1 is not on it
    for run_name, counts in cifar_launches.items():
        for kname in ("importance_mask_2d", "exponent_histogram",
                      "fedsgd_aggregate_weighted"):
            if not counts.get(kname):
                problems.append(f"spec C {run_name}: {kname} never "
                                "launched")
    t = time.perf_counter()
    fleet_problems, fleet_launches = fleet_phase(dev, card)
    problems += fleet_problems
    walls["fleet_streaming"] = time.perf_counter() - t
    t = time.perf_counter()
    problems += sweep_phase(dev, card)
    walls["sweep_service"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    problems += sharded_phase(dev, card)
    walls["sharded_client_axis"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    print(json.dumps({"phase_wall_s": {
        k: walls[k] for k in ("fleet_streaming", "sweep_service",
                              "sharded_client_axis")}}))

    # the LM stack. torch.cumsum on CUDA (the SSD scans') has no
    # deterministic implementation, so deterministic mode goes off here;
    # engine == sequential rests on the same ops at the same shapes
    torch.use_deterministic_algorithms(False)
    t = time.perf_counter()
    stop_flex_warmup(flex_warm)
    lm_problems, flash_rows = lm_kernel_phase(dev, name)
    problems += lm_problems
    walls["lm_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    g_problems, eng, flash_launches, occupants = serve_phase(dev, name, card,
                                                             GRANITE)
    problems += g_problems
    d_problems, decode_launches, decode_row = decode_entry_phase(
        dev, name, eng, occupants)
    problems += d_problems
    print(json.dumps(granite_window(eng)))
    del eng
    torch.cuda.empty_cache()
    walls["granite_serving"] = time.perf_counter() - t
    t = time.perf_counter()
    m_problems, ssd_launches, ssd_row = mamba_phase(dev, name)
    problems += m_problems
    walls["mamba2_serving"] = time.perf_counter() - t
    serve_launches = {}
    for conf in (HYMBA, MIXTRAL, WHISPER, VISION, GEMMA2, QWEN, YI, ARCTIC):
        t = time.perf_counter()
        s_problems, s_eng, serve_launches[conf["arch"]], _ = serve_phase(
            dev, name, card, conf)
        problems += s_problems
        del s_eng
        torch.cuda.empty_cache()
        walls[f"{conf['arch']}_serving"] = time.perf_counter() - t

    # LM training: deterministic algorithms where torch has them (the
    # embedding's index backward; CUDA cumsum, in mamba2's scan, only
    # warns), so that a step rerun gives the same bits
    torch.use_deterministic_algorithms(True, warn_only=True)
    t = time.perf_counter()
    tr_problems, train_launches, (train_fwd, train_bwd) = lm_train_phase(
        dev, name, card, *TRAIN_LAYERS[0])
    problems += tr_problems
    torch.cuda.empty_cache()
    walls["granite_train"] = time.perf_counter() - t
    t = time.perf_counter()
    problems += mamba_train_phase(dev, card)
    walls["mamba2_train"] = time.perf_counter() - t
    new_train = {}
    for arch, layers in TRAIN_LAYERS[1:]:
        t = time.perf_counter()
        tr_problems, tr_launches, tr_rows = lm_train_phase(
            dev, name, card, arch, layers)
        problems += tr_problems
        new_train[arch] = (tr_launches, *tr_rows)
        walls[f"{arch}_train"] = time.perf_counter() - t
    # the D 256 backward at gemma2's shape on random inputs, globally (the
    # row PERF.md has kept since the CUDA-core kernels) and under a window
    # of 1,024
    t = time.perf_counter()
    d256 = {}
    for window in GEMMA2_BWD["windows"]:
        d_problems, d256[f"window {window}"] = d256_bwd_row(dev, name, card,
                                                            window)
        problems += d_problems
    torch.cuda.empty_cache()
    walls["d256_bwd_rows"] = time.perf_counter() - t
    t = time.perf_counter()
    sh_problems, sharded_launches, sharded_rows = lm_sharded_phase(
        dev, name, card)
    problems += sh_problems
    walls["lm_sharded_train_step"] = time.perf_counter() - t
    torch.use_deterministic_algorithms(False)
    print(json.dumps({"phase_wall_s": walls}))

    # each kernel's launches come from the path that runs it, counted from
    # 0 just before that path and read just after
    paths = {"client_rank_sort": ("attack slice, coord_median, packed",
                                  median_launches),
             "fedsgd_aggregate": ("entry points", entry_launches),
             "masked_update_2d": ("entry points", entry_launches)}
    rows = []
    for kname, res in kernels.items():
        path, counts = paths.get(kname, (
            "pruned-FedSGD slice, packed, 32-round blocks on CUDA graphs "
            "(replays counted)", launches))
        spec_c = {run_name: c.get(kname, 0)
                  for run_name, c in cifar_launches.items()
                  if run_name.endswith("blocked")}
        rows.append({"name": kname, "route": "cuda", "source": SOURCE,
                     "replaces": REPLACES[kname],
                     "launches": counts[kname], "path": path,
                     **({"spec_c_launches": spec_c}
                        if any(spec_c.values()) else {}),
                     **({"sec5_launches": {
                         scheme: c[kname] for scheme, c in
                         sec5_launches.items()}}
                        if kname in SEC5_KERNELS else {}),
                     "fleet_launches": fleet_launches.get(kname, 0),
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"], "device_ms": res["device_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "symbol": res["symbol"],
                     "check": "bitwise" if res["ok"] else "FAILED",
                     **{k: res[k] for k in ("shapes", "subnormal_bitwise")
                        if k in res}})
    flash_ok = all(r["ok"] for r in flash_rows.values())
    for kname, res, path, counts in (
            ("flash_attention", {**flash_rows["granite S1024"],
                                 "ok": flash_ok},
             f"granite-3-2b serving engine ({GRANITE['layers']} layers)",
             flash_launches),
            ("flash_attention_bwd", train_bwd,
             "granite-3-2b masked-FedSGD training (warm-up gradient and 3 "
             "steps)", train_launches),
            ("decode_attention", decode_row,
             "decode entry point on the served caches", decode_launches),
            ("ssd_chunk", ssd_row,
             "ssd_chunked_pallas entry point, mamba2 layer 0",
             ssd_launches)):
        rows.append({"name": kname, "route": "cuda",
                     "source": LM_SOURCES[kname],
                     "replaces": LM_REPLACES[kname],
                     "launches": counts[kname], "path": path,
                     "fleet_launches": fleet_launches.get(kname, 0),
                     "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                     "plain_ms": res["plain_ms"],
                     "device_ms": res["device_ms"],
                     "bound_ms": res["bound_ms"],
                     "bound_by": res["bound_by"],
                     "library_ms": res["library_ms"],
                     "symbol": "/".join(LM_SYMBOLS[kname]),
                     "check": ("2e-2 of each output's peak, a planted "
                               "fault above" if kname == "flash_attention_bwd"
                               else "bf16 2e-2") if res["ok"] else "FAILED",
                     **({"entry_call": res["entry_call"]}
                        if "entry_call" in res else {}),
                     **({f"prefill_{label.replace(' ', '_')}":
                         _row_summary(flash_rows[label])
                         for label in ("whisper S512", "llama-vision S1024",
                                       "arctic S1024")}
                        if kname == "flash_attention" else {}),
                     **({"lm_sharded_launches": {
                         part: n[kname] for part, n in
                         sharded_launches.items()},
                         "lm_sharded_rank0": None if sharded_rows is None
                         else _row_summary(sharded_rows[
                             kname == "flash_attention_bwd"])}
                        if kname in FLASH_KERNELS else {}),
                     **({"train_launches": train_launches[kname],
                         "train_lse": _row_summary(train_fwd),
                         **{f"{_short(a)}_serving_launches": n[kname]
                            for a, n in serve_launches.items()},
                         **{f"{_short(a)}_train_launches": r[0][kname]
                            for a, r in new_train.items()},
                         **{f"{_short(a)}_train_lse": _row_summary(r[1])
                            for a, r in new_train.items()}}
                        if kname == "flash_attention" else {}),
                     **({**{f"{_short(a)}_train_launches": r[0][kname]
                            for a, r in new_train.items()},
                         **{f"{_short(a)}_train": _row_summary(r[2])
                            for a, r in new_train.items()}}
                        if kname == "flash_attention_bwd" else {}),
                     **({"library_bwd_ms": res["library_bwd_ms"],
                         "d256": {label: _row_summary(row)
                                  for label, row in d256.items()}}
                        if kname == "flash_attention_bwd" else {})})
    print(json.dumps({"kernels": rows}))
    problems += hgmma_problems(sass_job.result())
    print(json.dumps({"script_s": time.perf_counter() - T_START}))
    if problems:
        print("chip_smoke FAILED: " + "; ".join(problems), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
