#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper).

    python3 chip_smoke.py              # every phase, then the result line
    python3 chip_smoke.py --kernels    # phases 1 and 2 only, no result line

Run from the root of a checkout; it needs one CUDA card and `nvcc` (the
kernels are built from src/repro_torch/kernels/csrc at first use). Phases:

  1. set-up: card name and power limit, deterministic cuBLAS, TF32 off,
     kernel build (timed), and the HGMMA (tensor-core) instructions of
     each flash-attention and SSD-chunk function in the built library's
     SASS: the run fails if a bf16 (wgmma) instantiation has none, or if
     either wgmma kernel is missing; ptxas's registers, spills and stack
     frames of the LM kernels and of the round's mask, histogram,
     aggregate and masked-update kernels (every instantiation);
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
     packed paths; a profiled 8-round window of each packed path (ms a
     round, device busy, idle share, the host's CUDA calls a round); kill
     after round 20's checkpoint and `resume_from_checkpoint`, bit for bit
     the uninterrupted blocked run;
  8. the paper's CIFAR-10 path through the experiment API, spec C
     (benchmarks/common.py's synthetic-cifar10 cell: 10 clients, sigma = 1,
     ResNet-20 at 272,250 coordinates packed [2304, 128], `proposed` at
     E0 = 4 J, T0 = 40 s, eta 0.1, batch 32): first ResNet-20's gradient
     against an fp64 one (within 1e-3 relative L2 under the engine's
     scope; TF32, the planted fault, outside it); FedSGD over 60 rounds (its
     schedule spends 47 J, so the budget stop is off) and FedProx (E = 2,
     mu 0.01), FedDyn (E = 2, alpha 0.01) and FedAvg at E = 3 over 20, each
     three ways as in phase 7; parameters and FedDyn's state bit for bit,
     v as values, equal histories, the last round's train loss below round
     0's; steady 8-round windows of FedSGD and FedDyn, blocked and per
     round; kill after round 10's checkpoint of the blocked FedDyn run and
     resume, bit for bit with h;
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
     h included; (c) ResNet-20 at full width over a 100,000-client
     synthetic-fleet-cifar roster (2 samples a client on average), 32
     rounds, client_store "auto": its ~3.7 GB replicated estimate is over
     the 1 GiB budget, so it must stream; env build s, ms a round, H2D
     bytes, peak cohort bytes (per sample within 4x of (a)'s), prefetch
     stall and captures printed;
 10. the sweep service: four cells, (synthetic-mnist, lenet) and
     (synthetic-cifar10, resnet) zipped over seeds 0 and 1, 10 rounds
     each, run with workers=1 and workers=2 (two ResNet cells in flight):
     per-run JSONL byte-identical, one environment build per group; then
     a sweep killed during its third cell and resumed with workers=2,
     byte-identical again;
 11. the LM stack's kernels against their plain versions in bf16 (the
     JAX package's bf16 kernel tolerance, 2e-2): flash attention at
     granite's prefill buckets and at gemma2's head dim 256 with its
     softcap in its bend, globally and under a window of 256 that masks
     keys (each branch must change the result), decode attention with
     ragged positions at granite's and gemma2's cache shapes, the SSD chunk
     at mamba2's shapes; times, bounds and the library call
     (scaled_dot_product_attention) beside them, the device time summed
     over every kernel the wrapper launches per call;
 12. granite-3-2b at full width and depth in bf16 (random weights, seed 0)
     served by the continuous-batching engine through the flash kernel:
     16 greedy requests of 32 tokens, prompts of 130-1000 tokens, on 8
     slots; flash launches == 40 x 16, engine tokens == a sequential
     generation over the same padded prefill; the prefill's last-token
     logits in fp32 on the same weights within 1e-3 (relative L2) of the
     naive path's, with a planted fault (keys one position late) above
     that limit, and every flash launch of the bf16 prefill within 2e-2
     of the plain version on its own inputs; then a profiled window; and
     the decode kernel on the served caches, every
     layer, each row at its last request's position;
 13. mamba2-130m at full size in bf16 served to 8 requests on 4 slots
     (slots reused; tokens == a fresh sequential generation), and the SSD
     entry point on layer 0's real inputs for a 512-token prompt: its 4
     chunks in one ssd_chunk launch, within bf16 of the CPU's run and of
     the model's scan; the wgmma kernel timed on one real chunk and the
     whole entry call timed beside its bound;
 14. one JSON line listing the ten kernels (kernels 1-4 with their
     launches on spec C's blocked runs beside the slice's, every kernel
     with its launches on phase 9's streamed run), then the result line.

Any failed phase exits non-zero without the result line. Without CUDA, or
without the rest of the repository beside it, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

# deterministic cuBLAS, and one card (the first visible): both must be set
# before torch initialises CUDA
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ["CUDA_VISIBLE_DEVICES"] = \
    os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.api import Callback  # noqa: E402
from repro_torch.core import (AOConfig, BoundConstants, ClientData,  # noqa: E402
                              CorruptUpload, FederatedTrainer, GaussianPoison,
                              MixedFaults, ParamPack, ScaledMalicious,
                              SignFlip, make_aggregator, phis, solve_p1)
from repro_torch.core.packing import LANES  # noqa: E402
from repro_torch.core.round_engine import kth_smallest_threshold  # noqa: E402
from repro_torch.data import make_dataset, partition_by_dirichlet  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pruning_mask as pm  # noqa: E402
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


def time_ms(fn, reps: int = 200) -> float:
    """Mean time of one call on the device's clock: CUDA events around
    `reps` back-to-back calls. For a kernel shorter than its launch this is
    the wrapper's per-call cost, the rate at which the round can issue it."""
    for _ in range(10):
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


def kernel_device_ms(fn, symbols, reps: int = 50):
    """Device time per wrapper call: the summed duration of every CUDA
    kernel in torch.profiler's device trace whose name holds one of
    `symbols` (each kernel a wrapper may launch), over the `reps` calls of
    fn (one wrapper call each). Returns (ms, the kernel names that
    matched, the number of such kernel events). ms is None when the trace
    shows none of them, and the top device events are printed then. A
    trace with fewer events than calls has lost some (every wrapper here
    launches at least one kernel a call): that is printed, and ms is the
    mean per event, which is per call for the one-launch wrappers. A
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
    names = sorted({key[:120] for key, _, _ in hits})
    total_ms = sum(us for _, _, us in hits) / 1e3
    if n_events < reps:
        top = sorted(events, key=lambda e: -e[2])[:8]
        print(json.dumps({"device_trace_incomplete": list(symbols),
                          "calls": reps, "events": n_events,
                          "top_device_events": [
                              {"name": k[:120], "calls": c, "us": us}
                              for k, c, us in top]}))
        return (total_ms / n_events if n_events else None), names, n_events
    return total_ms / reps, names, n_events


def _instance(kernel: str, targs) -> str:
    """A kernel's name with its template arguments, if any: f<a,b>."""
    targs = [t for t in targs if t]
    return f"{kernel}<{','.join(targs)}>" if targs else kernel


LM_PTXAS = ("flash_attention", "decode_attention", "ssd_chunk")
# the round's kernels of the aggregate tail and the shared-threshold path
ROUND_PTXAS = ("importance_mask", "exponent_histogram", "fedsgd_aggregate",
               "masked_update")


def ptxas_report(prefixes) -> dict:
    """Registers, spill bytes and stack frame of each kernel instantiation
    whose name starts with one of `prefixes`, from the ptxas report the
    build keeps beside the library."""
    path = _build.ptxas_report_path()
    if not path.exists():
        return {"ptxas": "not measured: no report beside the library"}
    pattern = (r"(?<=\d)((?:" + "|".join(prefixes)
               + r")\w*?kernel)(?:I(.*?)EEv|E)")
    out, name = {}, None
    for line in path.read_text().splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            kern = re.search(pattern, head.group(1))
            name = None
            if kern:
                args = kern.group(2) or ""
                dtype = "bf16" if "bfloat16" in args else "fp32" \
                    if args.startswith("f") else ""
                name = _instance(kern.group(1),
                                 [dtype, *re.findall(r"Li(\d+)E", args)])
            continue
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
    """HGMMA (wgmma) instructions in each flash_attention and ssd_chunk
    function of the built kernel library, from `cuobjdump --dump-sass`."""
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
            kern = re.search(r"(?<=\d)((?:flash_attention|ssd_chunk)\w*?"
                             r"kernel)[IE]", mangled)
            name = None
            if kern:
                targs = re.findall(r"Li(\d+)E", mangled)
                if "kernelIf" in mangled:
                    targs = ["float", *targs]
                name = _instance(kern.group(1), targs)
                counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


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
QUICK_WINDOW = 8          # rounds of each profiled window
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
    one path, driven four times: first (the blocked path captures the
    window's graphs there) and again, timed on the host clock; then under
    torch.profiler (CUDA): wall and device-busy ms a round, the idle share
    (against the profiled and the unprofiled wall), the device's kernels a
    round; then under the CPU profiler: the kernel launches, graph launches
    and copies the host issues a round."""
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

    def drive():
        tr.run(win, env.sp, ch.uplink, ch.downlink)

    n = QUICK_WINDOW
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
    out = device_idle(drive)
    if "wall_ms" not in out:
        return {**steady, **out}
    out = {**steady,
           "profiled_wall_ms_per_round": out["wall_ms"] / n,
           "device_busy_ms_per_round": out["device_busy_ms"] / n,
           "device_idle_share": out["device_idle_share"],
           "device_kernels_per_round": out["kernel_launches"] / n,
           "top_kernels": out["top_kernels"]}
    # idle against the unprofiled wall: CUPTI's tracing of a graph's
    # kernels stretches the profiled one
    out["device_idle_share_unprofiled"] = max(
        0.0, 1.0 - out["device_busy_ms_per_round"]
        / steady["steady_ms_per_round"])
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            drive()
            torch.cuda.synchronize()
        api = {ev.key: ev.count for ev in prof.key_averages()
               if ev.key.startswith("cuda")}
        out["host_calls_per_round"] = {
            k: api.get(k, 0) / n for k in (
                "cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch", "cudaMemcpyAsync")}
    except (AssertionError, RuntimeError) as err:
        out["host_calls_per_round"] = f"not measured: {err}"
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
# (label, local scheme, E, its kwargs, rounds). The 60-round FedSGD
# schedule spends 47 J of the 4 J budget (infeasible), so the budget stop
# would end it after round 5: it runs all 60 rounds; the 20-round
# schedules are feasible and keep the stop
CIFAR_RUNS = (("fedsgd", "fedavg", 1, {}, 60),
              ("fedprox", "fedprox", 2, {"mu": 0.01}, 20),
              ("feddyn", "feddyn", 2, {"alpha": 0.01}, 20),
              ("fedavg_e3", "fedavg", 3, {}, 20))


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


def resnet_grad_accuracy(dev) -> dict:
    """ResNet-20's gradient on a CIFAR-shaped batch of 32 against an fp64
    reference taken on the CPU, as relative L2: under the engine's scope
    (fp32, deterministic cuDNN), with cuDNN off (torch's native
    convolution), on the CPU in fp32, and, the planted fault, without the
    scope under global TF32."""
    import contextlib
    from repro_torch.device import exact_fp32
    from repro_torch.models import cnn
    from repro_torch.tree import leaves, tree_map, unflatten
    params = resnet_init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32))

    def grad(d, dtype, ctx):
        ps = [t.to(d, dtype).requires_grad_(True) for t in leaves(params)]
        with ctx():
            loss = make_loss_fn(cnn.resnet_apply)(unflatten(params, ps),
                                                  x.to(d, dtype), y.to(d))
            g = torch.autograd.grad(loss, ps)
        return torch.cat([t.reshape(-1).double().cpu() for t in g])

    @contextlib.contextmanager
    def native():
        with exact_fp32():
            torch.backends.cudnn.enabled = False
            yield

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
    g64 = grad(cpu, torch.float64, contextlib.nullcontext)
    rel = {}
    for name, d, ctx in (("cuda_scoped", dev, exact_fp32),
                         ("cuda_native_conv", dev, native),
                         ("cpu_fp32", cpu, contextlib.nullcontext),
                         ("cuda_tf32_unscoped", dev, tf32)):
        rel[name] = float((grad(d, torch.float32, ctx) - g64).norm()
                          / g64.norm())
    return rel


def cifar_phase(dev, card):
    """First ResNet-20's gradient against fp64 (`resnet_grad_accuracy`:
    within 1e-3 relative L2, TF32 outside it). Then spec C through
    repro_torch.api: FedSGD over 60 rounds and FedProx (E = 2), FedDyn (E =
    2) and FedAvg at E = 3 over 20, each three ways ("auto": 32-round
    blocks on CUDA graphs, one round a dispatch, the reference backend).
    Parameters and FedDyn's state bit for bit across the three, v as
    values, equal histories; the train loss of the last round below round
    0's on every run; the blocked runs replay a graph
    every block round (or capture it after the round) and upload no
    batch; kernels 2, 3 and 4 launch once a round on both packed runs
    (the masks: kernel 2 or, where a round's clients have different
    lambdas, kernel 1). Then the
    steady 8-round windows of FedSGD and FedDyn, blocked and per round,
    and kill after round 10's checkpoint of the blocked FedDyn run and
    `resume_from_checkpoint`: bit for bit, h included. Returns (problems,
    launches of each packed run)."""
    from repro_torch.api import (Experiment, build_environment,
                                 resume_from_checkpoint)
    problems, launches_by_run = [], {}
    acc = resnet_grad_accuracy(dev)
    print(json.dumps({"resnet20_grad_rel_l2_vs_fp64": acc, "card": card}))
    if not acc["cuda_scoped"] < 1e-3 < acc["cuda_tf32_unscoped"]:
        problems.append(f"ResNet-20's gradient against fp64: {acc}")
    env = build_environment(cifar_spec("fedsgd"), device=dev)
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
            run = Experiment(dataclasses.replace(
                spec, run=dataclasses.replace(spec.run, **run_kw))
                             ).build(env=env)
            counter = BlockCounter()
            pm.reset_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run.run(callbacks=[counter])
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t
            launches = dict(pm.LAUNCHES)
            tr = run.trainer
            n = len(res.history)
            losses = [m.train_loss for m in res.history]
            row = {"rounds": n, "wall_s_with_eval": wall_s,
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
    windows = {}
    for label in ("fedsgd", "feddyn"):
        spec = blocked[label][0]
        windows[label] = {path: quick_window(dev, env, spec, kw) for path, kw
                          in (("blocked", {}),
                              ("per_round", dict(rounds_per_dispatch=1)))}
        print(json.dumps({"cifar10_window": label, "card": card,
                          "rounds": QUICK_WINDOW, **windows[label]}))

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
    return problems, launches_by_run, windows


# -- phases 9-10: fleet streaming and the sweep service -------------------------

# random_k over a virtual roster: 8 clients a round at one lambda (kernels
# 2-4 prune), batch 4, unbounded budgets, 8-round blocks
FLEET = dict(k=8, lam=0.5, seed=1, batch=4, rpd=8, n_test=800)
# (a) and (b): LeNet over 1,000 clients (the JAX benchmark's parity cap,
# benchmarks/fleet_scaling.py PARITY_MAX_POP), 24 samples a client on
# average; (c): ResNet-20 over 100,000 clients, 2 a client
FLEET_PARITY = dict(dataset="synthetic-fleet", model="lenet",
                    population=1_000, per_client=24, rounds=64)
FLEET_SCALE = dict(dataset="synthetic-fleet-cifar", model="resnet",
                   population=100_000, per_client=2, rounds=32)
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
    100,000-client synthetic-fleet-cifar roster, 32 rounds, "auto": its
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

    # (c) ResNet-20 over 100,000 clients: "auto" streams
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


# -- phases 11-13: the LM stack, serving granite-3-2b and mamba2-130m ---------

LM_SOURCES = {"flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
              "decode_attention":
                  "src/repro_torch/kernels/csrc/decode_attention.cu",
              "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_chunk.cu"}
# the kernels each LM wrapper launches (names as in the device trace): the
# flash and SSD wrappers take the wgmma kernel for bf16 and the CUDA-core
# kernel for fp32
LM_SYMBOLS = {"flash_attention": ("flash_attention_kernel",
                                  "flash_attention_wgmma_kernel"),
              "decode_attention": ("decode_attention_kernel",),
              "ssd_chunk": ("ssd_chunk_kernel", "ssd_chunk_wgmma_kernel")}
LM_REPLACES = {"flash_attention": "src/repro/kernels/flash_attention.py:80",
               "decode_attention": "src/repro/kernels/decode_attention.py:60",
               "ssd_chunk": "src/repro/kernels/ssd_chunk.py:49"}
# the kernel tolerance of the JAX package's tests (tests/test_kernels.py)
BF16_TOL = 2e-2
# logits_rel_l2: |kernel - naive| / |naive| over the last-token logits of
# one fp32 prefill; fp32 rounding carried through 40 layers stays orders
# below it, a kernel that reads the causal band one key off lands above it
GRANITE = dict(n_requests=16, new_tokens=32, max_batch=8, max_seq=2048,
               buckets=(256, 512, 1024), len_lo=130, len_hi=1000,
               n_sequential=3, logits_rel_l2=1e-3)
MAMBA = dict(n_requests=8, new_tokens=32, max_batch=4, max_seq=2048,
             len_lo=100, len_hi=600, entry_len=512, chunk=128)


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


def measure(name, ok, err, call, plain_call, symbols, nbytes, nflops, card,
            library_call=None, **extra):
    """One kernel's row: per-call time, the plain version's, the library
    call's, the wrapper's kernels on the device trace (per call, and which
    symbols they were), and the bound from the bytes (3.35 TB/s) and the
    live FLOPs at the bf16 tensor-core peak."""
    bw, _, bf16 = peaks(card)
    ms, plain = time_ms(call, reps=50), time_ms(plain_call, reps=20)
    lib = time_ms(library_call, reps=50) if library_call is not None \
        else None
    dev_ms, dev_symbols, dev_events = kernel_device_ms(call, symbols,
                                                       reps=20)
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


def lm_kernel_phase(dev, card):
    """The three LM kernels against their plain versions on random bf16
    inputs at the served models' shapes: flash attention at granite's
    prefill buckets and gemma2's head dim 256 with its softcap (global
    and local layer), decode attention at granite's [8, 2048, 8, 64] and
    gemma2's head dim with ragged positions, the SSD chunk at mamba2's.
    Returns (problems, flash timing row at granite's 1024 bucket)."""
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
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
            "gemma2 global S1024 cap 50": (1024, 16, 8, 256, 0, 50.0, 50.0),
            "gemma2 local S1024 window 256 cap 50":
                (1024, 16, 8, 256, 256, 50.0, 50.0)}.items():
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
        lib = None
        if not cap:
            lib = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)
        nbytes = 2 * (2 * hq + 2 * hkv) * s * d
        flash_rows[label] = measure(
            "flash_attention", ok, _abs_err(out, ref),
            lambda q=q, k=k, v=v, kw=kw: fa.flash_attention(q, k, v, **kw),
            lambda q=q, k=k, v=v, kw=kw: fa.flash_attention_plain(q, k, v,
                                                                  **kw),
            LM_SYMBOLS["flash_attention"], nbytes,
            4 * d * hq * causal_pairs(s, window), card, library_call=lib,
            shape=label)
        syms = flash_rows[label]["device_symbols"]
        if syms and not all("flash_attention_wgmma_kernel" in x
                            for x in syms):
            problems.append(f"flash_attention {label}: bf16 device time "
                            f"from {syms}, not the wgmma kernel")

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


def _sequential(params, cfg, rt, eng, prompt, new, dev):
    """Sequential greedy generation of one request with a batch-one cache,
    prefilling exactly the padded bucket the engine prefills."""
    from repro_torch.models import transformer as T
    cache = T.init_cache(cfg, 1, eng.max_seq, device=dev)
    toks = torch.as_tensor(eng.prefill_tokens(prompt), device=dev).long()
    T.prefill(params, toks[None], cache, cfg, rt)
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


def granite_phase(dev, card):
    """granite-3-2b at full width and depth in bf16, random weights from a
    torch.Generator seeded with 0 on the card, served by the engine with
    the flash kernel: 16 greedy requests of 32 new tokens, prompts of
    130-1000 tokens (numpy seed 0), so every bucket is above 128. Returns
    (problems, engine, the flash launches of the engine run, the final
    occupant of each slot)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.serving import ServingEngine
    c = GRANITE
    cfg = get_config("granite-3-2b")
    rt = Runtime(attn_impl="cuda")
    t = time.perf_counter()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    torch.cuda.synchronize()
    n_params = sum(int(np.prod(p.shape)) for p in _leaves(params))
    init_s = time.perf_counter() - t
    rng = np.random.default_rng(0)
    lens = rng.integers(c["len_lo"], c["len_hi"] + 1, size=c["n_requests"])
    prompts = [rng.integers(0, cfg.vocab_size, size=int(n)).astype(np.int32)
               for n in lens]
    eng = ServingEngine(params, cfg, max_batch=c["max_batch"],
                        max_seq=c["max_seq"], prompt_buckets=c["buckets"],
                        rt=rt, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=c["new_tokens"])
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t_pre, t_dec, steps = drive_engine(eng)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    peak = _peak_gib()
    done = list(eng.finished)
    problems = []
    if len(done) != c["n_requests"]:
        problems.append(f"granite: {len(done)} of {c['n_requests']} finished")
    want = cfg.num_layers * c["n_requests"]
    if launches["flash_attention"] != want:
        problems.append(f"granite: flash_attention launched "
                        f"{launches['flash_attention']} times, expected "
                        f"{want}")
    padded = sum(len(eng.prefill_tokens(pr)) for pr in prompts)
    generated = sum(len(st.generated) for st in done)
    print(json.dumps({
        "serving": "granite-3-2b", "params": n_params,
        "init_s": init_s, "requests_finished": len(done),
        "prompt_tokens": int(lens.sum()), "prefill_tokens_padded": padded,
        "prefill_s": t_pre, "prefill_tokens_per_s": padded / t_pre,
        "generated_tokens": generated, "decode_s": t_dec,
        "decode_tokens_per_s": generated / t_dec, "engine_steps": steps,
        "ms_per_engine_step": 1e3 * t_dec / max(steps, 1),
        "peak_gib": peak, "launches": launches}))

    # engine == sequential generation over the same padded prefill, for
    # the first request of each bucket (and more, up to n_sequential)
    by_uid = {st.request.uid: st.generated for st in done}
    firsts = {}
    for uid, pr in enumerate(prompts):
        firsts.setdefault(len(eng.prefill_tokens(pr)), uid)
    check = sorted(firsts.values())
    check += [u for u in range(len(prompts)) if u not in check]
    check = sorted(check[:max(c["n_sequential"], len(firsts))])
    for uid in check:
        seq = _sequential(params, cfg, rt, eng, prompts[uid],
                          c["new_tokens"], dev)
        if by_uid.get(uid) != seq:
            problems.append(f"granite: request {uid} engine tokens "
                            f"{by_uid.get(uid)} != sequential {seq}")
    print(json.dumps({"granite_engine_vs_sequential": check,
                      "equal": not any("sequential" in p for p in problems)}))

    logit_problems, logit_row = prefill_logits_check(
        params, cfg, eng, prompts[int(np.argmax(lens))], dev)
    problems += logit_problems
    print(json.dumps(logit_row))
    occupants = {}
    for st in done:                      # finish order: the last one stays
        occupants[st.slot] = st.pos
    return problems, eng, launches, occupants


def _to_float(tree):
    return {k: _to_float(v) if isinstance(v, dict)
            else v.float() if v.is_floating_point() else v
            for k, v in tree.items()}


def _rel_l2(a, b) -> float:
    return float((a - b).double().norm() / b.double().norm())


def prefill_logits_check(params, cfg, eng, prompt, dev):
    """The served prefill's last-token logits, kernel path against the
    naive path, for the longest prompt. The gate is in fp32 on the same
    weights: in bf16 the two plain paths (chunked, naive) already drift
    apart by about the bf16 tolerance over 40 layers, which would swamp a
    kernel fault. A planted fault (the kernel fed keys and values one
    position late: a one-token look-ahead) is read the same way and must
    land above the limit. The bf16 prefill itself is checked layer by
    layer: each flash launch against the plain version on the same q, k, v
    (bf16 2e-2). Returns (problems, row)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops as kops
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    c = GRANITE
    toks = torch.as_tensor(eng.prefill_tokens(prompt), device=dev).long()[None]
    sound = kops.flash_attention

    def prefill(p, pcfg, impl, flash=sound):
        kops.flash_attention = flash
        try:
            cache = T.init_cache(pcfg, 1, c["max_seq"], device=dev)
            return T.prefill(p, toks, cache, pcfg, Runtime(attn_impl=impl))[0]
        finally:
            kops.flash_attention = sound

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
    p32, cfg32 = _to_float(params), dataclasses.replace(cfg, dtype="float32")
    f32 = {impl: prefill(p32, cfg32, impl) for impl in ("naive", "cuda")}
    f32["fault"] = prefill(p32, cfg32, "cuda", late_band)
    del p32
    torch.cuda.empty_cache()
    sound_rel = _rel_l2(f32["cuda"], f32["naive"])
    fault_rel = _rel_l2(f32["fault"], f32["naive"])
    row = {"granite_prefill_logits": f"{toks.shape[1]} tokens",
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
                                    == bf["naive"].argmax())}
    problems = []
    if not (sound_rel <= c["logits_rel_l2"] < fault_rel
            and all(bool(torch.isfinite(x).all()) for x in f32.values())):
        problems.append(f"granite: fp32 prefill logits cuda vs naive rel L2 "
                        f"{sound_rel}, planted fault {fault_rel}, limit "
                        f"{c['logits_rel_l2']}")
    if len(layers) != cfg.num_layers or not all(ok for ok, _ in layers):
        problems.append(f"granite: bf16 prefill flash launches vs plain: "
                        f"{sum(ok for ok, _ in layers)} of {len(layers)} "
                        f"within 2e-2, expected {cfg.num_layers}")
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
    """mamba2-130m at full width and depth in bf16 (random weights, seed
    0 on the card): 8 greedy requests on 4 slots, so slots are reused;
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
    cfg = get_config("mamba2-130m")
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


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--kernels", action="store_true",
                        help="set-up and the kernels against their plain "
                             "versions (phases 1 and 2) only; no result line")
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

    walls = {}
    t = time.perf_counter()
    _build.load()
    walls["build"] = time.perf_counter() - t
    print(f"kernels built in {walls['build']:.2f} s "
          f"({_build.library_path().name})")
    # the bf16 flash and SSD kernels must run on the tensor cores: HGMMA in
    # the SASS of every wgmma instantiation
    hgmma = sass_hgmma_counts()
    print(json.dumps({"sass_hgmma": hgmma}))
    print(json.dumps({"ptxas_lm": ptxas_report(LM_PTXAS)}))
    print(json.dumps({"ptxas_round": ptxas_report(ROUND_PTXAS)}))
    wgmma_fns = [k for k in hgmma if "wgmma" in k]
    missing = [kern for kern in ("flash_attention_wgmma_kernel",
                                 "ssd_chunk_wgmma_kernel")
               if not any(k.startswith(kern) for k in wgmma_fns)]
    if missing or not all(hgmma[k] > 0 for k in wgmma_fns):
        print("chip_smoke FAILED: a bf16 wgmma kernel is missing "
              f"({missing}) or has no HGMMA instruction ({hgmma})",
              file=sys.stderr)
        return 1

    t = time.perf_counter()
    ds, clients, sp, ch, sched, params = slice_env(dev)
    pack = ParamPack.build(params)
    kernels = check_kernels(dev, pack, name)
    walls["kernels"] = time.perf_counter() - t
    if args.kernels:
        print(json.dumps({"phase_wall_s": walls}))
        return 0

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
    print(json.dumps({"phase_wall_s": {
        k: walls[k] for k in ("fleet_streaming", "sweep_service")}}))

    # the LM stack. torch.cumsum on CUDA (the SSD scans') has no
    # deterministic implementation, so deterministic mode goes off here;
    # engine == sequential rests on the same ops at the same shapes
    torch.use_deterministic_algorithms(False)
    t = time.perf_counter()
    lm_problems, flash_rows = lm_kernel_phase(dev, name)
    problems += lm_problems
    walls["lm_kernels"] = time.perf_counter() - t
    t = time.perf_counter()
    g_problems, eng, flash_launches, occupants = granite_phase(dev, name)
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
             "granite-3-2b serving engine", flash_launches),
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
                     "check": "bf16 2e-2" if res["ok"] else "FAILED",
                     **({"entry_call": res["entry_call"]}
                        if "entry_call" in res else {})})
    print(json.dumps({"kernels": rows}))
    if problems:
        print("chip_smoke FAILED: " + "; ".join(problems), file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
