#!/usr/bin/env python3
"""How often torch.profiler's device trace of a few short kernel calls comes
back empty or short, against how much host time the window holds before
the first call and after the synchronize that ends the last.

    PYTHONPATH=src python3 scripts/trace_window_probe.py [--trials 50] \
        [--gaps-s 0,300,0] [--windows 0:0,50:0,0:5,0:50,0:200] [--blocked]

Needs one CUDA card (the port's kernels build at first use). Each trial
profiles 20 calls of the weighted-aggregate kernel (kernel 3, R = 1024,
C = 8: ~2 µs of device time a call) as
`tests/test_torch_cuda.py::test_tail_kernel_is_one_kernel_a_call` does, under
each window of --windows ("head:tail" in ms of host sleep after the window
opens and after the synchronize; 0:0 closes the window microseconds after
the device's last kernel), interleaved trial by trial (with --blocked,
each window's trials in a row).

The trials run once a round; before each round the card multiplies bf16
matrices for that round's --gaps-s seconds with no profiler running, so a
later round reads the trace of an older process (as a long run's later
phases and test files do), and a round right after another reads it after
many profiled windows. Prints one JSON line a round: the process's age,
the windows opened before it, and for each window the trials whose trace
held no kernel, the trials that held some but fewer than 20, and the
events a trial (min / median / max).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

CALLS = 20
SYMBOL = "fedsgd_aggregate_weighted_kernel"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trials", type=int, default=50)
    ap.add_argument("--gaps-s", default="0,300,0")
    ap.add_argument("--windows", default="0:0,50:0,0:5,0:50,0:200")
    ap.add_argument("--blocked", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_window_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import pruning_mask as pm
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.normal(size=(1024, 128)).astype(np.float32)).to(
        dev)
    grads = torch.from_numpy(rng.normal(size=(8, 1024, 128)).astype(
        np.float32)).to(dev)
    cw = torch.ones(8, device=dev)
    inv = torch.tensor(1.0 / 8, device=dev)
    eta = torch.tensor(0.1, device=dev)

    def call():
        pm.fedsgd_aggregate_weighted(w, grads, cw, inv, eta)

    def window(head_s: float, tail_s: float) -> int:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(head_s)
            for _ in range(CALLS):
                call()
            torch.cuda.synchronize()
            time.sleep(tail_s)
        return sum(ev.count for ev in prof.key_averages()
                   if SYMBOL in ev.key and
                   str(getattr(ev, "device_type", "")).endswith("CUDA"))

    def busy(seconds: float):
        a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
        t = time.perf_counter()
        while time.perf_counter() - t < seconds:
            for _ in range(50):
                a = (a @ a).tanh_()
            torch.cuda.synchronize()

    windows = {name: tuple(float(x) / 1e3 for x in name.split(":"))
               for name in args.windows.split(",")}
    t_start, opened = time.perf_counter(), 0
    for rnd, gap in enumerate(float(g) for g in args.gaps_s.split(",")):
        busy(gap)
        age, before = time.perf_counter() - t_start, opened
        res = {k: [] for k in windows}
        order = [k for k in windows for _ in range(args.trials)] \
            if args.blocked else list(windows) * args.trials
        for k in order:
            res[k].append(window(*windows[k]))
            opened += 1
        summary = {}
        for k, counts in res.items():
            n = np.array(counts)
            summary[f"head:tail {k} ms"] = {
                "empty": int((n == 0).sum()),
                "short": int(((n > 0) & (n < CALLS)).sum()),
                "events_min_median_max": [int(n.min()), float(np.median(n)),
                                          int(n.max())]}
        print(json.dumps({"trace_window_probe": summary, "round": rnd,
                          "process_age_s": age, "windows_before": before,
                          "trials": args.trials, "calls": CALLS,
                          "card": smi, "torch": torch.__version__}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
