#!/usr/bin/env python3
"""Where one masked-FedSGD train step's peak allocation goes on the card.

    python3 scripts/train_step_memory_probe.py llama-3.2-vision-90b 5

Needs one CUDA card (the port's kernels build at first use). Builds the
named LM at full width in bf16, cut to the given depth, with random
weights (seed 0; a vlm's gates opened to 1), random uint8 masks keeping
70 % of every leaf and a synthetic batch of 4 x 4096 tokens (numpy seed
0, with the family's memory input), and runs `launch/steps.py`'s step
under specialize's train_4k runtime and its train_microbatches twice:
once to warm up, then under torch's memory history recorder. The
recorded trace is replayed to the moment of the peak allocation, and the
blocks live there are printed grouped by where they were allocated
(autograd's own buffers have no Python frames), largest first, after one
JSON line with the peak, the memory held before the step (weights, masks,
batch) and the peak's place in the trace.
"""

import collections
import dataclasses
import gc
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as cs  # noqa: E402  (sets the environment, imports torch)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES  # noqa: E402
from repro_torch.launch.steps import (make_train_step, specialize,  # noqa: E402
                                      train_microbatches)
from repro_torch.launch.train import synthetic_batch  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

dev = torch.device("cuda")
torch.use_deterministic_algorithms(True, warn_only=True)
cs._build.load()
arch, layers = sys.argv[1], int(sys.argv[2])
cfg, rt = specialize(dataclasses.replace(get_config(arch), num_layers=layers),
                     INPUT_SHAPES["train_4k"])
params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
if cfg.family == "vlm":
    params["blocks"]["cross"]["gate"].fill_(1.0)
gen = torch.Generator(device=dev).manual_seed(1)
masks = tree_map(lambda w: (torch.rand(w.shape, generator=gen, device=dev)
                            > 0.3).to(torch.uint8), params)
batch = synthetic_batch(np.random.default_rng(0), cfg, 4, 4096, dev)
step = make_train_step(cfg, rt, microbatches=train_microbatches(cfg))
step(params, masks, batch)                 # warm: workspaces, the build
gc.collect()
torch.cuda.synchronize()
base = torch.cuda.memory_allocated()
torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                         stacks="python")
torch.cuda.reset_peak_memory_stats()
loss, new = step(params, masks, batch)
torch.cuda.synchronize()
peak = torch.cuda.max_memory_allocated()
snap = torch.cuda.memory._snapshot()
torch.cuda.memory._record_memory_history(enabled=None)
del new
GiB = 2**30
live, cur, best, best_i = {}, 0, -1, 0
events = snap["device_traces"][0]
for i, e in enumerate(events):
    if e["action"] == "alloc":
        live[e["addr"]] = (e["size"], e.get("frames", []), i)
        cur += e["size"]
    elif e["action"] == "free_completed" and e["addr"] in live:
        cur -= live.pop(e["addr"])[0]
    if cur > best:
        best, best_i = cur, i
live, cur = {}, 0
for e in events[:best_i + 1]:
    if e["action"] == "alloc":
        live[e["addr"]] = (e["size"], e.get("frames", []), e)
    elif e["action"] == "free_completed" and e["addr"] in live:
        live.pop(e["addr"])


def where(frames):
    keep = [f"{os.path.basename(f['filename'])}:{f['line']}:{f['name']}"
            for f in frames if "repro_torch" in f["filename"]
            or "chip_smoke" in f["filename"] or "checkpoint" in f["filename"]]
    return " < ".join(keep[:4]) or "(no python frames: autograd engine)"


groups = collections.Counter()
sizes = collections.defaultdict(list)
for size, frames, _ in live.values():
    groups[where(frames)] += size
    sizes[where(frames)].append(size)
print(json.dumps({"arch": arch, "layers": layers, "base_gib": base / GiB,
                  "peak_gib": peak / GiB,
                  "trace_peak_over_base_gib": best / GiB,
                  "events": len(events), "peak_event": best_i,
                  "peak_event_frames": where(events[best_i].get(
                      "frames", []))}))
for w, total in groups.most_common(40):
    ss = sorted(sizes[w], reverse=True)
    print(f"{total / GiB:8.3f} GiB  n={len(ss):4d}  top="
          f"{[round(x / GiB, 3) for x in ss[:5]]}  {w}")
