"""The paper's Sec. V comparison through the PyTorch port: the proposed
scheme against the five baselines, over seeds, held to the JAX package's
outcome distributions.

    python examples/torch_feel_paper_reproduction.py [--seeds 8] [--device cpu]
        [--out build/torch_paper_repro.json]

The port's counterpart of examples/feel_paper_reproduction.py, at its
settings (benchmarks/common.py's ExpConfig defaults: synthetic-mnist, 10
clients, sigma 1, LeNet packed into [1024, 128], 60 rounds, E0 4 J, T0 40
s, evaluation every 25 rounds). The six SCHEMES x run.seed 0..seeds-1 run
as one SweepSpec through `repro_torch.api.run_sweep` (one environment,
one pooled trainer re-seeded between cells), each run from the port's own
initial weights. On CUDA (the default) a run is 32-round blocks replayed
from CUDA graphs; `--device cpu` runs it on the CPU, one round a dispatch.

For each scheme it prints the mean +- std over seeds of the final test
accuracy and of the mean train loss over the last 10 rounds, the rounds
completed, the energy and delay spent, clients a round and mean lambda
over the rounds run, and beside them the JAX package's numbers from
tests/torch_fixtures/sec5_jax.json (scripts/make_sec5_jax_reference.py
writes it; the card has no JAX). Then two checks: every scheme's schedule
as run (selected ids, per-client lambda, delay, energy, rounds completed)
equals JAX's bit for bit, and each mean lies within three standard errors
of JAX's, |m_port - m_jax| <= 3 sqrt(s_port^2 / n + s_jax^2 / n). One
seed's outcome is a draw: a keep-mask that flips at a near-tie sends the
trajectory elsewhere (tests/test_torch_paper_sec5.py pins that), so the
runs are compared as distributions (not with fewer than two seeds, where
no standard deviation is estimated). Exit status 1 if a check fails.

The matrix, the records and the comparison are scripts/sec5_records.py's,
which the reference's generator, chip_smoke.py's Sec. V phase and the
tests share.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.normpath(os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import repro_torch.api as api  # noqa: E402
from sec5_records import (SIGMAS, collect, compare, load_reference,  # noqa: E402
                          sec5_sweep, table)


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi failed: {err}"
    return (out.stdout.strip().splitlines()[0] if out.returncode == 0
            and out.stdout.strip() else f"nvidia-smi failed: {out.stderr}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, default=8,
                    help="run.seed 0..SEEDS-1 (default 8)")
    ap.add_argument("--device", default=None,
                    help="torch device (default CUDA; 'cpu' without a card)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "torch_paper_repro.json"))
    args = ap.parse_args()
    import torch
    device = torch.device(args.device or "cuda")
    card = card_line() if device.type == "cuda" else "CPU"
    print(f"device {device} ({card}); torch {torch.__version__}")
    reference = load_reference()
    sweep = sec5_sweep(api, args.seeds)
    t0 = time.perf_counter()
    res = api.run_sweep(sweep, device=device,
                        log=lambda msg: print(msg, flush=True))
    wall = time.perf_counter() - t0
    if res.errors:
        print(json.dumps(res.errors, indent=1), file=sys.stderr)
        return 1
    port = collect(res.cells, res.results)
    cmp = compare(port, reference)
    print(f"\n{args.seeds} seeds a scheme on {card}, JAX's "
          f"{reference['jax_version']} on the CPU beside it "
          f"({len(next(iter(reference['schemes'].values()))['runs'])} seeds)"
          f"; the sweep took {wall:.1f} s")
    for line in table(cmp["port"], cmp["jax"], cmp["checks"]):
        print(line)
    v, jv = cmp["verdict"], cmp["jax_verdict"]
    print(f"\nproposed {v['proposed']:.3f} vs best baseline "
          f"{v['best_baseline']} {v['best_baseline_accuracy']:.3f} "
          f"({v['result']}); JAX: {jv['proposed']:.3f} vs "
          f"{jv['best_baseline']} {jv['best_baseline_accuracy']:.3f} "
          f"({jv['result']})")
    out_of = [f"{name} {stat}" for name, c in cmp["checks"].items()
              for stat, r in c.items() if r["ok"] is False]
    unchecked = any(r["ok"] is None for c in cmp["checks"].values()
                    for r in c.values())
    print("schedules: " + ("bit for bit JAX's" if not cmp["schedule_problems"]
                           else "; ".join(cmp["schedule_problems"])))
    if unchecked:
        print("distributions: not checked (fewer than two seeds)")
    else:
        print(f"distributions: {'all within' if not out_of else 'OUTSIDE'} "
              f"{SIGMAS:g} standard errors"
              + (f": {out_of}" if out_of else ""))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": card, "device": str(device),
                   "torch": torch.__version__, "seeds": args.seeds,
                   "sweep_wall_s": wall, "sweep": sweep.to_dict(),
                   **{k: cmp[k] for k in ("port", "jax", "checks",
                                          "schedule_problems", "verdict",
                                          "jax_verdict")},
                   "runs": port}, f, indent=1)
    print("saved", args.out)
    return 1 if cmp["schedule_problems"] or out_of else 0


if __name__ == "__main__":
    sys.exit(main())
