"""ResNet-20's gradient against fp64, and spec C's ms a round, on cuDNN's
deterministic engines and on torch's native convolution, in one process;
and the engines cuDNN runs for each convolution, from its API log.

    python3 scripts/conv_scope_probe.py [--rounds 16] [--batches 6] [--out chiprun_out/conv_scope.json]

`repro_torch.device.exact_fp32` runs ResNet's convolutions on cuDNN's
deterministic fp32 engines ("cudnn"); the candidate is torch's native CUDA
convolution, im2col and cuBLAS GEMMs ("native": cuDNN off inside the same
scope). For each of `--batches` CIFAR-shaped batches of 32 (numpy seeds
0, 1, ...) the script takes ResNet-20's gradient at its seed-0 weights
under each and on the CPU in fp32, and prints the relative L2 distance to
an fp64 gradient on the CPU beside the count of ReLUs whose input took the
other sign than in fp64 (a kink flip). Then it times spec C
(chip_smoke.py's CIFAR-10 cell: ResNet-20, 10 clients, `proposed` at 4 J /
40 s, FedSGD) under both, each on the three paths (32-round blocks on CUDA
graphs, one round a dispatch, the reference backend), in the order cudnn,
native, native, cudnn: ms a round on the host clock with the card
synchronised, evaluation off; the blocked path's first run captures its
graph, the second, timed, replays it. Beside them a child process runs
one ResNet-20 forward and backward in the engine's scope with cuDNN's API
log on, and the script names the engine cuDNN ran for each convolution
(operation, shapes, engine id, knobs and its numerical notes: FFT,
TENSOR_CORE, ...). The gradients are chip_smoke.py's
(`grad_and_relu_signs`). Needs a CUDA card.
"""
import argparse
import contextlib
import json
import os
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro_torch.core.federated as federated  # noqa: E402
import repro_torch.core.round_engine as round_engine  # noqa: E402
import repro_torch.models.cnn as cnn  # noqa: E402
from repro_torch.api import (DataSpec, Experiment, ExperimentSpec,  # noqa: E402
                             ModelSpec, RunSpec, SchemeSpec, WirelessSpec,
                             build_environment)
from chip_smoke import grad_and_relu_signs  # noqa: E402
from repro_torch.device import exact_fp32  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402


@contextlib.contextmanager
def native_scope():
    """exact_fp32 with cuDNN off: torch's native convolution."""
    with exact_fp32():
        cudnn = torch.backends.cudnn
        prev = cudnn.enabled
        cudnn.enabled = False
        try:
            yield
        finally:
            cudnn.enabled = prev


SCOPES = {"cudnn": exact_fp32, "native": native_scope}


CUDNN_LOG = ROOT / "build" / "cudnn_api.log"
# one ResNet-20 forward and backward of a CIFAR-shaped batch of 32 in the
# engine's scope (exact_fp32: cuDNN's deterministic fp32 engines)
CUDNN_CHILD = r"""
import sys, numpy as np, torch
sys.path.insert(0, "src")
from repro_torch.device import exact_fp32
from repro_torch.models import cnn, make_loss_fn
from repro_torch.tree import leaves, unflatten
torch.use_deterministic_algorithms(True)
params = cnn.resnet_init(torch.Generator().manual_seed(0), device="cuda")
rng = np.random.default_rng(0)
x = torch.as_tensor(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
y = torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32))
ps = [t.requires_grad_(True) for t in leaves(params)]
with exact_fp32():
    loss = make_loss_fn(cnn.resnet_apply)(unflatten(params, ps), x.cuda(),
                                          y.cuda())
    torch.autograd.grad(loss, ps)
torch.cuda.synchronize()
print(torch.backends.cudnn.version())
"""


def start_cudnn_log():
    """Start a child that runs CUDNN_CHILD with cuDNN's API log on (info
    level, into CUDNN_LOG); `cudnn_engines` reads it. It runs beside the
    gradients and the timed runs: with the log on it takes ~20 s."""
    CUDNN_LOG.parent.mkdir(parents=True, exist_ok=True)
    CUDNN_LOG.unlink(missing_ok=True)
    env = {**os.environ, "CUDNN_LOGLEVEL_DBG": "3",
           "CUDNN_LOGDEST_DBG": str(CUDNN_LOG)}
    return subprocess.Popen([sys.executable, "-c", CUDNN_CHILD], env=env,
                            cwd=str(ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def cudnn_engines(job, timeout_s: float = 300.0) -> dict:
    """The engines cuDNN ran for each of ResNet-20's convolutions in the
    engine's scope, from its API log: each cudnnBackendExecute's
    operation, input and filter shapes, engine id and knobs, with the
    numerical notes cuDNN's heuristics reported for that engine (FFT,
    TENSOR_CORE, ...); grouped, with the count of executions."""
    try:
        out, err = job.communicate(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        job.kill()
        job.communicate()
        return {"error": f"the logged child ran past {timeout_s:g} s"}
    if job.returncode != 0 or not CUDNN_LOG.exists():
        return {"error": f"the logged child failed ({job.returncode}): "
                         f"{err.strip()[-400:]}"}
    text = CUDNN_LOG.read_text(errors="replace")
    CUDNN_LOG.unlink()
    notes: dict = {}
    ops = {"CONVOLUTION_FORWARD": "forward",
           "CONVOLUTION_BACKWARD_DATA": "backward data",
           "CONVOLUTION_BACKWARD_FILTER": "backward filter",
           "CONV_FORWARD": "forward", "CONV_BWD_DATA": "backward data",
           "CONV_BWD_FILTER": "backward filter"}
    runs: dict = {}
    for rec in re.split(r"\n(?=[IWE]! CuDNN)", text):
        for m in re.finditer(
                r"OPERATION_(\w+)_DESCRIPTOR:.*?engine_id: type=int; "
                r"val=(-?\d+);\n(.*?)behaviorNotes", rec, re.S):
            found = re.findall(r"CUDNN_NUMERICAL_NOTE_(\w+): type=bool; "
                               r"val=true", m.group(3))
            if m.group(1) in ops:
                notes.setdefault((ops[m.group(1)], m.group(2)),
                                 set()).update(found)
        if "cudnnBackendExecuteInternal() called" not in rec:
            continue
        op = re.search(r"operation: type=internalType; val=(\w+)", rec)
        eng = re.search(r"engine_id: type=int; val=(-?\d+)", rec)
        if op is None or eng is None or op.group(1) not in ops:
            continue
        dims = re.findall(r"dimA: type=int; val=\[([\d,]+)\]", rec)
        knobs = re.findall(r"CUDNN_KNOB_TYPE_(\w+): type=int; val=(-?\d+)",
                           rec)
        key = (ops[op.group(1)], eng.group(1),
               ",".join(f"{k}={v}" for k, v in knobs), dims[0] if dims
               else "", dims[1] if len(dims) > 1 else "")
        runs[key] = runs.get(key, 0) + 1
    rows = [{"op": op, "engine": int(eng), "knobs": knobs, "x": x, "w": w,
             "executions": n,
             "numerical_notes": sorted(notes.get((op, eng), ()))}
            for (op, eng, knobs, x, w), n in sorted(runs.items())]
    fft = sorted({f"{r['op']} engine {r['engine']}" for r in rows
                  if "FFT" in r["numerical_notes"]})
    return {"cudnn": out.strip(), "convolutions": rows,
            "fft_engines": fft, "fft_executions": sum(
                r["executions"] for r in rows
                if "FFT" in r["numerical_notes"])}


def use_scope(name: str) -> None:
    for mod in (federated, round_engine, cnn):
        mod.exact_fp32 = SCOPES[name]


def spec_c(rounds: int, **run) -> ExperimentSpec:
    return ExperimentSpec(
        data=DataSpec(dataset="synthetic-cifar10", n_clients=10, sigma=1.0,
                      n_train=4000, n_test=800, seed=0),
        model=ModelSpec(name="resnet"),
        wireless=WirelessSpec(e0=4.0, t0=40.0, seed=0),
        scheme=SchemeSpec(name="proposed", rounds=rounds, eta=0.1, batch=32),
        run=RunSpec(seed=0, evaluate=False, stop_on_budget=False, **run))


def time_paths(env, rounds: int) -> dict:
    out, params = {}, {}
    for path, kw in (("blocked", {}),
                     ("per_round", dict(rounds_per_dispatch=1)),
                     ("reference", dict(backend="reference"))):
        run = Experiment(spec_c(rounds, **kw)).build(env=env)
        walls = []
        for _ in range(2 if path == "blocked" else 1):
            run.trainer.reset(env.init_fn(torch.Generator().manual_seed(0),
                                          device=env.device), 0)
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = run.run()
            torch.cuda.synchronize()
            walls.append(1e3 * (time.perf_counter() - t) / len(res.history))
        out[path] = walls[-1]
        params[path] = [t.clone() for t in leaves(run.trainer.params)]
    out["param_bits_differing_from_blocked"] = {
        p: sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for a, b in zip(params["blocked"], params[p]))
        for p in ("per_round", "reference")}
    return out


def grad_rows(batches: int) -> list:
    """Per batch: relative L2 against fp64 and ReLU kink flips, for each
    scope on the card and for the CPU in fp32."""
    params = cnn.resnet_init(torch.Generator().manual_seed(0), device="cpu")

    def grad(x, y, d, dtype, ctx):
        return grad_and_relu_signs(params, cnn.resnet_apply, x, y, d, dtype,
                                   ctx)

    rows = []
    cpu, dev = torch.device("cpu"), torch.device("cuda")
    for seed in range(batches):
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(rng.normal(size=(32, 32, 32, 3)).astype(
            np.float32))
        y = torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32))
        g64, s64 = grad(x, y, cpu, torch.float64, contextlib.nullcontext)
        row = {"batch_seed": seed}
        for name, d, ctx in (("cudnn", dev, SCOPES["cudnn"]),
                             ("native", dev, SCOPES["native"]),
                             ("cpu_fp32", cpu, contextlib.nullcontext)):
            g, signs = grad(x, y, d, torch.float32, ctx)
            row[name] = {"rel_l2_vs_fp64": float((g - g64).norm()
                                                 / g64.norm()),
                         "relu_flips": sum(int((a != b).sum())
                                           for a, b in zip(signs, s64))}
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=16)
    ap.add_argument("--batches", type=int, default=6)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("conv_scope_probe: needs a CUDA card", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else "nvidia-smi failed"
    print(card)
    engines_job = start_cudnn_log()
    out = {"card": card, "gradients": grad_rows(args.batches), "spec_c": []}
    env = build_environment(spec_c(args.rounds), device="cuda")
    for name in ("cudnn", "native", "native", "cudnn"):
        use_scope(name)
        row = {"scope": name, "card": card, "rounds": args.rounds,
               "ms_per_round": time_paths(env, args.rounds)}
        print(json.dumps(row), flush=True)
        out["spec_c"].append(row)
    out["cudnn_engines"] = cudnn_engines(engines_job)
    print(json.dumps({"cudnn_engines": out["cudnn_engines"], "card": card}),
          flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
