"""Multi-pod dry run: every (arch x input shape) on the production meshes,
with per-device memory, FLOPs and collectives (the port of
``repro/launch/dryrun.py``).

The JAX package lowers and compiles each step for 256 or 512 forced host
devices and reads XLA's memory, cost and HLO. Here one process plays rank 0
of the mesh's world: the default process group is PyTorch's ``fake``
backend (every collective completes at once and moves nothing), the
inputs are meta-device DTensors placed by the partition rules
(sharding/rules.py), and the step runs, shapes only, under

  * ``FlopCounterMode``: FLOPs a device. A DTensor op is counted on its
    global shapes and divided by the number of ranks that split its work
    (the mesh dims where its output is sharded or a partial sum); the
    local ops inside ``local_map`` (the attention kernels' meta model,
    models/flash_vjp.py; the MoE dispatch) are counted as they are;
  * ``CommDebugMode``: collectives by kind, and their bytes (each result's
    local bytes times the JAX package's ring factor: 2 for an all-reduce,
    1 otherwise).

Memory a device is the bytes of rank 0's shards of params, masks, batch
and cache, from the rules' local shapes. XLA's compile-time
``temp_size_in_bytes`` (activations, workspace) has no meta counterpart and
is recorded as None; the card measures peak memory instead
(``chip_smoke.py --lm-sharded``). The step runs twice, once under each
counter: the FLOP counter's dispatch mode changes which redistributions
DTensor picks, so collectives are counted in a pass without it.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b \\
        --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

Records go to --out (default ``experiments/dryrun_torch/``), one JSON file
per (arch, shape, mesh), with the JAX record's keys where they mean the
same thing. ``REPRO_FORCE_MESH`` shrinks the mesh (the tests run 4,2).
Runs on the CPU (the mesh is CUDA-typed, its tensors meta ones); touches
no card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.configs.registry import (INPUT_SHAPES, get_config,
                                          list_configs, shape_applicable)
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.steps import (input_specs, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      specialize)
from repro_torch.sharding import rules
from repro_torch.tree import flatten_with_path

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

# bytes on the wire per byte of result, per collective kind (ring model)
_KIND_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}
_KINDS = {"all_gather_into_tensor": "all-gather", "all_gather": "all-gather",
          "all_reduce": "all-reduce", "reduce_scatter_tensor":
          "reduce-scatter", "all_to_all_single": "all-to-all",
          "all_to_all": "all-to-all", "shard_dim_alltoall": "all-to-all",
          "broadcast": "collective-permute"}


# -- the fake world -------------------------------------------------------------

def fake_world(n: int) -> None:
    """Make the default process group a ``fake`` one of world size `n`
    with this process as rank 0 (re-made when another size is up)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a real process group is up; the dry run "
                               "needs its own fake one")
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    # DTensor caches its redistribution plans and sharding decisions (in
    # Python and in its C++ dispatch) by mesh, and meshes compare by shape
    # and names: an output spec cached in an earlier world would carry a
    # mesh of destroyed groups into this one's collectives
    from torch.distributed.tensor import DTensor, _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    for clear in (getattr(_redistribute, "clear_redistribute_planner_cache",
                          None),
                  getattr(_redistribute._gen_transform_infos, "cache_clear",
                          None),
                  getattr(prop.propagate_op_sharding, "cache_clear", None),
                  getattr(torch._C, "_clear_DTensor_sharding_propagator_cache",
                          None)):
        if clear is not None:
            clear()
    dist.init_process_group("fake", rank=0, world_size=n, store=FakeStore())


def mesh_tag(sizes) -> str:
    return "x".join(str(s) for s in sizes)


# -- counting -------------------------------------------------------------------

def _split(out) -> int:
    """How many ranks split the work of an op whose output is `out`: the
    product of the mesh dims where a DTensor output is sharded or a
    partial sum (1 for a plain tensor, an op on local shards)."""
    from torch.distributed.tensor import DTensor, Replicate
    outs = out if isinstance(out, (tuple, list)) else (out,)
    for o in outs:
        if isinstance(o, DTensor):
            return math.prod(n for n, p in zip(o.device_mesh.shape,
                                               o.placements)
                             if not isinstance(p, Replicate))
    return 1


def flop_counter():
    """A FlopCounterMode that counts each DTensor op a device's share."""
    from torch.utils.flop_counter import FlopCounterMode

    class LocalFlops(FlopCounterMode):
        def _count_flops(self, func_packet, out, args, kwargs):
            if func_packet in self.flop_registry:
                n = self.flop_registry[func_packet](*args, **kwargs,
                                                    out_val=out)
                n //= _split(out)
                for par in set(self.mod_tracker.parents):
                    self.flop_counts[par][func_packet] += n
            return out

    return LocalFlops(display=False)


def comm_counter():
    """CommDebugMode that also adds up each collective's result bytes."""
    from torch.distributed.tensor.debug import CommDebugMode

    class CommBytes(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.bytes_by_kind: dict[str, float] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            kind = _kind(func)
            if kind is not None:
                nbytes = sum(t.numel() * t.element_size() for t in
                             (out if isinstance(out, (list, tuple))
                              else (out,)) if isinstance(t, torch.Tensor))
                self.bytes_by_kind[kind] = self.bytes_by_kind.get(
                    kind, 0.0) + nbytes * _KIND_FACTOR.get(kind, 1.0)
            return out

    return CommBytes()


def _kind(func) -> str | None:
    """JAX's HLO name of a collective op, or None for any other op (the
    waits and autograd wrappers of the functional collectives included)."""
    name = str(getattr(func, "_overloadpacket", func))
    ns, op = name.split(".")[0], name.split(".")[-1].rstrip("_")
    if "c10d" in ns or ns == "_dtensor":
        return _KINDS.get(op)
    return None


def collective_stats(comm) -> dict:
    """Collectives by kind (JAX's names) from a `comm_counter` that ran."""
    counts: dict[str, int] = {}
    for op, n in comm.get_comm_counts().items():
        kind = _kind(op) or str(op)     # a collective JAX has no name for
        counts[kind] = counts.get(kind, 0) + int(n)
    return {"counts": counts, "bytes_by_kind": dict(comm.bytes_by_kind),
            "total_bytes": sum(comm.bytes_by_kind.values())}


def _tree_bytes(tree, specs, mesh) -> int:
    """Bytes of one device's shards of `tree` under `specs`."""
    sp = [s for _, s in rules.spec_leaves(specs)]
    return sum(math.prod(rules.local_shape(t.shape, s, mesh))
               * t.element_size()
               for (_, t), s in zip(flatten_with_path(tree), sp))


# -- one (arch, shape, mesh) ----------------------------------------------------

@dataclasses.dataclass
class Lowered:
    """A step bound to its sharded inputs (what JAX's ``lower`` holds):
    `run()` calls it once under the mesh."""

    step: Callable
    args: tuple
    mesh: Any
    input_bytes: dict

    def run(self):
        with rules.set_mesh(self.mesh):
            return self.step(*self.args)


def input_bytes(cfg, shape, rt, mesh_shape) -> dict:
    """Per-device bytes of the step's inputs (params, masks, batch, cache)
    from the rules' local shapes: arithmetic only, nothing is run."""
    mode = "train" if shape.kind == "train" else "serve"
    pol = rules.make_policy(cfg, mesh_shape, mode)
    specs = input_specs(cfg, shape, rt)
    out = {"params": _tree_bytes(specs["params"],
                                 rules.param_specs(cfg, pol,
                                                   specs["params"]),
                                 mesh_shape)}
    pspec = rules.param_specs(cfg, pol, specs["params"])
    if "masks" in specs:
        out["masks"] = _tree_bytes(specs["masks"], pspec, mesh_shape)
    batch = specs.get("batch") or {"token": specs["token"]}
    out["batch"] = _tree_bytes(batch, _batch_specs(batch, pol), mesh_shape)
    if "cache" in specs:
        out["cache"] = _tree_bytes(specs["cache"], rules.cache_specs(
            cfg, pol, specs["cache"], shape.global_batch), mesh_shape)
    return out


def _batch_specs(batch: dict, pol) -> dict:
    return {k: rules.batch_spec(v.shape[0], pol, rank=v.ndim)
            for k, v in batch.items()}


def lower_step(arch: str, shape_name: str, *, multi_pod: bool = False):
    """Build the mesh (a fake world of its size) and the sharded meta
    inputs of the step. Returns (Lowered, meta), or (None, {"skipped":
    why}) for a pair the JAX package skips."""
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, {"skipped": why}
    cfg, rt = specialize(cfg, shape)
    sizes, _ = mesh_lib.production_mesh_shape(multi_pod=multi_pod)
    fake_world(math.prod(sizes))
    # a CUDA-typed mesh, as on the card: DTensor moves a shard from one dim
    # to another by an all-to-all there and by all-gather and chunk on a
    # CPU mesh (gloo has no all-to-all); the fake group takes either
    mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                         device_type="cuda")
    mode = "train" if shape.kind == "train" else "serve"
    pol = rules.make_policy(cfg, mesh, mode)
    specs = input_specs(cfg, shape, rt)
    pspec = rules.param_specs(cfg, pol, specs["params"])
    params = rules.distribute(specs["params"], pspec, mesh)
    if shape.kind == "train":
        batch = rules.distribute(specs["batch"],
                                 _batch_specs(specs["batch"], pol), mesh)
        args = (params, rules.distribute(specs["masks"], pspec, mesh), batch)
        step = make_train_step(cfg, rt)
    else:
        cache = rules.distribute(specs["cache"], rules.cache_specs(
            cfg, pol, specs["cache"], shape.global_batch), mesh)
        if shape.kind == "prefill":
            batch = rules.distribute(specs["batch"],
                                     _batch_specs(specs["batch"], pol), mesh)
            args = (params, batch, cache)
            step = make_prefill_step(cfg, rt)
        else:
            token = rules.distribute(
                {"token": specs["token"]},
                _batch_specs({"token": specs["token"]}, pol), mesh)["token"]
            args = (params, cache, token, specs["pos"])
            step = make_serve_step(cfg, rt)
    meta = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(sizes),
            "mode": shape.kind, "fsdp": pol.fsdp}
    return Lowered(step, args, mesh, input_bytes(
        cfg, shape, rt, rules.MeshShape.of(mesh))), meta


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            out_dir: str | None = OUT_DIR) -> dict:
    """Dry-run one pair and return its record (saved under `out_dir`
    unless it is None)."""
    t0 = time.time()
    lowered, meta = lower_step(arch, shape_name, multi_pod=multi_pod)
    if lowered is None:
        rec = dict(meta, arch=arch, shape=shape_name, status="skipped")
        _save(rec, arch, shape_name, multi_pod, out_dir)
        return rec
    t_lower = time.time() - t0
    t0 = time.time()
    # two passes: FlopCounterMode's dispatch changes which redistributions
    # DTensor picks (two more reduce-scatters on granite's two layers), so
    # the collectives are counted without it, as the card's step runs
    comm = comm_counter()
    with comm:
        lowered.run()
    flops = flop_counter()
    with flops:
        lowered.run()
    b = lowered.input_bytes
    rec = dict(
        meta, status="ok", lower_s=round(t_lower, 2),
        run_s=round(time.time() - t0, 2),
        memory={"argument_size_in_bytes": sum(b.values()),
                **{f"{k}_bytes": v for k, v in b.items()},
                "temp_size_in_bytes": None,
                "temp_note": "not measured: XLA's compile-time temp size "
                             "has no meta-device counterpart"},
        cost={"flops": float(flops.get_total_flops())},
        collectives=collective_stats(comm))
    _save(rec, arch, shape_name, multi_pod, out_dir)
    return rec


def _save(rec: dict, arch: str, shape_name: str, multi_pod: bool,
          out_dir: str | None) -> None:
    if out_dir is None:
        return
    os.makedirs(out_dir, exist_ok=True)
    sizes, _ = mesh_lib.production_mesh_shape(multi_pod=multi_pod)
    path = os.path.join(out_dir,
                        f"{arch}__{shape_name}__{mesh_tag(sizes)}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(a, s) for a in list_configs() for s in INPUT_SHAPES]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        pairs = [(args.arch, args.shape)]

    for arch, shape_name in pairs:
        try:
            rec = run_one(arch, shape_name, multi_pod=args.multi_pod,
                          out_dir=args.out)
        except Exception as e:  # record and continue the sweep
            rec = {"arch": arch, "shape": shape_name, "status": "error",
                   "error": f"{type(e).__name__}: {e}"}
            _save(rec, arch, shape_name, args.multi_pod, args.out)
            print(f"[FAIL] {arch} x {shape_name}: {rec['error'][:160]}")
            continue
        if rec["status"] == "skipped":
            print(f"[skip] {arch} x {shape_name}: {rec.get('skipped')}")
            continue
        print(f"[ok]   {arch} x {shape_name} ({rec['mesh']}): "
              f"run {rec['run_s']}s, "
              f"inputs/dev "
              f"{rec['memory']['argument_size_in_bytes'] / 1e9:.2f} GB, "
              f"flops/dev {rec['cost']['flops']:.3e}, "
              f"coll {rec['collectives']['total_bytes'] / 1e9:.3f} GB "
              f"{rec['collectives']['counts']}", flush=True)


if __name__ == "__main__":
    main()
