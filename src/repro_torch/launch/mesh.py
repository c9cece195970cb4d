"""Device meshes and process groups: the LM's production meshes and the
sharded client axis.

`make_production_mesh` is the port of the JAX package's entry point of the
same name: the 16x16 ("data", "model") or 2x16x16 ("pod", "data",
"model") ``DeviceMesh`` of the LM stack's partition rules
(sharding/rules.py), over the default process group that the caller has
initialised with the mesh's world size (launch/dryrun.py uses PyTorch's
``fake`` backend for it, so one process stands for rank 0 of 256 or 512).
``REPRO_FORCE_MESH="d,m"`` (or "p,d,m") overrides the shape, as in the JAX
package.

The rest is the port of ``repro/launch/mesh.py``'s host mesh
(``make_host_mesh``, ``replicate``). The JAX package shards the round's client axis over the
``data`` axis of a device mesh inside one program (``shard_map``). Torch has
no single-controller counterpart, so here one process is one shard, as in
PyTorch's own idiom: every rank runs the same trainer on the same host
schedule and RNG, holds (w, v) replicated, runs its slice of the bucketed
client axis and meets the other ranks in exactly one collective a round
(core/round_engine.py).

Backends. ``gloo`` serves CPU tensors and ranks that share one card: its
collectives run on the host, and `ShardGroup.all_gather_into` stages CUDA
tensors through pinned host buffers. ``nccl`` refuses two ranks on one
device and needs a card per rank; that leg is ROADMAP.md §1 item 12 and
raises here.

Every rendezvous and collective gives up after ``DEFAULT_TIMEOUT_S``, and
`spawn_shards` joins its ranks with a timeout of its own and stops the
others as soon as one fails, so a hung or crashed rank fails its caller
instead of hanging it. As everywhere in the port, ``device=None`` means
CUDA, which must then be available (`device.resolve_device`).

    results = spawn_shards(fn, 4, args=(spec,), device="cpu")

runs ``fn(group, spec)`` on 4 ranks and returns each rank's return value,
rank order. The rendezvous is a ``file://`` store in a fresh temporary
directory, so concurrent launches (the test suite's parallel workers) never
share a port.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

# collectives and the rendezvous give up after this many seconds
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass
class ShardGroup:
    """One rank's view of the default process group: its rank, the
    number of ranks and the device its trainer runs on. Ranks may share a
    device (gloo on one card)."""

    rank: int
    world: int
    device: torch.device
    # host seconds of the last all_gather_into: the device-to-host copy of
    # a CUDA row (its wait for the device included) and the collective
    last_copy_s: float = 0.0
    last_gather_s: float = 0.0
    # pinned host staging for CUDA tensors: (send, recv) by (numel, dtype),
    # and the event of the last host-to-device copy out of recv
    _staging: dict = dataclasses.field(default_factory=dict, repr=False)
    _h2d_done: Any = dataclasses.field(default=None, repr=False)

    def all_gather_into(self, send: torch.Tensor,
                        recv: torch.Tensor) -> None:
        """recv[r] = rank r's `send` for every rank r, in one collective.
        `recv` is [world, *send.shape] (contiguous), on send's device.

        A CUDA tensor goes through pinned host buffers: the device-to-host
        copy waits for the work queued before it on the current stream (the
        one host sync of a sharded round), the gather runs on the host, and
        the copy into `recv` is queued on the current stream without a
        wait."""
        if not send.is_cuda:
            t0 = time.perf_counter()
            dist.all_gather(list(recv.reshape(self.world, -1).unbind(0)),
                            send.reshape(-1))
            self.last_copy_s, self.last_gather_s = \
                0.0, time.perf_counter() - t0
            return
        key = (send.numel(), send.dtype)
        bufs = self._staging.get(key)
        if bufs is None:
            bufs = self._staging[key] = (
                torch.empty(send.numel(), dtype=send.dtype, pin_memory=True),
                torch.empty((self.world, send.numel()), dtype=send.dtype,
                            pin_memory=True))
        hs, hr = bufs
        if self._h2d_done is not None:
            # the last copy out of a host buffer must land before the next
            # gather overwrites it
            self._h2d_done.synchronize()
        t0 = time.perf_counter()
        hs.copy_(send.reshape(-1))
        t1 = time.perf_counter()
        dist.all_gather(list(hr.unbind(0)), hs)
        self.last_copy_s, self.last_gather_s = t1 - t0, \
            time.perf_counter() - t1
        recv.reshape(self.world, -1).copy_(hr, non_blocking=True)
        if self._h2d_done is None:
            self._h2d_done = torch.cuda.Event()
        self._h2d_done.record()

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Overwrite `t` with rank `src`'s copy, in place (staged through
        the host for a CUDA tensor)."""
        if not t.is_cuda:
            dist.broadcast(t, src)
            return t
        host = t.detach().cpu()
        dist.broadcast(host, src)
        t.copy_(host)
        return t


_CURRENT: ShardGroup | None = None


def production_mesh_shape(*, multi_pod: bool = False) -> tuple:
    """(sizes, axis names) of the production mesh, or of
    ``REPRO_FORCE_MESH`` when it is set."""
    forced = os.environ.get("REPRO_FORCE_MESH")
    if forced:
        sizes = tuple(int(x) for x in forced.split(","))
        return sizes, ("pod", "data", "model")[-len(sizes):]
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 single pod (256 ranks) or 2x16x16 two pods (512 ranks), a
    ``DeviceMesh`` over the initialised default process group, whose world
    size must be the mesh's. `device_type` None means CUDA."""
    from torch.distributed.device_mesh import init_device_mesh
    sizes, names = production_mesh_shape(multi_pod=multi_pod)
    return init_device_mesh(device_type or "cuda", sizes,
                            mesh_dim_names=names)


def init_shards(n: int, *, rank: int | None = None, backend: str = "gloo",
                init_method: str = "env://", device=None) -> ShardGroup:
    """Join the default process group as `rank` of `n` and return the
    rank's ShardGroup, which `current_group` then returns (the round
    engine's default). `rank` None reads the RANK environment variable
    (torchrun's); `device` None means CUDA."""
    if backend == "nccl":
        raise NotImplementedError(
            "the nccl backend (one card per rank, collectives inside the "
            "captured graph) is not ported yet (ROADMAP.md §1 item 12); "
            "use backend='gloo'")
    if backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")
    device = resolve_device(device)
    if rank is None:
        rank = int(os.environ["RANK"])
    dist.init_process_group(
        backend, init_method=init_method, world_size=int(n), rank=int(rank),
        timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
    global _CURRENT
    _CURRENT = ShardGroup(rank=int(rank), world=int(n), device=device)
    return _CURRENT


def current_group(device=None) -> ShardGroup | None:
    """The group `init_shards` set up, or one on `device` (None: CUDA)
    over a default process group initialised otherwise (torchrun's), or
    None when no group is up."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    if _CURRENT is not None:
        return _CURRENT
    return ShardGroup(rank=dist.get_rank(), world=dist.get_world_size(),
                      device=resolve_device(device))


def _shutdown() -> None:
    """Leave the default process group (after a final barrier)."""
    global _CURRENT
    if dist.is_available() and dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()
    _CURRENT = None


def replicate(tensors: Sequence[torch.Tensor],
              group: ShardGroup) -> list[torch.Tensor]:
    """Broadcast every tensor from rank 0 in place and return them: the
    counterpart of the JAX package's ``replicate``. The trainer does not
    need it (each rank builds the same store from the same seed); it makes
    a rank's copy rank 0's where that is not so by construction."""
    return [group.broadcast_(t) for t in tensors]


def _shard_main(fn, rank: int, n: int, init_method: str, device: str,
                backend: str, threads: int | None, out_dir: str,
                args: tuple) -> None:
    """A spawned rank: join the group, run fn(group, *args), pickle the
    result (or the traceback) into out_dir."""
    try:
        if threads:
            torch.set_num_threads(int(threads))
        group = init_shards(n, rank=rank, backend=backend,
                            init_method=init_method, device=device)
        out = fn(group, *args)
        _shutdown()
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    except BaseException:
        # no barrier on the way out: the other ranks may be waiting in a
        # collective, and the launcher stops them once this rank is gone
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        os._exit(1)


def spawn_shards(fn: Callable, n: int, *, args: tuple = (), device=None,
                 backend: str = "gloo", timeout_s: float | None = 600.0,
                 threads: int | None = 1) -> list:
    """Run ``fn(group, *args)`` on `n` ranks (torch.multiprocessing spawn,
    a ``file://`` rendezvous in a temporary directory) and return the ranks'
    return values in rank order. `fn` and its results must pickle (return
    numpy or CPU tensors). The ranks share `device` (None: CUDA, which
    must then be available); `threads` caps each rank's intra-op threads
    (None keeps torch's default).

    Raises RuntimeError with the failed rank's traceback when a rank fails
    (the others are stopped at once), and TimeoutError when the ranks have
    not all finished within `timeout_s` seconds (None: no limit beyond the
    collectives' own `DEFAULT_TIMEOUT_S`)."""
    import torch.multiprocessing as mp
    device = resolve_device(device)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="repro_shards_") as d:
        init = "file://" + os.path.join(d, "rendezvous")
        procs = [ctx.Process(
            target=_shard_main,
            args=(fn, r, int(n), init, str(device), backend, threads, d,
                  tuple(args)))
            for r in range(int(n))]
        for p in procs:
            p.start()
        deadline = None if timeout_s is None else \
            time.monotonic() + float(timeout_s)
        try:
            while any(p.is_alive() for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.exitcode not in (None, 0)]
                if failed:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(
                        f"spawn_shards: {n} ranks still running after "
                        f"{timeout_s} s")
                time.sleep(0.02)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        errs = []
        for r, p in enumerate(procs):
            path = os.path.join(d, f"rank{r}.err")
            if os.path.exists(path):
                with open(path) as f:
                    errs.append(f"rank {r}:\n{f.read()}")
            elif p.exitcode != 0:
                errs.append(f"rank {r}: exit code {p.exitcode}")
        if errs:
            raise RuntimeError("spawn_shards: a rank failed\n"
                               + "\n".join(errs))
        out = []
        for r in range(int(n)):
            with open(os.path.join(d, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
