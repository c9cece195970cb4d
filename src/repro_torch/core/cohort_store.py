"""Streamed cohort store: fleet-scale populations through the packed engine.

The port of ``repro/core/cohort_store.py``. `ClientStore` (client_store.py)
puts EVERY client's padded rows on the device: right for edge-scale
federations, impossible for 100k-1M-client fleets. The cohort store keeps
the population on the host (a lazy `FleetRoster` or a plain client list)
and moves only each block's *cohort*, the union of the clients the
schedule selects in that block, to the device:

  * the trainer registers the whole run's block plans up front
    (`schedule`: the block partition is schedule-pure, so cohort k+1 is
    known while block k trains), and the first two cohorts start to
    prefetch;
  * a prefetch thread packs a cohort's padded ``[rows, N_max, ...]`` rows
    on the host while the device runs the block before it; at most two
    cohorts are resident (the current one and the one prefetching);
  * `acquire(start)` joins the prefetch (recording the stall), retires the
    earlier cohort, commits this one to the device, starts the next
    prefetch and returns a `Cohort` whose ``remap`` turns global client ids
    into the device rows that hold them.

Rows and counters are the JAX package's: the cohort is the plan's
``np.unique`` ids on a pow2 row bucket (`bucket_capacity`, capped at the
population), rows past a client's count and past the cohort are zeros, a
cohort's bytes are its bucketed x + y bytes, and ``n_cohort_swaps``,
``h2d_bytes`` and ``peak_cohort_bytes`` advance at the same points, so
both packages count the same on one spec.

What CUDA graphs change. The round engine replays one captured graph a
round body, and a graph holds the addresses it gathers from. So the device
side is two fixed slots in one buffer, ``x [2 * S, N_max, ...]`` and ``y
[2 * S, N_max]`` (S: the largest plan's bucketed rows, sized in
`schedule`); block i's cohort lives in slot ``i % 2`` and `Cohort.remap`
adds the slot's first row. Every block gathers from the same two tensors,
so a graph captured over one cohort serves every later one and the
captures do not grow with the number of cohorts. The slots (and FedDyn's
state slab, `CohortSlots.h_slab`) outlive the store: the trainer hands them
to the next run's store, so a reused trainer keeps its graphs too.

The copies. A prefetch thread makes no CUDA call: it generates the cohort's
clients and packs them into one of two pinned host buffers, allocated in
`schedule` before any capture. The main thread issues the host-to-device
copy in `acquire`, on a side stream: the side stream first waits on the
event recorded after the last block that read the slot (two blocks back),
and the compute stream waits on the copy's event before the block's first
replay. A host buffer is refilled only after its last copy completed. The
copy is issued under `device.CAPTURE_LOCK`, so it never lands on a stream
another thread is capturing (torch's pooled streams can coincide).

Streaming moves data, never randomness: the batch indices are drawn on
the host as before, the gathered values are the replicated store's, and
the trajectory is bit for bit the replicated run's.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.client_store import canonical_dtype
from repro_torch.core.round_engine import bucket_capacity
from repro_torch.device import CAPTURE_LOCK, resolve_device


def fleet_counters_zero() -> dict:
    """The streaming counters, in one place so the trainer, checkpoints and
    RunResult.summary['fleet'] agree on the keys."""
    return {"n_cohort_swaps": 0, "h2d_bytes": 0,
            "prefetch_stall_s": 0.0, "peak_cohort_bytes": 0}


@dataclasses.dataclass
class Cohort:
    """One block's client rows on the device (ClientStore-shaped).

    ``x`` / ``y`` are the two-slot device buffers `RoundEngine.block_step`
    gathers from (the same tensors for every cohort); this cohort holds
    rows ``[base, base + len(counts))`` of them. ``counts`` are the
    cohort's per-row real sample counts (zero on padding rows, which are
    never gathered), ``ids_by_shard`` its sorted global client ids (one
    entry: data-sharded cohorts are ROADMAP.md §1 item 8)."""

    x: torch.Tensor
    y: torch.Tensor
    counts: np.ndarray
    sharded: bool
    ids_by_shard: list
    start: int                # first schedule round of the owning block
    nbytes: int               # bucketed x + y bytes (the H2D of its commit)
    slot: int = 0
    base: int = 0             # first device row of the slot

    def remap(self, cids: np.ndarray) -> np.ndarray:
        """Global client ids [K, C] -> the device rows holding them."""
        return (np.searchsorted(self.ids_by_shard[0], cids)
                + self.base).astype(np.int32)


class CohortSlots:
    """The device slots, the pinned host buffers and the copy stream and
    events of a cohort store, sized for `rows` rows a slot; reusable by a
    later store over the same population (`fits`)."""

    def __init__(self, rows: int, n_max: int, xshape: tuple, xdtype,
                 ydtype, device: torch.device):
        self.rows, self.n_max = int(rows), int(n_max)
        self.xshape, self.device = tuple(xshape), device
        self.xdtype, self.ydtype = np.dtype(xdtype), np.dtype(ydtype)
        cuda = device.type == "cuda"
        xs = (2 * self.rows, self.n_max) + self.xshape
        self.x = torch.zeros(xs, dtype=_torch_dtype(self.xdtype),
                             device=device)
        self.y = torch.zeros(xs[:2], dtype=_torch_dtype(self.ydtype),
                             device=device)
        # two pinned host buffers, one per slot parity
        self.host_x = [torch.zeros((self.rows,) + xs[1:],
                                   dtype=self.x.dtype, pin_memory=cuda)
                       for _ in range(2)]
        self.host_y = [torch.zeros((self.rows, self.n_max),
                                   dtype=self.y.dtype, pin_memory=cuda)
                       for _ in range(2)]
        self.stream = torch.cuda.Stream(device) if cuda else None
        # copy_done[b]: the last copy out of host buffer b (into slot b);
        # slot_free[s]: recorded after the last block that read slot s
        self.copy_done = [torch.cuda.Event() if cuda else None
                          for _ in range(2)]
        self.slot_free = [torch.cuda.Event() if cuda else None
                          for _ in range(2)]
        self._copied = [False, False]
        self._freed = [False, False]
        self._h_slab: torch.Tensor | None = None

    def fits(self, rows: int, n_max: int, xshape, xdtype, ydtype,
             device) -> bool:
        return (rows <= self.rows and n_max == self.n_max
                and tuple(xshape) == self.xshape
                and np.dtype(xdtype) == self.xdtype
                and np.dtype(ydtype) == self.ydtype
                and torch.device(device) == self.device)

    def h_slab(self, prows: int, lanes: int) -> torch.Tensor:
        """FedDyn's state rows of the resident cohorts, [2 * S, R, L]:
        indexed by the same remapped ids as the data, the same tensor for
        the slots' life (a captured graph updates it in place)."""
        if self._h_slab is None or self._h_slab.shape[1:] != (prows, lanes):
            self._h_slab = torch.zeros((2 * self.rows, prows, lanes),
                                       dtype=torch.float32,
                                       device=self.device)
        return self._h_slab

    def wait_host(self, b: int) -> None:
        """Block until host buffer b's last copy has completed."""
        if self._copied[b]:
            self.copy_done[b].synchronize()

    def commit(self, slot: int, rows: int) -> None:
        """Copy host buffer `slot` into device slot `slot` (rows [0, rows))
        and make the compute stream wait for it."""
        lo = slot * self.rows
        dx, dy = self.x[lo:lo + rows], self.y[lo:lo + rows]
        hx, hy = self.host_x[slot][:rows], self.host_y[slot][:rows]
        if self.stream is None:
            dx.copy_(hx)
            dy.copy_(hy)
            return
        cur = torch.cuda.current_stream(self.device)
        with CAPTURE_LOCK:
            if self._freed[slot]:
                self.stream.wait_event(self.slot_free[slot])
            with torch.cuda.stream(self.stream):
                dx.copy_(hx, non_blocking=True)
                dy.copy_(hy, non_blocking=True)
                self.copy_done[slot].record(self.stream)
        self._copied[slot] = True
        cur.wait_event(self.copy_done[slot])

    def release(self, slot: int) -> None:
        """Every block that reads `slot` has been issued on the compute
        stream: mark the point its next copy waits for."""
        if self.stream is not None:
            self.slot_free[slot].record(
                torch.cuda.current_stream(self.device))
            self._freed[slot] = True

    def drain(self) -> None:
        """Wait for every issued copy (before the host buffers are reused
        by another store)."""
        for b in range(2):
            self.wait_host(b)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class CohortStore:
    """Plans, prefetches and hands out per-block cohorts (module doc).

    One instance serves one `FederatedTrainer.run` (the plans belong to
    that run's schedule); the trainer builds it for each run, passes the
    previous run's `slots` for reuse, and `close`s it in the run's finally
    block. ``device=None`` means CUDA."""

    def __init__(self, clients: Sequence, *, mesh=None, shards: int = 1,
                 max_clients: int | None = None,
                 counters: dict | None = None, device=None,
                 slots: CohortSlots | None = None):
        if mesh is not None or int(shards or 1) > 1:
            raise NotImplementedError(
                "a data-sharded cohort store (a mesh, shards > 1) is not "
                "ported to repro_torch yet (ROADMAP.md §1 item 8)")
        self.clients = clients
        self.device = resolve_device(device)
        self.max_clients = int(max_clients or len(clients))
        counts = getattr(clients, "counts", None)
        if counts is None:
            counts = [len(c) for c in clients]
        self.counts = np.asarray(counts, np.int64)
        self.n_max = int(self.counts.max())
        x0 = np.asarray(clients[0].x)
        self._xshape = x0.shape[1:]
        self._xdtype = canonical_dtype(x0.dtype)
        self._ydtype = canonical_dtype(np.asarray(clients[0].y).dtype)
        self.counters = counters if counters is not None \
            else fleet_counters_zero()
        self.slots = slots
        self._lock = threading.Lock()
        self._resident = 0                 # bytes of packed, live cohorts
        self._plans: list[tuple] = []      # (start, cids [K, C], counts [K])
        self._ids: list[np.ndarray] = []   # each plan's sorted unique ids
        self._rows: list[int] = []         # each plan's bucketed rows
        self._order: dict[int, int] = {}
        self._pending: dict[int, tuple] = {}   # plan idx -> (thread, box)
        self._live: dict[int, Cohort] = {}

    # -- planning / prefetch lifecycle --------------------------------------

    def schedule(self, plans: Sequence[tuple]) -> None:
        """Register the run's blocks in execution order, size the device
        slots for the largest cohort, and start prefetching the first two
        cohorts. Each plan is ``(start_round, cids [K, c_max] global ids
        with the trainer's padding, counts [K])``, the arrays `_exec_block`
        passes to the engine, so the cohort schedule is a pure function of
        the block plan (and the same after a resume)."""
        self._plans = list(plans)
        self._order = {int(p[0]): i for i, p in enumerate(self._plans)}
        self._ids = [np.unique(np.asarray(p[1])).astype(np.int64)
                     for p in self._plans]
        # pow2 row bucket capped at the population, as the client axis
        self._rows = [max(len(ids), bucket_capacity(
            len(ids), max_clients=self.max_clients)) for ids in self._ids]
        if self._plans:
            rows = max(self._rows)
            args = (self.n_max, self._xshape, self._xdtype, self._ydtype,
                    self.device)
            if self.slots is None or not self.slots.fits(rows, *args):
                self.slots = CohortSlots(rows, *args)
            else:
                self.slots.drain()
        self._launch(0)
        self._launch(1)

    def _launch(self, i: int) -> None:
        if i >= len(self._plans) or i in self._pending or i in self._live:
            return
        b = i % 2
        # host buffer b last fed plan i - 2's copy
        self.slots.wait_host(b)
        box: dict = {}
        th = threading.Thread(target=self._worker, args=(i, box), daemon=True)
        self._pending[i] = (th, box)
        th.start()

    def _worker(self, i: int, box: dict) -> None:
        try:
            box["packed"] = self._pack(i)
            with self._lock:
                self._resident += self._nbytes(i)
                self.counters["peak_cohort_bytes"] = max(
                    self.counters["peak_cohort_bytes"], self._resident)
        except BaseException as e:          # surfaced at acquire()
            box["error"] = e

    def acquire(self, start: int) -> Cohort:
        """Wait for cohort `start` (the stall is the prefetch's miss cost),
        retire earlier cohorts, commit this one to its slot and prefetch
        the next plan."""
        i = self._order[int(start)]
        for j in [j for j in self._live if j != i]:
            dropped = self._live.pop(j)
            with self._lock:
                self._resident -= dropped.nbytes
            self.slots.release(dropped.slot)
        if i not in self._live:
            self._launch(i)                 # miss: no prefetch for it
            th, box = self._pending.pop(i)
            t0 = time.perf_counter()
            th.join()
            self.counters["prefetch_stall_s"] += time.perf_counter() - t0
            err = box.get("error")
            if err is not None:
                raise err
            self._live[i] = self._commit(i, box["packed"])
        cohort = self._live[i]
        self.counters["n_cohort_swaps"] += 1
        self.counters["h2d_bytes"] += cohort.nbytes
        self._launch(i + 1)
        return cohort

    def close(self) -> None:
        """Join outstanding prefetches and wait for issued copies; the
        slots stay allocated for the next store (`slots`)."""
        for th, _ in self._pending.values():
            th.join()
        self._pending.clear()
        self._live.clear()
        self._plans, self._ids, self._rows = [], [], []
        self._order = {}
        if self.slots is not None:
            self.slots.drain()
        with self._lock:
            self._resident = 0

    # -- cohort construction ------------------------------------------------

    def _nbytes(self, i: int) -> int:
        per = (int(np.prod(self._xshape)) * self._xdtype.itemsize
               + self._ydtype.itemsize)
        return self._rows[i] * self.n_max * per

    def _pack(self, i: int) -> np.ndarray:
        """Pack plan i's clients into host buffer i % 2: byte-copies of the
        rows a replicated ClientStore holds (zeros past each count and past
        the cohort). Host work only. Returns the per-row counts."""
        ids, rows = self._ids[i], self._rows[i]
        b = i % 2
        x = self.slots.host_x[b].numpy()[:rows]
        y = self.slots.host_y[b].numpy()[:rows]
        rcounts = np.zeros(rows, np.int64)
        for k, cid in enumerate(ids):
            c = self.clients[int(cid)]
            n = int(self.counts[cid])
            x[k, :n] = c.x
            x[k, n:] = 0
            y[k, :n] = c.y
            y[k, n:] = 0
            rcounts[k] = n
        x[len(ids):] = 0
        y[len(ids):] = 0
        return rcounts

    def _commit(self, i: int, rcounts: np.ndarray) -> Cohort:
        slot = i % 2
        self.slots.commit(slot, self._rows[i])
        return Cohort(x=self.slots.x, y=self.slots.y, counts=rcounts,
                      sharded=False, ids_by_shard=[self._ids[i]],
                      start=int(self._plans[i][0]),
                      nbytes=self._nbytes(i), slot=slot,
                      base=slot * self.slots.rows)
