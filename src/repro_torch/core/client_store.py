"""Device-resident client datasets for the multi-round block engine.

The port of ``repro/core/client_store.py``. `ClientStore` moves every
client's samples to the device once, as padded ``[C, N_max, ...]`` inputs
and ``[C, N_max]`` labels, with the per-client sample counts on the host.
`RoundEngine.block_step` then gathers each round's mini-batches on the
device from host-drawn index arrays ``[K, C, B]``, so no batch data crosses
from host to device inside a block: only the O(K*C*B) int32 indices do,
once per block.

The indices stay drawn from the trainer's numpy RNG, one `choice` call per
(round, selected client), the calls the per-round path makes, so the block
engine consumes the same batch sequence and stays bit for bit equal to the
per-round and reference paths (the gathered values are the values the host
would have indexed out of `ClientData`).

Padding rows (samples beyond a client's count) are zeros and are never
gathered: drawn indices are below the client's count, and padding clients
on the bucketed client axis replicate a real client's id and indices.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Sequence

import numpy as np
import torch

# bytes of device memory the "auto" client-store policy keys on, unless
# REPRO_DEVICE_MEM_BUDGET says otherwise
DEFAULT_DEVICE_BUDGET = 1 << 30


def default_device_budget() -> int:
    """REPRO_DEVICE_MEM_BUDGET (bytes) when set, else 1 GiB: small enough
    that fleet-scale rosters would stream, large enough that every
    edge-scale configuration keeps the replicated store."""
    env = os.environ.get("REPRO_DEVICE_MEM_BUDGET")
    return int(env) if env else DEFAULT_DEVICE_BUDGET


class StoreBudgetError(RuntimeError):
    """A replicated ClientStore would exceed the device-memory budget.

    Raised by `FederatedTrainer` and `Experiment.build` before the
    host-to-device copy, so the failure names its remedy instead of ending
    in a device out-of-memory error."""

    def __init__(self, population: int, nbytes: int, budget: int):
        self.population = int(population)
        self.nbytes = int(nbytes)
        self.budget = int(budget)
        super().__init__(
            f"replicated ClientStore for {population} clients needs "
            f"~{nbytes / 2**20:.1f} MiB on the device, over the "
            f"{budget / 2**20:.1f} MiB device-memory budget. Use "
            f'client_store="streamed" (cohort streaming, RunSpec.client_store'
            f" / FederatedTrainer(client_store=...)) or raise the budget "
            f"(device_mem_budget / REPRO_DEVICE_MEM_BUDGET).")


def canonical_dtype(dtype) -> np.dtype:
    """The dtype a client array takes on the device: float64 -> float32
    and int64 -> int32, as the JAX package's default configuration narrows
    them; others are kept."""
    dtype = np.dtype(dtype)
    if dtype == np.float64:
        return np.dtype(np.float32)
    if dtype == np.int64:
        return np.dtype(np.int32)
    return dtype


def to_device(a, device) -> torch.Tensor:
    """A host array on `device` in its canonical dtype: the per-round
    batch upload and the store take the same values."""
    a = np.asarray(a)
    return torch.as_tensor(a.astype(canonical_dtype(a.dtype), copy=False),
                           device=device)


def _client_counts(clients: Sequence) -> np.ndarray:
    """Per-client sample counts; a roster (data/fleet.FleetRoster) publishes
    them, so its clients are not materialised."""
    counts = getattr(clients, "counts", None)
    if counts is None:
        counts = [len(c) for c in clients]
    return np.asarray(counts, np.int64)


def estimated_store_nbytes(clients: Sequence) -> int:
    """Device bytes a replicated ClientStore for `clients` would take,
    without building it: ``clients.store_nbytes()`` where the sequence
    offers it (a roster), else the per-client counts and one client's
    shapes and dtypes."""
    sizer = getattr(clients, "store_nbytes", None)
    if callable(sizer):
        return int(sizer())
    counts = _client_counts(clients)
    n_max = int(counts.max())
    x0 = np.asarray(clients[0].x)
    per_sample = (int(np.prod(x0.shape[1:]))
                  * canonical_dtype(x0.dtype).itemsize
                  + canonical_dtype(np.asarray(clients[0].y).dtype).itemsize)
    return len(counts) * n_max * per_sample


@dataclasses.dataclass(frozen=True)
class ClientStore:
    """Padded datasets on the device: x [C, N_max, ...], y [C, N_max]."""

    x: torch.Tensor
    y: torch.Tensor
    counts: np.ndarray          # host [C] int: real samples a client

    @classmethod
    def build(cls, clients: Sequence, device=None) -> "ClientStore":
        """Pack `ClientData`-like objects (``.x``, ``.y`` numpy arrays) into
        one padded device buffer per field, in the canonical dtypes of the
        per-round upload (`to_device`), so a gathered batch is bit for bit
        what the host would have uploaded. device=None means CUDA."""
        from repro_torch.device import resolve_device
        device = resolve_device(device)
        counts = _client_counts(clients)
        n_max = int(counts.max())
        x0 = np.asarray(clients[0].x)
        y0 = np.asarray(clients[0].y)
        x = np.zeros((len(counts), n_max) + x0.shape[1:],
                     canonical_dtype(x0.dtype))
        y = np.zeros((len(counts), n_max), canonical_dtype(y0.dtype))
        # one row-major boolean scatter a field fills each client's prefix
        mask = np.arange(n_max)[None, :] < counts[:, None]
        x[mask] = np.concatenate([np.asarray(c.x) for c in clients])
        y[mask] = np.concatenate([np.asarray(c.y) for c in clients])
        return cls(x=torch.as_tensor(x, device=device),
                   y=torch.as_tensor(y, device=device), counts=counts)

    @property
    def n_clients(self) -> int:
        return int(self.x.shape[0])

    @property
    def nbytes(self) -> int:
        return int(self.x.nbytes + self.y.nbytes)

    def gather(self, cids, idx) -> tuple[torch.Tensor, torch.Tensor]:
        """Batch assembly on the device: cids [C], idx [C, B] -> (x [C, B,
        ...], y [C, B]); idx [C, E, B] (E local steps) gives [C, E, B, ...].
        The block's round body gathers the same way."""
        cids = torch.as_tensor(cids, device=self.x.device).long()
        idx = torch.as_tensor(idx, device=self.x.device).long()
        cx = cids.view(cids.shape + (1,) * (idx.ndim - 1))
        return self.x[cx, idx], self.y[cx, idx]
