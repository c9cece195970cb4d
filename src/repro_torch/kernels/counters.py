"""Launch counters of the port's kernels, one per kernel.

Each wrapper adds one to its kernel's count where it launches the kernel
and nowhere else (never on its plain PyTorch path), so a run that resets
the counts, drives a path and reads them shows which kernels that path
went through.

Counts are added under a lock, so sweep workers in several threads never
lose one. A CUDA-graph capture launches nothing: the capturing thread's
wrappers add to the capture's own dict instead (`capturing`), which the
engine keeps with the graph and adds at each replay; other threads' launches
meanwhile still reach `LAUNCHES`.
"""
from __future__ import annotations

import contextlib
import threading

LAUNCHES = {"importance_mask_2d": 0, "importance_mask_batched": 0,
            "fedsgd_aggregate_weighted": 0, "exponent_histogram": 0,
            "fedsgd_aggregate": 0, "client_rank_sort": 0,
            "masked_update_2d": 0, "flash_attention": 0,
            "decode_attention": 0, "ssd_chunk": 0}

_LOCK = threading.Lock()
_local = threading.local()


def count_launch(name: str, n: int = 1) -> None:
    """Add n launches of kernel `name`: to this thread's capture, if one is
    open, else to LAUNCHES."""
    sink = getattr(_local, "sink", None)
    if sink is not None:
        sink[name] = sink.get(name, 0) + n
        return
    with _LOCK:
        LAUNCHES[name] += n


@contextlib.contextmanager
def capturing():
    """Collect this thread's launches in a fresh dict (yielded) instead of
    LAUNCHES, for the duration of a graph capture."""
    prev = getattr(_local, "sink", None)
    sink: dict[str, int] = {}
    _local.sink = sink
    try:
        yield sink
    finally:
        _local.sink = prev


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0
