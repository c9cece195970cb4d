"""Launch counters of the port's kernels, one per kernel.

Each wrapper adds one to its kernel's count where it launches the kernel
and nowhere else (never on its plain PyTorch path), so a run that resets
the counts, drives a path and reads them shows which kernels that path
went through.
"""
from __future__ import annotations

LAUNCHES = {"importance_mask_2d": 0, "importance_mask_batched": 0,
            "fedsgd_aggregate_weighted": 0, "exponent_histogram": 0,
            "fedsgd_aggregate": 0, "client_rank_sort": 0,
            "masked_update_2d": 0, "flash_attention": 0,
            "decode_attention": 0, "ssd_chunk": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
