"""Minimal batching utilities (shuffle + drop-remainder batching)."""
from __future__ import annotations

from typing import Iterator

import numpy as np


def batches(
    x: np.ndarray, y: np.ndarray, batch_size: int,
    *, rng: np.random.Generator | None = None, shuffle: bool = True,
) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yield (x, y) minibatches; drops the ragged tail."""
    n = len(y)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng(0)).shuffle(idx)
    for start in range(0, n - batch_size + 1, batch_size):
        sel = idx[start: start + batch_size]
        yield x[sel], y[sel]
