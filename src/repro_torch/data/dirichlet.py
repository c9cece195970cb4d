"""Dirichlet(sigma) non-IID partitioning (paper Sec. V).

"splits non-IID data by sampling label proportions for clients from a
Dirichlet distribution p_{n,z} ~ Dirichlet(sigma), where the concentration
parameter sigma controls data heterogeneity."
"""
from __future__ import annotations

import numpy as np


def dirichlet_label_proportions(
    n_clients: int, n_classes: int, sigma: float,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """[n_clients, n_classes] row-stochastic label proportions."""
    if sigma <= 0:
        raise ValueError("Dirichlet concentration must be positive")
    rng = rng or np.random.default_rng(0)
    return rng.dirichlet(sigma * np.ones(n_classes), size=n_clients)


def partition_by_dirichlet(
    labels: np.ndarray, n_clients: int, sigma: float,
    *, rng: np.random.Generator | None = None, min_per_client: int = 1,
) -> list[np.ndarray]:
    """Split sample indices among clients with Dirichlet label skew.

    Standard construction: for each class, split its indices among clients
    proportionally to a Dirichlet(sigma) draw over clients. Every client is
    guaranteed at least `min_per_client` samples (re-draws otherwise).
    """
    rng = rng or np.random.default_rng(0)
    labels = np.asarray(labels)
    classes = np.unique(labels)
    for _attempt in range(100):
        parts: list[list[int]] = [[] for _ in range(n_clients)]
        for cls in classes:
            idx = np.flatnonzero(labels == cls)
            rng.shuffle(idx)
            props = rng.dirichlet(sigma * np.ones(n_clients))
            cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
            for n, chunk in enumerate(np.split(idx, cuts)):
                parts[n].extend(chunk.tolist())
        if min(len(p) for p in parts) >= min_per_client:
            return [np.array(sorted(p)) for p in parts]
    raise RuntimeError("could not satisfy min_per_client after 100 draws; "
                       "increase sigma or dataset size")
