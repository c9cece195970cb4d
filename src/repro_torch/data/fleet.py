"""Fleet-scale synthetic client roster: 1e2..1e6 clients, host-side (DESIGN.md §13).

The port's numpy copy of ``repro/data/fleet.py``: the same draws, byte for
byte, so both packages hold the same roster for the same arguments.

`make_dataset` (synthetic.py) materializes the whole federation as two dense
arrays — fine for tens of clients, impossible for the fleet-scale populations
the paper's selection machinery (P1/P5) is motivated by. `FleetRoster` keeps
the population *virtual*: each client's shard is a pure function of
``(seed, cid)`` and is generated on first touch (LRU-cached, thread-safe so
the cohort prefetcher can materialize from a background thread). Nothing is
ever resident for the whole fleet except O(population) scalars (sample
counts, optional label histograms).

The per-client draw protocol is FROZEN — the cohort store's bitwise
streamed-vs-replicated guarantee rests on every consumer seeing identical
bytes for client ``cid``:

    rng = default_rng(SeedSequence([seed & 0xFFFFFFFF, 1 + cid]))
    p     = rng.dirichlet(alpha)                      # alpha = sigma * ones
    y     = rng.choice(n_classes, size=count, p=p)    # non-IID labels
    t_idx = rng.integers(0, n_templates, size=count)
    mix   = rng.uniform(0.6, 1.0, size=(count,1,1,1))
    eps   = rng.normal(size=(count, *shape))
    x     = clip(mix * templates[y, t_idx] + noise * eps, 0, 1); normalize

A labels-only replay (``client_labels``) draws the same stream prefix and
stops before the image tensors, so phi/label-histogram passes cost O(count)
ints per client, not O(count * H * W).
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Sequence

import numpy as np

from repro_torch.data.synthetic import SyntheticImageDataset, _smooth_templates

_SHAPES = {
    "synthetic-fleet": (28, 28, 1),
    "synthetic-fleet-cifar": (32, 32, 3),
}


def _client_rng(seed: int, cid: int) -> np.random.Generator:
    # 1 + cid keeps client streams disjoint from the roster-level stream
    # (templates / test set / counts), which uses the bare seed
    return np.random.default_rng(
        np.random.SeedSequence([seed & 0xFFFFFFFF, 1 + int(cid)]))


class FleetRoster(Sequence):
    """A lazy, immutable Sequence of ClientData over a virtual population.

    ``roster[cid]`` materializes client ``cid``'s shard (cached); ``counts``
    is host-resident for the whole population so schedulers, the trainer's
    store-size estimate, and the cohort planner never touch image data.
    """

    def __init__(self, population: int, shape: tuple[int, int, int],
                 n_classes: int, templates: np.ndarray, counts: np.ndarray,
                 *, sigma: float, noise: float, seed: int,
                 norm: tuple[float, float], cache_size: int = 4096):
        self.population = int(population)
        self.shape = tuple(shape)
        self.n_classes = int(n_classes)
        self.templates = templates
        self.counts = np.asarray(counts, dtype=np.int64)
        self.sigma = float(sigma)
        self.noise = float(noise)
        self.seed = int(seed)
        self.norm = (float(norm[0]), float(norm[1]))
        self.cache_size = int(cache_size)
        self._cache: OrderedDict[int, "ClientData"] = OrderedDict()
        self._lock = threading.Lock()
        self._hists: np.ndarray | None = None

    # --- Sequence protocol -------------------------------------------------
    def __len__(self) -> int:
        return self.population

    def __getitem__(self, cid):
        if isinstance(cid, slice):
            return [self[i] for i in range(*cid.indices(self.population))]
        cid = int(cid)
        if cid < 0:
            cid += self.population
        if not 0 <= cid < self.population:
            raise IndexError(cid)
        with self._lock:
            hit = self._cache.get(cid)
            if hit is not None:
                self._cache.move_to_end(cid)
                return hit
        data = self._generate(cid)
        with self._lock:
            self._cache[cid] = data
            self._cache.move_to_end(cid)
            while len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return data

    # --- generation --------------------------------------------------------
    def _alpha(self) -> np.ndarray:
        return np.full(self.n_classes, max(self.sigma, 1e-3))

    def client_labels(self, cid: int) -> np.ndarray:
        """Labels only: replays the frozen stream prefix (p, y) and stops."""
        rng = _client_rng(self.seed, cid)
        p = rng.dirichlet(self._alpha())
        return rng.choice(self.n_classes, size=int(self.counts[cid]),
                          p=p).astype(np.int32)

    def _generate(self, cid: int) -> "ClientData":
        from repro_torch.core.federated import ClientData
        rng = _client_rng(self.seed, cid)
        count = int(self.counts[cid])
        p = rng.dirichlet(self._alpha())
        y = rng.choice(self.n_classes, size=count, p=p).astype(np.int32)
        t_idx = rng.integers(0, self.templates.shape[1], size=count)
        mix = rng.uniform(0.6, 1.0, size=(count, 1, 1, 1)).astype(np.float32)
        x = mix * self.templates[y, t_idx] + self.noise * rng.normal(
            size=(count, *self.shape)).astype(np.float32)
        x = np.clip(x, 0.0, 1.0).astype(np.float32)
        mu, sd = self.norm
        x = ((x - mu) / sd).astype(np.float32)
        return ClientData(x, y)

    def label_histograms(self) -> np.ndarray:
        """[population, n_classes] float histograms via the labels-only path."""
        if self._hists is None:
            h = np.zeros((self.population, self.n_classes))
            for cid in range(self.population):
                h[cid] = np.bincount(self.client_labels(cid),
                                     minlength=self.n_classes)
            self._hists = h
        return self._hists

    # --- sizing ------------------------------------------------------------
    @property
    def max_count(self) -> int:
        return int(self.counts.max())

    def store_nbytes(self) -> int:
        """Device bytes a replicated ClientStore for this roster would need
        (padded [population, max_count, ...]; fp32 x, int32 y)."""
        per_sample = 4 * int(np.prod(self.shape)) + 4
        return self.population * self.max_count * per_sample


class FleetDataset(SyntheticImageDataset):
    """SyntheticImageDataset-shaped view over a FleetRoster.

    Exposes the test split (small, eagerly drawn) plus ``roster``;
    ``x_train``/``y_train`` are intentionally absent-by-contract — touching
    them raises, because at fleet scale there is no dense train tensor.
    """

    def __init__(self, roster: FleetRoster, x_test: np.ndarray,
                 y_test: np.ndarray, name: str):
        self.roster = roster
        self.x_test = x_test
        self.y_test = y_test
        self.num_classes = roster.n_classes
        self.name = name

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return self.roster.shape

    def _no_dense(self, attr: str):
        raise AttributeError(
            f"FleetDataset has no dense {attr}: the {self.roster.population}"
            "-client train split is virtual (see FleetRoster)")

    @property
    def x_train(self):
        self._no_dense("x_train")

    @property
    def y_train(self):
        self._no_dense("y_train")


def make_fleet(
    name: str = "synthetic-fleet",
    *,
    population: int,
    n_train: int = 6000,
    n_test: int = 1000,
    sigma: float = 0.5,
    noise: float = 0.35,
    seed: int = 0,
    cache_size: int = 4096,
) -> FleetDataset:
    """Build a fleet dataset. ``n_train`` is the TOTAL sample budget across
    the federation (same semantic as make_dataset + Dirichlet partition):
    per-client counts are drawn uniformly in [ceil(m/2), ceil(3m/2)] for
    m = n_train / population, min 1 — ragged by construction."""
    if name not in _SHAPES:
        raise ValueError(f"unknown fleet dataset {name!r}; "
                         f"options: {sorted(_SHAPES)}")
    if population < 1:
        raise ValueError(f"population must be >= 1, got {population}")
    shape = _SHAPES[name]
    n_classes = 10
    # roster-level stream, fixed draw order: templates -> test set -> counts
    rng = np.random.default_rng(seed & 0xFFFFFFFF)
    templates = _smooth_templates(n_classes, shape, n_templates=4, rng=rng)
    y_te = rng.integers(0, n_classes, size=n_test)
    t_idx = rng.integers(0, templates.shape[1], size=n_test)
    mix = rng.uniform(0.6, 1.0, size=(n_test, 1, 1, 1)).astype(np.float32)
    x_te = mix * templates[y_te, t_idx] + noise * rng.normal(
        size=(n_test, *shape)).astype(np.float32)
    x_te = np.clip(x_te, 0.0, 1.0).astype(np.float32)
    # normalization constants come from the (deterministic, small) test
    # draw — train statistics would require materializing the fleet; both
    # estimate the same population moments
    mu, sd = float(x_te.mean()), float(x_te.std()) + 1e-8
    x_te = ((x_te - mu) / sd).astype(np.float32)
    m = max(1.0, n_train / population)
    lo = max(1, int(np.ceil(m / 2)))
    hi = max(lo, int(np.ceil(1.5 * m)))
    counts = rng.integers(lo, hi + 1, size=population)
    roster = FleetRoster(population, shape, n_classes, templates, counts,
                         sigma=sigma, noise=noise, seed=seed,
                         norm=(mu, sd), cache_size=cache_size)
    return FleetDataset(roster, x_te, y_te.astype(np.int32), name)
