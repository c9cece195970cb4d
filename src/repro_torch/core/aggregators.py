"""Byzantine-robust aggregation registry (DESIGN.md §11).

The port of ``repro/core/aggregators.py``. The server-side reduction of the
per-client gradient stack is a pluggable axis: `make_aggregator(name,
**kwargs)` instantiates an entry of `AGGREGATORS`, and both trainer
backends thread the instance through their aggregation tails —
`RoundEngine._aggregate_update` (packed) and
`FederatedTrainer._reference_robust_round` (eager mirror over the same
bucket-padded stack). "mean" maps to ``None``: the engines keep the
weighted-mean path and its kernel.

Every reducer is weight-aware: the [C] effective weights (0 = client-axis
padding, a dropped upload, or a quarantined non-finite client) exclude a
lane from ranks, norms and distance scores, and `reduce` returns ``(ghat,
stat)`` with ghat already survivor-normalized (kernels/ops.py holds the
math). `impl` is the kernel choice of kernels/ops.py: "auto", "torch" or
"cuda".
"""
from __future__ import annotations

import dataclasses
import json
from typing import Callable

from repro_torch.kernels import ops

# name -> factory(**kwargs) -> Aggregator | None (None = builtin mean path)
AGGREGATORS: dict[str, Callable] = {}


def register_aggregator(name: str, factory: Callable | None = None,
                        *, override: bool = False):
    """Register an aggregator factory (usable as a decorator). The factory
    is called with the aggregator's kwargs and returns an `Aggregator`
    instance — or None for the builtin mean path."""
    def _register(fn):
        if not override and name in AGGREGATORS:
            raise KeyError(f"aggregator {name!r} already registered "
                           f"(pass override=True to replace)")
        AGGREGATORS[name] = fn
        return fn
    return _register(factory) if factory is not None else _register


def aggregator_names() -> list[str]:
    return sorted(AGGREGATORS)


def make_aggregator(name: str, **kwargs):
    """Instantiate a registered aggregator; returns None for "mean". Raises
    KeyError with the known names on an unknown aggregator,
    TypeError/ValueError on bad kwargs."""
    factory = AGGREGATORS.get(name)
    if factory is None:
        raise KeyError(f"unknown aggregator {name!r}; registered: "
                       f"{aggregator_names()}")
    return factory(**kwargs)


@dataclasses.dataclass(frozen=True)
class Aggregator:
    """Base: a named, hashable robust reducer.

    `reduce(grads, cweights)` takes the packed [C, R, 128] per-client
    gradient stack (corruption factors and poison already applied) and the
    [C] effective validity weights, and returns ``(ghat, stat)`` — the
    survivor-normalized aggregate [R, 128] fp32 and an int32 per-round
    count that the trainer accumulates under `stat_field`."""
    impl: str = "auto"
    name = "?"            # class attrs: registry key + counter routing
    stat_field = "n_excluded"

    @property
    def spec_key(self) -> str:
        """Canonical identity string (the JAX package's trainer-pool key)."""
        return json.dumps([self.name, dataclasses.asdict(self)],
                          sort_keys=True)

    def reduce(self, grads, cweights):
        raise NotImplementedError


@register_aggregator("mean")
def _mean(**kwargs):
    if kwargs:
        raise TypeError(f"mean takes no kwargs, got {sorted(kwargs)}")
    return None


@dataclasses.dataclass(frozen=True)
class CoordMedian(Aggregator):
    """Coordinate-wise median over valid clients (rank sort per lane)."""
    name = "coord_median"

    def reduce(self, grads, cweights):
        return ops.packed_robust_aggregate(grads, cweights,
                                           kind="coord_median",
                                           impl=self.impl)


@dataclasses.dataclass(frozen=True)
class TrimmedMean(Aggregator):
    """Per-coordinate beta-trimmed mean: drop the floor(beta*n) smallest
    and largest values, mean the middle."""
    beta: float = 0.1
    name = "trimmed_mean"
    stat_field = "n_trimmed"

    def __post_init__(self):
        if not 0.0 <= float(self.beta) < 0.5:
            raise ValueError(
                f"trimmed_mean beta must be in [0, 0.5), got {self.beta}")

    def reduce(self, grads, cweights):
        return ops.packed_robust_aggregate(grads, cweights,
                                           kind="trimmed_mean",
                                           beta=float(self.beta),
                                           impl=self.impl)


@dataclasses.dataclass(frozen=True)
class NormClip(Aggregator):
    """Mean of norm-clipped uploads: client c scales by min(1,
    tau/||g_c||); tau None (or <= 0) is the median of the valid norms."""
    tau: float | None = None
    name = "norm_clip"
    stat_field = "n_clipped"

    def reduce(self, grads, cweights):
        return ops.packed_robust_aggregate(
            grads, cweights, kind="norm_clip",
            tau=None if self.tau is None else float(self.tau),
            impl=self.impl)


@dataclasses.dataclass(frozen=True)
class MultiKrum(Aggregator):
    """Multi-Krum (Blanchard et al.): score each valid client by the sum
    of its n-f-2 smallest squared distances to the others, keep the m
    (default n-f) lowest-scoring clients, mean them."""
    f: int = 1
    m: int | None = None

    name = "multi_krum"

    def __post_init__(self):
        if int(self.f) < 0:
            raise ValueError(f"multi_krum f must be >= 0, got {self.f}")
        if self.m is not None and int(self.m) < 1:
            raise ValueError(f"multi_krum m must be >= 1, got {self.m}")

    def reduce(self, grads, cweights):
        return ops.packed_robust_aggregate(
            grads, cweights, kind="multi_krum", f=int(self.f),
            m=None if self.m is None else int(self.m), impl=self.impl)


register_aggregator("coord_median", CoordMedian)
register_aggregator("trimmed_mean", TrimmedMean)
register_aggregator("norm_clip", NormClip)
register_aggregator("multi_krum", MultiKrum)
