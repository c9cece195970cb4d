"""String-keyed component registries backing the declarative specs.

The port of ``repro/api/registry.py``: the same seven registries and the
same names, so one spec file resolves in either package.

  MODELS          name -> factory(spec: ModelSpec, dataset) -> (init, apply)
  DATASETS        name -> factory(spec: DataSpec) -> SyntheticImageDataset
  SCHEMES         name -> factory(spec: SchemeSpec) -> AOConfig, or a
                  solver callable (random_k)
  DATA_SELECTION  name -> factory(spec: SchemeSpec) -> (clients -> clients)
                  or None ("none")
  CHANNEL_NOISE   name -> factory(spec: WirelessSpec) -> noise model or None
  FAULT_MODELS    name -> factory(spec: WirelessSpec) -> fault model or None
  LOCAL_SCHEMES   name -> factory(spec: SchemeSpec) -> LocalScheme or None

A model factory's `init` takes a `torch.Generator` (Experiment.build seeds
one from ``run.seed``) and an optional ``device``. The port's initial
weights therefore differ from the JAX package's, which draws them with
``jax.random``; a caller that needs JAX's weights registers a model whose
init returns them through `repro_torch.convert.params_from_numpy`.

The fleet datasets build the port's roster (data/fleet.py), byte for byte
the JAX package's. ``fedavg`` with ``local_steps=1`` is FedSGD itself and
resolves to None.
"""
from __future__ import annotations

from typing import Any, Callable

from repro_torch.api.spec import DataSpec, ModelSpec, SchemeSpec, WirelessSpec
from repro_torch.core.local import make_local_scheme
from repro_torch.core.optimizer_ao import AOConfig
from repro_torch.data import make_dataset
from repro_torch.models import (lenet_apply, lenet_init, mlp_edge_apply,
                                mlp_edge_init, resnet_apply, resnet_init)


class Registry:
    """A named string -> factory map with helpful unknown-key errors."""

    def __init__(self, kind: str):
        self.kind = kind
        self._items: dict[str, Callable] = {}

    def register(self, name: str, factory: Callable | None = None,
                 *, override: bool = False):
        """Register `factory` under `name`; usable as a decorator."""
        def _do(fn: Callable) -> Callable:
            if name in self._items and not override:
                raise ValueError(
                    f"{self.kind} {name!r} is already registered; pass "
                    f"override=True to replace it")
            self._items[name] = fn
            return fn
        return _do if factory is None else _do(factory)

    def get(self, name: str) -> Callable:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; registered {self.kind}s: "
                f"{self.names()}") from None

    def names(self) -> list[str]:
        return sorted(self._items)

    def __contains__(self, name: str) -> bool:
        return name in self._items


MODELS = Registry("model")
DATASETS = Registry("dataset")
SCHEMES = Registry("scheme")
DATA_SELECTION = Registry("data-selection policy")
CHANNEL_NOISE = Registry("channel-noise model")
FAULT_MODELS = Registry("fault model")
LOCAL_SCHEMES = Registry("local-update scheme")

register_model = MODELS.register
register_dataset = DATASETS.register
register_scheme = SCHEMES.register
register_data_selection = DATA_SELECTION.register
register_channel_noise = CHANNEL_NOISE.register
register_fault_model = FAULT_MODELS.register
register_local_scheme = LOCAL_SCHEMES.register


# ---------------------------------------------------------------------------
# Models. A factory receives the resolved dataset (image shape and class
# count) and returns (init(gen, device=None) -> params, apply).
# ---------------------------------------------------------------------------

@register_model("lenet")
def _lenet(spec: ModelSpec, dataset) -> tuple[Callable, Callable]:
    in_ch = int(dataset.image_shape[2])
    nc = int(dataset.num_classes)
    kw = dict(spec.kwargs)
    return (lambda gen, device=None: lenet_init(
                gen, in_channels=in_ch, num_classes=nc, device=device, **kw),
            lenet_apply)


@register_model("mlp-edge")
def _mlp_edge(spec: ModelSpec, dataset) -> tuple[Callable, Callable]:
    h, w, c = dataset.image_shape
    nc = int(dataset.num_classes)
    kw = dict(spec.kwargs)
    return (lambda gen, device=None: mlp_edge_init(
                gen, in_dim=h * w * c, num_classes=nc, device=device, **kw),
            mlp_edge_apply)


@register_model("resnet")
def _resnet(spec: ModelSpec, dataset) -> tuple[Callable, Callable]:
    in_ch = int(dataset.image_shape[2])
    nc = int(dataset.num_classes)
    kw = {"depth": 20, **spec.kwargs}
    return (lambda gen, device=None: resnet_init(
                gen, in_channels=in_ch, num_classes=nc, device=device, **kw),
            resnet_apply)


# ---------------------------------------------------------------------------
# Datasets: the two synthetic substrates and the fleet-scale rosters.
# ---------------------------------------------------------------------------

def _make_synthetic(name: str):
    def factory(spec: DataSpec):
        return make_dataset(name, n_train=spec.n_train, n_test=spec.n_test,
                            noise=spec.noise, seed=spec.seed)
    return factory


for _name in ("synthetic-mnist", "synthetic-cifar10"):
    register_dataset(_name, _make_synthetic(_name))


def _make_fleet_dataset(name: str):
    """Fleet-scale virtual rosters (data/fleet.py): DataSpec.n_clients IS
    the population (1e2..1e6); clients generate lazily on first touch, so
    building the dataset costs O(population) scalars, not samples."""
    def factory(spec: DataSpec):
        from repro_torch.data.fleet import make_fleet
        return make_fleet(name, population=spec.n_clients,
                          n_train=spec.n_train, n_test=spec.n_test,
                          sigma=spec.sigma, noise=spec.noise, seed=spec.seed)
    return factory


for _name in ("synthetic-fleet", "synthetic-fleet-cifar"):
    register_dataset(_name, _make_fleet_dataset(_name))


# ---------------------------------------------------------------------------
# Schemes: the paper's Sec.-V comparisons, as the JAX package defines them.
# SchemeSpec.ao overrides win over the scheme definition.
# ---------------------------------------------------------------------------

_PAPER_BASE: dict[str, Any] = dict(outer_iters=3, selection_method="paper",
                                   phi_coupling="mean")


def _scheme(**fields):
    def factory(spec: SchemeSpec) -> AOConfig:
        return AOConfig(**{**fields, **spec.ao})
    return factory


register_scheme("proposed", _scheme(**_PAPER_BASE))
register_scheme("proposed_exact", _scheme(outer_iters=3,
                                          selection_method="exact"))
register_scheme("no_gen", _scheme(use_phi=False, **_PAPER_BASE))
register_scheme("fixed_pruning", _scheme(fix_lambda=0.0, **_PAPER_BASE))
register_scheme("fixed_selection", _scheme(fix_selection=True, **_PAPER_BASE))
register_scheme("fixed_power", _scheme(fix_power=0.5, **_PAPER_BASE))
register_scheme("fixed_clock", _scheme(fix_freq=True, **_PAPER_BASE))


@register_scheme("random_k")
def _random_k(spec: SchemeSpec):
    """The fleet-scale baseline: the factory returns a solver callable that
    replaces Algorithm 1. SchemeSpec.ao carries {"k": clients a round,
    "lam": fixed pruning ratio, "seed": draw}."""
    from repro_torch.core.optimizer_ao import solve_random
    k = int(spec.ao.get("k", 8))
    lam = float(spec.ao.get("lam", 0.0))
    seed = int(spec.ao.get("seed", 0))

    def solve(phi, e0, t0, h_up, h_down, sp, consts):
        return solve_random(phi, e0, t0, h_up, h_down, sp, consts,
                            k=k, lam=lam, seed=seed)
    return solve


# ---------------------------------------------------------------------------
# Data-selection policies (SchemeSpec.data_selection): each client's shard
# filtered once, before the trainer is built (core/selection.py).
# ---------------------------------------------------------------------------

@register_data_selection("none")
def _data_selection_none(spec: SchemeSpec):
    return None


def _data_selection_policy(policy: str):
    def factory(spec: SchemeSpec):
        from repro_torch.core.federated import ClientData
        from repro_torch.core.selection import data_selection_keep_mask
        kw = dict(spec.data_selection_kwargs)

        def apply(clients):
            out = []
            for c in clients:
                keep = data_selection_keep_mask(c.x, c.y, policy=policy, **kw)
                out.append(ClientData(c.x[keep], c.y[keep]))
            return out
        return apply
    return factory


register_data_selection("threshold", _data_selection_policy("threshold"))
register_data_selection("fine_grained", _data_selection_policy("fine_grained"))


# ---------------------------------------------------------------------------
# Channel-noise models (WirelessSpec.noise_model): drawn a round, keyed by
# the round index only.
# ---------------------------------------------------------------------------

@register_channel_noise("none")
def _channel_noise_none(spec: WirelessSpec):
    return None


@register_channel_noise("gaussian")
def _channel_noise_gaussian(spec: WirelessSpec):
    from repro_torch.wireless.channel import GaussianAggregateNoise
    kw = dict(spec.noise_kwargs)
    kw.setdefault("seed", spec.seed)
    return GaussianAggregateNoise(**kw)


# ---------------------------------------------------------------------------
# Fault models (WirelessSpec.fault_model): draws keyed (seed, round, kind).
# ---------------------------------------------------------------------------

@register_fault_model("none")
def _fault_none(spec: WirelessSpec):
    return None


def _fault_factory(cls_name: str):
    def factory(spec: WirelessSpec):
        from repro_torch.core import faults
        kw = dict(spec.fault_kwargs)
        kw.setdefault("seed", spec.seed)
        return getattr(faults, cls_name)(**kw)
    return factory


register_fault_model("dropout", _fault_factory("ClientDropout"))
register_fault_model("straggler", _fault_factory("StragglerTimeout"))
register_fault_model("corrupt", _fault_factory("CorruptUpload"))
register_fault_model("mixed", _fault_factory("MixedFaults"))
register_fault_model("sign_flip", _fault_factory("SignFlip"))
register_fault_model("scaled_malicious", _fault_factory("ScaledMalicious"))
register_fault_model("gaussian_poison", _fault_factory("GaussianPoison"))


# ---------------------------------------------------------------------------
# Local-update schemes (SchemeSpec.local_scheme): a core/local.LocalScheme,
# or None for single-step fedavg, which is FedSGD itself. Unknown
# local_kwargs keys raise at build time.
# ---------------------------------------------------------------------------

def _local_scheme_factory(name: str):
    def factory(spec: SchemeSpec):
        return make_local_scheme(name, steps=spec.local_steps,
                                 **spec.local_kwargs)
    return factory


for _name in ("fedavg", "fedprox", "feddyn"):
    register_local_scheme(_name, _local_scheme_factory(_name))

