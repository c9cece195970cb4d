"""Declarative experiment specs (DESIGN.md §8).

The port of ``repro/api/spec.py``, unchanged: one spec file runs in either
package. ``run.shards`` > 1 shards the client axis over that many ranks of
a process group (launch/mesh.py; the CLI spawns them); the scheme's
``local_scheme``, ``local_steps`` and ``local_kwargs`` reach the trainer,
``client_store="streamed"`` and the fleet datasets stream cohorts, and
``resnet`` builds ResNet-CIFAR.

One `ExperimentSpec` captures everything the paper's pipeline needs — data
federation, model, wireless system, optimization scheme, and run policy —
as a tree of plain dataclasses that round-trips losslessly through
dict/JSON (`to_dict`/`from_dict`, `to_json`/`from_json`).  String-valued
fields (`data.dataset`, `model.name`, `scheme.name`) are resolved through
the component registries (repro_torch.api.registry) at build time, so new
datasets / models / schemes plug in without touching the pipeline wiring.

The spec is *inert*: constructing one performs no work and imports no
heavyweight machinery.  `repro_torch.api.experiment.Experiment` turns it into a
built `Run`.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


class SpecError(ValueError):
    """A spec dict does not match the declared schema."""


def _check_keys(cls, d: dict, where: str) -> None:
    if not isinstance(d, dict):
        raise SpecError(f"{where}: expected a dict, got {type(d).__name__}")
    valid = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(d) - valid)
    if unknown:
        raise SpecError(
            f"{where}: unknown key(s) {unknown}; valid keys: {sorted(valid)}")


class _SpecBase:
    """Shared dict/JSON plumbing. Subclasses set _NESTED for spec-typed
    fields so `from_dict` recurses with per-field error context."""

    _NESTED: dict[str, type] = {}

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict, *, _where: str | None = None):
        where = _where or cls.__name__
        _check_keys(cls, d, where)
        kw: dict[str, Any] = {}
        for k, v in d.items():
            sub = cls._NESTED.get(k)
            kw[k] = (sub.from_dict(v, _where=f"{where}.{k}")
                     if sub is not None else v)
        return cls(**kw)

    def to_json(self, *, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, s: str):
        return cls.from_dict(json.loads(s))


@dataclasses.dataclass
class DataSpec(_SpecBase):
    """The federated data substrate: dataset + Dirichlet(sigma) partition."""

    dataset: str = "synthetic-mnist"   # registry key (repro_torch.api.registry)
    n_clients: int = 10
    sigma: float = 1.0                 # Dirichlet concentration (non-IIDness)
    n_train: int = 4000
    n_test: int = 800
    noise: float = 0.35                # synthetic template-to-noise ratio
    seed: int = 0                      # dataset generation + partition rng


@dataclasses.dataclass
class ModelSpec(_SpecBase):
    """The client model; `kwargs` reach the registered init factory
    (e.g. {"depth": 20} for resnet, {"hidden": 128} for mlp-edge)."""

    name: str = "lenet"                # registry key
    kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class WirelessSpec(_SpecBase):
    """The wireless edge system (paper Table I) and the run budgets.

    `noise_model` picks a registered aggregation-channel noise model
    (repro_torch.api.registry CHANNEL_NOISE; "none" = the paper's noiseless
    aggregation, "gaussian" = AWGN on the averaged gradient à la Wu et
    al.); `noise_kwargs` reach its factory (e.g. {"std": 1e-3} — the draw
    seed defaults to this spec's `seed`).

    `fault_model` picks a registered client fault model
    (repro_torch.api.registry FAULT_MODELS; "none" = the paper's always-reliable clients, "dropout" /
    "straggler" / "corrupt" / "mixed" = core/faults.py injections);
    `fault_kwargs` reach its factory (e.g. {"rate": 0.2} — the draw seed
    defaults to this spec's `seed`). Like the noise axis it is sweepable:
    accuracy-vs-dropout-rate is a one-line `cli sweep` over
    `wireless.fault_kwargs.rate`."""

    table: str = "auto"                # "mnist" | "cifar10" | "auto" (by dataset)
    e0: float = 4.0                    # energy budget E0 [J]
    t0: float = 40.0                   # delay budget T0 [s]
    path_loss: float = 1e-5
    seed: int = 0                      # Rayleigh channel draw
    noise_model: str = "none"          # registry key (CHANNEL_NOISE)
    noise_kwargs: dict = dataclasses.field(default_factory=dict)
    fault_model: str = "none"          # registry key (FAULT_MODELS)
    fault_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SchemeSpec(_SpecBase):
    """The joint-optimization scheme (P1 / Algorithm 1) and its constants.

    `name` picks one of the registered schemes (the paper's six comparisons
    plus `proposed_exact`); `ao` overrides AOConfig fields on top of the
    scheme's definition (e.g. {"outer_iters": 1} for smoke runs) and
    `bound` overrides BoundConstants fields beyond the ones derived from
    (rounds, batch, eta). `data_selection` picks a registered per-client
    data-selection policy (repro_torch.api.registry DATA_SELECTION; "none",
    "threshold", "fine_grained" — Albaseer-style sample curation applied
    once per run, see core/selection.py) with `data_selection_kwargs`
    reaching its factory (e.g. {"keep_frac": 0.8}).

    `aggregator` picks the server-side reduction of the per-client
    gradient stack (core/aggregators.py AGGREGATORS; "mean" = the paper's
    weighted mean and the bitwise-identical default, "coord_median" /
    "trimmed_mean" / "norm_clip" / "multi_krum" = the Byzantine-robust
    reducers) with `aggregator_kwargs` reaching its factory (e.g.
    {"beta": 0.2}). Sweepable like every other axis — attacker fraction x
    aggregator is a two-axis `cli sweep` (benchmarks/robust_aggregation.py
    runs exactly that grid).

    `local_scheme` picks the client-local update rule between uploads
    (repro_torch.api.registry LOCAL_SCHEMES; "fedavg" = plain local SGD — with
    `local_steps=1` it IS the paper's FedSGD and rides the identical code
    path bit for bit — "fedprox" / "feddyn" = the proximal / dynamic-
    regularizer multi-epoch baselines, core/local.py + DESIGN.md §14);
    `local_steps` is E, the local gradient steps per round, and
    `local_kwargs` reach the scheme factory (e.g. {"mu": 0.01} for
    fedprox, {"alpha": 0.1} for feddyn). Sweepable like every other axis:
    generalization-gap-vs-E is a one-line `cli sweep` over
    `scheme.local_steps`, mu/alpha via `scheme.local_kwargs.mu`."""

    name: str = "proposed"             # registry key
    rounds: int = 60                   # S+1 (schedule length)
    eta: float = 0.1
    batch: int = 32
    ao: dict = dataclasses.field(default_factory=dict)
    bound: dict = dataclasses.field(default_factory=dict)
    data_selection: str = "none"       # registry key (DATA_SELECTION)
    data_selection_kwargs: dict = dataclasses.field(default_factory=dict)
    aggregator: str = "mean"           # registry key (core AGGREGATORS)
    aggregator_kwargs: dict = dataclasses.field(default_factory=dict)
    local_scheme: str = "fedavg"       # registry key (LOCAL_SCHEMES)
    local_steps: int = 1               # E local gradient steps per round
    local_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RunSpec(_SpecBase):
    """Execution policy: backends, eval cadence, checkpointing.

    `client_store` picks how client data reaches the device on the block
    path: "replicated" = the PR-3 full on-device ClientStore, "streamed" =
    per-block cohort prefetch for fleet-scale populations
    (core/cohort_store.py), "auto" (default) = replicated while the
    estimated store footprint fits `device_mem_budget` (bytes; None = the
    REPRO_DEVICE_MEM_BUDGET env or 1 GiB), streamed beyond it. Streaming
    moves data only — trajectories are bitwise the replicated ones."""

    seed: int = 0                      # trainer batch rng + model init key
    eval_every: int = 10
    evaluate: bool = True              # run test-set eval at the cadence
    stop_on_budget: bool = True        # stop when cumulative E/T pass E0/T0
    backend: str = "packed"            # FederatedTrainer backend
    rounds_per_dispatch: int | str = "auto"
    shards: int | None = None          # client-axis ranks (None = auto)
    client_store: str = "auto"         # "auto" | "replicated" | "streamed"
    device_mem_budget: int | None = None   # bytes; None = env or 1 GiB
    checkpoint_dir: str | None = None
    # rounds between checkpoints; None with a checkpoint_dir set falls
    # back to the eval cadence (a dir alone is a request to checkpoint)
    checkpoint_every: int | None = None


@dataclasses.dataclass
class ExperimentSpec(_SpecBase):
    """The full declarative experiment: data x model x wireless x scheme x run."""

    data: DataSpec = dataclasses.field(default_factory=DataSpec)
    model: ModelSpec = dataclasses.field(default_factory=ModelSpec)
    wireless: WirelessSpec = dataclasses.field(default_factory=WirelessSpec)
    scheme: SchemeSpec = dataclasses.field(default_factory=SchemeSpec)
    run: RunSpec = dataclasses.field(default_factory=RunSpec)

    _NESTED = {"data": DataSpec, "model": ModelSpec, "wireless": WirelessSpec,
               "scheme": SchemeSpec, "run": RunSpec}

    @classmethod
    def from_file(cls, path: str) -> "ExperimentSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path
