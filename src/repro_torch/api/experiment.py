"""Experiment -> Run -> RunResult: the unified entry point (DESIGN.md §8).

The port of ``repro/api/experiment.py``. A spec builds the same dataset,
federation, phi, wireless system and schedule as in the JAX package (the
port's numpy copies), and `RunResult.to_jsonl` writes the same JSON-lines
format, so `benchmarks/report.py` and the JAX package's
`RunResult.from_jsonl` read the port's results unchanged. The trainer runs
on CUDA unless `Experiment.build(device="cpu")`; the model's initial
weights come from a `torch.Generator` seeded with ``run.seed``.

Replaces the seven manually-wired steps (dataset -> Dirichlet partition ->
phis -> SystemParams/ChannelModel -> solve_p1 -> FederatedTrainer -> run)
with one declarative flow:

    spec = ExperimentSpec(...)            # or ExperimentSpec.from_file(p)
    run = Experiment(spec).build()        # resolves registries, solves P1
    result = run.run()                    # RunResult (JSONL-exportable)
    result = run.resume("ckpt_dir")       # bit-for-bit continuation

`Experiment.build` is deterministic in the spec (every RNG is seeded from
it), so the same spec always yields the same schedule and trajectory —
which is what makes checkpoint resume (`Run.resume`) reconstructible from
the spec stored inside the checkpoint. The environment half (dataset,
clients, phi, wireless system, model/loss/eval functions) is scheme-
independent and reusable across schemes via `build(env=...)` — the
benchmark harness sweeps the seven schemes over one environment that way.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.api.callbacks import (
    Callback, CheckpointCallback, metrics_from_dict, metrics_to_dict,
    restore_trainer_state,
)
from repro_torch.api.registry import (
    CHANNEL_NOISE, DATA_SELECTION, DATASETS, FAULT_MODELS, LOCAL_SCHEMES,
    MODELS, SCHEMES,
)
from repro_torch.api.spec import ExperimentSpec
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import (
    BoundConstants, ClientData, FederatedTrainer, RoundMetrics, phis,
    solve_p1,
)
from repro_torch.core.aggregators import make_aggregator
from repro_torch.core.local import local_spec_key
from repro_torch.core.optimizer_ao import Schedule
from repro_torch.data import partition_by_dirichlet
from repro_torch.device import resolve_device
from repro_torch.models import make_eval_fn, make_loss_fn
from repro_torch.wireless import ChannelModel, SystemParams


@dataclasses.dataclass
class Environment:
    """The scheme-independent half of a built experiment."""

    spec: ExperimentSpec
    dataset: Any                      # SyntheticImageDataset-like
    clients: Sequence                 # list[ClientData]
    phi: np.ndarray                   # [N] generalization statements (Lemma 1)
    sp: SystemParams
    ch: ChannelModel
    init_fn: Callable
    apply_fn: Callable
    loss_fn: Callable
    eval_fn: Callable
    device: torch.device


def build_environment(spec: ExperimentSpec, *,
                      device=None) -> Environment:
    """Steps 1-4 of the pipeline: data, federation, phi, wireless system,
    model/loss/eval functions — everything the scheme solver and trainer
    consume. Pure in the spec (all randomness seeded from it). The test set
    and the model live on `device` (None: CUDA).
    `build_environment.n_builds` counts invocations."""
    build_environment.n_builds += 1
    device = resolve_device(device)
    d = spec.data
    dataset = DATASETS.get(d.dataset)(d)
    nc = int(dataset.num_classes)
    test_hist = np.bincount(dataset.y_test, minlength=nc).astype(float)
    parts = partition_by_dirichlet(dataset.y_train, d.n_clients, d.sigma,
                                   rng=np.random.default_rng(d.seed))
    clients = [ClientData(dataset.x_train[i], dataset.y_train[i])
               for i in parts]
    phi = phis(np.stack([c.label_histogram(nc) for c in clients]),
               test_hist[None])
    table = spec.wireless.table
    if table == "auto":
        table = "mnist" if "mnist" in d.dataset else "cifar10"
    sp = SystemParams.table1(d.n_clients, dataset=table,
                             batch_size=spec.scheme.batch)
    ch = ChannelModel(d.n_clients, path_loss=spec.wireless.path_loss,
                      seed=spec.wireless.seed)
    init_fn, apply_fn = MODELS.get(spec.model.name)(spec.model, dataset)
    return Environment(
        spec=spec, dataset=dataset, clients=clients, phi=phi, sp=sp, ch=ch,
        init_fn=init_fn, apply_fn=apply_fn,
        loss_fn=make_loss_fn(apply_fn),
        eval_fn=make_eval_fn(apply_fn, dataset.x_test, dataset.y_test,
                             device=device),
        device=device)


build_environment.n_builds = 0


def _json_finite(obj):
    """Replace non-finite floats with None, recursively (strict JSON)."""
    if isinstance(obj, float):
        return obj if np.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_finite(v) for v in obj]
    return obj


@dataclasses.dataclass
class RunResult:
    """Structured outcome of a run: the solved schedule, the per-round
    history (train losses, selections, the energy/delay ledger, eval
    points), and a summary block. Serializes to JSON-lines — one header
    record then one record per round — so figure scripts, the bench
    harness, and external tooling share one metrics format
    (benchmarks/report.py ingests these)."""

    spec: dict
    summary: dict
    history: list[RoundMetrics]
    schedule: Schedule | None = None   # arrays kept in-process only

    @classmethod
    def build(cls, spec: ExperimentSpec, schedule: Schedule,
              history: list[RoundMetrics], *,
              resumed_from: int | None = None,
              faults: dict | None = None,
              aggregation: dict | None = None) -> "RunResult":
        evals = [(m.test_accuracy, m.round) for m in history
                 if m.test_accuracy is not None]
        acc, acc_round = evals[-1] if evals else (float("nan"), -1)
        last = history[-1] if history else None
        summary = {
            "theta": float(schedule.theta),
            "energy": float(schedule.energy),
            "delay": float(schedule.delay),
            "feasible": bool(schedule.feasible),
            "rounds_run": len(history),
            "final_accuracy": acc,
            "final_accuracy_round": acc_round,
            "cumulative_delay": last.cumulative_delay if last else 0.0,
            "cumulative_energy": last.cumulative_energy if last else 0.0,
            "resumed_from": resumed_from,
        }
        if faults:
            # present only when a fault model is active or the always-on
            # guard actually fired — a healthy fault-free run's summary
            # stays byte-identical to pre-fault-layer outputs (the golden
            # test compares the whole dict)
            summary["faults"] = dict(faults)
        if aggregation:
            # present only under a robust (non-mean) aggregator, by the
            # same golden-stability argument: clean mean summaries stay
            # byte-identical
            summary["aggregation"] = dict(aggregation)
        return cls(spec=spec.to_dict(), summary=summary, history=history,
                   schedule=schedule)

    def to_jsonl(self, path: str) -> str:
        # strict JSON: non-finite floats (nan train_loss of an empty
        # round, nan final_accuracy of an eval-free run) become null so
        # jq/JS/log pipelines can parse every line, not just Python
        with open(path, "w") as f:
            f.write(json.dumps(_json_finite(
                {"kind": "experiment", "spec": self.spec,
                 "summary": self.summary}), allow_nan=False) + "\n")
            for m in self.history:
                f.write(json.dumps(_json_finite(
                    {"kind": "round", **metrics_to_dict(m)}),
                    allow_nan=False) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path: str) -> "RunResult":
        spec: dict = {}
        summary: dict = {}
        history: list[RoundMetrics] = []
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                kind = rec.pop("kind", "round")
                if kind == "experiment":
                    spec, summary = rec["spec"], rec["summary"]
                elif kind == "round":
                    history.append(metrics_from_dict(rec))
                # unknown kinds (e.g. a sweep index's "sweep_run" records)
                # are skipped for forward compatibility
        return cls(spec=spec, summary=summary, history=history)


class Run:
    """A built experiment: environment + solved schedule + trainer.

    `.run()` executes the schedule from round 0; `.resume(dir)` restores
    the latest (or a chosen) checkpoint and continues from the next round,
    returning the FULL from-round-0 history (checkpointed prefix + newly
    executed rounds). Both honor RunSpec's eval cadence, budget stops, and
    checkpoint policy."""

    def __init__(self, spec: ExperimentSpec, env: Environment,
                 schedule: Schedule, trainer: FederatedTrainer):
        self.spec = spec
        self.env = env
        self.schedule = schedule
        self.trainer = trainer

    def run(self, *, callbacks: Sequence[Callback] = (),
            checkpoint_dir: str | None = None) -> RunResult:
        """Execute from round 0. `checkpoint_dir=` overrides where
        periodic checkpoints land WITHOUT touching the spec, so exported
        headers (which embed the spec) stay byte-identical across
        directories."""
        return self._execute(start_round=0, prefix=[], callbacks=callbacks,
                             checkpoint_dir=checkpoint_dir)

    def resume(self, directory: str | None = None, *,
               step: int | None = None,
               callbacks: Sequence[Callback] = (),
               checkpoint_dir: str | None = None) -> RunResult:
        directory = directory or self.spec.run.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory: pass resume(dir) or "
                             "set spec.run.checkpoint_dir")
        manager = CheckpointManager(directory)
        extra = restore_trainer_state(manager, self.trainer, step=step)
        start = int(extra["round"]) + 1
        prefix = [metrics_from_dict(d) for d in extra.get("history", [])]
        return self._execute(start_round=start, prefix=prefix,
                             callbacks=callbacks,
                             resumed_from=int(extra["round"]),
                             checkpoint_dir=checkpoint_dir)

    def run_or_resume(self, directory: str | None = None, *,
                      callbacks: Sequence[Callback] = ()) -> RunResult:
        """Elastic entry point: `run()` when `directory` holds no intact
        checkpoint, otherwise `resume()` from its newest intact step
        (CheckpointManager.latest_intact_step — torn steps from a kill
        mid-write are skipped). Either way further checkpoints land in
        `directory`, and the result's summary has `resumed_from`
        normalized to None, so an interrupted-then-resumed run exports
        byte-identical JSONL to an uninterrupted one."""
        directory = directory or self.spec.run.checkpoint_dir
        if not directory:
            raise ValueError("no checkpoint directory: pass "
                             "run_or_resume(dir) or set "
                             "spec.run.checkpoint_dir")
        step = None
        if os.path.isdir(directory):
            step = CheckpointManager(directory).latest_intact_step()
        if step is None:
            return self.run(callbacks=callbacks, checkpoint_dir=directory)
        res = self.resume(directory, step=step, callbacks=callbacks,
                          checkpoint_dir=directory)
        res.summary["resumed_from"] = None
        return res

    def _execute(self, *, start_round: int, prefix: list[RoundMetrics],
                 callbacks: Sequence[Callback],
                 resumed_from: int | None = None,
                 checkpoint_dir: str | None = None) -> RunResult:
        rs = self.spec.run
        ckpt_dir = checkpoint_dir or rs.checkpoint_dir
        cbs: list[Callback] = []
        if ckpt_dir:
            # a directory alone is an explicit request to checkpoint:
            # default the cadence to the eval cadence rather than
            # silently writing nothing. The checkpointer goes FIRST so a
            # user hook that raises at the same round (e.g. a kill in
            # tests) observes the saved state.
            cbs.append(CheckpointCallback(
                ckpt_dir, rs.checkpoint_every or rs.eval_every,
                spec=self.spec.to_dict(), history=prefix))
        cbs.extend(callbacks)
        history = self.trainer.run(
            self.schedule, self.env.sp, self.env.ch.uplink,
            self.env.ch.downlink,
            eval_fn=self.env.eval_fn if rs.evaluate else None,
            eval_every=rs.eval_every,
            stop_delay=self.spec.wireless.t0 if rs.stop_on_budget else None,
            stop_energy=self.spec.wireless.e0 if rs.stop_on_budget else None,
            callbacks=cbs, start_round=start_round)
        fc = dict(self.trainer.fault_counters)
        include = self.trainer.fault_model is not None or any(fc.values())
        agg = None
        if self.trainer.aggregator is not None:
            agg = {"aggregator": self.trainer.aggregator.name,
                   **{k: int(v)
                      for k, v in self.trainer.agg_counters.items()}}
        return RunResult.build(self.spec, self.schedule, prefix + history,
                               resumed_from=resumed_from,
                               faults=fc if include else None,
                               aggregation=agg)


class Experiment:
    """Declarative front door: resolve an ExperimentSpec into a Run."""

    def __init__(self, spec: ExperimentSpec):
        self.spec = spec

    @classmethod
    def from_dict(cls, d: dict) -> "Experiment":
        return cls(ExperimentSpec.from_dict(d))

    @classmethod
    def from_file(cls, path: str) -> "Experiment":
        return cls(ExperimentSpec.from_file(path))

    def build(self, *, env: Environment | None = None,
              trainer: FederatedTrainer | None = None,
              device=None) -> Run:
        """Resolve registries, solve (P1), and construct the trainer.

        `env=` reuses a previously built scheme-independent environment
        (same data/model/wireless axes) so scheme sweeps don't rebuild the
        dataset or re-draw the channel.

        `trainer=` additionally reuses a previously built trainer over the
        SAME environment and (eta, batch, backend, shards, data-selection)
        wiring: its engine, captured CUDA graphs and device-resident
        ClientStore survive while `FederatedTrainer.reset` reinitializes
        params, the global gradient, the batch RNG, and every counter from
        this spec — bit-for-bit a cold build.

        `device=` places the environment and trainer (None: CUDA); a
        reused `env` keeps its own."""
        spec = self.spec
        if env is None:
            env = build_environment(spec, device=device)
        else:
            # The environment is scheme-independent EXCEPT for the batch
            # size baked into SystemParams (Table-I bookkeeping): reusing
            # one across specs is only sound when the data/model/wireless
            # axes and the batch agree (budgets e0/t0 — and the trainer-
            # level noise/selection axes — are fine to vary: they only
            # reach solve_p1, the stop conditions, and the trainer).
            es = env.spec
            mismatch = [name for name, a, b in (
                ("data", es.data, spec.data),
                ("model", es.model, spec.model),
                ("scheme.batch", es.scheme.batch, spec.scheme.batch),
                ("wireless.table", es.wireless.table, spec.wireless.table),
                ("wireless.path_loss", es.wireless.path_loss,
                 spec.wireless.path_loss),
                ("wireless.seed", es.wireless.seed, spec.wireless.seed),
            ) if a != b]
            if mismatch:
                raise ValueError(
                    "build(env=...) reuse requires matching environment "
                    f"axes; spec differs from env.spec on: {mismatch}")
        sc = spec.scheme
        consts = BoundConstants(rounds_S=sc.rounds - 1, batch_Z=sc.batch,
                                eta=sc.eta, **sc.bound)
        ao = SCHEMES.get(sc.name)(sc)
        if callable(ao):
            # a scheme factory may return a solver callable instead of an
            # AOConfig (e.g. `random_k`): it replaces Algorithm 1 outright
            # — the paper schemes all run O(N) per-client host solves in
            # the (P2)-(P4) subproblems, infeasible at fleet scale
            schedule = ao(env.phi, spec.wireless.e0, spec.wireless.t0,
                          env.ch.uplink, env.ch.downlink, env.sp, consts)
        else:
            schedule = solve_p1(env.phi, spec.wireless.e0, spec.wireless.t0,
                                env.ch.uplink, env.ch.downlink, env.sp,
                                consts, ao)
        noise = CHANNEL_NOISE.get(spec.wireless.noise_model)(spec.wireless)
        fault = FAULT_MODELS.get(spec.wireless.fault_model)(spec.wireless)
        select = DATA_SELECTION.get(sc.data_selection)(sc)
        # robust aggregation (core/aggregators.py): resolved here, like the
        # other string axes; None ("mean") keeps the builtin path
        aggregator = make_aggregator(sc.aggregator, **sc.aggregator_kwargs)
        agg_key = (aggregator.spec_key if aggregator is not None else "mean")
        local = LOCAL_SCHEMES.get(sc.local_scheme)(sc)
        # the port's initial weights: a torch.Generator seeded from the
        # run's seed (not jax.random's, so they differ from the JAX
        # package's weights for the same spec)
        params = env.init_fn(torch.Generator().manual_seed(spec.run.seed),
                             device=env.device)
        if trainer is not None:
            bad = [name for name, a, b in (
                ("scheme.eta", trainer.eta, sc.eta),
                ("scheme.batch", trainer.batch_size, sc.batch),
                ("run.backend", trainer.backend, spec.run.backend),
                # the aggregator is traced into every round graph — a
                # different reducer means a different engine, not a reset
                ("scheme.aggregator", trainer.aggregator_key, agg_key),
                # so is the local-update scheme (step count, coefficients,
                # statefulness all shape the round graph)
                ("scheme.local", trainer.local_key, local_spec_key(local)),
                # the store mode decides replicated-vs-streamed wiring at
                # run(); pooling across modes would silently flip it
                ("run.client_store", trainer.client_store,
                 spec.run.client_store),
            ) if a != b]
            if bad:
                raise ValueError(
                    f"build(trainer=...) reuse requires matching {bad}")
            trainer.reset(params, spec.run.seed, channel_noise=noise,
                          fault_model=fault)
        else:
            clients = select(env.clients) if select is not None \
                else env.clients
            trainer = FederatedTrainer(
                env.loss_fn, params, clients,
                eta=sc.eta, batch_size=sc.batch, seed=spec.run.seed,
                backend=spec.run.backend, shards=spec.run.shards,
                rounds_per_dispatch=spec.run.rounds_per_dispatch,
                channel_noise=noise, fault_model=fault,
                aggregator=aggregator, local_scheme=local,
                client_store=spec.run.client_store,
                device_mem_budget=spec.run.device_mem_budget,
                device=env.device)
            # spec-time OOM guard: fail at build (with the actionable
            # StoreBudgetError) rather than mid-run at the first dispatch
            trainer.check_store_budget()
        return Run(spec, env, schedule, trainer)

    def run(self, *, device=None, **kw) -> RunResult:
        """Convenience: build() then run()."""
        return self.build(device=device).run(**kw)


def resume_from_checkpoint(directory: str, *, step: int | None = None,
                           callbacks: Sequence[Callback] = (),
                           device=None) -> RunResult:
    """Rebuild the experiment from the spec stored INSIDE the checkpoint
    and continue it — the `python -m repro_torch.api.cli resume` entry
    point. `device` as in `Experiment.build`."""
    from repro_torch.api.callbacks import load_run_state
    step, extra = load_run_state(directory, step=step)
    if not extra.get("spec"):
        raise ValueError(f"checkpoint {directory!r} step {step} carries no "
                         "spec; resume via Experiment(spec).build()."
                         "resume(dir) instead")
    spec = ExperimentSpec.from_dict(extra["spec"])
    run = Experiment(spec).build(device=device)
    return run.resume(directory, step=step, callbacks=callbacks)
