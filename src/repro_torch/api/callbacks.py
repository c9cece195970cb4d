"""Run lifecycle hooks and the checkpoint/resume state protocol.

The port of ``repro/api/callbacks.py``, with the same checkpoint contents,
so a checkpoint of either package resumes in the other's trainer (the
batch RNG state is numpy's in both).

Callbacks compose with the device-resident round/block engines by firing
at MATERIALIZATION points only (DESIGN.md §8): the trainer keeps per-round
losses as lazy device arrays so consecutive rounds pipeline, and drains
them in batches at eval rounds, checkpoint rounds, and run end.  A hook
therefore never forces a per-round device->host sync:

  on_round_end(m, trainer)      once per round, in round order, but BATCHED
                                at the next materialization point (m.train_
                                loss is materialized; trainer state may be
                                AHEAD of m.round mid-batch)
  on_eval(m, trainer)           at eval rounds, right after eval_fn; the
                                trainer state is coherent with m.round
  on_block_end(start, k, trainer)  after each multi-round block dispatch
                                (packed backend, rounds_per_dispatch > 1);
                                losses for the block are still lazy
  on_checkpoint(m, trainer)     at rounds where m.round % checkpoint_every
                                == 0; the trainer treats these rounds as
                                block boundaries, so params / global grad /
                                batch rng are exactly the state after round
                                m.round — what bit-for-bit resume requires

A callback opts into checkpoint rounds by setting `checkpoint_every`; the
trainer unions those rounds with the eval cadence when planning blocks, so
checkpointing never splits the middle of a compiled block.

Checkpoint contents (`save_trainer_state`): params + global grad v (as
trees through CheckpointManager's npz layer), FedDyn's per-client state
``h`` when the trainer carries one (the leaf ``"['h']"``, as the JAX
package writes it), plus JSON `extra` with
the numpy batch-RNG state, the wireless budget counters, the round index,
the originating spec, and the materialized history — everything needed to
resume an interrupted run bit-for-bit on fp32 (tests/test_torch_api.py).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.federated import RoundMetrics


class Callback:
    """Base lifecycle hook set; subclass and override what you need."""

    # When set (int >= 1), the trainer fires on_checkpoint at rounds where
    # round % checkpoint_every == 0 with state coherent at that round.
    checkpoint_every: int | None = None

    def on_round_end(self, m: RoundMetrics, trainer) -> None:
        pass

    def on_eval(self, m: RoundMetrics, trainer) -> None:
        pass

    def on_block_end(self, start: int, n_rounds: int, trainer) -> None:
        pass

    def on_checkpoint(self, m: RoundMetrics, trainer) -> None:
        pass


class StopOnEvent(Callback):
    """Cooperative interrupt: raise `exc_type` at the next materialization
    point once `event` (a threading.Event) is set, so an interrupt stops a
    run at a round or block boundary, never mid-dispatch, leaving the last
    checkpoint intact for bit-for-bit resume."""

    def __init__(self, event, exc_type=KeyboardInterrupt):
        self.event = event
        self.exc_type = exc_type

    def _check(self) -> None:
        if self.event.is_set():
            raise self.exc_type

    def on_round_end(self, m: RoundMetrics, trainer) -> None:
        self._check()

    def on_block_end(self, start: int, n_rounds: int, trainer) -> None:
        self._check()


def metrics_to_dict(m: RoundMetrics) -> dict:
    return dataclasses.asdict(m)


def metrics_from_dict(d: dict) -> RoundMetrics:
    if d.get("train_loss") is None:
        # strict-JSON exports write nan as null (see RunResult.to_jsonl)
        d = {**d, "train_loss": float("nan")}
    return RoundMetrics(**d)


def save_trainer_state(
    manager: CheckpointManager, trainer, m: RoundMetrics, *,
    spec: dict | None = None, history: Sequence[RoundMetrics] = (),
) -> str:
    """Checkpoint the full resume state after round `m.round`.

    Must be called at a coherent point (on_checkpoint / on_eval): the
    trainer's params, global gradient, and batch RNG have to reflect
    exactly the state after round m.round."""
    tree = {"params": trainer.params, "v": trainer.global_grad}
    if getattr(trainer, "_h", None) is not None:
        # FedDyn's per-client state: an fp32 leaf like the rest, so resume
        # restores it bit for bit
        tree["h"] = trainer._h
    extra = {
        "round": int(m.round),
        "rng_state": trainer.rng.bit_generator.state,
        "cumulative_delay": float(m.cumulative_delay),
        "cumulative_energy": float(m.cumulative_energy),
        "spec": spec,
        "history": [metrics_to_dict(h) for h in history],
        # counters accumulate only over EXECUTED rounds, so a resumed run
        # must start from the checkpointed totals to match an
        # uninterrupted run's (tests/test_faults.py, test_aggregators.py)
        "fault_counters": dict(getattr(trainer, "fault_counters", {})),
        "agg_counters": dict(getattr(trainer, "agg_counters", {})),
    }
    return manager.save(int(m.round), tree, extra=extra)


def restore_trainer_state(
    manager: CheckpointManager, trainer, *, step: int | None = None,
) -> dict:
    """Load a checkpoint into `trainer` (params, global grad, batch RNG)
    and return the JSON `extra` dict (round index, counters, spec,
    history). The restored fp32 leaves are exact, so continuing from
    extra["round"] + 1 replays the uninterrupted trajectory bit-for-bit.
    FedDyn's state is copied into the trainer's own tensor, which the
    trainer's captured CUDA graphs update."""
    like = {"params": trainer.params, "v": trainer.global_grad}
    ls = getattr(trainer, "local_scheme", None)
    if ls is not None and ls.stateful:
        like["h"] = trainer._ensure_h()
    tree, meta = manager.restore(like, step=step)
    trainer.params = tree["params"]
    trainer.global_grad = tree["v"]
    if "h" in like:
        trainer._h.copy_(tree["h"])
    extra = meta.get("extra", {})
    if "rng_state" in extra:
        trainer.rng.bit_generator.state = extra["rng_state"]
    if extra.get("fault_counters"):
        trainer.fault_counters = dict(extra["fault_counters"])
    if extra.get("agg_counters"):
        trainer.agg_counters = dict(extra["agg_counters"])
    return extra


def load_run_state(directory: str, *, step: int | None = None,
                   prefix: str = "ckpt") -> tuple[int, dict]:
    """Read a checkpoint's JSON metadata WITHOUT building a trainer —
    (step, extra). The CLI uses this to recover the originating spec.
    With step=None picks the newest INTACT checkpoint (skipping truncated
    ones), matching the step `restore_trainer_state` will load."""
    manager = CheckpointManager(directory, prefix=prefix)
    step = manager.latest_intact_step() if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {directory!r}")
    with open(manager.meta_path(step)) as f:
        meta = json.load(f)
    return step, meta.get("extra", {})


class CheckpointCallback(Callback):
    """Periodic bit-for-bit resume checkpoints through CheckpointManager.

    Accumulates the materialized history via on_round_end (the objects are
    updated in place when eval fills in test metrics, so the saved history
    carries them) and snapshots the full resume state every
    `checkpoint_every` rounds. Pass `history=` when resuming so later
    checkpoints keep the full from-round-0 history."""

    def __init__(self, directory: str, every: int, *,
                 spec: dict | None = None, keep: int = 3,
                 history: Sequence[RoundMetrics] = ()):
        if every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {every}")
        self.manager = CheckpointManager(directory, keep=keep)
        self.checkpoint_every = int(every)
        self.spec = spec
        self.history: list[RoundMetrics] = list(history)
        self.saved_paths: list[str] = []

    def on_round_end(self, m: RoundMetrics, trainer) -> None:
        self.history.append(m)

    def on_checkpoint(self, m: RoundMetrics, trainer) -> None:
        # a sharded run's ranks hold the same state: rank 0 writes it (the
        # others keep the checkpoint rounds as block boundaries all the
        # same, so every rank runs the same blocks)
        if getattr(trainer, "rank", 0) != 0:
            return
        self.saved_paths.append(save_trainer_state(
            self.manager, trainer, m, spec=self.spec, history=self.history))
