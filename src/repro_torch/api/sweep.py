"""Multi-seed sweep engine over ExperimentSpec templates (DESIGN.md §9, §12).

The port of ``repro/api/sweep.py``: the same SweepSpec JSON expands to the
same cells, names and spec hashes in either package, the same manifest and
per-run JSONL files verify under either, and `benchmarks/report.py` reads
the port's sweep directories. Cells run on CUDA unless
``run_sweep(device="cpu")``.

The paper's claims are statistical — Figs. 4-8 are means over seeds and
over scenario knobs (sigma, budgets, heterogeneity) — so the unit of
reproduction above a single run is a *matrix* of runs. `SweepSpec` takes a
base `ExperimentSpec` template plus axis overrides and expands it into a
deterministic run matrix:

    sweep = SweepSpec(
        base=ExperimentSpec(...),
        seeds=[0, 1, 2],                       # run.seed axis
        schemes=["proposed", "no_gen"],        # scheme.name axis
        grid={"data.sigma": [0.5, 5.0]},       # cartesian over field paths
        zip={"wireless.e0": [2.0, 4.0],        # paths varied in lockstep
             "wireless.t0": [20.0, 40.0]})     # (one composite axis)
    result = run_sweep(sweep, sink=JsonlDirSink("runs/"))

Expansion is pure and deterministic in the spec: axes nest in the order
grid (insertion order) -> zip -> schemes -> seeds, with the later axes
varying fastest, and every cell gets a stable, filename-safe name
(`expand()` twice yields the identical matrix — property-tested). Field
paths are validated against the spec tree; a typo fails with the field
path and the valid keys, like every other spec error.

Execution exploits what single runs cannot: one scheme-independent
`Environment` is built per distinct (data, model, wireless, batch) group
and reused through `Experiment.build(env=...)`, and one `FederatedTrainer`
is pooled per (environment, eta, batch, backend, shards, rounds-per-
dispatch, data-selection) family and re-seeded via `FederatedTrainer.
reset` — its captured CUDA graphs and device-resident client store
survive across the matrix, so an S-seed sweep costs far less than S cold
runs while every cell stays bit-for-bit equal to the same spec run
standalone (test-asserted). Each finished `RunResult` is streamed to the
sink AS RUNS FINISH (one per-run JSONL file plus an appended, flushed
index record), so long sweeps are observable and interruptible without
losing completed cells.

Execution is an elastic service (DESIGN.md §12):

  * `workers=N` runs independent cells concurrently on a thread pool.
    On the card the threads share one device and its process-wide state:
    `device.exact_fp32` counts its scopes across threads, graph captures
    run one at a time in "thread_local" mode (`device.CAPTURE_LOCK`), and
    launch counts are added under a lock, the capturing thread's to its
    graph (kernels/counters.py), so concurrent cells keep their bits.
    Environments are shared across workers (one build per `_env_key`,
    guarded by per-key locks); trainer pools are worker-LOCAL, so a
    pooled trainer is never driven from two threads. Per-run records are
    bitwise independent of N (each cell's trajectory depends only on its
    own spec); only sink *index order* and the trainer-build count vary.
  * `resume=True` verifies previously completed cells in the sink
    directory against the `sweep_manifest.json` spec hashes, skips the
    intact ones, re-runs missing/corrupt/failed cells, and picks up
    interrupted cells from their newest intact checkpoint
    (`<dir>/ckpt/<cell>/`, written when the base spec sets
    run.checkpoint_every) — bitwise equal to an uninterrupted run.
  * SIGTERM / KeyboardInterrupt stop every worker cooperatively at the
    next round/block boundary, flush a `sweep_interrupted` index record,
    and re-raise KeyboardInterrupt, so a killed sweep is always
    resumable.

CLI: `python -m repro_torch.api.cli sweep sweep.json --out-dir DIR
[--workers N] [--resume]` (`benchmarks/report.py --runs 'DIR/*.jsonl'`
aggregates mean±std over the seed axis and renders FAILED/TIMEOUT cells).
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import json
import os
import random
import re
import signal
import threading
import time
import traceback
from typing import Any, Callable, Sequence

from repro_torch.api.callbacks import Callback, StopOnEvent
from repro_torch.api.experiment import (
    Environment, Experiment, RunResult, build_environment, _json_finite,
)
from repro_torch.api.spec import ExperimentSpec, SpecError, _SpecBase
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.io import atomic_write_text


# ---------------------------------------------------------------------------
# Field-path overrides
# ---------------------------------------------------------------------------

def override_field(spec: ExperimentSpec, path: str, value: Any):
    """Return a copy of `spec` with the dotted `path` (e.g. "data.sigma",
    "scheme.name", "run.backend") replaced by `value`. Unknown segments
    fail with the offending field path and the valid keys at that level —
    sweep axes get the same actionable errors as spec files.

    Dict-valued fields (the `*_kwargs` factory knobs) descend one more
    level: "wireless.fault_kwargs.rate" replaces just that key in a copy
    of the dict — accuracy-vs-dropout-rate is a one-line sweep axis. Dict
    keys are free-form (they are factory kwargs), so a new key is created
    rather than rejected; scalar leaves still refuse to descend."""
    parts = path.split(".")

    def rec(node, i: int):
        where = ".".join([type(spec).__name__] + parts[:i])
        key = parts[i]
        if isinstance(node, dict):
            new = dict(node)
            if i == len(parts) - 1:
                new[key] = value
            else:
                sub = node.get(key, {})
                if not isinstance(sub, dict):
                    raise SpecError(
                        f"{where}: cannot descend into non-dict entry "
                        f"{key!r} with {'.'.join(parts[i + 1:])!r}")
                new[key] = rec(sub, i + 1)
            return new
        if not dataclasses.is_dataclass(node):
            raise SpecError(
                f"{where}: cannot descend into non-spec field with "
                f"{'.'.join(parts[i:])!r}")
        valid = {f.name for f in dataclasses.fields(node)}
        if key not in valid:
            raise SpecError(
                f"{where}: unknown field {key!r} in sweep axis path "
                f"{path!r}; valid keys: {sorted(valid)}")
        if i == len(parts) - 1:
            return dataclasses.replace(node, **{key: value})
        return dataclasses.replace(node,
                                   **{key: rec(getattr(node, key), i + 1)})

    if not path:
        raise SpecError("empty sweep axis path")
    return rec(spec, 0)


def _axis_label(path: str, value: Any) -> str:
    parts = path.split(".")
    # "scheme.name" -> "scheme=...": a bare "name=" label says nothing
    tail = parts[-2] if parts[-1] == "name" and len(parts) > 1 else parts[-1]
    v = value if isinstance(value, (str, int, float, bool)) else \
        json.dumps(value, sort_keys=True)
    return f"{tail}={v}"


def _sanitize(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.=+-]+", "-", name)


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One expanded run: a stable filename-safe name + its full spec."""

    index: int
    name: str
    spec: ExperimentSpec


# ---------------------------------------------------------------------------
# SweepSpec
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SweepSpec(_SpecBase):
    """A base ExperimentSpec template + axis overrides.

    seeds    run.seed values (the innermost / fastest axis);
    schemes  scheme.name values;
    grid     {field path: [values]} — cartesian product, axes nest in
             insertion order;
    zip      {field path: [values]} — all paths varied in lockstep as ONE
             composite axis (every list must have the same length).

    Empty axes are skipped; with no axes at all the sweep is the single
    base run. Round-trips through dict/JSON like every spec."""

    base: ExperimentSpec = dataclasses.field(default_factory=ExperimentSpec)
    seeds: list = dataclasses.field(default_factory=list)
    schemes: list = dataclasses.field(default_factory=list)
    grid: dict = dataclasses.field(default_factory=dict)
    zip: dict = dataclasses.field(default_factory=dict)

    _NESTED = {"base": ExperimentSpec}

    @classmethod
    def from_file(cls, path: str) -> "SweepSpec":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")
        return path

    # -- expansion ----------------------------------------------------------

    def axes(self) -> list[tuple[tuple[str, ...], list[tuple]]]:
        """The ordered axis list: [(paths, [value-tuples])]. grid axes come
        first (insertion order, one path each), then the zip composite
        (all its paths at once), then schemes, then seeds."""
        axes: list[tuple[tuple[str, ...], list[tuple]]] = []
        for path, values in self.grid.items():
            if not isinstance(values, (list, tuple)) or not values:
                raise SpecError(
                    f"sweep grid axis {path!r} needs a non-empty value "
                    f"list, got {values!r}")
            axes.append(((path,), [(v,) for v in values]))
        if self.zip:
            lens = {p: len(v) for p, v in self.zip.items()}
            if len(set(lens.values())) > 1:
                raise SpecError(
                    f"sweep zip axes must have equal lengths, got {lens}")
            if not next(iter(lens.values())):
                raise SpecError("sweep zip axes need non-empty value lists")
            paths = tuple(self.zip)
            axes.append((paths,
                         [tuple(vals) for vals in zip(*self.zip.values())]))
        if self.schemes:
            axes.append((("scheme.name",), [(s,) for s in self.schemes]))
        if self.seeds:
            axes.append((("run.seed",), [(int(s),) for s in self.seeds]))
        return axes

    def expand(self) -> list[SweepCell]:
        """Materialize the deterministic run matrix. The same template
        always yields the same cells in the same order (itertools.product
        over the ordered axes, later axes fastest)."""
        axes = self.axes()
        # validate every path once up front so a typo fails before any run
        for paths, values in axes:
            for p, v in zip(paths, values[0]):
                override_field(self.base, p, v)
        cells: list[SweepCell] = []
        combos = itertools.product(*[vals for _, vals in axes]) if axes \
            else iter([()])
        for i, combo in enumerate(combos):
            spec = self.base
            labels: list[str] = []
            for (paths, _), vals in zip(axes, combo):
                for p, v in zip(paths, vals):
                    spec = override_field(spec, p, v)
                    labels.append(_axis_label(p, v))
            name = _sanitize("_".join(labels)) if labels else "base"
            cells.append(SweepCell(index=i, name=f"{i:03d}_{name}",
                                   spec=spec))
        return cells


# ---------------------------------------------------------------------------
# Manifest + per-cell verification (the elastic-resume protocol)
# ---------------------------------------------------------------------------

MANIFEST_NAME = "sweep_manifest.json"


def spec_hash(spec) -> str:
    """Canonical content hash of an ExperimentSpec (or its dict form):
    sha256 over the sorted-key JSON. Stable across a JSON round-trip —
    floats reparse to the same float, so a cell hashed at expansion time
    matches the spec read back from its per-run JSONL header."""
    d = spec.to_dict() if hasattr(spec, "to_dict") else spec
    return hashlib.sha256(
        json.dumps(d, sort_keys=True).encode()).hexdigest()


def write_manifest(directory: str, cells: Sequence[SweepCell]) -> str:
    """Atomically record the expanded matrix — (index, name, spec hash)
    per cell — as `<directory>/sweep_manifest.json` BEFORE execution
    starts, so a later `--resume` can verify it is continuing the same
    sweep and check each completed cell's output against its hash."""
    payload = {
        "kind": "sweep_manifest",
        "n_cells": len(cells),
        "cells": [{"index": c.index, "name": c.name,
                   "spec_hash": spec_hash(c.spec)} for c in cells],
    }
    path = os.path.join(directory, MANIFEST_NAME)
    atomic_write_text(path, json.dumps(payload, indent=2) + "\n")
    return path


def load_manifest(directory: str) -> dict | None:
    """The recorded manifest, or None when the directory has none (or an
    unreadable one — a torn manifest means nothing can be verified, which
    resume treats the same as absent)."""
    path = os.path.join(directory, MANIFEST_NAME)
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify_cell_run(path: str, expected_hash: str) -> RunResult | None:
    """Parse a cell's per-run JSONL and verify it is the COMPLETE output
    of the expected spec: header present, spec hash matches the manifest,
    and the round history is as long as the summary claims (a truncated
    file fails that). Returns the parsed RunResult, or None when the file
    is missing/corrupt/mismatched — the caller re-runs the cell."""
    try:
        res = RunResult.from_jsonl(path)
    except (OSError, ValueError, TypeError, KeyError):
        return None
    if not res.spec or not res.summary:
        return None
    if spec_hash(res.spec) != expected_hash:
        return None
    if res.summary.get("rounds_run") != len(res.history):
        return None
    return res


# ---------------------------------------------------------------------------
# Streaming sinks
# ---------------------------------------------------------------------------

class RunSink:
    """Streaming consumer of finished runs: `write(name, result)` is
    called AS EACH RUN FINISHES (never post-sweep), `close()` once after
    the last run. Subclass for custom streaming (DBs, sockets, ...).

    The elastic service adds lifecycle hooks, all optional: `begin` fires
    once before execution with the full matrix, `write_skipped` when
    resume verifies a previously completed cell, `write_interrupted` when
    the sweep is stopped by SIGTERM/KeyboardInterrupt, and `resume_scan`
    returns previously completed results to skip. Sinks are context
    managers (`close` on exit) and must tolerate a second `close`."""

    def begin(self, cells: Sequence[SweepCell], *,
              resume: bool = False) -> None:
        """Called once with the expanded matrix before any cell runs."""

    def write(self, name: str, result: RunResult) -> None:
        raise NotImplementedError

    def write_error(self, name: str, spec, exc: BaseException,
                    tb: str, *, kind: str = "error") -> None:
        """Called when a cell fails permanently (after retries). `kind` is
        "error" for an exception and "timeout" for a cell that blew its
        wall-clock deadline (run_sweep cell_timeout). Default: ignore —
        sinks that persist (JsonlDirSink) record the failure."""

    def write_skipped(self, name: str, result: RunResult) -> None:
        """Called (in matrix order, before execution) for each cell that
        resume verified as already complete. Default: ignore."""

    def write_interrupted(self, exc: BaseException) -> None:
        """Called once when the sweep is interrupted, before close()."""

    def resume_scan(self, cells: Sequence[SweepCell]) -> dict[int, RunResult]:
        """{cell index: verified RunResult} for cells this sink already
        holds complete output for. Default: nothing to skip."""
        return {}

    def close(self) -> None:
        pass

    def __enter__(self) -> "RunSink":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


class JsonlDirSink(RunSink):
    """The standard JSONL sink: each finished run lands as
    `<dir>/<name>.jsonl` (the full RunResult — header + per-round records,
    complete and parseable the moment `write` returns) plus one summary
    record appended AND FLUSHED to `<dir>/sweep.jsonl`, so a running sweep
    can be tailed and a killed one keeps every completed cell.
    `benchmarks/report.py --runs '<dir>/*.jsonl'` ingests the per-run
    files (the index's `sweep_run` records are skipped on ingest).

    Concurrency + interruption guarantees (DESIGN.md §12): index appends
    are serialized under a lock and written as one flushed line each, so
    N workers never interleave bytes mid-record and a kill loses at most
    the record being written; per-run files are per-cell (unique names),
    so they never contend. `begin` records the matrix manifest atomically
    (write_manifest) and truncates the index for a FRESH sweep but
    appends for a resumed one — a rejected resume therefore never
    destroys the old index. `close` is idempotent."""

    def __init__(self, directory: str, *, index_name: str = "sweep.jsonl"):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.paths: list[str] = []
        self.index_path = os.path.join(directory, index_name)
        self._index = None          # opened lazily, on the first append
        self._mode = "w"
        self._lock = threading.Lock()
        self._closed = False

    def begin(self, cells: Sequence[SweepCell], *,
              resume: bool = False) -> None:
        self._mode = "a" if resume else "w"
        write_manifest(self.directory, cells)

    def resume_scan(self, cells: Sequence[SweepCell]) -> dict[int, RunResult]:
        """Verify previously completed cells against the recorded
        manifest: {index: RunResult} for every cell whose per-run JSONL
        is intact and hash-matched (verify_cell_run). Raises SpecError
        when the directory holds a DIFFERENT sweep's manifest — resuming
        would silently mix two matrices' results. A directory without a
        manifest (or with a torn one) verifies nothing."""
        manifest = load_manifest(self.directory)
        if manifest is None:
            return {}
        recorded = {c.get("index"): c for c in manifest.get("cells", [])}
        expected = {c.index: {"index": c.index, "name": c.name,
                              "spec_hash": spec_hash(c.spec)} for c in cells}
        if recorded != expected:
            raise SpecError(
                f"resume: {self.directory!r} holds the manifest of a "
                f"different sweep matrix ({len(recorded)} cell(s) recorded "
                f"vs {len(expected)} expanded); refusing to mix results — "
                f"use a fresh --out-dir or drop --resume to overwrite")
        done: dict[int, RunResult] = {}
        for c in cells:
            path = os.path.join(self.directory, f"{c.name}.jsonl")
            if not os.path.exists(path):
                continue
            res = verify_cell_run(path, expected[c.index]["spec_hash"])
            if res is not None:
                done[c.index] = res
        return done

    def _append(self, record: dict) -> None:
        line = json.dumps(_json_finite(record), allow_nan=False) + "\n"
        with self._lock:
            if self._closed:
                raise ValueError(f"sink {self.directory!r} is closed")
            if self._index is None:
                self._index = open(self.index_path, self._mode)
            # one write() of a full line + flush: concurrent workers
            # never interleave bytes, and a tailing consumer (or a kill)
            # always sees whole records
            self._index.write(line)
            self._index.flush()

    def write(self, name: str, result: RunResult) -> None:
        path = os.path.join(self.directory, f"{name}.jsonl")
        result.to_jsonl(path)
        self._append({"kind": "sweep_run", "name": name,
                      "spec": result.spec, "summary": result.summary})
        with self._lock:
            self.paths.append(path)

    def write_error(self, name: str, spec, exc: BaseException,
                    tb: str, *, kind: str = "error") -> None:
        # flushed immediately, like sweep_run records: a tailing consumer
        # (or a post-mortem) sees the failure the moment the cell dies
        self._append(
            {"kind": "sweep_error", "error_kind": kind, "name": name,
             "spec": spec.to_dict() if hasattr(spec, "to_dict") else spec,
             "error": f"{type(exc).__name__}: {exc}",
             "traceback": tb})

    def write_skipped(self, name: str, result: RunResult) -> None:
        # the per-run file already exists (it is what was verified); the
        # index records the skip so a resumed sweep's index still names
        # every cell of the matrix
        self._append({"kind": "sweep_skip", "name": name,
                      "spec": result.spec, "summary": result.summary})
        with self._lock:
            self.paths.append(os.path.join(self.directory, f"{name}.jsonl"))

    def write_interrupted(self, exc: BaseException) -> None:
        self._append({"kind": "sweep_interrupted",
                      "error": f"{type(exc).__name__}: {exc}"})

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._index is not None and not self._index.closed:
                try:
                    self._index.flush()
                finally:
                    self._index.close()


# ---------------------------------------------------------------------------
# Execution: an elastic service with env/trainer reuse across the matrix
# ---------------------------------------------------------------------------

class CellTimeout(RuntimeError):
    """A sweep cell exceeded its wall-clock deadline (run_sweep
    cell_timeout). Deliberately NOT retried: a deterministic cell that
    times out once will time out again, and re-running it just doubles
    the wasted wall-clock."""


class SweepInterrupted(BaseException):
    """The sweep was stopped by SIGTERM / KeyboardInterrupt. A
    BaseException (like KeyboardInterrupt itself) so the per-cell
    `except Exception` retry machinery can never absorb it — an
    interrupt always stops the whole matrix, never burns retries."""


class _DeadlineCallback(Callback):
    """Cooperative per-cell deadline: raises CellTimeout at the next
    materialization point past the deadline. Cooperative because the
    device-resident engines pipeline whole blocks — the check fires at
    round/block boundaries, so a cell can overshoot by at most one
    dispatched block, never hang detection mid-sweep."""

    def __init__(self, seconds: float):
        self.deadline = time.monotonic() + float(seconds)
        self.seconds = float(seconds)

    def _check(self) -> None:
        if time.monotonic() > self.deadline:
            raise CellTimeout(
                f"sweep cell exceeded its {self.seconds:g}s wall-clock "
                f"deadline")

    def on_round_end(self, m, trainer) -> None:
        self._check()

    def on_block_end(self, start: int, n_rounds: int, trainer) -> None:
        self._check()


def _env_key(spec: ExperimentSpec) -> str:
    """Runs sharing this key may share one Environment: the data / model
    axes, the wireless channel draw, and the batch baked into Table-I
    bookkeeping. Budgets (e0/t0) and the trainer-level noise / selection
    axes deliberately stay OUT of the key — they vary freely over a
    reused environment (mirrors Experiment.build's env-reuse contract)."""
    w = spec.wireless
    return json.dumps([spec.data.to_dict(), spec.model.to_dict(),
                       w.table, w.path_loss, w.seed, spec.scheme.batch],
                      sort_keys=True)


def _trainer_key(spec: ExperimentSpec) -> str:
    """Runs sharing an environment AND this key may share one trainer
    (reset between runs): everything that shapes the engine (its captured
    graphs) or the client roster. channel noise is NOT included — it is
    per-round host data, swapped by `reset(channel_noise=...)`."""
    sc, r = spec.scheme, spec.run
    return json.dumps([sc.eta, sc.batch, r.backend, r.shards,
                       r.rounds_per_dispatch, sc.data_selection,
                       sc.data_selection_kwargs, sc.aggregator,
                       sc.aggregator_kwargs, sc.local_scheme, sc.local_steps,
                       sc.local_kwargs, r.client_store,
                       r.device_mem_budget], sort_keys=True)


@dataclasses.dataclass
class SweepResult:
    """Outcome of `run_sweep`: results in matrix order + reuse accounting
    (the env/trainer build counters the acceptance tests assert on).
    A failed cell holds None at its matrix position (so indices line up
    with `cells`) and an error record — {"name", "kind", "error",
    "traceback"} with kind "error" or "timeout" — in `errors`; a sweep
    with any error should exit nonzero (the CLI does). `n_skipped` counts
    cells resume verified and did not re-run (their parsed RunResults sit
    in `results`); `n_worker_crashes` counts workers lost to exceptions
    OUTSIDE the per-cell retry machinery (their in-flight cells were
    requeued on surviving workers)."""

    cells: list[SweepCell]
    results: list[RunResult | None]
    n_env_builds: int
    n_trainer_builds: int
    errors: list[dict] = dataclasses.field(default_factory=list)
    n_skipped: int = 0
    n_worker_crashes: int = 0

    def summary_rows(self) -> list[dict]:
        return [{"name": c.name, **r.summary}
                for c, r in zip(self.cells, self.results) if r is not None]


class _CellRunner:
    """Shared execution state for one run_sweep call: the pending-cell
    queue, the cross-worker environment cache, per-worker trainer pools,
    and lock-serialized sink/log access. One instance is driven either
    serially (workers=1 — today's loop, bit-and-behavior identical) or by
    N daemon worker threads (run_parallel)."""

    def __init__(self, cells: Sequence[SweepCell], *, sink, log, callbacks,
                 max_retries: int, retry_backoff: float,
                 cell_timeout: float | None, interrupt: threading.Event,
                 skipped: dict[int, RunResult], device=None):
        self.cells = list(cells)
        self.device = device
        self.sink = sink
        self.log = log
        self.callbacks = list(callbacks)
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self.cell_timeout = cell_timeout
        self.interrupt = interrupt
        self.skipped = dict(skipped)
        self.results: list[RunResult | None] = [None] * len(self.cells)
        self.errors: dict[int, dict] = {}
        self.n_env = 0
        self.n_trainer = 0
        self.n_worker_crashes = 0
        self.n_done = 0
        self.queue = collections.deque(
            i for i in range(len(self.cells)) if i not in self.skipped)
        self._qlock = threading.Lock()
        # serializes sink + log + counter access: custom RunSinks need no
        # thread safety of their own (JsonlDirSink has its own lock too,
        # for direct use), and progress lines never interleave
        self._io = threading.Lock()
        self.envs: dict[str, Environment] = {}
        self._env_locks: dict[str, threading.Lock] = {}
        self._env_master = threading.Lock()

    # -- shared environment cache ------------------------------------------

    def _get_env(self, ek: str, spec: ExperimentSpec) -> Environment:
        """One build per env key, even under N workers: a per-key lock
        makes the second worker of a family wait for (then reuse) the
        first one's build instead of duplicating it."""
        with self._env_master:
            lock = self._env_locks.setdefault(ek, threading.Lock())
        with lock:
            env = self.envs.get(ek)
            if env is None:
                env = build_environment(spec, device=self.device)
                self.envs[ek] = env
                with self._io:
                    self.n_env += 1
            return env

    # -- queue --------------------------------------------------------------

    def _next(self) -> int | None:
        if self.interrupt.is_set():
            return None
        with self._qlock:
            return self.queue.popleft() if self.queue else None

    def _requeue(self, idx: int) -> None:
        with self._qlock:
            self.queue.appendleft(idx)

    # -- per-cell checkpointing (mid-cell elastic resume) -------------------

    def _ckpt_dir(self, cell: SweepCell) -> str | None:
        """The service-managed checkpoint directory for a cell —
        `<sink dir>/ckpt/<cell name>` — active only when the sink is
        directory-backed and the cell's spec opts into checkpointing
        (run.checkpoint_every set) without naming its own directory. The
        cell SPEC is never mutated: the path rides the checkpoint_dir=
        override of Run.run/run_or_resume, so per-run JSONL headers stay
        byte-identical across sink directories and standalone runs."""
        d = getattr(self.sink, "directory", None)
        rs = cell.spec.run
        if not d or rs.checkpoint_dir or not rs.checkpoint_every:
            return None
        return os.path.join(d, "ckpt", cell.name)

    # -- execution ----------------------------------------------------------

    def record_skip(self, idx: int) -> None:
        cell, res = self.cells[idx], self.skipped[idx]
        self.results[idx] = res
        with self._io:
            self.n_done += 1
            if self.sink is not None:
                self.sink.write_skipped(cell.name, res)
            if self.log is not None:
                self.log(f"[{cell.name}] verified complete — "
                         f"skipped (resume)")

    def run_cell(self, idx: int, trainers: dict) -> None:
        """Execute one cell with the retry/backoff/timeout machinery,
        record the outcome, and maintain the caller's (worker-local)
        trainer pool. Raises SweepInterrupted when the sweep is being
        stopped; lets sink failures escape (the worker loop treats those
        as worker crashes and requeues the cell)."""
        cell = self.cells[idx]
        ek = _env_key(cell.spec)
        tk = ek + "\x00" + _trainer_key(cell.spec)
        ckpt_dir = self._ckpt_dir(cell)
        res = last_exc = last_tb = None
        kind = "error"
        for attempt in range(self.max_retries + 1):
            if self.interrupt.is_set():
                raise SweepInterrupted
            if attempt:
                # exponential backoff, jittered to [0.5, 1.5)x
                delay = (self.retry_backoff * 2.0 ** (attempt - 1)
                         * (0.5 + random.random()))
                time.sleep(delay)
            trainer = trainers.get(tk)
            cbs = list(self.callbacks)
            cbs.append(StopOnEvent(self.interrupt, SweepInterrupted))
            if self.cell_timeout is not None:
                cbs.append(_DeadlineCallback(self.cell_timeout))
            try:
                env = self._get_env(ek, cell.spec)
                run = Experiment(cell.spec).build(env=env, trainer=trainer)
                if trainer is None:
                    trainers[tk] = run.trainer
                    with self._io:
                        self.n_trainer += 1
                if ckpt_dir is not None:
                    res = run.run_or_resume(ckpt_dir, callbacks=cbs)
                else:
                    res = run.run(callbacks=cbs)
                break
            except CellTimeout as exc:
                trainers.pop(tk, None)
                last_exc, last_tb = exc, traceback.format_exc()
                kind = "timeout"
                self._log(f"[{cell.name}] timed out: {exc}")
                break
            except SweepInterrupted:
                trainers.pop(tk, None)     # stopped mid-round: state torn
                raise
            except Exception as exc:
                trainers.pop(tk, None)
                last_exc, last_tb = exc, traceback.format_exc()
                kind = "error"
                self._log(f"[{cell.name}] attempt {attempt + 1} failed: "
                          f"{type(exc).__name__}: {exc}")
        if res is None:
            self.errors[idx] = {"name": cell.name, "kind": kind,
                                "error": (f"{type(last_exc).__name__}: "
                                          f"{last_exc}"),
                                "traceback": last_tb}
            with self._io:
                if self.sink is not None:
                    self.sink.write_error(cell.name, cell.spec, last_exc,
                                          last_tb, kind=kind)
            return
        self.results[idx] = res
        if ckpt_dir is not None and os.path.isdir(ckpt_dir):
            # the result is about to be durable in the sink; the cell's
            # resume checkpoints are dead weight (and would shadow a later
            # sweep's same-named cell). Best-effort: a racing cleanup must
            # not fail the cell.
            try:
                CheckpointManager(ckpt_dir).clear()
            except OSError:
                pass
        with self._io:
            # sink first: if the write dies (worker crash, cell requeued
            # and re-run), the done counter hasn't ticked for it yet
            if self.sink is not None:
                self.sink.write(cell.name, res)
            self.n_done += 1
            if self.log is not None:
                s = res.summary
                self.log(f"[{self.n_done}/{len(self.cells)}] {cell.name}: "
                         f"{s['rounds_run']} rounds, acc "
                         f"{s['final_accuracy']:.3f}")

    def _log(self, msg: str) -> None:
        if self.log is not None:
            with self._io:
                self.log(msg)

    def run_serial(self) -> None:
        """Drain the queue in the calling thread (workers=1, and the
        leftover fallback when every worker thread crashed). Exceptions
        escape to the caller — exactly the pre-elastic behavior."""
        trainers: dict = {}
        while True:
            idx = self._next()
            if idx is None:
                return
            self.run_cell(idx, trainers)

    def _worker_main(self) -> None:
        trainers: dict = {}
        while not self.interrupt.is_set():
            idx = self._next()
            if idx is None:
                return
            try:
                self.run_cell(idx, trainers)
            except SweepInterrupted:
                return           # in-flight cell stays un-recorded: resumable
            except BaseException as exc:
                # a failure OUTSIDE the per-cell machinery (e.g. the sink
                # died mid-write): this worker is done — its pooled
                # trainers go with it — but the matrix is not: the
                # in-flight cell is requeued for a surviving worker (or
                # the serial fallback)
                with self._io:
                    self.n_worker_crashes += 1
                    if self.log is not None:
                        self.log(f"worker crashed on "
                                 f"[{self.cells[idx].name}] "
                                 f"({type(exc).__name__}: {exc}); requeued")
                self._requeue(idx)
                return

    def run_parallel(self, workers: int) -> None:
        """Drive the queue with `workers` daemon threads; on return the
        queue is empty or the sweep was interrupted. Cells left behind by
        crashed workers are drained serially in the calling thread (same
        guarantees as workers=1)."""
        with self._qlock:
            n = min(int(workers), len(self.queue))
        threads = [threading.Thread(target=self._worker_main, daemon=True,
                                    name=f"sweep-worker-{i}")
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive():
                try:
                    t.join()
                except KeyboardInterrupt:
                    # Ctrl-C in the main thread: stop cooperatively, keep
                    # joining so no worker outlives the sweep
                    self.interrupt.set()
        self.run_serial()


def _collective_safe(cells: Sequence[SweepCell]) -> bool:
    """True when thread-parallel cell dispatch cannot deadlock. In the JAX
    package two in-flight programs with collectives over one mesh can
    interleave so that the rendezvous never completes. The port runs every
    engine on one device with no collective (sharding is ROADMAP.md §1
    item 8; a cell with shards > 1 fails at its trainer), so every matrix
    is safe."""
    return True


def _install_sigterm(interrupt: threading.Event):
    """Install a SIGTERM -> cooperative-stop handler (main thread only —
    Python forbids signal.signal elsewhere, and library callers running
    run_sweep in a thread keep their own handling). Returns the previous
    handler to restore, or None when not installed."""
    if threading.current_thread() is not threading.main_thread():
        return None
    try:
        return signal.signal(signal.SIGTERM,
                             lambda signum, frame: interrupt.set())
    except ValueError:
        return None


def run_sweep(sweep: SweepSpec, *, sink: RunSink | None = None,
              log: Callable[[str], None] | None = None,
              callbacks: Sequence = (), max_retries: int = 0,
              retry_backoff: float = 0.5,
              cell_timeout: float | None = None,
              workers: int = 1, resume: bool = False,
              device=None) -> SweepResult:
    """Execute the full matrix, streaming each RunResult to `sink` as it
    finishes. With `workers=1` (default) cells run serially in matrix
    order — today's behavior, bit-for-bit; `workers=N` runs independent
    cells concurrently (worker-local trainer pools + a shared per-key-
    locked environment cache), which changes no per-run record bits, only
    index completion order and the trainer-build count. When a cell's
    engine would issue collectives over more than one device, `workers`
    caps to 1 with a log note (`_collective_safe`; none can until
    multi-device sharding is ported, ROADMAP.md §1 item 8). Environments and
    trainers are pooled by `_env_key` / `_trainer_key`, which preserves
    bit-for-bit equality with standalone runs (reset re-derives every
    piece of run state from the cell's own spec). `callbacks` are passed
    to every run (careful with stateful hooks — one instance sees all
    cells, possibly from several threads).

    Cell failures are ISOLATED: a raising cell is retried up to
    `max_retries` times (for transient failures), sleeping
    `retry_backoff * 2**attempt`, jittered, between attempts so retries
    against a shared resource (filesystem sink, device under contention)
    decorrelate; then recorded — in the sink's index via `write_error`
    and in `SweepResult.errors` — and the rest of the matrix still runs.
    A failed cell's pooled trainer is evicted (the exception may have
    left it mid-round), so retries and later cells build fresh. A crash
    OUTSIDE the cell machinery (e.g. a dying sink) costs one worker: its
    in-flight cell is requeued on the survivors (serially in the main
    thread when none survive, where the failure then surfaces).

    `cell_timeout` (seconds) bounds each cell's wall clock via a
    cooperative deadline checked at round/block materialization points; a
    cell past its deadline raises CellTimeout, is NOT retried
    (deterministic cells time out deterministically), and is recorded
    with kind="timeout".

    `resume=True` asks the sink for previously completed cells
    (`resume_scan` — JsonlDirSink verifies per-run files against the
    sweep_manifest.json spec hashes), emits `write_skipped` for them in
    matrix order, and re-runs only the rest; cells that checkpointed
    mid-run (spec run.checkpoint_every + a directory sink) continue from
    their newest intact step. SIGTERM and KeyboardInterrupt stop all
    workers at the next materialization point, write a
    `sweep_interrupted` sink record, close the sink, and re-raise
    KeyboardInterrupt — a killed sweep is always resumable.

    `device` places every cell's environment and trainer (None: CUDA)."""
    cells = sweep.expand()
    workers = int(workers)
    if workers > 1 and not _collective_safe(cells):
        if log is not None:
            log("sweep: engine collectives over >1 device — cell workers "
                "serialized (concurrent collective dispatch can deadlock); "
                "running with workers=1")
        workers = 1
    skipped: dict[int, RunResult] = {}
    if resume and sink is not None:
        skipped = sink.resume_scan(cells)
    if sink is not None:
        # after resume_scan: a rejected resume (manifest mismatch) must
        # not have overwritten the old manifest or truncated the index
        sink.begin(cells, resume=resume)
    interrupt = threading.Event()
    runner = _CellRunner(cells, sink=sink, log=log, callbacks=callbacks,
                         max_retries=max_retries,
                         retry_backoff=retry_backoff,
                         cell_timeout=cell_timeout, interrupt=interrupt,
                         skipped=skipped, device=device)
    prev_handler = _install_sigterm(interrupt)
    interrupted = False
    try:
        try:
            for idx in sorted(skipped):
                runner.record_skip(idx)
            if workers <= 1:
                runner.run_serial()
            else:
                runner.run_parallel(workers)
        except (KeyboardInterrupt, SweepInterrupted):
            interrupted = True
            interrupt.set()
        interrupted = interrupted or interrupt.is_set()
    finally:
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        try:
            if interrupted and sink is not None:
                sink.write_interrupted(
                    KeyboardInterrupt("sweep interrupted"))
        finally:
            if sink is not None:
                sink.close()
    if interrupted:
        raise KeyboardInterrupt(
            "sweep interrupted — completed cells are preserved in the "
            "sink; relaunch with resume to continue")
    return SweepResult(cells=cells, results=runner.results,
                       n_env_builds=runner.n_env,
                       n_trainer_builds=runner.n_trainer,
                       errors=[runner.errors[i]
                               for i in sorted(runner.errors)],
                       n_skipped=len(skipped),
                       n_worker_crashes=runner.n_worker_crashes)
