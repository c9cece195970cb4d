"""Experiment CLI of the port: run / resume / validate / sweep spec files.

    PYTHONPATH=src python -m repro_torch.api.cli run spec.json \
        [--out run.jsonl] [--checkpoint-dir DIR] [--checkpoint-every N] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.api.cli resume DIR [--step N] \
        [--out ...] [--device cpu]
    PYTHONPATH=src python -m repro_torch.api.cli validate spec.json \
        [--checkpoints DIR]
    PYTHONPATH=src python -m repro_torch.api.cli sweep sweep.json \
        --out-dir DIR [--seeds 0,1,2] [--schemes proposed,no_gen] \
        [--grid data.sigma=0.5,5.0] [--expand-only] \
        [--max-retries N --retry-backoff S] [--cell-timeout S] \
        [--workers N] [--resume] [--device cpu]

The port of ``repro/api/cli.py``; a spec file, a sweep file, a checkpoint
directory and a sweep directory serve either package's CLI. Runs go to
the CUDA card unless given ``--device cpu``.

`run` executes a spec end-to-end (data -> phi -> P1 -> federated training)
and optionally exports the RunResult as JSON-lines. `resume` rebuilds the
experiment from the spec stored inside the checkpoint directory and
continues it bit-for-bit from the checkpointed round. `validate` parses a
spec, resolves every registry key, and prints the normalized JSON — a dry
syntax/typo check that runs no training. `sweep` expands a SweepSpec (or
an ExperimentSpec used as the base template with axes given by flags) into
its deterministic run matrix and executes it with environment / trainer
reuse, streaming per-run JSONL files into --out-dir as runs finish
(repro_torch.api.sweep).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

from repro_torch.api.experiment import (
    Experiment, RunResult, resume_from_checkpoint,
)
from repro_torch.api.registry import DATASETS, LOCAL_SCHEMES, MODELS, SCHEMES
from repro_torch.api.spec import ExperimentSpec
from repro_torch.api.sweep import (MANIFEST_NAME, JsonlDirSink, SweepSpec,
                                   run_sweep)
from repro_torch.core.aggregators import make_aggregator


def _print_result(res: RunResult) -> None:
    s = res.summary
    print(f"schedule: theta={s['theta']:.3f} E={s['energy']:.2f}J "
          f"T={s['delay']:.2f}s feasible={s['feasible']}")
    for m in res.history:
        if m.test_accuracy is not None:
            print(f"round {m.round:4d}  loss {m.train_loss:.4f}  "
                  f"acc {m.test_accuracy:.3f}  "
                  f"E {m.cumulative_energy:8.2f}J  "
                  f"T {m.cumulative_delay:8.2f}s")
    tail = (f" (resumed from round {s['resumed_from']})"
            if s.get("resumed_from") is not None else "")
    print(f"done: {s['rounds_run']} rounds, final acc "
          f"{s['final_accuracy']:.3f} @ round {s['final_accuracy_round']}"
          + tail)


def _cmd_run(args) -> int:
    spec = ExperimentSpec.from_file(args.spec)
    run_spec = spec.run
    if args.checkpoint_dir is not None:
        run_spec = dataclasses.replace(run_spec,
                                       checkpoint_dir=args.checkpoint_dir)
    if args.checkpoint_every is not None:
        run_spec = dataclasses.replace(run_spec,
                                       checkpoint_every=args.checkpoint_every)
    spec = dataclasses.replace(spec, run=run_spec)
    res = Experiment(spec).run(device=args.device)
    _print_result(res)
    if args.out:
        print(f"wrote {res.to_jsonl(args.out)}")
    return 0


def _cmd_resume(args) -> int:
    res = resume_from_checkpoint(args.checkpoint_dir, step=args.step,
                                 device=args.device)
    _print_result(res)
    if args.out:
        print(f"wrote {res.to_jsonl(args.out)}")
    return 0


def _cmd_validate(args) -> int:
    rc = 0
    if args.spec is not None:
        spec = ExperimentSpec.from_file(args.spec)
        DATASETS.get(spec.data.dataset)
        MODELS.get(spec.model.name)
        SCHEMES.get(spec.scheme.name)
        make_aggregator(spec.scheme.aggregator,
                        **spec.scheme.aggregator_kwargs)
        # resolving the factory also validates local_steps/local_kwargs
        LOCAL_SCHEMES.get(spec.scheme.local_scheme)(spec.scheme)
        print(spec.to_json())
    if args.checkpoints is not None:
        rc = max(rc, _validate_checkpoints(args.checkpoints))
    if args.spec is None and args.checkpoints is None:
        raise SystemExit("validate: pass a spec file, --checkpoints DIR, "
                         "or both")
    return rc


def _validate_checkpoints(directory: str) -> int:
    """Run verify_checkpoint over every step in a checkpoint directory;
    print one line per step and return 1 when any step is corrupt (so CI
    and pre-resume probes can gate on the exit code). A nonexistent
    directory fails BEFORE CheckpointManager touches it — the manager
    mkdirs its directory on construction, and a validate probe must never
    leave an empty decoy dir at a mistyped path."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.io import (CheckpointCorruptError,
                                           verify_checkpoint)
    if not os.path.isdir(directory):
        print(f"validate: checkpoint directory {directory!r} does not "
              f"exist — check the path", file=sys.stderr)
        return 1
    manager = CheckpointManager(directory)
    steps = manager._steps()
    if not steps:
        print(f"validate: no checkpoints under {directory!r} — empty "
              f"directory (wrong path, or the run never checkpointed)",
              file=sys.stderr)
        return 1
    n_bad = 0
    for s in steps:
        try:
            verify_checkpoint(manager._name(s))
            print(f"step {s:8d}  intact")
        except CheckpointCorruptError as e:
            n_bad += 1
            print(f"step {s:8d}  CORRUPT: {e}")
    print(f"{directory}: {len(steps) - n_bad}/{len(steps)} step(s) intact")
    return 1 if n_bad else 0


def _parse_values(raw: str) -> list:
    """Comma-separated axis values; each parsed as JSON when possible
    (numbers, booleans) and kept as a string otherwise."""
    out = []
    for tok in raw.split(","):
        tok = tok.strip()
        try:
            out.append(json.loads(tok))
        except json.JSONDecodeError:
            out.append(tok)
    return out


def _cmd_sweep(args) -> int:
    with open(args.spec) as f:
        d = json.load(f)
    # a SweepSpec file carries a "base" template; a plain ExperimentSpec
    # file IS the base, with axes supplied by flags
    sweep = (SweepSpec.from_dict(d) if "base" in d
             else SweepSpec(base=ExperimentSpec.from_dict(d)))
    if args.seeds:
        sweep = dataclasses.replace(sweep, seeds=_parse_values(args.seeds))
    if args.schemes:
        sweep = dataclasses.replace(
            sweep, schemes=[str(s) for s in _parse_values(args.schemes)])
    for axis in args.grid or ():
        path, _, raw = axis.partition("=")
        if not raw:
            raise SystemExit(f"--grid expects PATH=V1,V2,..., got {axis!r}")
        sweep = dataclasses.replace(
            sweep, grid={**sweep.grid, path: _parse_values(raw)})
    cells = sweep.expand()
    print(f"sweep matrix: {len(cells)} run(s)")
    if args.expand_only:
        for c in cells:
            print(f"  {c.name}")
        return 0
    if args.resume and not args.out_dir:
        raise SystemExit("sweep --resume requires --out-dir (the sink "
                         "directory holds the manifest and prior results)")
    if args.resume:
        # fail BEFORE run_sweep: a manifest-less dir (pre-manifest sweep,
        # or a typo'd path) would otherwise verify nothing and silently
        # re-run — and append to — whatever is there
        manifest = os.path.join(args.out_dir, MANIFEST_NAME)
        if not os.path.exists(manifest):
            raise SystemExit(
                f"sweep --resume: no sweep manifest at {manifest!r} — "
                "not a resumable sweep directory; drop --resume to start "
                "fresh or point --out-dir at the original sweep dir")
    sink = JsonlDirSink(args.out_dir) if args.out_dir else None
    try:
        res = run_sweep(sweep, sink=sink, log=print,
                        max_retries=args.max_retries,
                        retry_backoff=args.retry_backoff,
                        cell_timeout=args.cell_timeout,
                        workers=args.workers, resume=args.resume,
                        device=args.device)
    except KeyboardInterrupt:
        print("sweep interrupted — completed cells are preserved; "
              "relaunch with --resume to continue", file=sys.stderr)
        return 130
    n_ok = sum(r is not None for r in res.results)
    n_ran = n_ok - res.n_skipped
    if args.resume:
        print(f"resume: skipped {res.n_skipped} verified cell(s), "
              f"ran {len(res.results) - res.n_skipped}")
    print(f"done: {n_ok}/{len(res.results)} runs; environments built "
          f"{res.n_env_builds}, trainers built {res.n_trainer_builds} "
          f"(reused across {n_ran - res.n_trainer_builds} runs)")
    if res.n_worker_crashes:
        print(f"{res.n_worker_crashes} worker(s) crashed; their cells "
              f"were requeued and completed elsewhere", file=sys.stderr)
    if sink is not None:
        print(f"wrote {len(sink.paths)} run files + index under "
              f"{sink.directory}")
    if res.errors:
        for e in res.errors:
            print(f"FAILED {e['name']}: {e['error']}", file=sys.stderr)
        print(f"{len(res.errors)} cell(s) failed (errors recorded in "
              f"sweep.jsonl)", file=sys.stderr)
        return 1
    return 0


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.api.cli",
        description="Run / resume / validate declarative FEEL experiments.")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="execute a spec file end-to-end")
    pr.add_argument("spec", help="path to an ExperimentSpec JSON file")
    pr.add_argument("--out", help="export the RunResult as JSON-lines")
    pr.add_argument("--checkpoint-dir",
                    help="override spec.run.checkpoint_dir")
    pr.add_argument("--checkpoint-every", type=int,
                    help="override spec.run.checkpoint_every")
    pr.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    pr.set_defaults(fn=_cmd_run)

    ps = sub.add_parser("resume",
                        help="continue a checkpointed run bit-for-bit")
    ps.add_argument("checkpoint_dir")
    ps.add_argument("--step", type=int,
                    help="checkpoint round to resume from (default latest)")
    ps.add_argument("--out", help="export the RunResult as JSON-lines")
    ps.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ps.set_defaults(fn=_cmd_resume)

    pv = sub.add_parser("validate",
                        help="parse a spec + resolve registry keys, no run; "
                             "optionally verify a checkpoint directory")
    pv.add_argument("spec", nargs="?", default=None,
                    help="ExperimentSpec JSON file (optional with "
                         "--checkpoints)")
    pv.add_argument("--checkpoints", metavar="DIR",
                    help="run verify_checkpoint over every step under DIR; "
                         "exit nonzero when any step is corrupt")
    pv.set_defaults(fn=_cmd_validate)

    pw = sub.add_parser(
        "sweep", help="expand + execute a run matrix with env/trainer reuse")
    pw.add_argument("spec", help="SweepSpec JSON (with 'base') or an "
                                 "ExperimentSpec JSON used as the template")
    pw.add_argument("--out-dir", help="stream per-run JSONL files (+ a "
                                      "sweep.jsonl index) here as runs finish")
    pw.add_argument("--seeds", help="override the run.seed axis, e.g. 0,1,2")
    pw.add_argument("--schemes", help="override the scheme.name axis")
    pw.add_argument("--grid", action="append", metavar="PATH=V1,V2",
                    help="add a cartesian axis over a spec field path "
                         "(repeatable)")
    pw.add_argument("--expand-only", action="store_true",
                    help="print the deterministic matrix, run nothing")
    pw.add_argument("--max-retries", type=int, default=0,
                    help="retry a failing cell up to N times before "
                         "recording the failure and moving on (default 0)")
    pw.add_argument("--retry-backoff", type=float, default=0.5,
                    help="base seconds for the jittered exponential "
                         "backoff between retry attempts (default 0.5)")
    pw.add_argument("--cell-timeout", type=float, default=None,
                    help="per-cell wall-clock deadline in seconds; a cell "
                         "past it is recorded as a timeout (not retried) "
                         "and the sweep moves on")
    pw.add_argument("--workers", type=int, default=1,
                    help="run up to N independent cells concurrently "
                         "(default 1 = serial; per-run records are "
                         "bitwise identical for any N)")
    pw.add_argument("--resume", action="store_true",
                    help="skip cells whose per-run JSONL in --out-dir "
                         "verifies against the recorded sweep manifest; "
                         "re-run missing/corrupt/failed cells and continue "
                         "interrupted ones from their newest intact "
                         "checkpoint")
    pw.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    pw.set_defaults(fn=_cmd_sweep)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
