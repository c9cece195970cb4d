"""Experiment CLI of the port: run / resume / validate spec files.

    PYTHONPATH=src python -m repro_torch.api.cli run spec.json \
        [--out run.jsonl] [--checkpoint-dir DIR] [--checkpoint-every N] \
        [--device cpu]
    PYTHONPATH=src python -m repro_torch.api.cli resume DIR [--step N] \
        [--out ...] [--device cpu]
    PYTHONPATH=src python -m repro_torch.api.cli validate spec.json \
        [--checkpoints DIR]

The port of ``repro/api/cli.py``; a spec file and a checkpoint directory
serve either package's CLI. Runs go to the CUDA card unless given
``--device cpu``. ``sweep`` is not ported yet (ROADMAP.md §1 item 6) and
exits with that message.

`run` executes a spec end-to-end (data -> phi -> P1 -> federated training)
and optionally exports the RunResult as JSON-lines. `resume` rebuilds the
experiment from the spec stored inside the checkpoint directory and
continues it bit-for-bit from the checkpointed round. `validate` parses a
spec, resolves every registry key, and prints the normalized JSON — a dry
syntax/typo check that runs no training.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

from repro_torch.api.experiment import (
    Experiment, RunResult, resume_from_checkpoint,
)
from repro_torch.api.registry import DATASETS, LOCAL_SCHEMES, MODELS, SCHEMES
from repro_torch.api.spec import ExperimentSpec
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


def _cmd_sweep(args) -> int:
    raise SystemExit("sweep is not ported to repro_torch yet (ROADMAP.md §1 "
                     "item 6); run it with python -m repro.api.cli sweep")


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

    pw = sub.add_parser("sweep", help="not ported yet (ROADMAP.md §1 "
                                      "item 6)")
    pw.add_argument("spec", nargs="?")
    pw.set_defaults(fn=_cmd_sweep)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
