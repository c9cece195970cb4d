"""Regenerate the JAX reference of the paper's Sec. V comparison
(tests/torch_fixtures/sec5_jax.json).

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/make_sec5_jax_reference.py

Runs the JAX package's sweep service (`repro.api.sweep.run_sweep`) over
`benchmarks/common.py`'s six SCHEMES x run.seed 0..7 at
`examples/feel_paper_reproduction.py`'s settings (ExpConfig's defaults:
synthetic-mnist, 10 clients, sigma 1, 60 rounds, E0 4 J, T0 40 s,
evaluation every 25 rounds) on the CPU, and writes a small JSON:

  * each scheme's schedule as run: per round the selected client ids, the
    per-client lambda, the round's delay and energy and the cumulative
    ones, beside the solver's theta / energy / delay / feasible;
  * for each seed: the per-round train loss, (round, test loss, test
    accuracy) at each evaluated round, the rounds completed and the
    cumulative energy and delay;
  * the JAX version, the command and the wall time.

The matrix and the records are scripts/sec5_records.py's (`sec5_sweep`
on `repro.api`'s specs, `collect`), which also compare the PyTorch port
with this file where JAX cannot run: in
examples/torch_feel_paper_reproduction.py, chip_smoke.py's Sec. V phase
and tests/test_torch_cuda.py; tests/test_torch_paper_sec5.py checks that
the file is current. Floats are written by `json` as their shortest
round-trip repr, so they read back bit for bit. About 320 s on an 8-core
CPU.
"""
import json
import os
import platform
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, os.path.join(ROOT, "src"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.api as api  # noqa: E402
from sec5_records import (EVAL_EVERY, LAST_ROUNDS, REFERENCE, SEEDS,  # noqa: E402
                          collect, sec5_sweep)


def main() -> int:
    sweep = sec5_sweep(api, SEEDS)
    t0 = time.perf_counter()
    res = api.run_sweep(sweep, log=lambda msg: print(msg, flush=True))
    wall = time.perf_counter() - t0
    if res.errors:
        print(json.dumps(res.errors, indent=1), file=sys.stderr)
        return 1
    schemes = collect(res.cells, res.results)
    out = {"kind": "sec5_jax_reference",
           "command": ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                       "scripts/make_sec5_jax_reference.py"),
           "jax_version": jax.__version__, "numpy_version": np.__version__,
           "python": platform.python_version(),
           "backend": jax.default_backend(), "wall_s": wall,
           "eval_every": EVAL_EVERY, "last_rounds": LAST_ROUNDS,
           "sweep": sweep.to_dict(), "schemes": schemes}
    with open(REFERENCE, "w") as f:
        json.dump(out, f, separators=(",", ":"), allow_nan=False)
        f.write("\n")
    print(f"wrote {REFERENCE} ({os.path.getsize(REFERENCE)} bytes) in "
          f"{wall:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
