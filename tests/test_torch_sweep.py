"""The port's sweep service (`repro_torch.api.sweep`), on the CPU, against
the JAX package's `repro.api.sweep`.

* Expansion: one SweepSpec JSON gives the same cell names, order and
  spec hashes in both packages, and the same field-path errors.
* Execution: per-run records are byte-identical for workers=1 and
  workers=2, with one environment build per group; a sweep over a fleet
  spec reuses one streamed trainer, each cell equal to its standalone run.
* The elastic service: the manifest, verification of truncated and garbage
  records (a port directory verifies under the JAX package's manifest and
  sink too), kill mid-sweep and resume byte for byte, re-run of missing
  cells, a different matrix refused, the cell timeout under concurrent
  workers, worker-crash requeue, the CLI's failed-cell exit code, and
  `benchmarks/report.py` on a port directory.
* The process-wide state that worker threads share: `exact_fp32` keeps its
  flags while any thread is inside, and launch counts stay exact across
  threads, a capture's in its own dict.
"""
import glob
import json
import os
import threading

import pytest

torch = pytest.importorskip("torch")

import repro.api as japi  # noqa: E402
from repro.api import sweep as jsweep  # noqa: E402
from benchmarks import report  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import cli  # noqa: E402
from repro_torch.api import sweep as tsweep  # noqa: E402
from repro_torch.device import exact_fp32  # noqa: E402
from repro_torch.kernels import counters  # noqa: E402

N_CLIENTS, ROUNDS, BATCH = 5, 4, 8


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test: the suite runs in parallel
    workers beside XLA's thread pools (see tests/test_torch_api.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def base_spec(api=tapi, **run_kw):
    return api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-mnist", n_clients=N_CLIENTS,
                          sigma=5.0, n_train=200, n_test=60, seed=0),
        model=api.ModelSpec(name="mlp-edge"),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="proposed", rounds=ROUNDS, eta=0.1,
                              batch=BATCH, ao={"outer_iters": 1}),
        run=api.RunSpec(seed=0, eval_every=2, **run_kw))


def matrix(**run_kw):
    return tapi.SweepSpec(base=base_spec(**run_kw), seeds=[0, 1],
                          schemes=["proposed", "no_gen"])


def sweep(sw, **kw):
    return tapi.run_sweep(sw, device="cpu", **kw)


def run_file_bytes(directory: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(directory, "0*.jsonl"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


def index_kinds(directory: str) -> list:
    with open(os.path.join(directory, "sweep.jsonl")) as f:
        return [json.loads(line)["kind"] for line in f if line.strip()]


# -- expansion ------------------------------------------------------------------

def test_expansion_names_order_and_hashes_match_jax(tmp_path):
    sw = tapi.SweepSpec(
        base=base_spec(), seeds=[0, 1, 2], schemes=["proposed", "no_gen"],
        grid={"data.sigma": [0.5, 5.0],
              "wireless.fault_kwargs.rate": [0.1, 0.3]},
        zip={"wireless.e0": [2.0, 4.0], "wireless.t0": [20.0, 40.0]})
    path = sw.save(str(tmp_path / "sweep.json"))
    jsw = japi.SweepSpec.from_file(path)
    assert tapi.SweepSpec.from_file(path) == sw
    cells, jcells = sw.expand(), jsw.expand()
    assert len(cells) == 2 * 2 * 2 * 2 * 3
    assert [c.name for c in cells] == [c.name for c in jcells]
    assert [c.index for c in cells] == [c.index for c in jcells]
    assert [tsweep.spec_hash(c.spec) for c in cells] == \
        [jsweep.spec_hash(c.spec) for c in jcells]
    assert [c.spec.to_dict() for c in cells] == \
        [c.spec.to_dict() for c in jcells]
    assert sw.expand() == cells                 # deterministic
    assert tapi.SweepSpec(base=base_spec()).expand()[0].name == "000_base"
    for bad in ("data.sigmaa", "scheme.name.x", ""):
        with pytest.raises(tapi.SpecError) as te:
            tapi.override_field(base_spec(), bad, 1)
        with pytest.raises(japi.SpecError) as je:
            japi.override_field(base_spec(japi), bad, 1)
        assert str(te.value) == str(je.value)
    with pytest.raises(tapi.SpecError, match="equal lengths"):
        tapi.SweepSpec(base=base_spec(), zip={"wireless.e0": [1.0],
                                              "wireless.t0": []}).expand()


# -- execution ------------------------------------------------------------------

@pytest.fixture(scope="module")
def workers_1(tmp_path_factory):
    # set up before the per-test one_torch_thread: one thread here too, so
    # the CPU's reductions split as in the tests that compare with it
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        d = str(tmp_path_factory.mktemp("w1"))
        return d, sweep(matrix(), sink=tapi.JsonlDirSink(d), workers=1)
    finally:
        torch.set_num_threads(n)


def test_workers_1_and_2_write_identical_records(workers_1, tmp_path):
    d1, r1 = workers_1
    d2 = str(tmp_path / "w2")
    r2 = sweep(matrix(), sink=tapi.JsonlDirSink(d2), workers=2)
    assert r1.errors == [] and r2.errors == []
    b1, b2 = run_file_bytes(d1), run_file_bytes(d2)
    assert len(b1) == 4 and b1 == b2           # byte for byte
    assert r1.summary_rows() == r2.summary_rows()
    assert r1.n_env_builds == r2.n_env_builds == 1
    assert r1.n_trainer_builds == 1            # one trainer, reset per cell
    assert r2.n_worker_crashes == 0 and r2.n_skipped == 0


def test_manifest_verifies_in_both_packages(workers_1):
    d, res = workers_1
    man = tapi.load_manifest(d)
    cells = matrix().expand()
    assert man["kind"] == "sweep_manifest" and man["n_cells"] == 4
    assert [c["name"] for c in man["cells"]] == [c.name for c in cells]
    for rec, cell in zip(man["cells"], cells):
        assert rec["spec_hash"] == tsweep.spec_hash(cell.spec)
        path = os.path.join(d, f"{cell.name}.jsonl")
        for verify in (tsweep.verify_cell_run, jsweep.verify_cell_run):
            r = verify(path, rec["spec_hash"])
            assert r is not None and r.summary["rounds_run"] == ROUNDS
            assert verify(path, "0" * 64) is None
    # the JAX package's sink takes the port's directory as complete
    jcells = japi.SweepSpec.from_dict(matrix().to_dict()).expand()
    assert sorted(japi.JsonlDirSink(d).resume_scan(jcells)) == [0, 1, 2, 3]


def test_verify_rejects_truncated_and_garbage(workers_1, tmp_path):
    d, _ = workers_1
    cell = matrix().expand()[0]
    with open(os.path.join(d, f"{cell.name}.jsonl")) as f:
        lines = f.readlines()
    h = tsweep.spec_hash(cell.spec)
    path = str(tmp_path / "cell.jsonl")
    with open(path, "w") as f:
        f.writelines(lines)
    assert tsweep.verify_cell_run(path, h) is not None
    with open(path, "w") as f:                 # trailing rounds lost
        f.writelines(lines[:2])
    assert tsweep.verify_cell_run(path, h) is None
    with open(path, "w") as f:                 # a record torn mid-line
        f.write("".join(lines)[:-20])
    assert tsweep.verify_cell_run(path, h) is None
    assert tsweep.verify_cell_run(str(tmp_path / "nope.jsonl"), h) is None


def test_sweep_over_a_fleet_spec_reuses_its_streamed_trainer(tmp_path):
    base = tapi.ExperimentSpec(
        data=tapi.DataSpec(dataset="synthetic-fleet", n_clients=16,
                           n_train=16 * 24, n_test=32, seed=5),
        model=tapi.ModelSpec(name="mlp-edge", kwargs={"hidden": 16}),
        wireless=tapi.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=tapi.SchemeSpec(name="random_k", rounds=4, batch=BATCH,
                               ao={"k": 4, "lam": 0.3, "seed": 1}),
        run=tapi.RunSpec(seed=0, eval_every=2, stop_on_budget=False,
                         client_store="streamed", rounds_per_dispatch=2))
    sw = tapi.SweepSpec(base=base, seeds=[0, 1])
    res = sweep(sw)
    assert res.errors == [] and res.n_trainer_builds == 1
    for cell, r in zip(sw.expand(), res.results):
        alone = tapi.Experiment(cell.spec).build(device="cpu").run()
        assert [m.train_loss for m in r.history] == \
            [m.train_loss for m in alone.history]
        assert r.summary["fleet"]["n_cohort_swaps"] == \
            alone.summary["fleet"]["n_cohort_swaps"]


# -- the elastic service ------------------------------------------------------------

class InterruptAfterRounds(tapi.Callback):
    """KeyboardInterrupt once `n` round ends were seen across the sweep: an
    in-process stand-in for SIGTERM."""

    def __init__(self, n: int):
        self.n, self.seen = int(n), 0

    def on_round_end(self, m, trainer) -> None:
        self.seen += 1
        if self.seen >= self.n:
            raise KeyboardInterrupt


def test_kill_midsweep_then_resume_bytewise(tmp_path):
    sw = matrix(checkpoint_every=1)
    oracle_dir = str(tmp_path / "oracle")
    sweep(sw, sink=tapi.JsonlDirSink(oracle_dir))
    oracle = run_file_bytes(oracle_dir)
    d = str(tmp_path / "elastic")
    with pytest.raises(KeyboardInterrupt):
        sweep(sw, sink=tapi.JsonlDirSink(d),
              callbacks=[InterruptAfterRounds(ROUNDS + 2)])
    cells = sw.expand()
    assert list(run_file_bytes(d)) == [f"{cells[0].name}.jsonl"]
    assert "sweep_interrupted" in index_kinds(d)
    ck = os.path.join(d, "ckpt", cells[1].name)
    assert glob.glob(os.path.join(ck, "ckpt_*"))
    res = sweep(sw, sink=tapi.JsonlDirSink(d), resume=True)
    assert res.n_skipped == 1 and res.errors == []
    assert run_file_bytes(d) == oracle         # byte for byte
    assert not glob.glob(os.path.join(ck, "ckpt_*.npz"))
    kinds = index_kinds(d)
    assert kinds.count("sweep_skip") == 1 and kinds.count("sweep_run") == 4


def test_resume_reruns_missing_and_refuses_another_matrix(tmp_path):
    sw = tapi.SweepSpec(base=base_spec(), seeds=[0, 1])
    d = str(tmp_path / "runs")
    sweep(sw, sink=tapi.JsonlDirSink(d))
    oracle = run_file_bytes(d)
    cells = sw.expand()
    os.unlink(os.path.join(d, f"{cells[1].name}.jsonl"))
    res = sweep(sw, sink=tapi.JsonlDirSink(d), resume=True)
    assert res.n_skipped == 1 and run_file_bytes(d) == oracle
    before = index_kinds(d)
    with pytest.raises(tapi.SpecError, match="different sweep matrix"):
        sweep(tapi.SweepSpec(base=base_spec(), seeds=[0, 1, 2]),
              sink=tapi.JsonlDirSink(d), resume=True)
    assert index_kinds(d) == before
    assert tapi.load_manifest(d)["n_cells"] == 2


class TimeoutSlowCells(tapi.Callback):
    """Raise CellTimeout on the eta 0.05 family and count first rounds per
    eta, so the test sees that timed-out cells were not retried."""

    def __init__(self):
        self.starts: dict = {}
        self._lock = threading.Lock()

    def on_round_end(self, m, trainer) -> None:
        if m.round == 0:
            with self._lock:
                self.starts[trainer.eta] = self.starts.get(trainer.eta, 0) + 1
        if trainer.eta == 0.05:
            raise tapi.CellTimeout("synthetic deadline")


def test_cell_timeout_under_concurrent_workers(tmp_path):
    sw = tapi.SweepSpec(base=base_spec(), seeds=[0, 1],
                        grid={"scheme.eta": [0.1, 0.05]})
    d = str(tmp_path / "runs")
    probe = TimeoutSlowCells()
    res = sweep(sw, sink=tapi.JsonlDirSink(d), workers=2, callbacks=[probe],
                max_retries=2)
    assert [e["kind"] for e in res.errors] == ["timeout", "timeout"]
    assert [r is not None for r in res.results] == [True, True, False, False]
    assert probe.starts == {0.1: 2, 0.05: 2}   # not retried
    deadline = tsweep._DeadlineCallback(0.0)
    with pytest.raises(tapi.CellTimeout, match="deadline"):
        deadline.on_block_end(0, 1, None)


class CrashOnceSink(tapi.RunSink):
    """A sink whose first write dies: the worker-crash injection."""

    def __init__(self):
        self.written, self.crashed = [], False

    def write(self, name, result) -> None:
        if not self.crashed:
            self.crashed = True
            raise RuntimeError("sink storage died")
        self.written.append(name)


def test_worker_crash_requeues_the_cell():
    sw = tapi.SweepSpec(base=base_spec(), seeds=[0, 1])
    sink = CrashOnceSink()
    res = sweep(sw, sink=sink, workers=2)
    assert res.n_worker_crashes == 1
    assert res.errors == [] and all(r is not None for r in res.results)
    assert sorted(sink.written) == [c.name for c in sw.expand()]


def test_cli_sweep_exit_codes_and_report(tmp_path, capsys):
    spec_path = base_spec().save(str(tmp_path / "base.json"))
    ok_dir = str(tmp_path / "ok")
    assert cli.main(["sweep", spec_path, "--seeds", "0,1", "--schemes",
                     "proposed", "--out-dir", ok_dir, "--device",
                     "cpu"]) == 0
    out = capsys.readouterr().out
    assert "sweep matrix: 2 run(s)" in out and "environments built 1" in out
    assert cli.main(["sweep", spec_path, "--seeds", "0,1", "--schemes",
                     "proposed", "--out-dir", ok_dir, "--device", "cpu",
                     "--resume"]) == 0
    assert "skipped 2 verified cell(s)" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no sweep manifest"):
        cli.main(["sweep", spec_path, "--resume", "--out-dir",
                  str(tmp_path / "nothing")])
    # benchmarks/report.py reads the port's directory
    paths = sorted(glob.glob(os.path.join(ok_dir, "*.jsonl")))
    assert len(report._parseable_runs(paths)) == 2
    rows = report.aggregate_runs(paths)
    assert [r["n"] for r in rows] == [2]
    assert "| ok |" in report.runs_table(paths)
    # a failing cell: recorded, the rest still runs, exit code 1
    bad_dir = str(tmp_path / "bad")
    rc = cli.main(["sweep", spec_path, "--grid", "model.name=mlp-edge,wat",
                   "--out-dir", bad_dir, "--max-retries", "1", "--device",
                   "cpu"])
    assert rc == 1
    cap = capsys.readouterr()
    assert "FAILED" in cap.err and "wat" in cap.err
    assert "1 cell(s) failed" in cap.err
    assert len(os.listdir(bad_dir)) == 3
    table = report.runs_table(sorted(glob.glob(os.path.join(bad_dir,
                                                            "*.jsonl"))))
    assert table.count("| ok |") == 1 and table.count("FAILED") == 1


# -- state the worker threads share -------------------------------------------------

def test_exact_fp32_keeps_its_flags_while_any_thread_is_inside():
    cudnn = torch.backends.cudnn
    saved = (cudnn.benchmark, cudnn.deterministic, cudnn.conv.fp32_precision)
    cudnn.benchmark, cudnn.deterministic = True, False
    cudnn.conv.fp32_precision = "tf32"
    a_in, b_in, a_out, b_done = (threading.Event() for _ in range(4))
    seen = {}

    def flags():
        return (cudnn.benchmark, cudnn.deterministic,
                cudnn.conv.fp32_precision)

    def worker_a():
        with exact_fp32():
            a_in.set()
            b_in.wait()
        a_out.set()

    def worker_b():
        a_in.wait()
        with exact_fp32():
            b_in.set()
            a_out.wait()
            # A left first: B must still run under the exact flags
            seen["b_after_a_left"] = flags()
            with exact_fp32():                 # nested in one thread
                seen["nested"] = flags()
            seen["after_nested"] = flags()
        b_done.set()

    try:
        ts = [threading.Thread(target=f) for f in (worker_a, worker_b)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
        exact = (False, True, "ieee")
        assert seen == {"b_after_a_left": exact, "nested": exact,
                        "after_nested": exact}
        assert flags() == (True, False, "tf32")   # the caller's, restored
    finally:
        cudnn.benchmark, cudnn.deterministic = saved[:2]
        cudnn.conv.fp32_precision = saved[2]


def test_launch_counts_stay_exact_across_threads():
    counters.reset_launches()
    captured = {}
    go = threading.Barrier(5)

    def counting():
        go.wait()
        for _ in range(2000):
            counters.count_launch("exponent_histogram")

    def capturing():
        go.wait()
        with counters.capturing() as sink:
            for _ in range(300):
                counters.count_launch("importance_mask_2d")
        captured.update(sink)
        counters.count_launch("importance_mask_2d", 7)   # a replay's count

    ts = [threading.Thread(target=counting) for _ in range(4)]
    ts.append(threading.Thread(target=capturing))
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    try:
        assert counters.LAUNCHES["exponent_histogram"] == 4 * 2000
        assert counters.LAUNCHES["importance_mask_2d"] == 7
        assert captured == {"importance_mask_2d": 300}
    finally:
        counters.reset_launches()
