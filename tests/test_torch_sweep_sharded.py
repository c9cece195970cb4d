"""`cli sweep` over sharded cells (run.shards = 2) in the port, on the CPU.

The CLI spawns the cells' 2 gloo ranks; each rank drains the whole matrix
with one worker and rank 0 alone writes the sink. Held against the same
cells run one by one through the API on 2 ranks of `spawn_shards`: the
per-run JSONL byte for byte, 2 seeds x {mean, coord_median}. Then a real
SIGTERM to the CLI mid-sweep, and `--resume` completes the matrix to the
same bytes.
"""
import glob
import json
import os
import signal
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import cli  # noqa: E402
from repro_torch.launch.mesh import spawn_shards  # noqa: E402

import _torch_shards as shards  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def matrix(rounds=6) -> tapi.SweepSpec:
    base = tapi.ExperimentSpec(
        data=tapi.DataSpec(dataset="synthetic-mnist", n_clients=4,
                           sigma=5.0, n_train=240, n_test=60, seed=0),
        model=tapi.ModelSpec(name="mlp-edge", kwargs={"hidden": 16}),
        wireless=tapi.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=tapi.SchemeSpec(name="random_k", rounds=rounds, eta=0.1,
                               batch=8, ao={"k": 3, "lam": 0.3, "seed": 1}),
        run=tapi.RunSpec(seed=0, eval_every=3, stop_on_budget=False,
                         shards=2))
    return tapi.SweepSpec(base=base, seeds=[0, 1],
                          grid={"scheme.aggregator": ["mean",
                                                      "coord_median"]})


def run_file_bytes(directory: str) -> dict:
    out = {}
    for p in sorted(glob.glob(os.path.join(directory, "0*.jsonl"))):
        with open(p, "rb") as f:
            out[os.path.basename(p)] = f.read()
    return out


@pytest.fixture(scope="module")
def api_oracle(tmp_path_factory):
    """The matrix's cells through the API on 2 ranks, one by one."""
    d = str(tmp_path_factory.mktemp("api"))
    spawn_shards(shards.sweep_cells_via_api, 2, args=(matrix().to_dict(), d),
                 device="cpu", timeout_s=300)
    return run_file_bytes(d)


def test_cli_sweep_of_sharded_cells_matches_the_api(tmp_path, api_oracle,
                                                    capsys):
    path = str(tmp_path / "sweep.json")
    with open(path, "w") as f:
        json.dump(matrix().to_dict(), f)
    d = str(tmp_path / "runs")
    assert cli.main(["sweep", path, "--out-dir", d, "--device", "cpu",
                     "--workers", "2"]) == 0
    out = capsys.readouterr().out
    assert "done: 4/4 runs" in out and "wrote 4 run files" in out
    assert len(api_oracle) == 4
    assert run_file_bytes(d) == api_oracle
    with open(os.path.join(d, "sweep.jsonl")) as f:
        kinds = [json.loads(line)["kind"] for line in f if line.strip()]
    assert kinds == ["sweep_run"] * 4        # written once, by rank 0
    for name in api_oracle:
        res = tapi.RunResult.from_jsonl(os.path.join(d, name))
        assert res.spec["run"]["shards"] == 2


def test_cli_sweep_refuses_two_shard_counts(tmp_path):
    sw = matrix()
    sw = tapi.SweepSpec(base=sw.base, seeds=[0],
                        grid={"run.shards": [2, 3]})
    path = str(tmp_path / "sweep.json")
    with open(path, "w") as f:
        json.dump(sw.to_dict(), f)
    with pytest.raises(SystemExit, match="one process group"):
        cli.main(["sweep", path, "--out-dir", str(tmp_path / "r"),
                  "--device", "cpu"])


def test_sigterm_midsweep_then_resume_bytewise(tmp_path, api_oracle):
    """SIGTERM to the CLI once the first cell is on disk: the ranks stop,
    the CLI exits 130; `--resume` skips the verified cells, reruns the
    rest and ends with the API's bytes."""
    path = str(tmp_path / "sweep.json")
    with open(path, "w") as f:
        json.dump(matrix().to_dict(), f)
    d = str(tmp_path / "runs")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.api.cli", "sweep", path,
         "--out-dir", d, "--device", "cpu"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + 240
    try:
        while not run_file_bytes(d) and time.monotonic() < deadline:
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 130, err[-2000:]
    assert "relaunch with --resume" in err
    done = run_file_bytes(d)
    assert 1 <= len(done) < 4
    assert cli.main(["sweep", path, "--out-dir", d, "--device", "cpu",
                     "--resume"]) == 0
    assert run_file_bytes(d) == api_oracle
