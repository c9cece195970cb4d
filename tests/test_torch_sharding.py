"""The port's sharded client axis (torch.distributed, gloo ranks on the CPU)
against the JAX package's forced-4-device mesh and against itself.

One module fixture runs both packages once: the JAX package's cases in one
subprocess under ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
(tests/_jax_shards_reference.py), and meanwhile the port's on 4 gloo ranks
in one spawn (tests/_torch_shards.py `cpu_cases`), both from the same
numpy-drawn weights, data and schedules.

* Bit for bit against JAX: the sharded tails alone (the mean path's
  per-shard partial sums in psum order, the robust path's gathered stack),
  the first round's thresholds, the bucket formula, the shard-count
  resolution and the sweep's collective gate.
* Against JAX within its own sharded tolerances (rtol 1e-6 / atol 1e-7 a
  round, 1e-5 / 1e-6 a trajectory): the first rounds, the hetero trainer,
  the coord_median attack run and FedDyn; FedAvg E = 3 within the port's
  local-scheme bound against JAX (atol 1e-4). JAX's sharded MEAN path
  does not hold on JAX 0.9 (ROADMAP.md §3), so those cases hold the port
  to JAX's unsharded run, which JAX documents its sharded run to equal.
* Inside the port, bit for bit: sharded blocks == sharded rounds, robust
  and FedDyn sharded == unsharded, the mean path == the host's replay of
  its gathered partials, streamed sharded cohorts == the replicated store
  (each rank holding only its sub-cohort's rows), every rank's (w, v)
  after every block; one collective a round.
* The launcher: a failing rank stops the others, a hung run times out, the
  CLI runs and resumes a spec at 2 ranks.
"""
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.api.sweep import _collective_safe as jax_collective_safe  # noqa: E402
from repro.api.sweep import SweepSpec as JSweepSpec  # noqa: E402
from repro.core.round_engine import bucket_capacity as jax_bucket  # noqa: E402
from repro.core.round_engine import resolve_shards as jax_resolve  # noqa: E402

import _shard_probes  # noqa: E402
import _torch_shards as ts  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch.api import cli  # noqa: E402
from repro_torch.api.sweep import SweepSpec, _collective_safe  # noqa: E402
from repro_torch.core import FederatedTrainer, ParamPack, RoundEngine  # noqa: E402
from repro_torch.core.round_engine import bucket_capacity, resolve_shards  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

RANKS = 4
SRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
JAX_SCRIPT = os.path.join(os.path.dirname(__file__),
                          "_jax_shards_reference.py")
# JAX's sharded tolerances (tests/test_round_engine.py, test_block_engine.py)
ROUND_TOL = dict(rtol=1e-6, atol=1e-7)
TRAJ_TOL = dict(rtol=1e-5, atol=1e-6)


def _bits(a):
    return np.ascontiguousarray(a).view(np.int32)


def _bitwise(a, b) -> bool:
    return np.array_equal(_bits(np.asarray(a)), _bits(np.asarray(b)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's per-rank results, JAX's outputs) of every case."""
    d = tmp_path_factory.mktemp("shards")
    first, hetero = ts.lenet_params(1), ts.lenet_params(0)
    rows = ParamPack.build(ts.to_params(first, "cpu")).rows
    grads, cw, w, v, inv, losses = ts.tail_inputs(rows)
    inp = {**{f"first/{k}": a for k, a in first.items()},
           **{f"hetero/{k}": a for k, a in hetero.items()},
           "tail/grads": grads, "tail/cw": cw, "tail/w": w, "tail/v": v,
           "tail/inv": inv, "tail/losses": losses}
    np.savez(d / "in.npz", **inp)
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": (os.environ.get("XLA_FLAGS", "")
                         + " --xla_force_host_platform_device_count=4"),
           "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    env.pop("REPRO_ROUND_SHARDS", None)
    proc = subprocess.Popen(
        [sys.executable, JAX_SCRIPT, str(d / "in.npz"), str(d / "out.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = mesh.spawn_shards(ts.cpu_cases, RANKS, args=(first, hetero),
                                 device="cpu", timeout_s=300)
        _, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return port, dict(np.load(d / "out.npz"))


def _owner(port, case, name):
    """The unsharded baseline `name` of `case`, from the rank that ran it."""
    return next(r[case][name] for r in port if name in r[case])


# -- bit for bit against JAX ------------------------------------------------------

def test_both_packages_draw_the_same_batches(runs):
    port, jx = runs
    np.testing.assert_array_equal(port[0]["first"]["xs"], jx["first/xs"])
    np.testing.assert_array_equal(port[0]["first"]["ys"], jx["first/ys"])


@pytest.mark.parametrize("name", ["mean", "coord_median"])
def test_sharded_tail_matches_jax_bit_for_bit(runs, name):
    """Given the same uploads (five decades of magnitude, a NaN client, two
    padding clients), the port's rows, gather and replicated tail give
    JAX's shard_map partials, psum (or all_gather) and tail bit for bit."""
    port, jx = runs
    for r in port:
        t = r["tail"][name]
        for k in ("w", "v", "losses"):
            assert _bitwise(t[k], jx[f"tail/{name}_{k}"]), (name, k)
        assert t["n_ok"] == int(jx[f"tail/{name}_n_ok"]) == 5
        assert t["ast"] == int(jx[f"tail/{name}_ast"])


@pytest.mark.parametrize("tag", ["shared", "multi"])
def test_first_round_matches_jax(runs, tag):
    """JAX's test_sharded_engine_first_round setting at 4 ranks: the
    thresholds are JAX's sharded and unsharded ones bit for bit; losses, w
    and v within JAX's sharded round tolerance of JAX's unsharded round."""
    port, jx = runs
    f = port[0]["first"]
    for label in ("n", "1"):
        assert _bitwise(f[f"{tag}_thr_n"], jx[f"first/{tag}_thr_{label}"])
    for k in ("losses", "w", "v"):
        np.testing.assert_allclose(f[f"{tag}_{k}_n"],
                                   jx[f"first/{tag}_{k}_1"], **ROUND_TOL)
    assert f["buckets"] == list(jx["first/buckets_n"]) == [4]
    assert f["shards"] == RANKS


@pytest.mark.parametrize("tag", ["shared", "multi"])
def test_first_round_sharded_matches_one_rank(runs, tag):
    port, _ = runs
    f = port[0]["first"]
    assert _bitwise(f[f"{tag}_thr_n"], f[f"{tag}_thr_1"])
    assert _bitwise(f[f"{tag}_losses_n"], f[f"{tag}_losses_1"])
    for k in ("w", "v"):
        np.testing.assert_allclose(f[f"{tag}_{k}_n"], f[f"{tag}_{k}_1"],
                                   **ROUND_TOL)


def test_mean_path_is_the_shard_order_replay_of_its_partials(runs):
    port, _ = runs
    for r in port:
        assert _bitwise(r["first"]["replay_v"], r["first"]["shared_v_n"])


def test_bucket_capacity_matches_jax():
    for shards in (1, 2, 4):
        for m in (None, 1, 3, 6, 10, 20):
            for n in range(1, 21):
                for bucket in (True, False):
                    assert bucket_capacity(
                        n, shards=shards, bucket=bucket, max_clients=m) == \
                        jax_bucket(n, shards=shards, bucket=bucket,
                                   max_clients=m), (n, shards, m, bucket)


def test_resolve_shards_matches_jax(monkeypatch):
    monkeypatch.delenv("REPRO_ROUND_SHARDS", raising=False)
    for s in (None, 0, 1, 2, 4):
        assert resolve_shards(s) == jax_resolve(s), s
    # the port reads the environment as JAX does, but never caps it to a
    # device count: a count no process group serves raises at the engine
    monkeypatch.setenv("REPRO_ROUND_SHARDS", "2")
    assert resolve_shards(None) == 2
    assert resolve_shards(1) == 1


def _cells(api, sweep_cls, backend, shards):
    base = api.ExperimentSpec(
        data=api.DataSpec(n_clients=4, n_train=200, n_test=40),
        run=api.RunSpec(backend=backend, shards=shards))
    return sweep_cls(base=base, seeds=[0, 1]).expand()


@pytest.mark.parametrize("backend", ["packed", "reference"])
@pytest.mark.parametrize("shards", [None, 1, 2, 4])
def test_collective_safe_matches_jax(backend, shards, monkeypatch):
    import repro.api as japi
    monkeypatch.delenv("REPRO_ROUND_SHARDS", raising=False)
    got = _collective_safe(_cells(tapi, SweepSpec, backend, shards))
    want = jax_collective_safe(_cells(japi, JSweepSpec, backend, shards))
    assert got == want == (backend == "reference" or shards in (None, 1))


# -- against JAX within its tolerances ----------------------------------------------

def test_hetero_trajectory_matches_jax(runs):
    """Sizes 60/30/20/10/7/3, 6 rounds of varying selection, at 4 ranks,
    per round and in blocks of 4, against JAX's (unsharded) trajectory."""
    port, jx = runs
    for rpd in (1, 4):
        h = port[0]["hetero"][f"rpd{rpd}"]
        np.testing.assert_allclose(h["losses"], jx["hetero/losses"],
                                   **TRAJ_TOL)
        for k in ("w", "v"):
            np.testing.assert_allclose(h[k], jx[f"hetero/{k}"], **TRAJ_TOL)


def test_coord_median_attack_matches_jax_sharded(runs):
    port, jx = runs
    h = port[0]["robust"]["coord_median"]
    np.testing.assert_allclose(h["losses"], jx["coord_median/losses"],
                               **TRAJ_TOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(h[k], jx[f"coord_median/{k}"], **TRAJ_TOL)


def test_feddyn_matches_jax_sharded(runs):
    port, jx = runs
    h = port[0]["local"]["feddyn"]
    np.testing.assert_allclose(h["losses"], jx["feddyn/losses"], **TRAJ_TOL)
    for k in ("w", "v", "h"):
        np.testing.assert_allclose(h[k], jx[f"feddyn/{k}"], **TRAJ_TOL)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / np.linalg.norm(np.asarray(b, np.float64)))


def test_fedavg_e3_matches_jax(runs):
    """FedAvg E = 3 rides the mean path. Its three local steps a client
    carry the packages' gradient differences (layer (c): cuDNN/ATen and XLA
    reduce in different orders) to a drift JAX's trajectory tolerance does
    not cover even unsharded (ROADMAP.md §3 has the readings: relative L2
    3.4e-5 on w, 4.7e-4 on v after 4 rounds, sharded and unsharded alike).
    So: the losses within JAX's trajectory tolerance, (w, v) within 1e-3
    relative L2 of JAX's, and the sharded run within JAX's trajectory
    tolerance of the port's unsharded one, whose own drift from JAX it
    matches."""
    port, jx = runs
    h = port[0]["local"]["fedavg"]
    one = _owner(port, "local", "fedavg_1")
    np.testing.assert_allclose(h["losses"], jx["fedavg/losses"], **TRAJ_TOL)
    np.testing.assert_allclose(h["losses"], one["losses"], **TRAJ_TOL)
    for k in ("w", "v"):
        assert _rel_l2(h[k], jx[f"fedavg/{k}"]) < 1e-3, k
        np.testing.assert_allclose(h[k], one[k], **TRAJ_TOL)
        assert abs(_rel_l2(h[k], jx[f"fedavg/{k}"])
                   - _rel_l2(one[k], jx[f"fedavg/{k}"])) < 1e-6, k


# -- inside the port ---------------------------------------------------------------

def test_sharded_blocks_equal_sharded_rounds_bit_for_bit(runs):
    port, _ = runs
    for r in port:
        one, blk = r["hetero"]["rpd1"], r["hetero"]["rpd4"]
        assert list(one["losses"]) == list(blk["losses"])
        for k in ("w", "v"):
            assert _bitwise(one[k], blk[k]), k
        assert blk["n_batch_uploads"] == 0 and blk["n_block_dispatches"] > 0
        assert one["n_block_dispatches"] == 0


@pytest.mark.parametrize("name", ["coord_median", "trimmed_mean"])
def test_robust_sharded_equals_unsharded_bit_for_bit(runs, name):
    port, _ = runs
    one = _owner(port, "robust", name + "_1")
    for r in port:
        h = r["robust"][name]
        assert list(h["losses"]) == list(one["losses"])
        assert list(h["n_agg"]) == list(one["n_agg"])
        for k in ("w", "v"):
            assert _bitwise(h[k], one[k]), k
    assert sum(one["n_agg"]) > 0          # the attackers were trimmed


def test_mean_path_with_quarantine_within_tolerance_of_unsharded(runs):
    """NaN uploads on the mean path: each rank quarantines its own clients
    and the counts cross the ranks, so the survivors and losses are the
    unsharded run's exactly; w and v within JAX's trajectory tolerance."""
    port, _ = runs
    one = _owner(port, "robust", "mean_1")
    h = port[0]["robust"]["mean"]
    assert list(h["n_quarantined"]) == list(one["n_quarantined"])
    assert sum(one["n_quarantined"]) > 0
    np.testing.assert_allclose(h["losses"], one["losses"], **TRAJ_TOL)
    for k in ("w", "v"):
        np.testing.assert_allclose(h[k], one[k], **TRAJ_TOL)


def test_feddyn_sharded_equals_unsharded_bit_for_bit(runs):
    port, _ = runs
    one = _owner(port, "local", "feddyn_1")
    for r in port:
        h = r["local"]["feddyn"]
        assert list(h["losses"]) == list(one["losses"])
        for k in ("w", "v", "h"):
            assert _bitwise(h[k], one[k]), k


def test_every_rank_holds_the_same_state(runs):
    port, _ = runs
    for case, names in (("hetero", ("rpd1", "rpd4")),
                        ("robust", ("mean", "coord_median", "trimmed_mean")),
                        ("local", ("feddyn", "fedavg"))):
        for name in names:
            ref = port[0][case][name]
            for r in port[1:]:
                got = r[case][name]
                assert got["digests"] == ref["digests"], (case, name)
                assert list(got["losses"]) == list(ref["losses"])
                for k in ("w", "v"):
                    assert _bitwise(got[k], ref[k]), (case, name, k)
    assert len(port[0]["hetero"]["rpd4"]["digests"]) > 1


def test_one_collective_a_round(runs):
    port, _ = runs
    for r in port:
        assert r["first"]["collectives"] == 2
        for rpd in (1, 4):
            assert r["hetero"][f"rpd{rpd}"]["collectives"] == \
                ts.HETERO_ROUNDS
        for name in ("feddyn", "fedavg"):
            assert r["local"][name]["collectives"] == ts.LOCAL_ROUNDS
        assert r["robust"]["coord_median"]["collectives"] == ts.HETERO_ROUNDS
    for r in port:
        for name in ("mean_1", "coord_median_1", "feddyn_1"):
            for case in ("robust", "local"):
                if name in r[case]:
                    assert r[case][name]["collectives"] == 0


def test_streamed_sharded_cohorts_equal_the_replicated_store(runs):
    """The fleet spec at 4 ranks through the experiment API: streamed with
    sharded cohorts == replicated bit for bit; each rank's device rows are
    exactly its sub-cohort's clients (its `ids_by_shard` entry), about a
    quarter of the JAX-counted cohort bytes."""
    port, _ = runs
    for rank, r in enumerate(port):
        st, rep = r["fleet"]["streamed"], r["fleet"]["replicated"]
        assert st["streaming"] and not rep["streaming"]
        assert st["shards"] == rep["shards"] == RANKS
        assert st["history"] == rep["history"]
        for k in ("w", "v"):
            assert _bitwise(st[k], rep[k]), k
        assert st["collectives"] == rep["collectives"] == 6
        assert st["blocks"] and all(b["rows_ok"] and b["sharded"]
                                    for b in st["blocks"])
        for b in st["blocks"]:
            assert b["nbytes"] == RANKS * b["local_nbytes"]
        # the rank's counters count the rows it copied, one commit a block
        assert st["fleet"]["h2d_bytes"] == sum(b["local_nbytes"]
                                               for b in st["blocks"])
        assert st["fleet"] == port[0]["fleet"]["streamed"]["fleet"]
    # every block's sub-cohorts together are the block's cohort, and
    # each rank holds only its own
    for i, b0 in enumerate(port[0]["fleet"]["streamed"]["blocks"]):
        ids = [r["fleet"]["streamed"]["blocks"][i]["ids"] for r in port]
        assert len({tuple(x) for x in ids}) > 1
        assert all(len(x) <= max(map(len, ids)) for x in ids)
    digests = {tuple(b["digest"] for b in r["fleet"]["streamed"]["blocks"])
               for r in port}
    assert len(digests) == 1


def test_replicate_broadcasts_rank_0s_client_store(runs):
    port, _ = runs
    assert all(r["store"]["equal"] for r in port)


# -- process groups and the launcher ------------------------------------------------

def test_shards_without_a_process_group_raise():
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    with pytest.raises(ValueError, match="process group of 2 ranks"):
        RoundEngine(loss, ParamPack.build(params), eta=0.1, shards=2,
                    device="cpu")
    clients = ts.hetero_env((20, 20))
    with pytest.raises(ValueError, match="none is initialised"):
        FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                         device="cpu", shards=2)
    # the reference backend ignores shards, as the JAX package's does
    FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                     device="cpu", shards=2, backend="reference")


def test_nccl_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match=r"item 12\)"):
        mesh.init_shards(2, rank=0, backend="nccl", init_method="file:///x",
                         device="cpu")


def test_current_group_takes_device_none_as_cuda():
    """Over a default group set up without `init_shards`, device None
    resolves as everywhere in the port: CUDA, or an error naming
    device='cpu' on a host without a card."""
    out = mesh.spawn_shards(_shard_probes.default_group_device, 2,
                            device="cpu", timeout_s=120, threads=None)
    for raised, dev, explicit in out:
        if torch.cuda.is_available():
            assert raised is None and dev == "cuda"
        else:
            assert dev is None and "device='cpu'" in raised
        assert explicit == "cpu"


def test_spawn_shards_stops_the_ranks_of_a_failed_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        mesh.spawn_shards(_shard_probes.fail_on_rank_1, 3, device="cpu",
                          timeout_s=120, threads=None)
    # the ranks left waiting in the barrier were stopped, not timed out
    assert time.monotonic() - t0 < 60
    with pytest.raises(TimeoutError):
        mesh.spawn_shards(_shard_probes.sleep, 2, args=(300,), device="cpu",
                          timeout_s=4)
    assert mesh.spawn_shards(_shard_probes.sleep, 2, args=(0,), device="cpu",
                             timeout_s=120) == [0, 1]


def test_cli_run_then_resume_at_two_ranks(tmp_path, capsys):
    """`run` spawns the spec's 2 ranks (rank 0 writes the checkpoints and
    the JSONL); `resume` from round 2 reads the checkpoint on both ranks
    and replays the run's rounds bit for bit."""
    spec = tapi.ExperimentSpec(
        data=tapi.DataSpec(dataset="synthetic-mnist", n_clients=4,
                           sigma=5.0, n_train=240, n_test=60, seed=0),
        model=tapi.ModelSpec(name="mlp-edge", kwargs={"hidden": 16}),
        wireless=tapi.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=tapi.SchemeSpec(name="random_k", rounds=6, eta=0.1, batch=8,
                               ao={"k": 3, "lam": 0.3, "seed": 1}),
        run=tapi.RunSpec(seed=0, eval_every=3, stop_on_budget=False,
                         shards=2, checkpoint_every=2))
    spec_path = spec.save(str(tmp_path / "spec.json"))
    ckpt = str(tmp_path / "ckpt")
    out1, out2 = str(tmp_path / "run.jsonl"), str(tmp_path / "res.jsonl")
    assert cli.main(["run", spec_path, "--out", out1, "--checkpoint-dir",
                     ckpt, "--device", "cpu"]) == 0
    assert sorted(os.listdir(ckpt))
    assert cli.main(["resume", ckpt, "--step", "2", "--out", out2,
                     "--device", "cpu"]) == 0
    capsys.readouterr()
    full = tapi.RunResult.from_jsonl(out1)
    resumed = tapi.RunResult.from_jsonl(out2)
    assert full.summary["rounds_run"] == 6
    assert resumed.summary["resumed_from"] == 2
    assert full.spec["run"]["shards"] == 2
    rec = [dataclasses.astuple(m) for m in full.history]
    assert [dataclasses.astuple(m) for m in resumed.history] == rec
