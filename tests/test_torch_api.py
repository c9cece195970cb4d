"""The port's experiment API (`repro_torch.api`) and checkpoints, on the CPU,
against the JAX package's `repro.api`.

* Specs: dict/JSON/file round trips and their errors; one spec's dict is
  the same in both packages.
* Registries: the same names; `resnet`, the fleet datasets and the local
  schemes beyond single-step fedavg raise naming their ROADMAP items; the
  rest resolve.
* `Experiment.build`: the port's schedule equals JAX's bit for bit, and a
  run from JAX's initial weights (a model registered for the test returns
  them through `convert`) keeps JAX's selection and energy/delay ledger
  exactly, losses to rtol 1e-3 and weights to atol 1e-4 (the layer-(d)
  tolerance of tests/test_torch_e2e.py).
* Callbacks fire at materialisation points; kill and resume is bit for bit
  at rounds_per_dispatch 1 and 4; a truncated checkpoint is skipped.
* Checkpoints cross packages in both directions with identical arrays and
  meta, trainer state included; the RunResult JSONL reads back through
  `benchmarks/report.py` and JAX's `RunResult.from_jsonl`.
* The CLI's run / validate / resume, and `sweep` naming its item.
"""
import dataclasses
import glob
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.checkpoint import CheckpointManager as JManager  # noqa: E402
from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import cli  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointManager, load_checkpoint,
                                    save_checkpoint)
from repro_torch.models import cnn  # noqa: E402

N, ROUNDS, BATCH = 5, 10, 8
# the JAX package's registries as they stand at import (collection), before
# any test runs: tests/test_api.py registers a model there for good, and a
# worker that runs it first would show that name in the live registry
JAX_REGISTRY_NAMES = {name: getattr(japi, name).names() for name in (
    "MODELS", "DATASETS", "SCHEMES", "DATA_SELECTION", "CHANNEL_NOISE",
    "FAULT_MODELS")}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test: the suite runs in parallel
    workers beside XLA's thread pools, and torch's default pool (a thread
    per core in every worker) oversubscribes the cores several times over.
    The port's tests use small tensors, where one thread loses little."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def small_spec(api, model="mlp-edge", **run_kw):
    return api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-mnist", n_clients=N, sigma=5.0,
                          n_train=300, n_test=80, seed=0),
        model=api.ModelSpec(name=model),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="proposed_exact", rounds=ROUNDS, eta=0.1,
                              batch=BATCH, ao={"outer_iters": 1}),
        run=api.RunSpec(seed=0, eval_every=5, **run_kw))


def _with_run(spec, **kw):
    return dataclasses.replace(spec, run=dataclasses.replace(spec.run, **kw))


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _params_bitwise(a, b):
    return all(torch.equal(_bits(a[k]), _bits(b[k])) for k in a)


@pytest.fixture(scope="module")
def api_result():
    run = tapi.Experiment(small_spec(tapi)).build(device="cpu")
    return run, run.run()


# -- specs ---------------------------------------------------------------------

def test_spec_roundtrips_and_matches_jax(tmp_path):
    spec = small_spec(tapi, rounds_per_dispatch=4)
    assert tapi.ExperimentSpec.from_dict(spec.to_dict()) == spec
    assert tapi.ExperimentSpec.from_json(spec.to_json()) == spec
    path = spec.save(str(tmp_path / "spec.json"))
    assert tapi.ExperimentSpec.from_file(path) == spec
    # one spec file runs in either package
    jspec = japi.ExperimentSpec.from_file(path)
    assert jspec.to_dict() == spec.to_dict()
    assert tapi.ExperimentSpec().to_dict() == japi.ExperimentSpec().to_dict()
    assert tapi.RunSpec().rounds_per_dispatch == "auto"


def test_spec_errors_name_the_field():
    with pytest.raises(tapi.SpecError, match=r"ExperimentSpec.data: "
                                             r"unknown key\(s\) \['nclients'\]"):
        tapi.ExperimentSpec.from_dict({"data": {"nclients": 3}})
    with pytest.raises(tapi.SpecError, match="expected a dict"):
        tapi.ExperimentSpec.from_dict({"run": 3})


# -- registries ------------------------------------------------------------------

def test_registries_match_jax_and_name_unported_items():
    for name, jax_names in JAX_REGISTRY_NAMES.items():
        assert getattr(tapi, name).names() == jax_names
    from repro.api.registry import LOCAL_SCHEMES as JLOCAL
    assert tapi.LOCAL_SCHEMES.names() == JLOCAL.names()
    with pytest.raises(KeyError, match="unknown model 'wat'; registered"):
        tapi.MODELS.get("wat")
    with pytest.raises(ValueError, match="already registered"):
        tapi.register_model("lenet", lambda s, d: None)
    ds = tapi.DATASETS.get("synthetic-mnist")(tapi.DataSpec(n_train=40,
                                                            n_test=10))
    # resnet, the local schemes and the fleet datasets resolve (ported)
    init, apply = tapi.MODELS.get("resnet")(tapi.ModelSpec(name="resnet"), ds)
    assert apply is cnn.resnet_apply
    assert len(init(torch.Generator().manual_seed(0), device="cpu")
               ["blocks"]) == 9
    for fleet in ("synthetic-fleet", "synthetic-fleet-cifar"):
        spec = tapi.DataSpec(dataset=fleet, n_clients=7, n_train=70,
                             n_test=10)
        fds = tapi.DATASETS.get(fleet)(spec)
        jfds = japi.DATASETS.get(fleet)(japi.DataSpec(**spec.to_dict()))
        assert len(fds.roster) == 7 and fds.image_shape == jfds.image_shape
        np.testing.assert_array_equal(fds.roster.counts, jfds.roster.counts)
    assert tapi.LOCAL_SCHEMES.get("fedavg")(tapi.SchemeSpec()) is None
    from repro.core.local import make_local_scheme as jmake
    for name, steps in (("fedavg", 2), ("fedprox", 1), ("feddyn", 3)):
        assert tapi.LOCAL_SCHEMES.get(name)(tapi.SchemeSpec(
            local_scheme=name, local_steps=steps)).spec_key == \
            jmake(name, steps=steps).spec_key
    with pytest.raises(ValueError, match="unknown local scheme kwargs"):
        tapi.LOCAL_SCHEMES.get("fedavg")(
            tapi.SchemeSpec(local_kwargs={"nu": 1.0}))
    # everything else resolves
    sc = tapi.SchemeSpec(name="random_k", ao={"k": 2, "lam": 0.1})
    assert callable(tapi.SCHEMES.get("random_k")(sc))
    for name in tapi.SCHEMES.names():
        if name != "random_k":
            assert dataclasses.asdict(
                tapi.SCHEMES.get(name)(tapi.SchemeSpec(name=name))) == \
                dataclasses.asdict(
                    japi.SCHEMES.get(name)(japi.SchemeSpec(name=name)))
    ws = tapi.WirelessSpec(noise_kwargs={"std": 1e-3},
                           fault_kwargs={"rate": 0.2})
    assert tapi.CHANNEL_NOISE.get("gaussian")(ws).std == 1e-3
    for name in ("dropout", "corrupt", "sign_flip", "scaled_malicious",
                 "gaussian_poison"):
        assert tapi.FAULT_MODELS.get(name)(ws) is not None
    sel = tapi.DATA_SELECTION.get("threshold")(tapi.SchemeSpec(
        data_selection="threshold", data_selection_kwargs={"keep_frac": 0.5}))
    from repro_torch.core import ClientData
    rng = np.random.default_rng(0)
    c = ClientData(rng.random((20, 28, 28, 1)).astype(np.float32),
                   rng.integers(0, 10, 20).astype(np.int32))
    assert 0 < len(sel([c])[0]) < 20


def test_build_schedule_matches_jax_bitwise():
    spec = small_spec(tapi)
    run = tapi.Experiment(spec).build(device="cpu")
    jrun = japi.Experiment(japi.ExperimentSpec.from_dict(spec.to_dict())
                           ).build()
    for f in ("a", "lam", "power", "freq"):
        np.testing.assert_array_equal(getattr(run.schedule, f),
                                      getattr(jrun.schedule, f))
    for f in ("theta", "energy", "delay", "feasible"):
        assert getattr(run.schedule, f) == getattr(jrun.schedule, f)
    np.testing.assert_array_equal(run.env.phi, jrun.env.phi)
    assert run.trainer.rounds_per_dispatch == 1       # "auto" on the CPU
    assert len(run.trainer.clients) == len(jrun.trainer.clients)


def test_port_experiment_matches_jax_experiment(request):
    """The same spec through both packages from JAX's LeNet weights."""
    def jax_lenet(spec, dataset):
        jp = jcnn.lenet_init(jax.random.key(0))
        tp = convert.params_from_numpy({k: np.asarray(v)
                                        for k, v in jp.items()})
        return (lambda gen, device=None: {k: t.to(device)
                                          for k, t in tp.items()},
                cnn.lenet_apply)

    tapi.register_model("lenet-jax-init", jax_lenet, override=True)
    # the registry is the process's: leave it as the other tests find it
    request.addfinalizer(
        lambda: tapi.MODELS._items.pop("lenet-jax-init", None))
    spec = small_spec(tapi, model="lenet-jax-init", rounds_per_dispatch=4)
    spec = dataclasses.replace(
        spec, scheme=dataclasses.replace(spec.scheme, rounds=6, batch=16))
    run = tapi.Experiment(spec).build(device="cpu")
    res = run.run()
    jspec = japi.ExperimentSpec.from_dict(
        {**spec.to_dict(), "model": {"name": "lenet", "kwargs": {}}})
    jrun = japi.Experiment(jspec).build()
    jres = jrun.run()
    assert len(res.history) == len(jres.history) == 6
    for a, b in zip(res.history, jres.history):
        assert (a.round, a.selected, a.mean_lambda, a.delay, a.energy,
                a.cumulative_delay, a.cumulative_energy) == (
            b.round, b.selected, b.mean_lambda, b.delay, b.energy,
            b.cumulative_delay, b.cumulative_energy)
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-3)
        assert (a.test_loss is None) == (b.test_loss is None)
    for k, v in jrun.trainer.params.items():
        np.testing.assert_allclose(run.trainer.params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4)
    for f in ("theta", "energy", "delay", "feasible", "rounds_run",
              "final_accuracy_round", "cumulative_delay",
              "cumulative_energy", "resumed_from"):
        assert res.summary[f] == jres.summary[f], f


def test_trainer_reuse_is_a_cold_build():
    """build(trainer=) resets a used trainer (params, v, RNG, counters) to
    the new spec's state: the same bits as a cold build, and mismatched
    wiring is refused."""
    spec = small_spec(tapi, rounds_per_dispatch=4)
    cold = tapi.Experiment(spec).build(device="cpu")
    res_cold = cold.run()
    used = tapi.Experiment(_with_run(spec, seed=3)).build(device="cpu")
    used.run()
    warm = tapi.Experiment(spec).build(env=used.env, trainer=used.trainer)
    assert warm.trainer is used.trainer
    res_warm = warm.run()
    assert [m.train_loss for m in res_warm.history] == \
        [m.train_loss for m in res_cold.history]
    assert _params_bitwise(warm.trainer.params, cold.trainer.params)
    assert warm.trainer.n_block_dispatches == cold.trainer.n_block_dispatches
    bad = dataclasses.replace(spec, scheme=dataclasses.replace(
        spec.scheme, aggregator="coord_median"))
    with pytest.raises(ValueError, match="scheme.aggregator"):
        tapi.Experiment(bad).build(env=used.env, trainer=used.trainer)


# -- callbacks and resume --------------------------------------------------------------

class Recorder(tapi.Callback):
    def __init__(self):
        self.round_end, self.evals, self.blocks, self.ckpts = [], [], [], []

    def on_round_end(self, m, trainer):
        assert not np.isnan(m.train_loss)        # materialised
        self.round_end.append(m.round)

    def on_eval(self, m, trainer):
        self.evals.append(m.round)

    def on_block_end(self, start, n_rounds, trainer):
        self.blocks.append((start, n_rounds))

    def on_checkpoint(self, m, trainer):
        self.ckpts.append(m.round)


def test_callbacks_fire_at_materialization_points():
    rec = Recorder()
    rec.checkpoint_every = 3
    run = tapi.Experiment(small_spec(tapi, rounds_per_dispatch=4)
                          ).build(device="cpu")
    run.run(callbacks=[rec])
    assert rec.round_end == list(range(ROUNDS))
    assert rec.evals == [0, 5, ROUNDS - 1]
    assert rec.ckpts == [0, 3, 6, 9]
    covered = [s for start, k in rec.blocks for s in range(start, start + k)]
    assert covered == list(range(ROUNDS))        # every round in a block
    # a block ends at an eval or checkpoint round, never spans one
    boundaries = {0, 3, 5, 6, 9}
    assert all(s not in boundaries for start, k in rec.blocks
               for s in range(start, start + k - 1))


class KillAt(tapi.Callback):
    """A crash right after the checkpoint at `round_` is written (the
    CheckpointCallback is ordered first)."""

    def __init__(self, round_, every):
        self.round_ = round_
        self.checkpoint_every = every

    def on_checkpoint(self, m, trainer):
        if m.round == self.round_:
            raise RuntimeError("simulated mid-run kill")


@pytest.mark.parametrize("rpd", [1, 4])
def test_kill_resume_bitwise(tmp_path, rpd):
    base = small_spec(tapi, rounds_per_dispatch=rpd)
    run_a = tapi.Experiment(base).build(device="cpu")
    res_a = run_a.run()
    ckpt = str(tmp_path / f"ckpt_rpd{rpd}")
    spec = _with_run(base, checkpoint_dir=ckpt, checkpoint_every=3)
    run_k = tapi.Experiment(spec).build(device="cpu")
    with pytest.raises(RuntimeError, match="simulated"):
        run_k.run(callbacks=[KillAt(3, 3)])
    assert run_k.trainer._callbacks == ()
    run_b = tapi.Experiment(spec).build(device="cpu")
    res_b = run_b.resume(ckpt)
    assert res_b.summary["resumed_from"] == 3
    assert [m.round for m in res_b.history] == list(range(ROUNDS))
    for fld in ("train_loss", "test_loss", "test_accuracy",
                "cumulative_delay", "cumulative_energy", "selected"):
        assert [getattr(m, fld) for m in res_b.history] == \
            [getattr(m, fld) for m in res_a.history], fld
    assert _params_bitwise(run_a.trainer.params, run_b.trainer.params)
    assert _params_bitwise(run_a.trainer.global_grad,
                           run_b.trainer.global_grad)
    assert run_b.trainer.rng.bit_generator.state == \
        run_a.trainer.rng.bit_generator.state
    res_c = tapi.resume_from_checkpoint(ckpt, step=3, device="cpu")
    assert [m.train_loss for m in res_c.history] == \
        [m.train_loss for m in res_a.history]


def test_resume_skips_truncated_checkpoint(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    spec = _with_run(small_spec(tapi), checkpoint_dir=ckpt,
                     checkpoint_every=3)
    res_a = tapi.Experiment(spec).run(device="cpu")
    latest = sorted(glob.glob(f"{ckpt}/ckpt_*.npz"))[-1]
    assert "00000009" in latest
    with open(latest, "rb") as f:
        head = f.read(64)
    with open(latest, "wb") as f:
        f.write(head)
    with pytest.raises(CheckpointCorruptError, match="truncated"):
        tapi.resume_from_checkpoint(ckpt, step=9, device="cpu")
    assert cli.main(["validate", "--checkpoints", ckpt]) == 1
    res_b = tapi.resume_from_checkpoint(ckpt, device="cpu")
    assert res_b.summary["resumed_from"] == 6
    assert [m.train_loss for m in res_b.history] == \
        [m.train_loss for m in res_a.history]
    assert tapi.resume_from_checkpoint(ckpt, device="cpu"
                                       ).summary["resumed_from"] == 9
    # run_or_resume normalises resumed_from: the same JSONL as a clean run
    res_d = tapi.Experiment(spec).build(device="cpu").run_or_resume(ckpt)
    assert res_d.summary == res_a.summary


# -- checkpoints across the two packages -------------------------------------------------

def test_checkpoints_cross_packages_both_ways(tmp_path):
    jp = jcnn.lenet_init(jax.random.key(3))
    jv = {k: 0.5 * v for k, v in jp.items()}
    meta = {"round": 7, "note": "x"}
    jsave(str(tmp_path / "from_jax"), {"params": jp, "v": jv}, step=7,
          extra=meta)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    like = {"params": tp, "v": {k: torch.zeros_like(t) for k, t in tp.items()}}
    tree, tmeta = load_checkpoint(str(tmp_path / "from_jax"), like)
    for k in jp:
        np.testing.assert_array_equal(tree["params"][k].numpy(),
                                      np.asarray(jp[k]))
        np.testing.assert_array_equal(tree["v"][k].numpy(),
                                      np.asarray(jv[k]))
        assert tree["params"][k].dtype == torch.float32
    assert tmeta["extra"] == meta and tmeta["step"] == 7
    # the reverse: the port writes, JAX reads, same keys and meta
    save_checkpoint(str(tmp_path / "from_port"), tree, step=7, extra=meta)
    jtree, jmeta = jload(str(tmp_path / "from_port"),
                         {"params": jp, "v": jv})
    for k in jp:
        np.testing.assert_array_equal(np.asarray(jtree["params"][k]),
                                      np.asarray(jp[k]))
    assert jmeta == tmeta
    assert json.load(open(tmp_path / "from_port.meta.json"))["keys"] == \
        json.load(open(tmp_path / "from_jax.meta.json"))["keys"]
    with np.load(tmp_path / "from_port.npz") as z:
        assert "['params']['conv1']" in z.files
    # a whole trainer state: JAX run -> port trainer resumes its RNG
    jrun = japi.Experiment(japi.ExperimentSpec.from_dict(
        small_spec(tapi, model="lenet").to_dict())).build()
    mgr = JManager(str(tmp_path / "jstate"))
    m = jrun.run().history[4]
    japi.save_trainer_state(mgr, jrun.trainer, m)
    run = tapi.Experiment(small_spec(tapi, model="lenet")).build(device="cpu")
    extra = tapi.restore_trainer_state(CheckpointManager(
        str(tmp_path / "jstate")), run.trainer)
    assert extra["round"] == 4
    assert run.trainer.rng.bit_generator.state == \
        jrun.trainer.rng.bit_generator.state
    for k, v in jrun.trainer.params.items():
        np.testing.assert_array_equal(run.trainer.params[k].numpy(),
                                      np.asarray(v))


# -- RunResult and the CLI --------------------------------------------------------------

def test_runresult_jsonl_reads_in_report_and_jax(tmp_path, api_result):
    _, res = api_result
    path = str(tmp_path / "run.jsonl")
    res.to_jsonl(path)
    back = tapi.RunResult.from_jsonl(path)
    assert back.spec == res.spec and back.summary == res.summary
    assert [dataclasses.asdict(m) for m in back.history] == \
        [dataclasses.asdict(m) for m in res.history]
    jback = japi.RunResult.from_jsonl(path)
    assert jback.summary == res.summary
    assert [dataclasses.asdict(m) for m in jback.history] == \
        [dataclasses.asdict(m) for m in res.history]
    report = pytest.importorskip("benchmarks.report")
    table = report.runs_table([path])
    assert "synthetic-mnist" in table and "proposed_exact" in table
    assert f"{res.summary['final_accuracy']:.3f}" in table
    with open(path) as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds[0] == "experiment" and set(kinds[1:]) == {"round"}


def test_cli_run_validate_resume(tmp_path, capsys):
    spec = small_spec(tapi)
    spec = dataclasses.replace(
        spec, scheme=dataclasses.replace(spec.scheme, rounds=4),
        run=dataclasses.replace(spec.run, eval_every=2, checkpoint_every=2))
    spec_path = spec.save(str(tmp_path / "spec.json"))
    ckpt = str(tmp_path / "ckpt")
    out1, out2 = str(tmp_path / "run.jsonl"), str(tmp_path / "res.jsonl")
    assert cli.main(["validate", spec_path]) == 0
    assert cli.main(["run", spec_path, "--out", out1, "--checkpoint-dir",
                     ckpt, "--device", "cpu"]) == 0
    assert cli.main(["validate", "--checkpoints", ckpt]) == 0
    assert cli.main(["resume", ckpt, "--out", out2, "--device", "cpu"]) == 0
    capsys.readouterr()
    full = tapi.RunResult.from_jsonl(out1)
    resumed = tapi.RunResult.from_jsonl(out2)
    assert full.summary["rounds_run"] == 4
    assert resumed.summary["resumed_from"] == 2
    assert [m.train_loss for m in resumed.history] == \
        [m.train_loss for m in full.history]
    bad = dataclasses.replace(spec, model=tapi.ModelSpec(name="wat"))
    with pytest.raises(KeyError, match="unknown model 'wat'"):
        cli.main(["validate", bad.save(str(tmp_path / "bad.json"))])
    # sweep is ported (tests/test_torch_sweep.py): the spec expands
    assert cli.main(["sweep", spec_path, "--seeds", "0,1",
                     "--expand-only"]) == 0
    assert "sweep matrix: 2 run(s)" in capsys.readouterr().out
