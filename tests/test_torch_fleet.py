"""Fleet-scale rosters and cohort streaming in the port (`repro_torch`), on
the CPU, against the JAX package.

* `make_fleet`: the port's roster is the JAX roster byte for byte (counts,
  test set, normalisation, templates, labels-only replay, every client's x
  and y), for both fleet datasets.
* `CohortStore`: cohort rows are byte-copies of a replicated ClientStore's
  rows on randomised block plans; cohorts alternate between two fixed
  device slots; its counters equal the JAX CohortStore's on the same plans.
* The trainer: streamed == replicated bit for bit (FedSGD at
  rounds_per_dispatch 2 and 4, with faults and evaluation, FedDyn with its
  state, kill and resume); a reused trainer keeps its slots; a roster stays
  lazy.
* Against JAX through the experiment API: the fleet counters (all but the
  stall seconds) are JAX's, and the streamed trajectory from JAX's initial
  weights stays within atol 1e-4 of JAX's after 6 rounds (layer (d)).
* Policy: "auto" resolves on the budget, StoreBudgetError names the
  population, data selection on a roster is refused. (Sharded cohorts:
  tests/test_torch_sharding.py.)
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.core import CohortStore as JCohortStore  # noqa: E402
from repro.data import make_fleet as jmake_fleet  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import (ClientStore, CohortStore,  # noqa: E402
                              StoreBudgetError, estimated_store_nbytes)
from repro_torch.data import make_fleet  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

POP, ROUNDS, BATCH = 24, 6, 8


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


def fleet_spec(api, mode: str = "auto", *, model: str = "mlp-edge",
               rounds: int = ROUNDS, k: int = 5, scheme_kw=None,
               **run_kw):
    return api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-fleet", n_clients=POP,
                          n_train=24 * POP, n_test=64, seed=5),
        model=api.ModelSpec(name=model,
                            kwargs={"hidden": 16} if model == "mlp-edge"
                            else {}),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="random_k", rounds=rounds, batch=BATCH,
                              ao={"k": k, "lam": 0.3, "seed": 1},
                              **(scheme_kw or {})),
        run=api.RunSpec(seed=2, eval_every=3, stop_on_budget=False,
                        client_store=mode, **run_kw))


def history_records(res):
    """Every numeric field of every round, by repr (exact floats); never
    the summary, whose stall seconds are wall clock."""
    return [(m.round, repr(m.train_loss), tuple(int(i) for i in m.selected),
             repr(m.energy), repr(m.delay), repr(m.cumulative_energy),
             repr(m.cumulative_delay), repr(m.test_loss),
             repr(m.test_accuracy), m.n_faulted) for m in res.history]


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def params_bitwise(a, b) -> bool:
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(leaves(a), leaves(b)))


def run_port(spec, **build_kw):
    run = tapi.Experiment(spec).build(device="cpu", **build_kw)
    return run, run.run()


def warm(roster):
    """Generate every client once (the roster caches them), so a cohort's
    host pack is a copy and its prefetch always finishes within the block
    before it: the peak counter then reads the planned value in both
    packages."""
    for cid in range(len(roster)):
        roster[cid]


# -- the roster ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["synthetic-fleet", "synthetic-fleet-cifar"])
def test_make_fleet_matches_jax_bytes(name):
    kw = dict(population=13, n_train=130, n_test=20, sigma=0.7, noise=0.3,
              seed=11)
    ds, jds = make_fleet(name, **kw), jmake_fleet(name, **kw)
    r, jr = ds.roster, jds.roster
    assert ds.name == jds.name and ds.image_shape == jds.image_shape
    assert ds.num_classes == jds.num_classes
    np.testing.assert_array_equal(r.counts, jr.counts)
    assert r.norm == jr.norm
    np.testing.assert_array_equal(r.templates, jr.templates)
    np.testing.assert_array_equal(ds.x_test, jds.x_test)
    np.testing.assert_array_equal(ds.y_test, jds.y_test)
    assert ds.x_test.dtype == jds.x_test.dtype
    assert r.store_nbytes() == jr.store_nbytes()
    np.testing.assert_array_equal(r.label_histograms(),
                                  jr.label_histograms())
    for cid in range(len(r)):
        c, jc = r[cid], jr[cid]
        assert c.x.dtype == jc.x.dtype and c.y.dtype == jc.y.dtype
        assert c.x.tobytes() == jc.x.tobytes()
        assert c.y.tobytes() == jc.y.tobytes()
        np.testing.assert_array_equal(r.client_labels(cid),
                                      jr.client_labels(cid))


def test_roster_replay_cache_sizing_and_no_dense_split():
    ds = make_fleet(population=30, n_train=600, n_test=32, seed=3)
    r = ds.roster
    assert len(r) == 30 and len(r[-1]) == int(r.counts[29])
    for cid in (0, 7, 29):
        # labels-only replay draws the same stream prefix as generation
        np.testing.assert_array_equal(r.client_labels(cid), r[cid].y)
    assert r[4] is r[4]                        # an LRU hit
    assert r.store_nbytes() == estimated_store_nbytes(r)
    with pytest.raises(IndexError):
        r[30]
    with pytest.raises(AttributeError, match="virtual"):
        ds.x_train
    with pytest.raises(ValueError, match="unknown fleet dataset"):
        make_fleet("synthetic-fleet-wat", population=3)


# -- the cohort store ---------------------------------------------------------

def block_plans(rng, population: int, n_blocks: int):
    """Trainer-shaped block plans: per-round selections, rows padded by
    repeating the round's last real client (`_block_cids`)."""
    plans, start = [], 0
    for _ in range(n_blocks):
        k_rounds = int(rng.integers(1, 5))
        c_real = [int(rng.integers(1, population + 1))
                  for _ in range(k_rounds)]
        c_max = max(c_real)
        cids = np.empty((k_rounds, c_max), np.int32)
        for k, c in enumerate(c_real):
            sel = np.sort(rng.choice(population, size=c, replace=False))
            cids[k, :c] = sel
            cids[k, c:] = sel[-1]
        plans.append((start, cids, np.asarray(c_real)))
        start += k_rounds
    return plans


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_cohort_rows_match_replicated_store_and_jax_counters(seed):
    rng = np.random.default_rng(seed)
    population = int(rng.integers(6, 41))
    kw = dict(population=population, n_train=8 * population, n_test=8,
              seed=seed % 17)
    roster, jroster = make_fleet(**kw).roster, jmake_fleet(**kw).roster
    warm(roster)
    warm(jroster)
    plans = block_plans(rng, population, n_blocks=5)
    rep = ClientStore.build(list(roster), device="cpu")
    store = CohortStore(roster, max_clients=population, device="cpu")
    jstore = JCohortStore(jroster, max_clients=population)
    store.schedule(plans)
    jstore.schedule(plans)
    for i, (start, cids, _) in enumerate(plans):
        cohort, jcohort = store.acquire(start), jstore.acquire(start)
        for s in (store, jstore):         # the prefetch finished in time
            if i + 1 in s._pending:
                s._pending[i + 1][0].join()
        assert cohort.x is store.slots.x and cohort.y is store.slots.y
        assert cohort.slot == i % 2
        assert cohort.base == (i % 2) * store.slots.rows
        assert cohort.nbytes == jcohort.nbytes
        np.testing.assert_array_equal(cohort.counts, jcohort.counts)
        rows = cohort.remap(cids)
        np.testing.assert_array_equal(rows - cohort.base,
                                      jcohort.remap(cids))
        # the cohort's rows are byte-copies of the replicated store's, and
        # of the JAX cohort's (zero padding included)
        n = len(cohort.counts)
        got = cohort.x[cohort.base:cohort.base + n]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jcohort.x))
        np.testing.assert_array_equal(
            cohort.y[cohort.base:cohort.base + n].numpy(),
            np.asarray(jcohort.y))
        rt, ct = torch.as_tensor(rows).long(), torch.as_tensor(cids).long()
        assert torch.equal(cohort.x[rt], rep.x[ct])
        assert torch.equal(cohort.y[rt], rep.y[ct])
    assert {k: store.counters[k] for k in ("n_cohort_swaps", "h2d_bytes",
                                           "peak_cohort_bytes")} == \
        {k: jstore.counters[k] for k in ("n_cohort_swaps", "h2d_bytes",
                                         "peak_cohort_bytes")}
    slots = store.slots
    store.close()
    jstore.close()
    # a later store over the same population reuses the slots
    again = CohortStore(roster, max_clients=population, device="cpu",
                        slots=slots)
    again.schedule(plans[:2])
    assert again.slots is slots
    again.close()


# -- the trainer: streamed == replicated ---------------------------------------

@pytest.mark.parametrize("rpd", [2, 4])
def test_streamed_equals_replicated_bitwise(rpd):
    run_rep, res_rep = run_port(
        fleet_spec(tapi, "replicated", rounds_per_dispatch=rpd))
    run_str, res_str = run_port(
        fleet_spec(tapi, "streamed", rounds_per_dispatch=rpd))
    assert res_rep.summary["rounds_run"] == ROUNDS
    assert history_records(res_rep) == history_records(res_str)
    assert params_bitwise(run_rep.trainer.params, run_str.trainer.params)
    assert torch.equal(run_rep.trainer._v, run_str.trainer._v)
    assert run_str.trainer.n_batch_uploads == 0
    # the roster stayed lazy: the trainer holds it, not a list
    assert run_str.trainer.clients is run_str.env.clients
    assert "fleet" not in res_rep.summary
    fleet = res_str.summary["fleet"]
    assert set(fleet) == {"n_cohort_swaps", "h2d_bytes", "prefetch_stall_s",
                          "peak_cohort_bytes"}
    assert fleet["n_cohort_swaps"] == run_str.trainer.n_block_dispatches
    assert fleet["h2d_bytes"] > 0 and fleet["peak_cohort_bytes"] > 0
    if fleet["n_cohort_swaps"] >= 2:
        assert fleet["peak_cohort_bytes"] <= fleet["h2d_bytes"]


def test_streamed_with_faults_and_eval():
    def with_faults(mode):
        s = fleet_spec(tapi, mode, rounds_per_dispatch=3)
        return dataclasses.replace(s, wireless=dataclasses.replace(
            s.wireless, fault_model="dropout", fault_kwargs={"rate": 0.3}))
    run_rep, res_rep = run_port(with_faults("replicated"))
    run_str, res_str = run_port(with_faults("streamed"))
    assert history_records(res_rep) == history_records(res_str)
    assert res_rep.summary["faults"] == res_str.summary["faults"]
    assert any(m.n_faulted for m in res_str.history)
    assert any(m.test_accuracy is not None for m in res_str.history)
    assert params_bitwise(run_rep.trainer.params, run_str.trainer.params)


def test_streamed_feddyn_bitwise_with_its_state():
    kw = dict(scheme_kw=dict(local_scheme="feddyn", local_steps=2,
                             local_kwargs={"alpha": 0.01}),
              rounds_per_dispatch=2)
    run_rep, res_rep = run_port(fleet_spec(tapi, "replicated", **kw))
    run_str, res_str = run_port(fleet_spec(tapi, "streamed", **kw))
    assert history_records(res_rep) == history_records(res_str)
    assert params_bitwise(run_rep.trainer.params, run_str.trainer.params)
    h_rep, h_str = run_rep.trainer._h, run_str.trainer._h
    assert h_str.shape[0] == POP              # population-sized, as JAX's
    assert torch.equal(_bits(h_rep), _bits(h_str))
    assert float(h_str.abs().sum()) > 0
    # and the reference backend agrees
    run_ref, res_ref = run_port(fleet_spec(tapi, "streamed",
                                           backend="reference", **kw))
    assert [m.train_loss for m in res_ref.history] == \
        [m.train_loss for m in res_str.history]
    assert params_bitwise(run_ref.trainer.params, run_str.trainer.params)


class KillAt(tapi.Callback):
    def __init__(self, round_, every):
        self.round_ = round_
        self.checkpoint_every = every

    def on_checkpoint(self, m, trainer):
        if m.round == self.round_:
            raise RuntimeError("simulated mid-run kill")


def test_streamed_kill_resume_bitwise(tmp_path):
    base = fleet_spec(tapi, "streamed", rounds_per_dispatch=2)
    run_a, res_a = run_port(base)
    ckpt = str(tmp_path / "ckpt")
    spec = dataclasses.replace(base, run=dataclasses.replace(
        base.run, checkpoint_dir=ckpt, checkpoint_every=2))
    with pytest.raises(RuntimeError, match="simulated"):
        tapi.Experiment(spec).build(device="cpu").run(
            callbacks=[KillAt(2, 2)])
    run_b = tapi.Experiment(spec).build(device="cpu")
    res_b = run_b.resume(ckpt)
    assert res_b.summary["resumed_from"] == 2
    assert history_records(res_a) == history_records(res_b)
    assert params_bitwise(run_a.trainer.params, run_b.trainer.params)
    # the resumed leg streams too: the same cohort plan from round 3 on
    assert 1 <= res_b.summary["fleet"]["n_cohort_swaps"] < \
        res_a.summary["fleet"]["n_cohort_swaps"]


def test_reused_trainer_keeps_its_slots_and_bits():
    spec = fleet_spec(tapi, "streamed", rounds_per_dispatch=2)
    cold, res_cold = run_port(spec)
    used = tapi.Experiment(dataclasses.replace(
        spec, run=dataclasses.replace(spec.run, seed=7))).build(device="cpu")
    used.run()
    slots = used.trainer._cohort_slots
    assert slots is not None
    warm_run = tapi.Experiment(spec).build(env=used.env,
                                           trainer=used.trainer)
    res_warm = warm_run.run()
    assert warm_run.trainer._cohort_slots is slots
    assert history_records(res_warm) == history_records(res_cold)
    assert params_bitwise(warm_run.trainer.params, cold.trainer.params)
    assert res_warm.summary["fleet"]["n_cohort_swaps"] == \
        res_cold.summary["fleet"]["n_cohort_swaps"]


# -- against JAX ----------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_streamed():
    spec = fleet_spec(japi, "streamed", rounds_per_dispatch=2)
    run = japi.Experiment(spec).build()
    warm(run.env.clients)
    return spec, run, run.run()


def test_fleet_counters_equal_jax(jax_streamed):
    jspec, _, jres = jax_streamed
    spec = tapi.ExperimentSpec.from_dict(jspec.to_dict())
    run = tapi.Experiment(spec).build(device="cpu")
    warm(run.env.clients)
    res = run.run()
    keys = ("n_cohort_swaps", "h2d_bytes", "peak_cohort_bytes")
    assert {k: res.summary["fleet"][k] for k in keys} == \
        {k: jres.summary["fleet"][k] for k in keys}
    for a, b in zip(res.history, jres.history):
        assert (a.round, a.selected, a.energy, a.delay) == \
            (b.round, b.selected, b.energy, b.delay)


def test_streamed_trajectory_matches_jax_from_its_init(jax_streamed, request):
    """Layer (d): the port's streamed run from JAX's initial weights stays
    within atol 1e-4 of JAX's streamed run after 6 rounds."""
    jspec, jrun, jres = jax_streamed
    jp = jcnn.mlp_edge_init(jax.random.key(jspec.run.seed), hidden=16)
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})

    def jax_init(spec, dataset):
        return (lambda gen, device=None: {k: t.to(device)
                                          for k, t in tp.items()},
                cnn.mlp_edge_apply)

    tapi.register_model("mlp-edge-jax-init", jax_init, override=True)
    # the registry is the process's: leave it as the other files find it
    request.addfinalizer(
        lambda: tapi.MODELS._items.pop("mlp-edge-jax-init", None))
    run, res = run_port(fleet_spec(tapi, "streamed", rounds_per_dispatch=2,
                                   model="mlp-edge-jax-init"))
    assert "fleet" in res.summary and len(res.history) == ROUNDS
    for a, b in zip(res.history, jres.history):
        assert (a.round, a.selected, a.mean_lambda, a.energy) == \
            (b.round, b.selected, b.mean_lambda, b.energy)
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-3)
    for k, v in jrun.trainer.params.items():
        np.testing.assert_allclose(run.trainer.params[k].numpy(),
                                   np.asarray(v), rtol=0, atol=1e-4)


# -- policy ------------------------------------------------------------------------

def test_auto_mode_resolves_on_budget():
    tr = tapi.Experiment(fleet_spec(tapi, "auto", rounds_per_dispatch=2)
                         ).build(device="cpu").trainer
    assert tr.store_mode() == "replicated"    # a tiny roster fits 1 GiB
    small = fleet_spec(tapi, "auto", rounds_per_dispatch=2,
                       device_mem_budget=1024)
    run = tapi.Experiment(small).build(device="cpu")
    assert run.trainer.store_mode() == "streamed"
    assert "fleet" in run.run().summary       # "auto" actually streamed


def test_store_budget_error_names_the_population():
    with pytest.raises(StoreBudgetError) as ei:
        tapi.Experiment(fleet_spec(tapi, "replicated", rounds_per_dispatch=2,
                                   device_mem_budget=1024)).build(device="cpu")
    msg = str(ei.value)
    assert str(POP) in msg and ei.value.population == POP
    assert "client_store" in msg and "streamed" in msg
    assert "REPRO_DEVICE_MEM_BUDGET" in msg


def test_data_selection_rejected_on_roster():
    spec = fleet_spec(tapi, "streamed", rounds_per_dispatch=2)
    spec = dataclasses.replace(spec, scheme=dataclasses.replace(
        spec.scheme, data_selection="threshold"))
    with pytest.raises(ValueError, match="roster"):
        tapi.Experiment(spec).build(device="cpu")
