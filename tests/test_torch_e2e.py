"""The port end to end against the JAX package, and its isolation from it.

* Substrate: the port keeps its own numpy/scipy copies of the data and
  schedule code; dataset, Dirichlet split, phi and the `solve_p1` schedule
  of the paper's configuration must come out exactly equal.
* The paper's pipeline at a small size (synthetic-mnist, 6 clients, LeNet,
  6 rounds of the `proposed` AO schedule with pruning on) from the same
  JAX-initialised weights: selection and the energy/delay ledger exactly
  equal, train losses to rtol 1e-3, final weights to atol 1e-4 (fp32 GEMMs
  reduce in another order in XLA and PyTorch; the masks then see importances
  that differ in the last bits, and six rounds of SGD carry that forward).
* The same pipeline under a scaled-malicious attack with the coordinate-wise
  median, and under NaN uploads with the mean: every count exactly equal.
* The port imports neither JAX nor the JAX package, and its entry points
  default to CUDA.
"""
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.wireless as jwireless  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.wireless as twireless  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import cnn  # noqa: E402


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


def _pipeline(core, data, wireless, *, n_clients, n_train, n_test, rounds,
              e0, t0):
    """dataset -> Dirichlet split -> phi -> solve_p1, through one package."""
    ds = data.make_dataset("synthetic-mnist", n_train=n_train, n_test=n_test,
                           seed=0)
    parts = data.partition_by_dirichlet(ds.y_train, n_clients, 5.0,
                                        rng=np.random.default_rng(0))
    clients = [core.ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]
    test_hist = np.bincount(ds.y_test, minlength=10).astype(float)
    phi = core.phis(np.stack([c.label_histogram(10) for c in clients]),
                    test_hist[None])
    sp = wireless.SystemParams.table1(n_clients, dataset="mnist",
                                      batch_size=32)
    ch = wireless.ChannelModel(n_clients, path_loss=1e-5, seed=0)
    consts = core.BoundConstants(rounds_S=rounds - 1, batch_Z=32, eta=0.1)
    sched = core.solve_p1(phi, e0, t0, ch.uplink, ch.downlink, sp, consts,
                          core.AOConfig(outer_iters=3,
                                        selection_method="paper",
                                        phi_coupling="mean"))
    return ds, parts, clients, phi, sp, ch, sched


def test_slice_substrate_and_schedule_exactly_equal():
    """The configuration chip_smoke.py runs: 10 clients, sigma 5, E0 = 25 J,
    T0 = 15 s, 40 rounds of the `proposed` schedule."""
    cfg = dict(n_clients=10, n_train=4000, n_test=800, rounds=40, e0=25.0,
               t0=15.0)
    j = _pipeline(jcore, jdata, jwireless, **cfg)
    t = _pipeline(tcore, tdata, twireless, **cfg)
    for name in ("x_train", "y_train", "x_test", "y_test"):
        np.testing.assert_array_equal(getattr(t[0], name),
                                      getattr(j[0], name))
    for a, b in zip(t[1], j[1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[3], j[3])
    np.testing.assert_array_equal(t[5].uplink, j[5].uplink)
    np.testing.assert_array_equal(t[5].downlink, j[5].downlink)
    ts, js = t[6], j[6]
    for field in ("a", "lam", "power", "freq"):
        np.testing.assert_array_equal(getattr(ts, field), getattr(js, field))
    for field in ("theta", "energy", "delay", "feasible"):
        assert getattr(ts, field) == getattr(js, field), field
    # the schedule prunes, and its ulp-level spread in lambda sends some
    # rounds down the per-client-threshold path
    assert ts.feasible and ts.a.sum(axis=1).min() >= 1
    ks = np.floor(ts.lam * 107_764).astype(int)
    multi = [s for s in range(40) if len(set(ks[s][ts.a[s] > 0])) > 1]
    assert (ts.lam[ts.a > 0] > 0).all() and 1 <= len(multi) < 40


def test_pipeline_matches_jax_end_to_end():
    cfg = dict(n_clients=6, n_train=600, n_test=200, rounds=6, e0=5.0,
               t0=3.0)
    j = _pipeline(jcore, jdata, jwireless, **cfg)
    t = _pipeline(tcore, tdata, twireless, **cfg)
    ds = t[0]
    jsched, tsched = j[6], t[6]
    assert (tsched.lam[tsched.a > 0] > 0).all()         # pruning is on
    jp = jcnn.lenet_init(jax.random.key(0))
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    run = dict(eval_every=5, stop_delay=cfg["t0"], stop_energy=cfg["e0"])

    jtr = jcore.FederatedTrainer(jcnn.make_loss_fn(jcnn.lenet_apply), jp,
                                 j[2], eta=0.1, batch_size=32, seed=0,
                                 backend="packed", shards=1,
                                 rounds_per_dispatch=1)
    jh = jtr.run(jsched, j[4], j[5].uplink, j[5].downlink,
                 eval_fn=jcnn.make_eval_fn(jcnn.lenet_apply, ds.x_test,
                                           ds.y_test), **run)
    ttr = tcore.FederatedTrainer(cnn.make_loss_fn(cnn.lenet_apply), tp,
                                 t[2], eta=0.1, batch_size=32, seed=0,
                                 backend="packed", device="cpu")
    th = ttr.run(tsched, t[4], t[5].uplink, t[5].downlink,
                 eval_fn=cnn.make_eval_fn(cnn.lenet_apply, ds.x_test,
                                          ds.y_test, device="cpu"), **run)

    assert len(th) == len(jh) == 6
    for a, b in zip(th, jh):
        assert (a.round, a.selected, a.mean_lambda) == (
            b.round, b.selected, b.mean_lambda)
        assert (a.delay, a.energy) == (b.delay, b.energy)
        assert (a.cumulative_delay, a.cumulative_energy) == (
            b.cumulative_delay, b.cumulative_energy)
        assert a.n_quarantined == b.n_quarantined == 0
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-3)
        assert (a.test_loss is None) == (b.test_loss is None)
        if a.test_loss is not None:
            np.testing.assert_allclose(a.test_loss, b.test_loss, rtol=1e-3)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)


SCENARIOS = {
    "scaled_malicious+coord_median": (
        lambda m: m.ScaledMalicious(rate=0.3, scale=10.0, seed=0, exact=True),
        "coord_median"),
    "corrupt_nan+mean": (
        lambda m: m.CorruptUpload(rate=0.3, mode="nan", seed=11), "mean"),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_matches_jax_end_to_end(scenario):
    """The same small pipeline under an attack with a robust reducer and
    under NaN uploads with the mean: selection, the energy/delay ledger and
    every fault and aggregation count exactly equal (they come from the
    host draws and the survivor counts), train losses to rtol 1e-3, weights
    to atol 1e-4 under the mean as above. Under the median, gradients that
    differ in their last bits (XLA and torch GEMMs) can swap the ranks of
    two close client values at a coordinate, which moves that coordinate by
    eta times half their gap instead of by the gradients' own difference:
    there at most 1 coordinate in 10,000 may exceed atol 1e-4, and none
    1e-2."""
    import repro.core.aggregators as jagg
    import repro.core.faults as jfaults
    import repro_torch.core.aggregators as tagg
    import repro_torch.core.faults as tfaults

    make_fault, agg = SCENARIOS[scenario]
    cfg = dict(n_clients=6, n_train=600, n_test=200, rounds=6, e0=5.0,
               t0=3.0)
    j = _pipeline(jcore, jdata, jwireless, **cfg)
    t = _pipeline(tcore, tdata, twireless, **cfg)
    jp = jcnn.lenet_init(jax.random.key(0))
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    run = dict(stop_delay=cfg["t0"], stop_energy=cfg["e0"])
    jtr = jcore.FederatedTrainer(jcnn.make_loss_fn(jcnn.lenet_apply), jp,
                                 j[2], eta=0.1, batch_size=32, seed=0,
                                 backend="packed", shards=1,
                                 rounds_per_dispatch=1,
                                 fault_model=make_fault(jfaults),
                                 aggregator=jagg.make_aggregator(agg))
    jh = jtr.run(j[6], j[4], j[5].uplink, j[5].downlink, **run)
    ttr = tcore.FederatedTrainer(cnn.make_loss_fn(cnn.lenet_apply), tp,
                                 t[2], eta=0.1, batch_size=32, seed=0,
                                 backend="packed", device="cpu",
                                 fault_model=make_fault(tfaults),
                                 aggregator=tagg.make_aggregator(agg))
    th = ttr.run(t[6], t[4], t[5].uplink, t[5].downlink, **run)

    assert len(th) == len(jh) == 6
    for a, b in zip(th, jh):
        assert (a.round, a.selected, a.mean_lambda) == (
            b.round, b.selected, b.mean_lambda)
        assert (a.delay, a.energy, a.cumulative_delay,
                a.cumulative_energy) == (b.delay, b.energy,
                                         b.cumulative_delay,
                                         b.cumulative_energy)
        assert (a.n_faulted, a.n_quarantined, a.n_agg_adjusted) == (
            b.n_faulted, b.n_quarantined, b.n_agg_adjusted)
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-3)
    assert ttr.fault_counters == jtr.fault_counters
    assert ttr.agg_counters == jtr.agg_counters
    assert ttr.aggregator_key == jtr.aggregator_key
    bit = (ttr.fault_counters["n_corrupt_finite"] if agg != "mean"
           else ttr.fault_counters["n_quarantined"])
    assert bit > 0                               # the scenario really bites
    diff = np.concatenate([np.abs(ttr.params[k].numpy()
                                  - np.asarray(v)).ravel()
                           for k, v in jtr.params.items()])
    if agg == "mean":
        assert diff.max() <= 1e-4
    else:
        assert (diff > 1e-4).mean() <= 1e-4 and diff.max() <= 1e-2


def test_port_imports_neither_jax_nor_the_jax_package():
    code = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m.startswith("jaxlib")
             or m == "repro" or m.startswith("repro."))
assert not bad, bad
for need in ("repro_torch.kernels._build", "repro_torch.configs.registry",
             "repro_torch.models.transformer", "repro_torch.models.ssm",
             "repro_torch.kernels.flash_attention",
             "repro_torch.kernels.decode_attention",
             "repro_torch.kernels.ssd_chunk", "repro_torch.serving.engine",
             "repro_torch.launch.serve", "repro_torch.api.spec",
             "repro_torch.api.registry", "repro_torch.api.callbacks",
             "repro_torch.api.experiment", "repro_torch.api.cli",
             "repro_torch.checkpoint.io", "repro_torch.core.client_store",
             "repro_torch.data.loader", "repro_torch.core.local",
             "repro_torch.tree", "repro_torch.data.fleet",
             "repro_torch.core.cohort_store", "repro_torch.api.sweep"):
    assert need in sys.modules, need
print(len(names))
"""
    import os
    src = os.path.join(os.path.dirname(os.path.dirname(__file__)), "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": src})
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 68


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    clients = [tcore.ClientData(np.zeros((4, 28, 28, 1), np.float32),
                                np.zeros(4, np.int32))]
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                               clients, eta=0.1, batch_size=4)
    assert resolve_device("cpu").type == "cpu"
    # the LM stack: model init, caches and the serving engine
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving import ServingEngine
    cfg = get_config("granite-3-2b").reduced(layers=1, d_model=64, vocab=32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 16)
    lm = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(lm, cfg, max_seq=16)
    assert ServingEngine(lm, cfg, max_seq=16, device="cpu").rt.attn_impl \
        == "cuda"


def test_engine_eval_and_inits_default_to_cuda():
    """RoundEngine, make_eval_fn and the model inits take device=None as
    CUDA, like FederatedTrainer: on a host without a card they raise rather
    than run on the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("the host has a card: device=None resolves to it")
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    calls = [
        lambda: tcore.RoundEngine(cnn.make_loss_fn(cnn.mlp_edge_apply),
                                  tcore.ParamPack.build(params), eta=0.1),
        lambda: cnn.make_eval_fn(cnn.mlp_edge_apply,
                                 np.zeros((2, 28, 28, 1), np.float32),
                                 np.zeros(2, np.int32)),
        lambda: cnn.lenet_init(torch.Generator().manual_seed(0)),
        lambda: cnn.mlp_edge_init(torch.Generator().manual_seed(0)),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
