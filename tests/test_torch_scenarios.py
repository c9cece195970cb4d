"""The port's scenario axes through the trainer: packed backend against
reference backend, inside the port.

Over 6 rounds of mlp-edge with 10 clients (and LeNet for the attack slice's
pairing, coordinate-wise median under a scaled-malicious attack), every
fault model of the JAX suite's `tests/test_faults.py` on the mean path,
every (attack x aggregator) pair of `tests/test_aggregators.py`, and the
noisy aggregation channel: parameters bit for bit, the broadcast gradient
equal as values, train losses, per-round counts and every counter equal.
The selection varies from round to round, so the client axis is
bucket-padded (the packed engine replicates batches on the padding lanes,
the reference backend zero-pads: the weight-aware reducers must not see
the difference). A round in which no upload arrives skips the update.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (ClientData, ClientDropout,  # noqa: E402
                              CorruptUpload, FederatedTrainer,
                              GaussianPoison, MixedFaults, ScaledMalicious,
                              SignFlip, StragglerTimeout, make_aggregator)
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.data import make_dataset, partition_by_dirichlet  # noqa: E402
from repro_torch.kernels import pruning_mask as pm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.wireless import (ChannelModel,  # noqa: E402
                                  GaussianAggregateNoise, SystemParams)


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


N, ROUNDS = 10, 6

FAULT_MODELS = [
    ClientDropout(rate=0.3, seed=5),
    StragglerTimeout(tolerance=1.0, sigma=0.8, seed=5),
    CorruptUpload(rate=0.4, mode="scale", scale=10.0, seed=5),
    CorruptUpload(rate=0.4, mode="nan", seed=5),
    MixedFaults(dropout_rate=0.25, corrupt_rate=0.25, seed=5),
]
FAULT_IDS = ["dropout", "straggler", "corrupt_scale", "corrupt_nan",
             "mixed"]
AGG_CASES = [
    ("coord_median", {}),
    ("trimmed_mean", {"beta": 0.3}),
    ("norm_clip", {}),
    ("norm_clip", {"tau": 0.05}),
    ("multi_krum", {"f": 1}),
]
AGG_IDS = ["coord_median", "trimmed_mean", "norm_clip_adaptive",
           "norm_clip_fixed", "multi_krum"]
ATTACKS = [None, ScaledMalicious(rate=0.4, scale=10.0, seed=5),
           SignFlip(rate=0.4, scale=2.0, seed=5),
           GaussianPoison(rate=0.4, sigma=0.5, seed=5)]
ATTACK_IDS = ["clean", "scaled_malicious", "sign_flip", "gaussian_poison"]


def _bits(t):
    return t.detach().contiguous().view(torch.int32)


def _clients(seed=2, n_train=600):
    ds = make_dataset("synthetic-mnist", n_train=n_train, n_test=60,
                      seed=seed)
    parts = partition_by_dirichlet(ds.y_train, N, 1.0,
                                   rng=np.random.default_rng(seed))
    return [ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]


def _schedule(full: bool):
    """Every client every round, or a varying selection (buckets 4, 8 and
    the full 10) with one client always in; lambda 0.3 prunes."""
    if full:
        a = np.ones((ROUNDS, N))
    else:
        a = np.zeros((ROUNDS, N))
        for s, n_sel in enumerate((10, 7, 3, 9, 5, 10)):
            a[s, :n_sel] = 1.0
            a[s] = np.roll(a[s], s)
    lam = np.where(a > 0, 0.3, 0.0)
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def _run_pair(model="mlp-edge", full=False, batch_size=8, **kw):
    init, apply_fn = {"mlp-edge": (cnn.mlp_edge_init, cnn.mlp_edge_apply),
                      "lenet": (cnn.lenet_init, cnn.lenet_apply)}[model]
    params = init(torch.Generator().manual_seed(2), device="cpu")
    clients = _clients()
    sched = _schedule(full)
    ch = ChannelModel(N)
    out = {}
    for backend in ("reference", "packed"):
        tr = FederatedTrainer(cnn.make_loss_fn(apply_fn), params, clients,
                              eta=0.1, batch_size=batch_size, seed=0,
                              backend=backend, device="cpu", **kw)
        out[backend] = (tr, tr.run(sched, SystemParams.table1(N),
                                   ch.uplink, ch.downlink))
    return out


def _assert_backends_equal(out):
    (tr_ref, h_ref), (tr_pk, h_pk) = out["reference"], out["packed"]
    assert tr_pk.n_fallback_rounds == 0
    np.testing.assert_array_equal([m.train_loss for m in h_ref],
                                  [m.train_loss for m in h_pk])
    for f in ("n_faulted", "n_quarantined", "n_agg_adjusted"):
        assert [getattr(m, f) for m in h_ref] == [getattr(m, f)
                                                  for m in h_pk], f
    assert tr_ref.fault_counters == tr_pk.fault_counters
    assert tr_ref.agg_counters == tr_pk.agg_counters
    for k, a in tr_ref.params.items():
        assert torch.equal(_bits(tr_pk.params[k]), _bits(a)), k
        assert torch.equal(tr_pk.global_grad[k], tr_ref.global_grad[k]), k
        assert bool(torch.isfinite(a).all())


@pytest.mark.parametrize("fm", FAULT_MODELS, ids=FAULT_IDS)
def test_fault_packed_vs_reference_bitwise(fm):
    out = _run_pair(fault_model=fm)
    _assert_backends_equal(out)
    tr = out["packed"][0]
    if isinstance(fm, CorruptUpload) and fm.mode == "scale":
        assert tr.fault_counters["n_corrupt_finite"] > 0
    else:
        assert tr.fault_counters["n_dropped"] \
            + tr.fault_counters["n_quarantined"] > 0


@pytest.mark.parametrize("fm", ATTACKS, ids=ATTACK_IDS)
@pytest.mark.parametrize("name,kwargs", AGG_CASES, ids=AGG_IDS)
def test_aggregator_packed_vs_reference_bitwise(name, kwargs, fm):
    agg = make_aggregator(name, **kwargs)
    out = _run_pair(fault_model=fm, aggregator=agg)
    _assert_backends_equal(out)
    tr = out["packed"][0]
    assert list(tr.agg_counters) == [agg.stat_field]
    if fm is not None:
        assert tr.fault_counters["n_corrupt_finite"] > 0


@pytest.mark.parametrize("name,kwargs", [("mean", {}), ("multi_krum",
                                                       {"f": 1}),
                                         ("coord_median", {})],
                         ids=["mean", "multi_krum", "coord_median"])
def test_channel_noise_packed_vs_reference_bitwise(name, kwargs):
    agg = make_aggregator(name, **kwargs)
    noise = GaussianAggregateNoise(std=1e-3, seed=3)
    out = _run_pair(aggregator=agg, channel_noise=noise,
                    fault_model=SignFlip(rate=0.4, scale=2.0, seed=5))
    _assert_backends_equal(out)
    clean = _run_pair(aggregator=agg,
                      fault_model=SignFlip(rate=0.4, scale=2.0, seed=5))
    assert [m.train_loss for m in out["packed"][1]] != \
        [m.train_loss for m in clean["packed"][1]]


def test_lenet_coord_median_under_scaled_malicious():
    """The attack slice's pairing on its model: the rank sort runs every
    round of the packed run (on the CPU the wrapper takes its plain version
    and counts nothing), and the counters are the draw's."""
    fm = ScaledMalicious(rate=0.3, scale=10.0, seed=0, exact=True)
    pm.reset_launches()
    out = _run_pair(model="lenet", full=True,
                    fault_model=fm, aggregator=make_aggregator("coord_median"))
    _assert_backends_equal(out)
    assert set(pm.LAUNCHES.values()) == {0}
    tr = out["packed"][0]
    assert tr.fault_counters["n_corrupt_finite"] == 3 * ROUNDS
    # 10 valid clients: the median window holds 2, the other 8 are out
    assert tr.agg_counters == {"n_excluded": 8 * ROUNDS}


@pytest.mark.parametrize("agg", [None, "coord_median"])
def test_all_dropped_rounds_skip_the_update(agg):
    out = _run_pair(fault_model=ClientDropout(rate=1.0),
                    aggregator=None if agg is None else make_aggregator(agg))
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(2), device="cpu")
    for backend in ("reference", "packed"):
        tr, hist = out[backend]
        for k, t in tr.params.items():
            assert torch.equal(_bits(t), _bits(params[k])), (backend, k)
            assert not tr.global_grad[k].any()
        assert tr.fault_counters["n_skipped_rounds"] == ROUNDS
        assert all(np.isnan(m.train_loss) for m in hist)
        assert [m.n_faulted for m in hist] == [10, 7, 3, 9, 5, 10]
