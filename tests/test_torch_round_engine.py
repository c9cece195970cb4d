"""The port's round engine and trainer backends.

* One `RoundEngine.round_step` of the port against the JAX package's from
  the same (w, v, batches, lambda): thresholds and masks bit for bit,
  parameters and the broadcast gradient to 1e-6 (the client gradients run
  through fp32 GEMMs whose reduction order differs between XLA and PyTorch).
* Inside the port, the packed backend against the reference backend:
  equal fp32 values round after round, shared and per-client lambda,
  bucket-padded and ragged clients. Like the JAX package's own
  packed-vs-reference tests this compares values, so +0.0 and -0.0 in the
  broadcast gradient count as equal (a pruned coordinate's masked gradient
  can be -0.0; the packed sum starts from +0.0); the parameters are
  compared bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ParamPack as JaxPack  # noqa: E402
from repro.core import RoundEngine as JaxEngine  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ClientData, FederatedTrainer, ParamPack  # noqa: E402
from repro_torch.core import RoundEngine  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.data import make_dataset, partition_by_dirichlet  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.wireless import ChannelModel, SystemParams  # noqa: E402


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


MODELS = {"lenet": (jcnn.lenet_init, jcnn.lenet_apply, cnn.lenet_apply),
          "mlp-edge": (jcnn.mlp_edge_init, jcnn.mlp_edge_apply,
                       cnn.mlp_edge_apply)}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).view(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# -- one round_step against the JAX engine -----------------------------------------

@pytest.mark.parametrize("name,lams,ragged", [
    ("mlp-edge", [0.4, 0.4, 0.4], False),          # shared threshold
    ("mlp-edge", [0.1, 0.5, 0.8], True),           # per-client, ragged
    ("lenet", [0.3, 0.6, 0.3], False),             # per-client, padded
])
def test_round_step_matches_jax(name, lams, ragged):
    init, japply, tapply = MODELS[name]
    jp = init(jax.random.key(5))
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    jpack, tpack = JaxPack.build(jp), ParamPack.build(tp)
    jeng = JaxEngine(jcnn.make_loss_fn(japply), jpack, eta=0.1, shards=1,
                     weighted_loss_fn=jcnn.make_weighted_loss_fn(japply),
                     max_clients=8)
    teng = RoundEngine(cnn.make_loss_fn(tapply), tpack, eta=0.1,
                       weighted_loss_fn=cnn.make_weighted_loss_fn(tapply),
                       max_clients=8, device="cpu")
    rng = np.random.default_rng(6)
    w = np.asarray(jpack.pack(jp))
    v = (1e-2 * rng.normal(size=w.shape)).astype(np.float32) \
        * jpack.valid_mask()
    n = len(lams)
    xs = rng.normal(size=(n, 16, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, size=(n, 16)).astype(np.int32)
    sw = np.ones((n, 16), np.float32)
    if ragged:
        sw[1, 11:] = 0.0
    jout = jeng.round_step(jnp.asarray(w), jnp.asarray(v), jnp.asarray(xs),
                           jnp.asarray(ys), lams,
                           sample_weights=sw if ragged else None)
    tout = teng.round_step(_t(w), _t(v), _t(xs), _t(ys), lams,
                           sample_weights=sw if ragged else None)
    assert 4 in teng.buckets_used and teng.buckets_used == jeng.buckets_used
    jw, jv, jl, jthr, jstep = jout
    tw, tv, tl, tthr, tstep = tout
    np.testing.assert_array_equal(_bits(tthr), _bits(jthr))
    pr = tpack.prunable_mask()
    if len(set(lams)) == 1:
        _, jm = jops.packed_importance_mask(w, v, pr, jthr, impl="xla")
        _, tm = tops.packed_importance_mask(_t(w), _t(v), _t(pr), tthr)
    else:
        _, jm = jops.packed_importance_masks(w, v, pr, jthr, impl="xla")
        _, tm = tops.packed_importance_masks(_t(w), _t(v), _t(pr), tthr)
    np.testing.assert_array_equal(_bits(tm), _bits(jm))
    assert 0.0 < float((tm == 0).float().mean()) < 1.0   # it did prune
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    for a, b in ((tw, jw), (tv, jv), (tstep, jstep)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert int(teng.last_n_ok) == int(jeng.last_n_ok) == n


def test_bucket_capacity_matches_jax():
    from repro.core.round_engine import bucket_capacity as jax_bucket
    from repro_torch.core.round_engine import bucket_capacity
    for m in (None, 1, 6, 10, 20):
        for n in range(1, (m or 33) + 1):
            assert bucket_capacity(n, max_clients=m) == jax_bucket(
                n, max_clients=m), (n, m)


def test_round_step_rejects_bad_lambda():
    tp = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    eng = RoundEngine(cnn.make_loss_fn(cnn.mlp_edge_apply),
                      ParamPack.build(tp), eta=0.1, device="cpu")
    w, v = eng.init_buffers(tp)
    xs, ys = torch.zeros(2, 4, 28, 28, 1), torch.zeros(2, 4, dtype=torch.int32)
    for bad in ([1.0, 0.1], [-0.1, 0.1], [0.1]):
        with pytest.raises(ValueError):
            eng.round_step(w, v, xs, ys, bad)


def test_all_clients_quarantined_keeps_the_model():
    """A round whose every upload is non-finite is skipped on the device:
    (w, v) come back unchanged and the survivor count is 0."""
    tp = cnn.mlp_edge_init(torch.Generator().manual_seed(1), device="cpu")
    eng = RoundEngine(cnn.make_loss_fn(cnn.mlp_edge_apply),
                      ParamPack.build(tp), eta=0.1, device="cpu")
    w, v = eng.init_buffers(tp)
    v = v + 0.5
    xs = torch.full((2, 4, 28, 28, 1), float("nan"))
    ys = torch.zeros(2, 4, dtype=torch.int32)
    w2, v2, _, _, _ = eng.round_step(w, v, xs, ys, [0.2, 0.2])
    assert torch.equal(w2, w) and torch.equal(v2, v)
    assert int(eng.last_n_ok) == 0


# -- packed backend against the reference backend, inside the port ------------------

def _env(n_clients, n_train, seed, ragged_sizes=()):
    ds = make_dataset("synthetic-mnist", n_train=n_train, n_test=60,
                      seed=seed)
    parts = partition_by_dirichlet(ds.y_train, n_clients, 1.0,
                                   rng=np.random.default_rng(seed))
    parts = [p[:ragged_sizes[i]] if i < len(ragged_sizes) else p
             for i, p in enumerate(parts)]
    return [ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]


def _schedule(a, lam):
    a = np.asarray(a, float)
    lam = np.broadcast_to(np.asarray(lam, float), a.shape).copy()
    lam[a == 0] = 0.0
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def _run_pair(clients, params, loss_fn, sched, batch_size):
    out = {}
    n = len(clients)
    for backend in ("reference", "packed"):
        tr = FederatedTrainer(loss_fn, params, clients, eta=0.1,
                              batch_size=batch_size, seed=0, backend=backend,
                              device="cpu")
        ch = ChannelModel(n)
        out[backend] = (tr, tr.run(sched, SystemParams.table1(n), ch.uplink,
                                   ch.downlink))
    return out


def _assert_backends_equal(out):
    (tr_ref, h_ref), (tr_pk, h_pk) = out["reference"], out["packed"]
    assert tr_pk.n_fallback_rounds == 0
    assert [m.train_loss for m in h_ref] == [m.train_loss for m in h_pk]
    for k, a in tr_ref.params.items():
        np.testing.assert_array_equal(_bits(tr_pk.params[k]), _bits(a))
        b = tr_pk.global_grad[k]
        assert torch.equal(b, tr_ref.global_grad[k])          # values
        diff = _bits(b) != _bits(tr_ref.global_grad[k])
        assert bool(np.all(b.numpy()[diff] == 0.0))         # only +-0


@pytest.mark.parametrize("lam_kind", ["shared", "per-client"])
def test_mlp_edge_packed_matches_reference_10_rounds(lam_kind):
    """10 clients, 10 rounds, a different selection every round (the client
    axis is bucket-padded), ragged clients carried by sample weights."""
    clients = _env(10, 900, seed=2, ragged_sizes=(9, 40, 13))
    rng = np.random.default_rng(2)
    a = (rng.random((10, 10)) < 0.6).astype(float)
    a[:, 0] = 1.0
    lam = 0.35 if lam_kind == "shared" else rng.uniform(0.0, 0.8, (10, 10))
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(2), device="cpu")
    out = _run_pair(clients, params, cnn.make_loss_fn(cnn.mlp_edge_apply),
                    _schedule(a, lam), batch_size=16)
    _assert_backends_equal(out)
    eng = out["packed"][0].engine
    assert len(eng.buckets_used) > 1


@pytest.mark.parametrize("lam", [0.4, [0.0, 0.3, 0.6]])
def test_lenet_packed_matches_reference_3_rounds(lam):
    clients = _env(3, 240, seed=3, ragged_sizes=(11,))
    params = cnn.lenet_init(torch.Generator().manual_seed(3), device="cpu")
    out = _run_pair(clients, params, cnn.make_loss_fn(cnn.lenet_apply),
                    _schedule(np.ones((3, 3)), lam), batch_size=16)
    _assert_backends_equal(out)


def test_ragged_round_without_weighted_loss_falls_back_on_cpu():
    """On the CPU, a packed trainer whose loss has no weighted companion
    runs a round with a ragged client through the reference loop, and the
    others through the engine; both kinds equal the reference backend."""
    clients = _env(3, 240, seed=6, ragged_sizes=(11,))
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(6), device="cpu")
    plain = cnn.make_loss_fn(cnn.mlp_edge_apply)

    def loss(p, x, y):                  # no .weighted: batches stay ragged
        return plain(p, x, y)

    sched = _schedule([[1, 1, 1], [0, 1, 1], [1, 0, 1]], 0.3)
    out = _run_pair(clients, params, loss, sched, batch_size=16)
    (tr_ref, h_ref), (tr_pk, h_pk) = out["reference"], out["packed"]
    assert tr_pk.n_fallback_rounds == 2
    assert [m.train_loss for m in h_ref] == [m.train_loss for m in h_pk]
    for k, a in tr_ref.params.items():
        np.testing.assert_array_equal(_bits(tr_pk.params[k]), _bits(a))


def test_trainer_state_views_round_trip():
    clients = _env(3, 120, seed=4)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(4), device="cpu")
    tr = FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                          clients, eta=0.1, batch_size=8, device="cpu")
    doubled = {k: 2.0 * t for k, t in tr.params.items()}
    tr.params = doubled
    for k, t in tr.params.items():
        assert torch.equal(t, doubled[k])


def test_unported_options_raise_not_implemented():
    """Options of the JAX trainer the port does not carry yet raise naming
    their ROADMAP.md §1 item; the ones it now carries (blocks, the client
    store, local schemes, callbacks, resume, reset) do not."""
    from repro_torch.core.local import make_local_scheme
    clients = _env(2, 60, seed=5)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(5), device="cpu")
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    for kw, item in ((dict(shards=2), "8"),):
        with pytest.raises(NotImplementedError, match=f"item {item}\\)"):
            FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                             device="cpu", **kw)
    for kw in (dict(rounds_per_dispatch=4), dict(rounds_per_dispatch="auto"),
               dict(client_store="replicated"), dict(client_store="auto"),
               dict(client_store="streamed"),
               dict(local_scheme=make_local_scheme("feddyn", steps=2,
                                                   alpha=0.1))):
        FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                         device="cpu", **kw)
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          device="cpu")
    ch = ChannelModel(2)
    sched = _schedule(np.ones((2, 2)), 0.1)
    hist = tr.run(sched, SystemParams.table1(2), ch.uplink, ch.downlink,
                  callbacks=[], start_round=1)
    assert [m.round for m in hist] == [1]
    tr.reset(params, seed=1)
    assert tr.n_batch_uploads == 0 and tr.rng.integers(1 << 30) == \
        np.random.default_rng(1).integers(1 << 30)
