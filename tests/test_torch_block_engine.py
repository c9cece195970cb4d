"""The port's multi-round blocks: `ClientStore`, `RoundEngine.block_step`
and the trainer's block planning, on the CPU.

* The store gathers bit for bit what the per-round path uploads.
* A block equals K `round_step` calls bit for bit for every kind of round
  body: shared and per-client lambda, ragged clients, channel noise, fault
  weights and factors, poison, and a robust reducer (on the CPU the body
  runs eagerly; tests/test_torch_cuda.py holds the CUDA graphs to the same
  contract on the card).
* The trainer's blocks equal its per-round dispatch and the reference
  backend bit for bit, with eval and stop boundaries, empty and fallback
  rounds between blocks, and upload no batch.
* "auto" resolves to one round a dispatch on the CPU.
* Against the JAX package's block path at rounds_per_dispatch=4 from the
  same JAX-initialised weights: selection and the energy/delay ledger
  exactly equal, losses to rtol 1e-3, weights to atol 1e-4 (the layer-(d)
  tolerance of tests/test_torch_e2e.py: XLA and torch reduce fp32 GEMMs in
  other orders).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core as jcore  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from _torch_blocks import BLOCK_BODIES, block_case, round_args  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import ClientData, FederatedTrainer  # noqa: E402
from repro_torch.core import client_store as tstore  # noqa: E402
from repro_torch.core.federated import DEFAULT_ROUNDS_PER_DISPATCH  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.wireless import ChannelModel, SystemParams  # noqa: E402

CPU = torch.device("cpu")


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


def _bits(t):
    return t.detach().cpu().contiguous().view(torch.int32)


def _hetero_env(sizes, seed=0):
    ds = make_dataset("synthetic-mnist", n_train=sum(sizes), n_test=60,
                      seed=seed)
    off = np.cumsum([0] + list(sizes))
    return [ClientData(ds.x_train[a:b], ds.y_train[a:b])
            for a, b in zip(off, off[1:])]


def _schedule(a, lam):
    a = np.asarray(a, np.float64)
    lam = np.broadcast_to(np.asarray(lam, np.float64), a.shape).copy()
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def _varying(n, rounds, seed):
    rng = np.random.default_rng(seed)
    a = np.zeros((rounds, n))
    for s in range(rounds):
        a[s, rng.choice(n, rng.integers(1, n + 1), replace=False)] = 1.0
    return a


def _train(clients, params, sched, *, loss=None, **kw):
    n = len(clients)
    loss = loss or cnn.make_loss_fn(cnn.mlp_edge_apply)
    run = {k: kw.pop(k) for k in ("eval_fn", "eval_every", "stop_delay")
           if k in kw}
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=16,
                          seed=0, device="cpu", **kw)
    ch = ChannelModel(n)
    hist = tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink,
                  **run)
    return tr, hist


def _assert_same_run(a, b):
    (ta, ha), (tb, hb) = a, b
    assert len(ha) == len(hb)
    for ma, mb in zip(ha, hb):
        assert (ma.round, ma.selected) == (mb.round, mb.selected)
        assert (np.isnan(ma.train_loss) and np.isnan(mb.train_loss)) \
            or ma.train_loss == mb.train_loss
        assert (ma.test_loss, ma.test_accuracy) == (mb.test_loss,
                                                   mb.test_accuracy)
    for k in ta.params:
        assert torch.equal(_bits(ta.params[k]), _bits(tb.params[k])), k
        assert torch.equal(ta.global_grad[k], tb.global_grad[k]), k


# -- client store ----------------------------------------------------------------

def test_client_store_matches_host_upload():
    clients = _hetero_env([40, 20, 7])
    store = tstore.ClientStore.build(clients, device="cpu")
    assert store.n_clients == 3 and list(store.counts) == [40, 20, 7]
    assert store.x.shape[1] == 40
    assert store.nbytes == tstore.estimated_store_nbytes(clients)
    rng = np.random.default_rng(0)
    idx = np.stack([rng.choice(len(c), size=5) for c in clients])
    xs, ys = store.gather(np.arange(3), idx)
    up_x = tstore.to_device(np.stack([c.x[i] for c, i in zip(clients, idx)]),
                            CPU)
    up_y = tstore.to_device(np.stack([c.y[i] for c, i in zip(clients, idx)]),
                            CPU)
    assert xs.dtype == up_x.dtype == torch.float32
    assert ys.dtype == up_y.dtype == torch.int32
    assert torch.equal(_bits(xs), _bits(up_x)) and torch.equal(ys, up_y)
    # float64 / int64 clients narrow as the JAX store narrows them
    wide = [ClientData(c.x.astype(np.float64), c.y.astype(np.int64))
            for c in clients]
    ws = tstore.ClientStore.build(wide, device="cpu")
    assert ws.x.dtype == torch.float32 and ws.y.dtype == torch.int32
    assert torch.equal(ws.x, store.x) and torch.equal(ws.y, store.y)
    assert tstore.estimated_store_nbytes(wide) == store.nbytes


def test_store_budget_and_policy(monkeypatch):
    clients = _hetero_env([40, 30])
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    nbytes = tstore.estimated_store_nbytes(clients)
    monkeypatch.setenv("REPRO_DEVICE_MEM_BUDGET", str(nbytes - 1))
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          device="cpu", rounds_per_dispatch=4,
                          client_store="replicated")
    assert tr.device_mem_budget == nbytes - 1
    with pytest.raises(tstore.StoreBudgetError, match="MiB"):
        tr.check_store_budget()
    auto = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                            device="cpu", rounds_per_dispatch=4)
    with pytest.raises(NotImplementedError, match="item 5"):
        auto.store_mode()
    monkeypatch.delenv("REPRO_DEVICE_MEM_BUDGET")
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          device="cpu", rounds_per_dispatch=4)
    assert tr.device_mem_budget == 1 << 30
    assert tr.store_mode() == "replicated" and tr.store_nbytes() == nbytes
    tr.check_store_budget()


# -- block_step against round_step --------------------------------------------------

@pytest.mark.parametrize("body", BLOCK_BODIES)
def test_block_step_bitwise_equals_sequential_round_steps(body):
    eng, store, params, ops_, kw = block_case(CPU, body, seed=3)
    w0, v0 = eng.init_buffers(params)
    w, v = w0, v0
    ref = []
    for k in range(4):
        xs, ys, args = round_args(store, ops_, kw, k)
        lams = args.pop("lams")
        w, v, losses, thr, _ = eng.round_step(w, v, xs, ys, lams, **args)
        ref.append((losses, thr, int(eng.last_n_ok),
                    int(eng.last_agg_stat)))
    wb, vb, losses_b, thr_b = eng.block_step(w0, v0, store, *ops_, **kw)
    assert torch.equal(_bits(wb), _bits(w))
    assert torch.equal(_bits(vb), _bits(v))
    counts = ops_[3]
    shared = body in ("shared", "ragged", "noisy", "coord_median")
    assert thr_b.shape == ((4,) if shared else (4, 4))
    for k, (loss_k, thr_k, n_ok, ast) in enumerate(ref):
        n = int(counts[k])
        assert torch.equal(_bits(losses_b[k, :n]), _bits(loss_k))
        assert torch.equal(_bits(thr_b[k].reshape(-1)[:thr_k.numel()]),
                           _bits(thr_k.reshape(-1)))
        assert int(eng.last_n_ok[k]) == n_ok
        assert int(eng.last_agg_stat[k]) == ast
    assert eng.k_buckets_used == {4} and eng.buckets_used == {4}
    assert eng.graphs_captured == 0          # the CPU runs the body eagerly
    if body in ("faulted", "coord_median"):  # the scenario bites
        assert any(n_ok < int(c) for (_, _, n_ok, _), c in zip(ref, counts))


def test_block_step_validates_inputs():
    eng, store, params, ops_, kw = block_case(CPU, "shared")
    w, v = eng.init_buffers(params)
    cids = np.zeros((2, 2), np.int32)
    idxs = np.zeros((2, 2, 4), np.int32)
    with pytest.raises(ValueError, match="lambda"):
        eng.block_step(w, v, store, cids, idxs, np.full((2, 2), 1.0),
                       np.full(2, 2))
    with pytest.raises(ValueError, match="outside"):
        eng.block_step(w, v, store, cids, idxs, np.full((2, 2), 0.2),
                       np.asarray([2, 3]))
    with pytest.raises(ValueError, match="bucket"):
        eng.block_step(w, v, store, np.zeros((2, 3), np.int32),
                       np.zeros((2, 3, 4), np.int32), np.full((2, 3), 0.2),
                       np.asarray([1, 3]))
    with pytest.raises(ValueError, match="inconsistent"):
        eng.block_step(w, v, store, cids, idxs, np.full((2, 3), 0.2),
                       np.full(2, 2))
    with pytest.raises(ValueError, match=r"\[K, C, B\]"):
        eng.block_step(w, v, store, cids, np.zeros((2, 2), np.int32),
                       np.full((2, 2), 0.2), np.full(2, 2))
    with pytest.raises(ValueError, match="corrupt"):
        eng.block_step(w, v, store, cids, idxs, np.full((2, 2), 0.2),
                       np.full(2, 2), corrupt=[None])
    with pytest.raises(ValueError, match="FedDyn's per-client state"):
        eng.block_step(w, v, store, cids, idxs, np.full((2, 2), 0.2),
                       np.full(2, 2), h=w)


# -- the trainer's blocks -------------------------------------------------------------

def test_block_trainer_bitwise_vs_per_round_and_reference():
    """AO-style varying selection (bucket changes split blocks), per-client
    and shared lambda, a ragged client: blocks == per-round == reference."""
    sizes = [60, 40, 30, 25, 12, 33]
    clients = _hetero_env(sizes)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(1), device="cpu")
    a = _varying(len(sizes), 12, seed=5)
    rng = np.random.default_rng(6)
    lam = np.where(rng.random((12, 1)) < 0.5, 0.3,
                   rng.uniform(0.1, 0.5, (12, len(sizes))))
    sched = _schedule(a, lam)
    blk = _train(clients, params, sched, rounds_per_dispatch=4)
    per = _train(clients, params, sched, rounds_per_dispatch=1)
    ref = _train(clients, params, sched, backend="reference")
    assert blk[0].n_batch_uploads == 0 and blk[0].n_block_dispatches > 3
    assert per[0].n_batch_uploads == 12 and per[0].n_block_dispatches == 0
    assert blk[0].engine.k_buckets_used <= {1, 2, 4}
    _assert_same_run(blk, per)
    _assert_same_run(blk, ref)


def test_block_mode_matches_per_round_with_eval_and_stop():
    """Blocks end at eval rounds, and stop truncation is schedule-pure:
    identical histories, eval numbers included."""
    sizes = [60, 40, 30, 20]
    clients = _hetero_env(sizes)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(2), device="cpu")
    ds = make_dataset("synthetic-mnist", n_train=150, n_test=80, seed=3)
    ev = cnn.make_eval_fn(cnn.mlp_edge_apply, ds.x_test, ds.y_test,
                          device="cpu")
    sched = _schedule(np.ones((11, 4)), 0.3)
    out = {rpd: _train(clients, params, sched, rounds_per_dispatch=rpd,
                       eval_fn=ev, eval_every=3) for rpd in (1, 8)}
    _assert_same_run(out[8], out[1])
    # blocks never span an eval round: 0 | 1-3 | 4-6 | 7-9 | 10
    assert out[8][0].engine.k_buckets_used == {1, 2}
    stop = out[1][1][4].cumulative_delay
    out = {rpd: _train(clients, params, sched, rounds_per_dispatch=rpd,
                       stop_delay=stop) for rpd in (1, 8)}
    assert len(out[1][1]) == len(out[8][1]) == 5
    _assert_same_run(out[8], out[1])


def test_block_mode_empty_rounds_and_fallback_rounds_interleave():
    """Rounds the block path cannot take (an empty selection; mixed batch
    lengths without a weighted loss) run as before, blocks around them."""
    sizes = [40, 30, 7]                      # 7 < batch 16: ragged
    clients = _hetero_env(sizes)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(3), device="cpu")
    a = np.ones((6, 3))
    a[2] = 0.0
    a[4] = [1.0, 1.0, 0.0]                   # no ragged client: a block
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)

    def bare_loss(p, x, y):                  # no weighted form
        return loss(p, x, y)

    sched = _schedule(a, 0.3)
    blk = _train(clients, params, sched, loss=bare_loss,
                 rounds_per_dispatch=4)
    ref = _train(clients, params, sched, loss=bare_loss, backend="reference")
    assert blk[0].n_fallback_rounds == 4     # every mixed round
    assert blk[0].n_block_dispatches == 1    # round 4
    assert np.isnan(blk[1][2].train_loss)
    _assert_same_run(blk, ref)


def test_block_auto_resolution():
    clients = _hetero_env([40, 30])
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(4), device="cpu")
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          device="cpu")
    assert tr.rounds_per_dispatch == 1                   # "auto" on the CPU
    assert DEFAULT_ROUNDS_PER_DISPATCH == 32
    from repro_torch.core.federated import _resolve_rounds_per_dispatch
    assert _resolve_rounds_per_dispatch("auto", torch.device("cuda")) == 32
    assert _resolve_rounds_per_dispatch(8, CPU) == 8
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          device="cpu", backend="reference",
                          rounds_per_dispatch=16)
    assert tr.rounds_per_dispatch == 1                   # never blocks
    with pytest.raises(ValueError, match=">= 1"):
        FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                         device="cpu", rounds_per_dispatch=0)


def test_block_scenarios_match_per_round():
    """Faults with poison, a robust reducer and channel noise through the
    trainer's blocks: bit for bit the per-round run, counters equal."""
    from repro_torch.core import GaussianPoison, MixedFaults, make_aggregator
    from repro_torch.wireless import GaussianAggregateNoise
    sizes = [50, 40, 30, 45, 35]
    clients = _hetero_env(sizes)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(5), device="cpu")
    sched = _schedule(_varying(5, 8, seed=9), 0.2)
    for kw in (dict(fault_model=MixedFaults(dropout_rate=0.2,
                                            corrupt_rate=0.2, seed=2)),
               dict(fault_model=GaussianPoison(rate=0.4, sigma=0.5, seed=1),
                    aggregator=make_aggregator("norm_clip")),
               dict(channel_noise=GaussianAggregateNoise(std=1e-3, seed=4),
                    aggregator=make_aggregator("trimmed_mean", beta=0.2))):
        blk = _train(clients, params, sched, rounds_per_dispatch=8, **kw)
        per = _train(clients, params, sched, rounds_per_dispatch=1, **kw)
        _assert_same_run(blk, per)
        assert blk[0].fault_counters == per[0].fault_counters
        assert blk[0].agg_counters == per[0].agg_counters
        assert [m.n_agg_adjusted for m in blk[1]] == \
            [m.n_agg_adjusted for m in per[1]]
        assert blk[0].n_block_dispatches >= 1


# -- against the JAX package's blocks ----------------------------------------------------

def test_port_block_matches_jax_block():
    """The same 12 AO-style rounds in 4-round blocks through both packages,
    from JAX's LeNet weights: selection, delays and energies exact, losses
    to rtol 1e-3, weights to atol 1e-4."""
    from repro.core import ClientData as JClient
    sizes = [60, 45, 30, 50, 12, 40]
    clients = _hetero_env(sizes)
    jclients = [JClient(c.x, c.y) for c in clients]
    jp = jcnn.lenet_init(jax.random.key(0))
    tp = convert.params_from_numpy({k: np.asarray(v) for k, v in jp.items()})
    sched = _schedule(_varying(6, 12, seed=21), 0.25)
    n = len(sizes)
    sp, ch = SystemParams.table1(n), ChannelModel(n)
    jtr = jcore.FederatedTrainer(jcnn.make_loss_fn(jcnn.lenet_apply), jp,
                                 jclients, eta=0.1, batch_size=16, seed=0,
                                 backend="packed", shards=1,
                                 rounds_per_dispatch=4)
    jh = jtr.run(sched, sp, ch.uplink, ch.downlink)
    ttr = FederatedTrainer(cnn.make_loss_fn(cnn.lenet_apply), tp, clients,
                           eta=0.1, batch_size=16, seed=0, device="cpu",
                           rounds_per_dispatch=4)
    th = ttr.run(sched, sp, ch.uplink, ch.downlink)
    assert ttr.n_block_dispatches == jtr.n_block_dispatches > 3
    assert ttr.n_batch_uploads == jtr.n_batch_uploads == 0
    assert len(th) == len(jh) == 12
    for a, b in zip(th, jh):
        assert (a.round, a.selected, a.mean_lambda) == (
            b.round, b.selected, b.mean_lambda)
        assert (a.delay, a.energy, a.cumulative_delay,
                a.cumulative_energy) == (b.delay, b.energy,
                                         b.cumulative_delay,
                                         b.cumulative_energy)
        np.testing.assert_allclose(a.train_loss, b.train_loss, rtol=1e-3)
    for k, v in jtr.params.items():
        np.testing.assert_allclose(ttr.params[k].numpy(), np.asarray(v),
                                   rtol=0, atol=1e-4)
