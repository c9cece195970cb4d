"""The port's local-update schemes (FedAvg with E local steps, FedProx,
FedDyn) against the JAX package, on the CPU.

* `core/local.py` is the JAX package's scheme zoo: the same schemes, keys
  and errors.
* `ops.packed_local_delta` is bit for bit the jitted JAX mirror, subnormal
  input included.
* Packed == reference bit for bit (parameters, v as values, losses, and
  FedDyn's state h) for the three schemes, one round a dispatch and in
  blocks of 4, on the JAX test's toy problem and on a depth-8 ResNet; a
  block equals its K round_step calls.
* Against the JAX package's trajectories from the same weights and
  schedule, E = 3 included: parameters and h to atol 1e-4, losses to rtol
  1e-4 (XLA and torch reduce in other orders).
* FedDyn: kill and resume restore h bit for bit (rounds_per_dispatch 1 and
  4); `reset` zeroes it in place; a subnormal client weight leaves its row
  unchanged, as in JAX; a checkpoint of either package loads in the other.
* A resnet + fedprox spec validates in both CLIs.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.api as japi  # noqa: E402
from repro.api import callbacks as jcallbacks  # noqa: E402
from repro.api import cli as jcli  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core import local as jlocal  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import round_engine as jre  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from _torch_blocks import (LOCAL_BODIES, local_block_case,  # noqa: E402
                           round_args)
import repro_torch.api as tapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api import callbacks as tcallbacks  # noqa: E402
from repro_torch.api import cli as tcli  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.core import ClientData, FederatedTrainer  # noqa: E402
from repro_torch.core import ParamPack, RoundEngine  # noqa: E402
from repro_torch.core import local as tlocal  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402
from repro_torch.wireless import ChannelModel, SystemParams  # noqa: E402

CPU = torch.device("cpu")
SCHEMES = [("fedavg", dict(steps=3)), ("fedprox", dict(steps=3, mu=0.05)),
           ("feddyn", dict(steps=2, alpha=0.1))]


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
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                      else t, np.float32).view(np.int32)


def _same_bits(a, b):
    return np.array_equal(_bits(a), _bits(b))


def _schedule(a, lam):
    a = np.asarray(a, np.float64)
    lam = np.broadcast_to(np.asarray(lam, np.float64), a.shape).copy()
    lam[a == 0] = 0.0
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def _assert_trainers_bitwise(ta, tb):
    for a, b in zip(leaves(ta.params), leaves(tb.params)):
        assert _same_bits(a, b)
    for a, b in zip(leaves(ta.global_grad), leaves(tb.global_grad)):
        assert torch.equal(a, b)
    assert (ta._h is None) == (tb._h is None)
    if ta._h is not None:
        assert _same_bits(ta._h, tb._h)


# -- the scheme zoo ----------------------------------------------------------------

@pytest.mark.parametrize("name,kw", [("fedavg", dict(steps=1)),
                                     ("fedavg", dict(steps=3)),
                                     ("fedprox", dict(steps=5, mu=0.05)),
                                     ("feddyn", dict(steps=1, alpha=0.1))])
def test_local_schemes_are_the_jax_packages(name, kw):
    t, j = tlocal.make_local_scheme(name, **kw), \
        jlocal.make_local_scheme(name, **kw)
    assert tlocal.local_spec_key(t) == jlocal.local_spec_key(j)
    if j is None:
        assert t is None
        return
    assert (t.steps_bucket, t.stateful, t.coeff) == \
        (j.steps_bucket, j.stateful, j.coeff)
    for bad, match in ((("scaffold", 2), {}), "unknown local scheme"), \
            ((("fedavg", 0), {}), "local_steps"), \
            ((("fedprox", 2), {"mue": 0.1}), "unknown local scheme kwargs"), \
            ((("feddyn", 2), {"alpha": -0.5}), "alpha must be >= 0"):
        with pytest.raises(ValueError, match=match):
            tlocal.make_local_scheme(bad[0][0], steps=bad[0][1], **bad[1])


def _subnormal_rich(rng, shape):
    a = (rng.normal(size=shape) * 1e-3).astype(np.float32)
    m = rng.random(shape)
    sign = np.sign(rng.normal(size=shape)).astype(np.float32)
    a[m < 0.1] = (np.float32(3e-39) * sign)[m < 0.1]
    a[(m >= 0.1) & (m < 0.15)] = -0.0
    a[(m >= 0.15) & (m < 0.2)] = np.float32(1.2e-38)
    return a


@pytest.mark.parametrize("coeff", [0.01, 0.5, 1e-30])
@pytest.mark.parametrize("with_h", [False, True])
def test_packed_local_delta_matches_jitted_jax(coeff, with_h):
    """d = g + coeff*(u - u0) [- hm] bit for bit against the jitted JAX op
    on inputs full of subnormals, signed zeros and differences that land
    below FLT_MIN (1e-30 flushes most products)."""
    rng = np.random.default_rng(int(coeff * 1e3) + with_h)
    g, u, u0, hm = (_subnormal_rich(rng, (256, 128)) for _ in range(4))
    u0[:, :5] = u[:, :5] + np.float32(2e-38)
    fn = jax.jit(lambda g, u, u0, hm: jops.packed_local_delta(
        g, u, u0, coeff, hm=hm if with_h else None))
    want = np.asarray(fn(g, u, u0, hm))
    got = ops.packed_local_delta(
        *(torch.from_numpy(a) for a in (g, u, u0)), coeff,
        hm=torch.from_numpy(hm) if with_h else None)
    np.testing.assert_array_equal(_bits(got), want.view(np.int32))


# -- packed == reference --------------------------------------------------------------

_rng = np.random.default_rng(0)
D = 5


class _Toy:
    def __init__(self, n):
        self.x = _rng.normal(size=(n, D)).astype(np.float32)
        self.y = _rng.integers(0, 2, size=n).astype(np.int32)

    def __len__(self):
        return len(self.y)


def _toy_problem(n_clients=4):
    """The JAX test's toy logistic problem, in both packages."""
    clients = [_Toy(12 + 3 * i) for i in range(n_clients)]
    w = _rng.normal(size=(D,)).astype(np.float32)
    jparams = {"w": jnp.asarray(w), "b": jnp.zeros((), jnp.float32)}
    tparams = {"w": torch.as_tensor(w), "b": torch.zeros(())}

    def jloss(p, x, y):
        logits = x @ p["w"] + p["b"]
        return jnp.mean(jnp.log1p(jnp.exp(-(2.0 * y - 1.0) * logits)))

    def tloss(p, x, y):
        logits = x @ p["w"] + p["b"]
        return torch.log1p(torch.exp(-(2.0 * y - 1.0) * logits)).mean()

    return clients, (jparams, jloss), (tparams, tloss)


def _run(loss, params, clients, sched, ls, **kw):
    tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                          seed=0, device="cpu", local_scheme=ls, **kw)
    n = len(clients)
    ch = ChannelModel(n)
    hist = tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink)
    return tr, [m.train_loss for m in hist]


@pytest.mark.parametrize("name,kw", SCHEMES)
def test_toy_packed_matches_reference_bitwise(name, kw):
    clients, _, (params, loss) = _toy_problem()
    sched = _schedule(np.ones((5, 4)), 0.3)
    ls = tlocal.make_local_scheme(name, **kw)
    tr_r, lr = _run(loss, params, clients, sched, ls, backend="reference")
    for rpd in (1, 4):
        tr_p, lp = _run(loss, params, clients, sched, ls,
                        rounds_per_dispatch=rpd)
        _assert_trainers_bitwise(tr_r, tr_p)
        assert lp == lr
        if rpd == 4:
            assert tr_p.n_block_dispatches >= 2
    if name == "feddyn":
        assert float(tr_r._h.abs().sum()) > 0
    else:
        assert tr_r._h is None


@pytest.mark.parametrize("name,kw", SCHEMES)
def test_resnet_packed_matches_reference_bitwise(name, kw):
    """A depth-8 ResNet (width 4) on synthetic CIFAR-10, three rounds of 3
    clients with per-client lambda in round 1, one of them ragged."""
    ds = make_dataset("synthetic-cifar10", n_train=50, n_test=10, seed=1)
    sizes = (20, 24, 6)
    off = np.cumsum((0,) + sizes)
    clients = [ClientData(ds.x_train[a:b], ds.y_train[a:b])
               for a, b in zip(off, off[1:])]
    params = cnn.resnet_init(torch.Generator().manual_seed(2), depth=8,
                             width=4, device="cpu")
    lam = np.full((3, 3), 0.3)
    lam[1] = [0.2, 0.5, 0.3]
    sched = _schedule(np.ones((3, 3)), lam)
    ls = tlocal.make_local_scheme(name, **kw)
    loss = cnn.make_loss_fn(cnn.resnet_apply)
    tr_r, lr = _run(loss, params, clients, sched, ls, backend="reference")
    for rpd in (1, 4):
        tr_p, lp = _run(loss, params, clients, sched, ls,
                        rounds_per_dispatch=rpd)
        _assert_trainers_bitwise(tr_r, tr_p)
        assert lp == lr
        assert tr_p.n_fallback_rounds == 0


@pytest.mark.parametrize("name", list(LOCAL_BODIES))
def test_local_block_step_equals_round_steps(name):
    """A block of 4 local-scheme rounds (FedDyn under dropped and NaN
    uploads, FedProx with a ragged client) equals 4 round_step calls bit
    for bit, FedDyn's state included."""
    eng, store, params, ops_, kw = local_block_case(CPU, name, seed=3)
    cids, _, _, counts = ops_
    dyn = name == "feddyn"
    w0, v0 = eng.init_buffers(params)
    h_e = torch.zeros((6,) + tuple(w0.shape)) if dyn else None
    h_b = torch.zeros_like(h_e) if dyn else None
    w, v, ref = w0, v0, []
    for k in range(4):
        xs, ys, args = round_args(store, ops_, kw, k)
        lams = args.pop("lams")
        if dyn:
            args.update(h=h_e, client_ids=cids[k, :int(counts[k])])
        w, v, losses, thr, _ = eng.round_step(w, v, xs, ys, lams, **args)
        ref.append((losses, thr, int(eng.last_n_ok)))
    wb, vb, lb, tb = eng.block_step(w0, v0, store, *ops_, h=h_b, **kw)
    assert _same_bits(wb, w) and torch.equal(vb, v)
    if dyn:
        assert _same_bits(h_b, h_e) and float(h_b.abs().sum()) > 0
        assert eng.last_h is h_b
    for k, (losses, thr, n_ok) in enumerate(ref):
        n = int(counts[k])
        assert _same_bits(lb[k, :n], losses)
        assert _same_bits(tb[k].reshape(-1)[:thr.numel()], thr.reshape(-1))
        assert int(eng.last_n_ok[k]) == n_ok
    with pytest.raises(ValueError, match="local-step"):
        eng.block_step(w0, v0, store, cids, ops_[1][:, :, 0], *ops_[2:],
                       h=h_b, **kw)


# -- against the JAX package ----------------------------------------------------------

@pytest.mark.parametrize("name,kw", SCHEMES)
def test_local_schemes_follow_jax(name, kw):
    """Five rounds of the toy problem (per-client lambda on round 2) from
    the same weights in both packages: losses to rtol 1e-4, parameters,
    v and FedDyn's h to atol 1e-4."""
    clients, (jparams, jloss), (tparams, tloss) = _toy_problem()
    lam = np.full((5, 4), 0.3)
    lam[2] = [0.1, 0.3, 0.5, 0.3]
    sched = _schedule(np.ones((5, 4)), lam)
    tr, lt = _run(tloss, tparams, clients, sched,
                  tlocal.make_local_scheme(name, **kw))
    jtr = JTrainer(jloss, jparams, clients, eta=0.1, batch_size=8, seed=0,
                   shards=1, local_scheme=jlocal.make_local_scheme(name, **kw))
    ch = ChannelModel(4)
    jh = jtr.run(sched, SystemParams.table1(4), ch.uplink, ch.downlink)
    np.testing.assert_allclose(lt, [m.train_loss for m in jh], rtol=1e-4)
    for k in ("w", "b"):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jtr.params[k]), atol=1e-4)
        np.testing.assert_allclose(tr.global_grad[k].numpy(),
                                   np.asarray(jtr.global_grad[k]), atol=1e-4)
    if name == "feddyn":
        np.testing.assert_allclose(tr._h.numpy(), np.asarray(jtr._h),
                                   atol=1e-4)
        assert float(np.abs(np.asarray(jtr._h)).sum()) > 0


def test_subnormal_client_weight_leaves_its_state_row_like_jax():
    """A FedDyn round whose second client's upload weight is 3e-39: XLA
    compares the flushed weight, so that client is dead and its h row stays
    zero, in the JAX engine and in the port's; the live rows move."""
    rng = np.random.default_rng(8)
    jp = jcnn.mlp_edge_init(jax.random.key(8))
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp))
    xs = rng.normal(size=(3, 2, 8, 28, 28, 1)).astype(np.float32)
    ys = rng.integers(0, 10, (3, 2, 8)).astype(np.int32)
    uw = np.asarray([1.0, 3e-39, 1.0], np.float32)
    ids = np.asarray([4, 1, 2], np.int32)
    jls = jlocal.make_local_scheme("feddyn", steps=2, alpha=0.1)
    jpack = jpacking.ParamPack.build(jp)
    jloss = jcnn.make_loss_fn(jcnn.mlp_edge_apply)
    jeng = jre.RoundEngine(jloss, jpack, eta=0.1, weighted_loss_fn=jloss.weighted,
                           shards=1, local_scheme=jls)
    jw, jv = jeng.init_buffers(jp)
    jh0 = jnp.zeros((5, jpack.rows, 128), jnp.float32)
    jeng.round_step(jw, jv, xs, ys, [0.3] * 3, upload_weights=uw, h=jh0,
                    client_ids=ids)
    jh = np.asarray(jeng.last_h)
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    eng = RoundEngine(loss, ParamPack.build(tp), eta=0.1,
                      weighted_loss_fn=loss.weighted,
                      local_scheme=tlocal.make_local_scheme(
                          "feddyn", steps=2, alpha=0.1), device="cpu")
    w, v = eng.init_buffers(tp)
    h = torch.zeros((5, eng.pack.rows, 128))
    eng.round_step(w, v, xs, ys, [0.3] * 3, upload_weights=uw, h=h,
                   client_ids=ids)
    for hh in (jh, h.numpy()):
        assert not hh[1].any() and not hh[0].any() and not hh[3].any()
        assert hh[4].any() and hh[2].any()
    np.testing.assert_allclose(h.numpy(), jh, atol=1e-5)


# -- FedDyn's state through the experiment API -----------------------------------------

N, ROUNDS = 5, 8


def _small_spec(api, **kw):
    scheme_kw = {k: kw.pop(k) for k in
                 ("local_scheme", "local_steps", "local_kwargs") if k in kw}
    return api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-mnist", n_clients=N, sigma=5.0,
                          n_train=200, n_test=60, seed=0),
        model=api.ModelSpec(name="mlp-edge"),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="proposed", rounds=ROUNDS, eta=0.1,
                              batch=8, ao={"outer_iters": 1}, **scheme_kw),
        run=api.RunSpec(seed=0, eval_every=4, **kw))


_FEDDYN = dict(local_scheme="feddyn", local_steps=2,
               local_kwargs={"alpha": 0.1})


class _KillAt(tapi.Callback):
    def __init__(self, round_, every):
        self.round_ = round_
        self.checkpoint_every = every

    def on_checkpoint(self, m, trainer):
        if m.round == self.round_:
            raise RuntimeError("simulated mid-run kill")


@pytest.mark.parametrize("rpd", [1, 4])
def test_feddyn_kill_resume_restores_h_bitwise(tmp_path, rpd):
    base = _small_spec(tapi, rounds_per_dispatch=rpd, **_FEDDYN)
    run_a = tapi.Experiment(base).build(device="cpu")
    res_a = run_a.run()
    assert float(run_a.trainer._h.abs().sum()) > 0
    ckpt = str(tmp_path / f"ckpt_rpd{rpd}")
    spec = dataclasses.replace(base, run=dataclasses.replace(
        base.run, checkpoint_dir=ckpt, checkpoint_every=4))
    with pytest.raises(RuntimeError, match="simulated"):
        tapi.Experiment(spec).build(device="cpu").run(
            callbacks=[_KillAt(4, 4)])
    run_b = tapi.Experiment(spec).build(device="cpu")
    h_b = run_b.trainer._ensure_h()
    res_b = run_b.resume(ckpt)
    assert res_b.summary["resumed_from"] == 4
    assert run_b.trainer._h is h_b            # restored in place
    for fld in ("train_loss", "test_loss", "test_accuracy",
                "cumulative_energy", "selected"):
        assert [getattr(m, fld) for m in res_b.history] == \
            [getattr(m, fld) for m in res_a.history], fld
    _assert_trainers_bitwise(run_a.trainer, run_b.trainer)


def test_reset_zeroes_the_feddyn_state_in_place():
    clients, _, (params, loss) = _toy_problem()
    ls = tlocal.make_local_scheme("feddyn", steps=2, alpha=0.1)
    tr, _ = _run(loss, params, clients, _schedule(np.ones((2, 4)), 0.3), ls)
    h = tr._h
    assert float(h.abs().sum()) > 0
    tr.reset(params, seed=0)
    assert tr._h is h and not h.any()
    # a reset trainer's run is a new trainer's, h included
    ch = ChannelModel(4)
    tr.run(_schedule(np.ones((2, 4)), 0.3), SystemParams.table1(4),
           ch.uplink, ch.downlink)
    fresh, _ = _run(loss, params, clients, _schedule(np.ones((2, 4)), 0.3),
                    ls)
    _assert_trainers_bitwise(tr, fresh)


def test_feddyn_checkpoints_load_in_either_package(tmp_path):
    """A FedDyn checkpoint written by the port restores into the JAX
    package's trainer, and one written by JAX into the port's: parameters,
    v and h bit for bit (the leaf "['h']" of both formats)."""
    spec_t = _small_spec(tapi, **_FEDDYN)
    spec_j = _small_spec(japi, shards=1, **_FEDDYN)
    run_t = tapi.Experiment(spec_t).build(device="cpu")
    run_t.run()
    run_j = japi.Experiment(spec_j).build()
    run_j.run()
    m = run_t.trainer
    mt = tcallbacks.metrics_from_dict({"round": 7, "train_loss": 0.0,
                                       "selected": [], "mean_lambda": 0.0,
                                       "delay": 0.0, "energy": 0.0,
                                       "cumulative_delay": 0.0,
                                       "cumulative_energy": 0.0})
    tcallbacks.save_trainer_state(CheckpointManager(str(tmp_path / "t")),
                                  m, mt)
    jt = japi.Experiment(spec_j).build().trainer
    jcallbacks.restore_trainer_state(
        jcallbacks.CheckpointManager(str(tmp_path / "t")), jt)
    assert _same_bits(np.asarray(jt._h), m._h)
    for a, b in zip(jax.tree_util.tree_leaves(jt.params), leaves(m.params)):
        assert _same_bits(np.asarray(a), b)
    jcallbacks.save_trainer_state(
        jcallbacks.CheckpointManager(str(tmp_path / "j")), run_j.trainer, mt)
    tt = tapi.Experiment(spec_t).build(device="cpu").trainer
    h = tt._ensure_h()
    tcallbacks.restore_trainer_state(CheckpointManager(str(tmp_path / "j")),
                                     tt)
    assert tt._h is h and _same_bits(tt._h, np.asarray(run_j.trainer._h))
    for a, b in zip(leaves(tt.global_grad),
                    jax.tree_util.tree_leaves(run_j.trainer.global_grad)):
        assert _same_bits(a, np.asarray(b))


def test_resnet_fedprox_spec_validates_in_both_clis(tmp_path, capsys):
    spec = tapi.ExperimentSpec(
        data=tapi.DataSpec(dataset="synthetic-cifar10"),
        model=tapi.ModelSpec(name="resnet"),
        scheme=tapi.SchemeSpec(local_scheme="fedprox", local_steps=2,
                               local_kwargs={"mu": 0.01}))
    path = spec.save(str(tmp_path / "spec.json"))
    assert tcli.main(["validate", path]) == 0
    out_t = capsys.readouterr().out
    assert jcli.main(["validate", path]) == 0
    out_j = capsys.readouterr().out
    assert out_t == out_j and '"resnet"' in out_t and '"fedprox"' in out_t
    built = tapi.Experiment(dataclasses.replace(
        spec, data=dataclasses.replace(spec.data, n_train=60, n_test=20,
                                       n_clients=3),
        model=dataclasses.replace(spec.model, kwargs={"depth": 8,
                                                      "width": 4}),
        run=dataclasses.replace(spec.run, evaluate=False))
    ).build(device="cpu")
    assert built.trainer.local_scheme.spec_key == ("fedprox", 2, 0.01, 0.0)
    assert built.trainer.pack.paths[0] == "['blocks'][0]['bias1']"


def test_feddyn_over_a_streamed_store_names_item_5():
    """FedDyn over a streamed store (ROADMAP.md §1 item 5, ported): the
    state slab round trip gives the replicated store's bits, h included
    (tests/test_torch_fleet.py holds it through the experiment API)."""
    clients, _, (params, loss) = _toy_problem()
    a = np.zeros((6, 4))
    for s, sel in enumerate(([0, 1], [2, 3], [1, 2], [0, 3], [0, 2],
                             [1, 3])):
        a[s, sel] = 1.0                  # a new cohort every block
    sched = _schedule(a, 0.3)
    out = {}
    for mode in ("streamed", "replicated"):
        tr = FederatedTrainer(loss, params, clients, eta=0.1, batch_size=8,
                              device="cpu", client_store=mode,
                              rounds_per_dispatch=2,
                              local_scheme=tlocal.make_local_scheme(
                                  "feddyn", steps=2, alpha=0.1))
        n = len(clients)
        ch = ChannelModel(n)
        hist = tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink)
        out[mode] = (tr, hist)
    (ts, hs), (tr_, hr) = out["streamed"], out["replicated"]
    assert ts.streaming and not tr_.streaming
    assert [m.train_loss for m in hs] == [m.train_loss for m in hr]
    assert np.array_equal(_bits(ts._h), _bits(tr_._h))
    assert float(ts._h.abs().sum()) > 0
    assert all(np.array_equal(_bits(a), _bits(b)) for a, b in
               zip(leaves(ts.params), leaves(tr_.params)))
