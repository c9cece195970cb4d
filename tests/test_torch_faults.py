"""The port's scenario draws against the JAX package's: fault models,
channel noise, and the attack slice's schedule.

Every draw is numpy on the host in both packages (the port keeps its own
copy of `core/faults.py` and `wireless/channel.py`), so everything here is
held EXACTLY equal: upload flags, corruption factors, poison stacks and
noise bit for bit, and the attack slice's schedule (the configuration
`chip_smoke.py` runs, `benchmarks/robust_aggregation.attack_spec` at a 30 %
scaled-malicious attack) array for array.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.faults as jfaults  # noqa: E402
import repro.wireless.channel as jchannel  # noqa: E402
import repro_torch.core.faults as tfaults  # noqa: E402
import repro_torch.wireless.channel as tchannel  # noqa: E402


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


N_POP = 10
ROUNDS = 20


def _models(mod):
    """One instance of every fault model, with the knobs that make it bite
    (rates high enough that most rounds fault something)."""
    return [
        mod.ClientDropout(rate=0.3, seed=5),
        mod.StragglerTimeout(tolerance=1.0, sigma=0.8, seed=5),
        mod.CorruptUpload(rate=0.4, mode="scale", scale=10.0, seed=5),
        mod.CorruptUpload(rate=0.4, mode="nan", seed=5),
        mod.MixedFaults(dropout_rate=0.25, corrupt_rate=0.25, seed=5),
        mod.MixedFaults(dropout_rate=0.2, straggler_tolerance=1.2,
                        corrupt_rate=0.2, corrupt_mode="scale", seed=7),
        mod.SignFlip(rate=0.4, scale=2.0, seed=5),
        mod.ScaledMalicious(rate=0.3, scale=10.0, seed=0, exact=True),
        mod.ScaledMalicious(rate=0.4, scale=10.0, seed=5),
        mod.GaussianPoison(rate=0.4, sigma=0.5, seed=5),
        mod.GaussianPoison(rate=0.3, sigma=1.0, seed=2, exact=True),
    ]


MODEL_IDS = ["dropout", "straggler", "corrupt_scale", "corrupt_nan",
             "mixed", "mixed_straggler", "sign_flip", "scaled_exact",
             "scaled", "gaussian_poison", "gaussian_exact"]


def _assert_draws_equal(t, j, valid):
    np.testing.assert_array_equal(t.upload_ok, j.upload_ok)
    assert t.upload_ok.dtype == j.upload_ok.dtype
    assert (t.corrupt is None) == (j.corrupt is None)
    if t.corrupt is not None:
        assert t.corrupt.dtype == j.corrupt.dtype == np.float32
        np.testing.assert_array_equal(t.corrupt.view(np.int32),
                                      j.corrupt.view(np.int32))
    assert (t.poison is None) == (j.poison is None)
    if t.poison is not None:
        np.testing.assert_array_equal(t.poison.flags, j.poison.flags)
        tp, jp = t.poison(valid.shape, valid), j.poison(valid.shape, valid)
        assert tp.dtype == jp.dtype == np.float32
        np.testing.assert_array_equal(tp.view(np.int32), jp.view(np.int32))
    assert t.n_faulted == j.n_faulted


@pytest.mark.parametrize("k", range(len(MODEL_IDS)), ids=MODEL_IDS)
def test_fault_draws_equal_jax_over_20_rounds(k):
    tm, jm = _models(tfaults)[k], _models(jfaults)[k]
    rng = np.random.default_rng(k)
    valid = np.ones((3, 128), np.float32)
    valid[-1, 70:] = 0.0                      # padding lanes of the pack
    everyone = np.arange(N_POP)
    bit = 0
    for s in range(ROUNDS):
        sel = np.sort(rng.choice(N_POP, size=rng.integers(1, N_POP + 1),
                                 replace=False))
        delays = rng.uniform(0.5, 2.0, N_POP)
        kw = dict(delays=delays[sel], deadline=float(delays[sel].max()))
        t = tm.draw(s, N_POP, sel, **kw)
        _assert_draws_equal(t, jm.draw(s, N_POP, sel, **kw), valid)
        # a client's fate is a function of (seed, round, id) alone: the
        # same draw over the whole population, then indexed, agrees
        full = tm.draw(s, N_POP, everyone, delays=delays,
                       deadline=kw["deadline"])
        np.testing.assert_array_equal(t.upload_ok, full.upload_ok[sel])
        if t.corrupt is not None:
            np.testing.assert_array_equal(t.corrupt.view(np.int32),
                                          full.corrupt[sel].view(np.int32))
        if t.poison is not None:
            np.testing.assert_array_equal(t.poison.flags,
                                          full.poison.flags[sel])
        # and a larger population (clients appended after these ids) leaves
        # the Bernoulli draws of these ids as they were; the exact-count
        # attacks rank the whole population, so they may move
        if not getattr(tm, "exact", False):
            big = tm.draw(s, N_POP + 6, sel, **kw)
            np.testing.assert_array_equal(big.upload_ok, t.upload_ok)
            if t.corrupt is not None:
                np.testing.assert_array_equal(big.corrupt, t.corrupt)
            if t.poison is not None:
                np.testing.assert_array_equal(big.poison.flags,
                                              t.poison.flags)
        bit += int((~t.upload_ok).sum())
        if t.corrupt is not None:
            bit += int((t.corrupt != 1.0).sum())
        if t.poison is not None:
            bit += int(np.asarray(t.poison.flags).sum())
    assert bit > 0                            # the model really faults


def test_fault_model_validation_matches_jax():
    for mod in (tfaults, jfaults):
        for bad in (lambda: mod.ClientDropout(rate=1.5),
                    lambda: mod.StragglerTimeout(tolerance=0.0),
                    lambda: mod.CorruptUpload(mode="wat"),
                    lambda: mod.SignFlip(rate=-0.1),
                    lambda: mod.GaussianPoison(sigma=-1.0)):
            with pytest.raises(ValueError):
                bad()
    assert tfaults.ClientDropout(rate=1.0).draw(
        0, 8, np.arange(8)).n_faulted == 8
    assert tfaults.GaussianPoison(rate=0.0).draw(
        2, 8, np.arange(8)).poison is None


@pytest.mark.parametrize("std,seed", [(1e-3, 0), (0.5, 7)])
def test_channel_noise_equals_jax_bitwise(std, seed):
    valid = np.ones((256, 128), np.float32)
    valid.reshape(-1)[-300:] = 0.0
    tn = tchannel.GaussianAggregateNoise(std=std, seed=seed)
    jn = jchannel.GaussianAggregateNoise(std=std, seed=seed)
    for s in (0, 1, 17):
        a = tn.sample_packed(s, valid.shape, valid)
        b = jn.sample_packed(s, valid.shape, valid)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        assert not a.reshape(-1)[-300:].any()
    assert not np.array_equal(tn.sample_packed(0, (4, 128)),
                              tn.sample_packed(1, (4, 128)))


def test_attack_slice_schedule_equals_jax():
    """The attack slice: `attack_spec(ExpConfig(), "coord_median", {}, 0.3)`
    through the JAX package's build_environment and Experiment, against the
    same configuration through the port's numpy copies (what chip_smoke.py
    builds): (a, lambda, power, freq) exactly equal, every client selected
    every round, no pruning."""
    from benchmarks.common import ExpConfig
    from benchmarks.robust_aggregation import attack_spec
    from repro.api import Experiment, build_environment
    import repro_torch.core as tcore
    import repro_torch.data as tdata
    import repro_torch.wireless as twireless

    spec = attack_spec(ExpConfig(), "coord_median", {}, 0.3)
    env = build_environment(spec)
    jsched = Experiment(spec).build(env=env).schedule
    d, sc, wl = spec.data, spec.scheme, spec.wireless

    ds = tdata.make_dataset(d.dataset, n_train=d.n_train, n_test=d.n_test,
                            noise=d.noise, seed=d.seed)
    parts = tdata.partition_by_dirichlet(ds.y_train, d.n_clients, d.sigma,
                                         rng=np.random.default_rng(d.seed))
    clients = [tcore.ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]
    phi = tcore.phis(np.stack([c.label_histogram(10) for c in clients]),
                     np.bincount(ds.y_test, minlength=10).astype(float)[None])
    sp = twireless.SystemParams.table1(d.n_clients, dataset="mnist",
                                       batch_size=sc.batch)
    ch = twireless.ChannelModel(d.n_clients, path_loss=wl.path_loss,
                                seed=wl.seed)
    consts = tcore.BoundConstants(rounds_S=sc.rounds - 1, batch_Z=sc.batch,
                                  eta=sc.eta)
    tsched = tcore.solve_p1(phi, wl.e0, wl.t0, ch.uplink, ch.downlink, sp,
                            consts, tcore.AOConfig(
                                fix_selection=True, outer_iters=3,
                                selection_method="paper",
                                phi_coupling="mean"))
    np.testing.assert_array_equal(phi, env.phi)
    for field in ("a", "lam", "power", "freq"):
        np.testing.assert_array_equal(getattr(tsched, field),
                                      getattr(jsched, field))
    assert tsched.feasible == jsched.feasible
    assert tsched.a.shape == (60, 10) and (tsched.a == 1).all()
    # lambda <= 6e-12: k = floor(lambda * 107764) = 0, the shared mask
    assert (np.floor(tsched.lam * 107_764) == 0).all()
    assert wl.fault_model == "scaled_malicious"
    assert wl.fault_kwargs == {"rate": 0.3, "scale": 10.0, "exact": True}
