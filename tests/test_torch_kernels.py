"""The port's round kernels against the JAX package's, bit for bit.

The same numpy inputs (fixed seed) go through the JAX entry points in
`repro.kernels.ops` — the XLA mirror (impl="xla") and the Pallas kernels in
interpret mode (impl="pallas"), exactly as the JAX package's own tests run
them on the CPU — and through the port's `repro_torch.kernels.ops`, whose
CPU path is each kernel's plain PyTorch version. Every output must carry the
same fp32 bits. The inputs hold the cases the round relies on: exact-zero
and underflowing importances (denormals are zero), a subnormal threshold
(round 0's nextafter(0)), NaN gradients on zero-weight clients, and for the
rank sort NaN on zero-weight clients, +-0.0, ties and +-inf on valid ones.
The masked update is held bit for bit to the eager reference
(``ref.masked_update_ref``); the jitted JAX entry point contracts its
w - eta*g into an FMA and is held within one ulp of eta*g.

The hand-written CUDA kernels are held to the same plain versions on the
card by tests/test_torch_cuda.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.round_engine import kth_smallest_threshold  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import pruning_mask as pm  # noqa: E402


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


LANES = 128
# jitted once per (coarse, k shape): the inputs below share one shape
jax_kth = jax.jit(kth_smallest_threshold, static_argnames=("coarse",))
TINY = np.float32(np.nextafter(np.float32(0), np.float32(1)))  # 0x00000001


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def assert_bitwise(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(rows: int, seed: int = 0):
    """w, v, prunable [rows, 128] with the edge cases of the round: v = 0
    (q exactly 0), |w*v| ~ 1e-20 (q subnormal before the flush), tiny v
    (q underflows), protected and padding coordinates (prunable = 0)."""
    rng = np.random.default_rng(seed)
    shape = (rows, LANES)
    w = rng.normal(size=shape).astype(np.float32)
    v = (1e-2 * rng.normal(size=shape)).astype(np.float32)
    v.reshape(-1)[::11] = 0.0
    v.reshape(-1)[3::17] = np.float32(3e-20)
    v.reshape(-1)[5::13] = np.float32(1e-30)
    pr = np.ones(shape, np.float32)
    pr.reshape(-1)[: 7 * LANES // 2] = 0.0          # a protected leaf
    pr.reshape(-1)[-3 * LANES - 17:] = 0.0          # padding tail
    return w, v, pr


def _thresholds(q: np.ndarray, n: int, seed: int = 1) -> np.ndarray:
    """n thresholds covering the compare's cases."""
    rng = np.random.default_rng(seed)
    pool = [np.float32(0.0), TINY, np.float32(-np.inf), np.float32(np.nan),
            np.float32(np.nextafter(np.float32(1e-30), np.float32(1)))]
    pool += list(rng.choice(q.reshape(-1), size=8))
    return np.asarray(pool[:n] if n <= len(pool) else
                      (pool * (n // len(pool) + 1))[:n], np.float32)


CASES = [(256, "xla"), (1024, "xla"), (256, "pallas")]


# -- importance: the denormal rule ----------------------------------------------

@pytest.mark.parametrize("rows", [256, 1024])
def test_importance_flushes_denormals_like_jax(rows):
    w, v, _ = _inputs(rows)
    q_jax = jax.jit(lambda a, b: (a * b) ** 2)(w, v)
    q = pm.importance(_t(w), _t(v))
    assert_bitwise(q, q_jax)
    # the flush is what makes them agree: torch alone keeps subnormals
    raw = (_t(w) * _t(v)) ** 2
    assert bool(((raw > 0) & (raw < pm.FLT_MIN)).any())
    assert not bool(((q > 0) & (q < pm.FLT_MIN)).any())


# -- importance_mask_2d / packed_importance_mask ---------------------------------

@pytest.mark.parametrize("rows,impl", CASES)
def test_importance_mask_shared_matches_jax(rows, impl):
    w, v, pr = _inputs(rows)
    q_np = np.asarray(pm.importance(_t(w), _t(v)))
    for thr in _thresholds(q_np, 13):
        jq, jm = jops.packed_importance_mask(w, v, pr, jnp.float32(thr),
                                             impl=impl)
        tq, tm = tops.packed_importance_mask(_t(w), _t(v), _t(pr),
                                             torch.tensor(thr))
        assert_bitwise(tq, jq)
        assert_bitwise(tm, jm)


@pytest.mark.parametrize("rows,impl", CASES)
@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_importance_masks_per_client_match_jax(rows, impl, n_clients):
    w, v, pr = _inputs(rows, seed=n_clients)
    q_np = np.asarray(pm.importance(_t(w), _t(v)))
    thr = _thresholds(q_np, n_clients, seed=n_clients)
    jq, jm = jops.packed_importance_masks(w, v, pr, jnp.asarray(thr),
                                          impl=impl)
    tq, tm = tops.packed_importance_masks(_t(w), _t(v), _t(pr), _t(thr))
    assert tm.shape == (n_clients, rows, LANES)
    assert_bitwise(tq, jq)
    assert_bitwise(tm, jm)


def test_subnormal_threshold_keeps_zero_importance():
    """Round 0: v = 0, every q is 0 and the threshold is nextafter(0), a
    subnormal. JAX (denormals are zero) keeps every coordinate; so must the
    port, or it would prune the whole model and never train."""
    w, _, pr = _inputs(256)
    v = np.zeros_like(w)
    _, jm = jops.packed_importance_mask(w, v, pr, jnp.float32(TINY),
                                        impl="xla")
    _, tm = tops.packed_importance_mask(_t(w), _t(v), _t(pr),
                                        torch.tensor(TINY))
    assert bool(np.all(np.asarray(jm) == 1.0))
    assert_bitwise(tm, jm)


# -- exponent_histogram ----------------------------------------------------------

@pytest.mark.parametrize("rows,impl", CASES)
def test_exponent_histogram_matches_jax(rows, impl):
    w, v, pr = _inputs(rows)
    q = np.asarray(pm.importance(_t(w), _t(v)))
    q.reshape(-1)[7] = np.float32(3e38)
    q.reshape(-1)[9] = np.float32(1.5e-38)
    h_jax = jops.packed_exponent_histogram(q, pr, impl=impl)
    h = tops.packed_exponent_histogram(_t(q), _t(pr))
    assert h.dtype == torch.int32
    assert_bitwise(h, h_jax)
    assert int(h.sum()) == int(pr.sum())


# -- fedsgd_aggregate_weighted ---------------------------------------------------

def _aggregate_inputs(rows, n_clients, seed):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rows, LANES)).astype(np.float32)
    grads = rng.normal(size=(n_clients, rows, LANES)).astype(np.float32)
    cw = np.ones(n_clients, np.float32)
    if n_clients > 1:                      # padding clients hold NaN
        cw[-1] = 0.0
        grads[-1] = np.nan
    if n_clients > 3:
        cw[1] = 0.0
        grads[1, ::3] = np.inf
    inv = np.float32(1.0 / cw.sum())
    return w, grads, cw, inv


@pytest.mark.parametrize("rows,impl", CASES)
@pytest.mark.parametrize("n_clients", [1, 3, 8, 10])
def test_fedsgd_update_weighted_matches_jax(rows, impl, n_clients):
    w, grads, cw, inv = _aggregate_inputs(rows, n_clients, seed=n_clients)
    eta = np.float32(0.1)
    jw, jg, js = jops.packed_fedsgd_update_weighted(w, grads, cw, inv, eta,
                                                    impl=impl)
    tw, tg, ts = tops.packed_fedsgd_update_weighted(
        _t(w), _t(grads), _t(cw), torch.tensor(inv), torch.tensor(eta))
    for t in (tw, tg, ts):
        assert bool(torch.isfinite(t).all())
    assert_bitwise(tg, jg)
    assert_bitwise(ts, js)
    # w' = w - step with the step rounded on its own, as the reference
    # trainer computes it
    assert_bitwise(tw, w - np.asarray(js))
    if impl == "xla":
        assert_bitwise(tw, jw)
    else:
        # The interpret-mode Pallas kernel lets XLA:CPU contract its own
        # w - eta*g into an FMA, so its w' may sit a few ulps off its own
        # step output; the JAX package's tests allow the same 1e-6 between
        # its two impls (tests/test_round_engine.py).
        np.testing.assert_allclose(_bits(tw).view(np.float32), np.asarray(jw),
                                   rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("n_clients", [3, 8])
def test_quarantine_and_aggregate_tail_match_jax(n_clients):
    """The engine's tail from the same stacked gradients: the non-finite
    quarantine (a weighted client uploading NaN is dropped and the mean
    renormalised on the device), then the weighted aggregate."""
    w, grads, cw, _ = _aggregate_inputs(256, n_clients, seed=5)
    grads[0, 4, 7] = np.nan                 # a real client goes non-finite
    inv = np.float32(1.0 / cw.sum())
    jcw, jinv, jn, jalive = jops.packed_client_quarantine(grads, cw, inv)
    tcw, tinv, tn, talive = tops.packed_client_quarantine(_t(grads), _t(cw),
                                                          inv)
    assert_bitwise(tcw, jcw)
    assert_bitwise(tinv, jinv)
    assert int(tn) == int(jn) and bool(talive) == bool(jalive)
    eta = np.float32(0.05)
    jout = jops.packed_fedsgd_update_weighted(w, grads, jcw, jinv, eta,
                                              impl="xla")
    tout = tops.packed_fedsgd_update_weighted(_t(w), _t(grads), tcw, tinv,
                                              torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)


# -- fedsgd_aggregate (unweighted) -------------------------------------------------

@pytest.mark.parametrize("rows,impl", CASES)
@pytest.mark.parametrize("n_clients", [1, 3, 8, 10])
def test_fedsgd_update_matches_jax(rows, impl, n_clients):
    """g bit for bit. The port's step is eta*g rounded on its own, the
    sequence the JAX mirror writes (and the eager reference loop and the
    weighted aggregate compute). XLA:CPU reassociates that mirror, and the
    interpret-mode Pallas kernel, into (eta * float32(1/C)) * sum: the same
    bits when 1/C is a power of two (C = 1, 8), within two ulps of the step
    otherwise (C = 3, 10)."""
    rng = np.random.default_rng(20 + n_clients)
    w = rng.normal(size=(rows, LANES)).astype(np.float32)
    grads = rng.normal(size=(n_clients, rows, LANES)).astype(np.float32)
    grads[0, 3, :9] = -0.0                  # the sum starts from client 0
    eta = 0.1
    jw, jg, js = (np.asarray(a) for a in jops.packed_fedsgd_update(
        w, grads, eta, impl=impl))
    tw, tg, ts = tops.packed_fedsgd_update(_t(w), _t(grads), eta)
    assert_bitwise(tg, jg)
    assert_bitwise(ts, np.float32(eta) * jg)
    assert_bitwise(tw, w - ts.numpy())
    acc = grads[0].copy()
    for c in range(1, n_clients):
        acc = acc + grads[c]
    assert_bitwise(js, (np.float32(eta) * np.float32(1 / n_clients)) * acc)
    if n_clients in (1, 8):
        assert_bitwise(ts, js)
        if impl == "xla":
            assert_bitwise(tw, jw)
    else:
        # two roundings of three reals, each side: within two ulps
        np.testing.assert_allclose(ts.numpy(), js, rtol=2 * 2.0**-23, atol=0)
        assert bool((_bits(ts) != _bits(js)).any())
    if impl == "pallas":
        # the interpret-mode kernel also contracts its own w - step
        np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6, atol=1e-8)


def test_fedsgd_update_equals_weighted_with_unit_weights():
    """The contract between the two aggregates: all-ones weights and
    inv = float32(1/C) give the unweighted kernel's bits, a -0.0 on the
    first client included (both sums start from client 0's term)."""
    rng = np.random.default_rng(8)
    w = _t(rng.normal(size=(256, LANES)).astype(np.float32))
    g_np = rng.normal(size=(10, 256, LANES)).astype(np.float32)
    g_np[:, 3, :9] = -0.0                   # -0.0 on every client
    grads = _t(g_np)
    eta = torch.tensor(np.float32(0.1))
    a = tops.packed_fedsgd_update(w, grads, 0.1)
    b = tops.packed_fedsgd_update_weighted(
        w, grads, torch.ones(10), torch.tensor(np.float32(1 / 10)), eta)
    for x, y in zip(a, b):
        assert_bitwise(x, y)


# -- client_rank_sort -------------------------------------------------------------

def _rank_inputs(rows, n_clients, seed):
    """[C, rows, 128] with the sort's cases: ties (values from a small pool),
    +-0.0 and +-inf on valid clients, NaN and garbage on zero-weight ones."""
    rng = np.random.default_rng(seed)
    pool = np.asarray([-1.5, -0.0, 0.0, 0.25, 0.25, 3.0, np.inf, -np.inf],
                      np.float32)
    g = rng.normal(size=(n_clients, rows, LANES)).astype(np.float32)
    tie = rng.random(g.shape) < 0.3
    g[tie] = rng.choice(pool, size=int(tie.sum()))
    cw = np.ones(n_clients, np.float32)
    if n_clients > 2:
        cw[[1, -1]] = 0.0
        g[1] = np.nan
        g[-1, ::2] = 1e30
    return g, cw


@pytest.mark.parametrize("rows,impl", CASES)
@pytest.mark.parametrize("n_clients", [1, 3, 8, 10])
def test_client_rank_sort_matches_jax_on_every_rank(rows, impl, n_clients):
    g, cw = _rank_inputs(rows, n_clients, seed=n_clients)
    want = jops.packed_client_rank_sort(jnp.asarray(g), jnp.asarray(cw),
                                        impl=impl)
    got = tops.packed_client_rank_sort(_t(g), _t(cw))
    # every rank, the zero-weight tail included (the network is stable);
    # int32 views, since NaN never equals itself
    assert_bitwise(got, want)
    nv = int(cw.sum())
    keys = pm.order_keys(got[:nv])
    assert bool((keys[1:] >= keys[:-1]).all())


def test_order_keys_are_monotone():
    x = np.asarray([-np.inf, -3.0, -1e-40, -0.0, 0.0, 1e-40, 2.0, np.inf],
                   np.float32)
    k = pm.order_keys(_t(x))
    assert bool((k[1:] > k[:-1]).all())


# -- masked_update_2d --------------------------------------------------------------

def _masked_update_gap(got, jit, eta, g):
    """|port - jitted| beyond its bound, half an ulp of eta*g plus one ulp
    of the result; <= 0 everywhere when the FMA is the only difference."""
    diff = np.abs(got.numpy().astype(np.float64) - jit)
    bound = (0.5 * np.spacing(np.abs(np.float32(eta) * g))
             + np.spacing(np.abs(jit)))
    return diff - bound


@pytest.mark.parametrize("rows,impl", CASES)
def test_masked_update_matches_jax(rows, impl):
    rng = np.random.default_rng(rows)
    w = rng.normal(size=(rows, LANES)).astype(np.float32)
    g = rng.normal(size=(rows, LANES)).astype(np.float32)
    m = (rng.random((rows, LANES)) < 0.7).astype(np.float32)
    eta = 0.05
    got = tops.packed_masked_update(_t(w), _t(g), _t(m), eta)
    assert_bitwise(got, jref.masked_update_ref(w, g, m, eta))
    # the jitted entry point computes fmaf(-eta, g, w) * m: it differs from
    # the rounded-product form by at most half an ulp of eta*g (the one
    # rounding it skips) plus one ulp of the result
    jit = np.asarray(jops.packed_masked_update(w, g, m, eta, impl=impl))
    assert (_masked_update_gap(got, jit, eta, g) <= 0).all()
    fma = (np.float32(w.astype(np.float64) - np.float64(np.float32(eta))
                      * g.astype(np.float64)) * m)
    assert_bitwise(jit, fma)
    # 5,022 of 131,072 coordinates at R = 1024, 1,328 of 32,768 at R = 256
    contracted = int((_bits(got) != _bits(jit)).sum())
    assert contracted == {256: 1328, 1024: 5022}[rows]


@pytest.mark.parametrize("shape", [(129,), (7, 13), (5, 5, 6, 16)])
def test_masked_update_per_leaf_matches_jax(shape):
    rng = np.random.default_rng(len(shape))
    w = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = (rng.random(shape) < 0.5).astype(np.float32)
    got = tops.masked_update(_t(w), _t(g), _t(m), 0.1)
    assert got.shape == shape and got.dtype == torch.float32
    assert_bitwise(got, jref.masked_update_ref(w, g, m, 0.1))
    jit = np.asarray(jops.masked_update(w, g, m, 0.1))
    assert (_masked_update_gap(got, jit, 0.1, g) <= 0).all()


# -- kth_smallest_threshold ------------------------------------------------------

def _q_and_mask(scale, seed=11, n=4000):
    rng = np.random.default_rng(seed)
    vals = (scale * rng.random(n)).astype(np.float32)
    vals[::7] = 0.0                                   # ties at the bottom
    rows = -(-n // LANES)
    q = np.zeros(rows * LANES, np.float32)
    q[:n] = vals
    pr = np.zeros(rows * LANES, np.float32)
    pr[50:n] = 1.0
    return q.reshape(rows, LANES), pr.reshape(rows, LANES), int(pr.sum())


@pytest.mark.parametrize("coarse", ["bisect", "histogram"])
@pytest.mark.parametrize("scale", [1e-38, 1e-18, 1.0, 10.0, 1e18, 1e30])
def test_kth_smallest_threshold_matches_jax(coarse, scale):
    q, pr, n_valid = _q_and_mask(scale)
    ks = [0, 1, 7, n_valid // 3, n_valid - 1, n_valid, n_valid + 7]
    for k in ks:
        want = jax_kth(q, pr, jnp.int32(k), coarse=coarse)
        got = tre.kth_smallest_threshold(_t(q), _t(pr), k, coarse=coarse)
        assert got.shape == ()
        assert_bitwise(got, want)
    want = jax_kth(q, pr, jnp.asarray(ks, jnp.int32), coarse=coarse)
    got = tre.kth_smallest_threshold(_t(q), _t(pr), torch.tensor(ks),
                                 coarse=coarse)
    assert_bitwise(got, want)


@pytest.mark.parametrize("coarse", ["bisect", "histogram"])
def test_threshold_on_all_zero_importance_keeps_everything(coarse):
    """The denormal rule end to end: q = 0 everywhere (round 0) gives the
    threshold nextafter(0) on both sides, and the mask keeps every
    coordinate in both packages."""
    w, _, pr = _inputs(256)
    v = np.zeros_like(w)
    q = np.zeros_like(w)
    k = int(0.5 * pr.sum())
    want = jax_kth(q, pr, jnp.int32(k), coarse=coarse)
    got = tre.kth_smallest_threshold(_t(q), _t(pr), k, coarse=coarse)
    assert_bitwise(got, want)
    assert _bits(got) == 1                            # nextafter(0): 0x1
    _, jm = jops.packed_importance_mask(w, v, pr, want, impl="xla")
    _, tm = tops.packed_importance_mask(_t(w), _t(v), _t(pr), got)
    assert bool((tm == 1.0).all())
    assert_bitwise(tm, jm)


def test_threshold_modes_agree_and_reject_unknown():
    q, pr, n_valid = _q_and_mask(3.0, seed=4)
    for k in (0, 5, n_valid // 2, n_valid + 1):
        a = tre.kth_smallest_threshold(_t(q), _t(pr), k, coarse="histogram")
        b = tre.kth_smallest_threshold(_t(q), _t(pr), k, coarse="bisect")
        assert_bitwise(a, b)
    # CPU tensors default to the plain bisection, as JAX does on its CPU
    assert_bitwise(tre.kth_smallest_threshold(_t(q), _t(pr), 9),
                   tre.kth_smallest_threshold(_t(q), _t(pr), 9, coarse="bisect"))
    with pytest.raises(ValueError):
        tre.kth_smallest_threshold(_t(q), _t(pr), 3, coarse="sort")


# -- the impl resolver and the wrappers' CPU contract ----------------------------

def test_impl_resolver():
    w, v, pr = (_t(a) for a in _inputs(256))
    thr = torch.tensor(np.float32(1e-4))
    auto = tops.packed_importance_mask(w, v, pr, thr)
    plain = tops.packed_importance_mask(w, v, pr, thr, impl="torch")
    for a, b in zip(auto, plain):
        assert_bitwise(a, b)
    with pytest.raises(ValueError, match="cuda"):
        tops.packed_importance_mask(w, v, pr, thr, impl="cuda")
    with pytest.raises(ValueError, match="unknown impl"):
        tops.packed_exponent_histogram(w, pr, impl="pallas")


def test_wrappers_take_plain_version_on_cpu_without_counting():
    w, v, pr = (_t(a) for a in _inputs(256))
    pm.reset_launches()
    q, m = pm.importance_mask_2d(w, v, pr, torch.tensor(np.float32(1e-4)))
    pm.importance_mask_batched(w, v, pr, torch.tensor([0.0, 1e-4]))
    pm.exponent_histogram(q, pr)
    pm.fedsgd_aggregate_weighted(w, torch.stack([v, v]),
                                 torch.tensor([1.0, 0.0]),
                                 torch.tensor(np.float32(1.0)),
                                 torch.tensor(np.float32(0.1)))
    pm.fedsgd_aggregate(w, torch.stack([v, v]), 0.1)
    pm.client_rank_sort(torch.stack([v, w]), torch.tensor([1.0, 1.0]))
    pm.masked_update_2d(w, v, pr, 0.1)
    # the LM stack's wrappers share the counters
    x = torch.zeros((1, 128, 2, 64))
    tops.flash_attention(x, x, x)
    tops.decode_attention(x[:, :1], x, x, 5)
    tops.ssd_chunked_pallas(x, x[:, :, 0, :16], x[:, :, 0, :16], x[..., 0],
                            torch.zeros(2), chunk=64)
    assert set(pm.LAUNCHES) == {
        "importance_mask_2d", "importance_mask_batched",
        "fedsgd_aggregate_weighted", "exponent_histogram",
        "fedsgd_aggregate", "client_rank_sort", "masked_update_2d",
        "flash_attention", "flash_attention_bwd", "decode_attention",
        "ssd_chunk"}
    assert set(pm.LAUNCHES.values()) == {0}
