"""The aggregate tail on subnormal input: the port against the JAX package.

XLA:CPU (and the TPU) read a subnormal input as a zero of its sign and
flush a result whose exact value is below FLT_MIN to a zero of its sign,
even where it would round up to FLT_MIN; eager torch does neither. The
port states the flush in every op of the tail (``pruning_mask.flush_add``,
``flush_sub``, ``flush_mul``), and these tests hold it bit for bit to the
JAX ``impl="xla"`` mirrors on the same numpy inputs: gradients of scale
1e-39 (subnormal), a few normal rows, values that straddle FLT_MIN (sums and
differences of normals that land below it) and values whose exact product
with the tail's factor rounds up to FLT_MIN.

* the weighted aggregate (kernel 3's plain version) at C in {1, 3, 8}, a
  zero-weight client holding NaN; at C in {2, 5, 10, 16, 32, 33} with
  zero-weight clients holding NaN at the front, in the middle, at the end
  and everywhere (jitted mirror, 0/1 weights), and with non-unit and
  subnormal weights (eager JAX, each op flushed on its own);
* the unweighted aggregate (kernel 5) at C in {2, 4} (1/C a power of two:
  XLA reassociates its step, ROADMAP section 3);
* the masked update (kernel 7) against the eager JAX reference, and against
  the jitted mirror at a power-of-two eta, where its FMA is exact; also
  with masks of values other than 0 and 1 and with NaN and inf in w;
* the weighted sum and the mean-update tail with channel noise, eager JAX
  with non-unit weights (each op flushed on its own) and jitted;
* `RoundEngine._aggregate_update` with corruption factors and poison on a
  stacked [C, R, 128] against the jitted JAX engine's tail;
* a short trainer run with every upload scaled into the subnormal range:
  packed == reference bit for bit, and no subnormal left in w or v.

The kernels are held to these plain versions on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ParamPack as JaxPack  # noqa: E402
from repro.core import RoundEngine as JaxEngine  # noqa: E402
from repro.core import aggregators as jagg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro_torch.core import (ClientData, CorruptUpload,  # noqa: E402
                              FederatedTrainer, ParamPack, RoundEngine)
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
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


LANES = 128
FLT_MIN = np.finfo(np.float32).tiny


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def assert_bitwise(a, b):
    a, b = _bits(a), _bits(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32, copy=True))


def _subnormal(x) -> np.ndarray:
    x = np.abs(np.asarray(x, np.float32))
    return (x > 0) & (x < FLT_MIN)


def round_up_to_flt_min(factor, n: int = LANES) -> np.ndarray:
    """Normal fp32 values x whose exact product with `factor` lies just
    below FLT_MIN and rounds up to FLT_MIN in fp32 (numpy rounds without a
    flush); XLA flushes these products to zero. Tiled to n values."""
    f = np.float32(factor)
    x0 = np.float32(FLT_MIN / np.float64(f))
    xs = np.asarray([np.float32(x0 + k * np.spacing(x0))
                     for k in range(-256, 257)], np.float32)
    exact = xs.astype(np.float64) * np.float64(f)
    keep = (xs >= FLT_MIN) & (exact < FLT_MIN) & (xs * f == FLT_MIN)
    found = xs[keep]
    assert found.size, f"no value rounds up to FLT_MIN at factor {f}"
    return np.resize(found, n)


def tiny_stack(c, rows=64, seed=0, inv=None):
    """[c, rows, 128] gradients of scale 1e-39 (subnormal), with normal
    rows 0-3, rows 4-11 straddling FLT_MIN (their sums and differences
    land below it), and, given the tail's factor inv, row 12 of client 0
    holding values whose product with inv rounds up to FLT_MIN (the other
    clients 0 there, so the sum is those values)."""
    rng = np.random.default_rng(seed)
    g = (1e-39 * rng.normal(size=(c, rows, LANES))).astype(np.float32)
    g[:, :4] = rng.normal(size=(c, 4, LANES))
    g[:, 4:12] = (FLT_MIN * rng.uniform(-3.0, 3.0, size=(c, 8, LANES))
                  ).astype(np.float32)
    if inv is not None:
        g[:, 12] = 0.0
        g[0, 12] = round_up_to_flt_min(inv)
    assert _subnormal(g).mean() > 0.5
    return g


def _w(rows=64, seed=1):
    """Normal weights with a row of subnormal ones and a row at FLT_MIN's
    scale (so w - step lands below it)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(rows, LANES)).astype(np.float32)
    w[5] = (1e-39 * rng.normal(size=LANES)).astype(np.float32)
    w[6] = (FLT_MIN * rng.uniform(-2.0, 2.0, size=LANES)).astype(np.float32)
    return w


# -- the weighted and unweighted aggregates ------------------------------------

@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_weighted_aggregate_flushes_like_jax(n_clients):
    """C = 8 has a padding client holding NaN; inv = 1/3 and 1/7 have
    values whose product with them rounds up to FLT_MIN."""
    cw = np.ones(n_clients, np.float32)
    if n_clients == 8:
        cw[-1] = 0.0                         # a padding client holding NaN
    inv = np.float32(1.0 / cw.sum())
    g = tiny_stack(n_clients, seed=n_clients,
                   inv=inv if n_clients > 1 else None)
    if n_clients == 8:
        g[-1] = np.nan
    w, eta = _w(), np.float32(0.1)
    jout = jops.packed_fedsgd_update_weighted(w, g, cw, inv, eta, impl="xla")
    tout = tops.packed_fedsgd_update_weighted(
        _t(w), _t(g), _t(cw), torch.tensor(inv), torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
        assert not _subnormal(a).any()
    # without the flush torch keeps subnormal sums: the test is not vacuous
    raw = g[cw > 0].sum(0)
    assert _subnormal(raw * inv).any()


@pytest.mark.parametrize("n_clients", [2, 4])
def test_unweighted_aggregate_flushes_like_jax(n_clients):
    eta = 0.15
    g = tiny_stack(n_clients, seed=10 + n_clients)
    # g = sum / C is exact here, and eta * g rounds up to FLT_MIN
    g[0, 13] = n_clients * round_up_to_flt_min(eta)
    g[1:, 13] = 0.0
    w = _w(seed=2)
    jout = jops.packed_fedsgd_update(w, g, eta, impl="xla")
    tout = tops.packed_fedsgd_update(_t(w), _t(g), eta)
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
        assert not _subnormal(a).any()


def test_masked_update_flushes_like_jax():
    """Against the eager JAX reference (each op rounded and flushed on its
    own) at eta 0.02, and against the jitted mirror at eta 0.5: there
    eta*g is exact, so the mirror's FMA gives the same bits (the inputs
    never pair a tiny eta*g with a subnormal w, where the FMA would keep
    the sign of w - eta*g that the flushed product loses)."""
    rng = np.random.default_rng(7)
    w = _w(seed=7)
    w[12] = (1e-39 * rng.normal(size=LANES)).astype(np.float32)
    g = tiny_stack(1, seed=7)[0]
    g[5] = rng.normal(size=LANES)            # subnormal w, normal g
    g[6] = (2.0 * FLT_MIN * rng.uniform(1.0, 2.0, size=LANES)
            ).astype(np.float32)             # w - eta*g below FLT_MIN
    g[14] = round_up_to_flt_min(0.02)        # eta*g rounds up
    m = (rng.random(w.shape) < 0.7).astype(np.float32)
    for eta, jit in ((0.02, False), (0.5, True)):
        want = (jops.packed_masked_update(w, g, m, eta, impl="xla") if jit
                else jref.masked_update_ref(jnp.asarray(w), jnp.asarray(g),
                                            jnp.asarray(m), eta))
        got = tops.packed_masked_update(_t(w), _t(g), _t(m), eta)
        assert_bitwise(got, want)
        assert not _subnormal(got).any()


ZERO_WEIGHT_PATTERNS = ["front", "middle", "end", "everywhere"]
STACK_SIZES = [2, 5, 10, 16, 32, 33]


def zero_weights(n_clients, pattern) -> np.ndarray:
    """0/1 client weights with zero-weight clients at the front (client 0),
    in the middle, at the end, or everywhere."""
    cw = np.ones(n_clients, np.float32)
    at = {"front": [0], "middle": [n_clients // 2], "end": [n_clients - 1],
          "everywhere": list(range(n_clients))}[pattern]
    cw[at] = 0.0
    return cw


def planted_stack(cw, inv, seed):
    """tiny_stack's gradients for weights cw, zero-weight clients holding
    NaN, and row 12 of the first live client holding values whose product
    with inv rounds up to FLT_MIN where there are such values (every other
    client 0 there)."""
    g = tiny_stack(len(cw), seed=seed)
    live = np.flatnonzero(cw > 0)
    try:
        planted = round_up_to_flt_min(inv) if inv else None
    except AssertionError:                    # inv = 2^-k (exact) or 1/9
        planted = None
    if live.size and planted is not None:
        g[:, 12] = 0.0
        g[live[0], 12] = planted
    g[cw <= 0] = np.nan
    return g


@pytest.mark.parametrize("pattern", ZERO_WEIGHT_PATTERNS)
@pytest.mark.parametrize("n_clients", STACK_SIZES)
def test_weighted_aggregate_zero_weight_patterns_like_jax(n_clients, pattern):
    """The plain weighted aggregate against the jitted xla mirror on
    subnormal gradients: the oracle of kernel 3's instantiations (C <= 32)
    and of its any-count path (33). inv is the quarantine's: 1/#live, or 0
    with no live client, where g and the step are zeros and w' is w
    flushed."""
    cw = zero_weights(n_clients, pattern)
    n_live = int(cw.sum())
    inv = np.float32(1.0 / n_live) if n_live else np.float32(0.0)
    g = planted_stack(cw, inv, seed=100 + n_clients)
    w, eta = _w(), np.float32(0.1)
    jout = jops.packed_fedsgd_update_weighted(w, g, cw, inv, eta, impl="xla")
    tout = tops.packed_fedsgd_update_weighted(
        _t(w), _t(g), _t(cw), torch.tensor(inv), torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
        assert not _subnormal(a).any()
    assert np.isfinite(_bits(tout[1]).view(np.float32)).all()
    if pattern == "everywhere":
        assert (_bits(tout[1]) == 0).all() and (_bits(tout[2]) == 0).all()
        assert_bitwise(tout[0], w * (np.abs(w) >= FLT_MIN))


@pytest.mark.parametrize("n_clients", STACK_SIZES)
def test_weighted_aggregate_nonunit_weights_like_jax(n_clients):
    """Non-unit weights (one of 1.0 among them, and a subnormal one, which
    XLA compares as 0: its client is skipped) against eager JAX, where each
    product and sum is flushed on its own; XLA would contract acc + cw*g in
    a jitted graph. Client 0 has weight 0, so both sums start from +0.0
    (eager JAX adds the first term to +0.0, the port starts from client 0's
    term)."""
    rng = np.random.default_rng(200 + n_clients)
    cw = rng.uniform(0.2, 1.9, size=n_clients).astype(np.float32)
    cw[0] = 0.0
    cw[-1] = np.float32(3e-39) if n_clients > 2 else cw[-1]
    cw[n_clients // 2] = 1.0 if n_clients > 4 else cw[n_clients // 2]
    inv = np.float32(1.0 / 7.0)
    g = planted_stack(cw, inv, seed=200 + n_clients)
    w, eta = _w(seed=3), np.float32(0.15)
    gsum = jops.packed_weighted_grad_sum(jnp.asarray(g), jnp.asarray(cw))
    jout = jops.packed_apply_mean_update(jnp.asarray(w), gsum, inv, eta)
    tout = tops.packed_fedsgd_update_weighted(
        _t(w), _t(g), _t(cw), torch.tensor(inv), torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
        assert not _subnormal(a).any()


MASK_KINDS = ["keep", "scaled", "signed_zero_subnormal"]


def general_mask(kind, shape, rng) -> np.ndarray:
    """A 0/1 keep-mask, or masks holding other values: scales (0.5, -1, 3,
    1e30, whose products overflow), -0.0 and subnormals (read as zeros of
    their sign)."""
    m = (rng.random(shape) < 0.6).astype(np.float32)
    if kind == "scaled":
        pool = np.asarray([0.5, -1.0, 3.0, 1e30, 0.0, 1.0], np.float32)
        m = rng.choice(pool, size=shape).astype(np.float32)
    elif kind == "signed_zero_subnormal":
        pool = np.asarray([-0.0, 0.0, 1.0, 3e-39, -1e-39, 1.0000001],
                          np.float32)
        m = rng.choice(pool, size=shape).astype(np.float32)
    return m


@pytest.mark.parametrize("kind", MASK_KINDS)
def test_masked_update_general_masks_like_jax(kind):
    """The plain masked update against the eager JAX reference (eta 0.02)
    and the jitted mirror (eta 0.5, where its FMA is exact) with masks of
    0/1 and of other values, on subnormal input and with NaN and inf in w:
    the oracle of kernel 7."""
    rng = np.random.default_rng(50 + MASK_KINDS.index(kind))
    w = _w(seed=9)
    w[12] = (1e-39 * rng.normal(size=LANES)).astype(np.float32)
    w[20, :6] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
    g = tiny_stack(1, seed=9)[0]
    g[5] = rng.normal(size=LANES)            # subnormal w, normal g
    g[6] = (2.0 * FLT_MIN * rng.uniform(1.0, 2.0, size=LANES)
            ).astype(np.float32)             # w - eta*g below FLT_MIN
    g[14] = round_up_to_flt_min(0.02)        # eta*g rounds up
    m = general_mask(kind, w.shape, rng)
    m[20, :6] = [0.0, 0.0, 0.0, 1.0, 1.0, -0.0]
    for eta, jit in ((0.02, False), (0.5, True)):
        want = (jops.packed_masked_update(w, g, m, eta, impl="xla") if jit
                else jref.masked_update_ref(jnp.asarray(w), jnp.asarray(g),
                                            jnp.asarray(m), eta))
        got = tops.packed_masked_update(_t(w), _t(g), _t(m), eta)
        assert_bitwise(got, want)
        assert not _subnormal(got).any()
        assert np.isnan(_bits(got).view(np.float32)[20, :4]).all()


# -- the noisy tail ------------------------------------------------------------

@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_weighted_sum_and_noisy_tail_flush_like_jax(jit):
    """packed_weighted_grad_sum + packed_apply_mean_update(noise=...): eager
    with non-unit weights (every product and sum flushed on its own), jitted
    with 0/1 weights (XLA contracts acc + cw*g into an FMA, exact for a
    unit weight). Eager JAX starts the sum from +0.0 + term where the jitted
    graph (and the port) start from client 0's term: the eager case gives
    client 0 weight 0, so both start from +0.0."""
    c = 5
    rng = np.random.default_rng(21)
    g = tiny_stack(c, seed=21)
    cw = (np.asarray([1, 1, 0, 1, 1], np.float32) if jit else
          np.asarray([0.0, 1.7, 0.3, 0.55, 1.0], np.float32))
    g[2 if jit else 0] = np.nan
    w = _w(seed=21)
    noise = (1e-39 * rng.normal(size=w.shape)).astype(np.float32)
    noise[:2] = (FLT_MIN * rng.uniform(-2, 2, size=(2, LANES))
                 ).astype(np.float32)
    inv = np.float32(1.0 / 3.0)
    eta = np.float32(0.1)

    def jtail(w, g, cw, noise):
        gsum = jops.packed_weighted_grad_sum(g, cw)
        return (gsum,) + jops.packed_apply_mean_update(w, gsum, inv, eta,
                                                       noise=noise)

    jfn = jax.jit(jtail) if jit else jtail
    jout = jfn(jnp.asarray(w), jnp.asarray(g), jnp.asarray(cw),
               jnp.asarray(noise))
    gsum = tops.packed_weighted_grad_sum(_t(g), _t(cw))
    tout = (gsum,) + tops.packed_apply_mean_update(
        _t(w), gsum, torch.tensor(inv), torch.tensor(eta), noise=_t(noise))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
        assert not _subnormal(a).any()


def test_mean_update_tail_flushes_products_that_round_up():
    """g = gsum * inv and step = eta * g where the exact products lie just
    below FLT_MIN: XLA flushes them, rounding would give FLT_MIN."""
    inv, eta = np.float32(1.0 / 3.0), np.float32(0.15)
    gsum = np.zeros((8, LANES), np.float32)
    gsum[0] = round_up_to_flt_min(inv)
    w = _w(rows=8)
    jout = jops.packed_apply_mean_update(jnp.asarray(w), jnp.asarray(gsum),
                                         inv, eta)
    tout = tops.packed_apply_mean_update(_t(w), _t(gsum), torch.tensor(inv),
                                         torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
    assert (_bits(tout[1][0]) == 0).all()
    g = np.zeros((8, LANES), np.float32)
    g[1] = round_up_to_flt_min(eta)
    jout = jops.packed_apply_mean_update(jnp.asarray(w), jnp.asarray(g),
                                         np.float32(1.0), eta)
    tout = tops.packed_apply_mean_update(_t(w), _t(g), torch.tensor(1.0),
                                         torch.tensor(eta))
    for a, b in zip(tout, jout):
        assert_bitwise(a, b)
    assert (_bits(tout[2][1]) == 0).all()


# -- the round engine's tail ---------------------------------------------------

def _engines(name, kwargs):
    """A JAX and a port engine on the same tiny packed layout (rows 256)."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(16, 3)).astype(np.float32)

    def apply_fn(p, x):
        return x.reshape(x.shape[0], -1) @ p["w"]

    ja = None if name == "mean" else jagg.make_aggregator(name, **kwargs)
    ta = None if name == "mean" else tagg.make_aggregator(name, **kwargs)
    jeng = JaxEngine(jmake_loss_fn(apply_fn), JaxPack.build({"w": w}),
                     eta=0.05, shards=1, aggregator=ja)
    teng = RoundEngine(cnn.make_loss_fn(lambda p, x: x @ p["w"]),
                       ParamPack.build({"w": _t(w)}), eta=0.05,
                       aggregator=ta, device="cpu")
    return jeng, teng


@pytest.mark.parametrize("fault", ["corrupt", "poison"])
@pytest.mark.parametrize("name,kwargs,noisy", [
    ("mean", {}, False), ("mean", {}, True), ("coord_median", {}, False),
    ("trimmed_mean", {"beta": 0.3}, False)],
    ids=["mean", "mean_noise", "coord_median", "trimmed_mean"])
def test_engine_tail_with_faults_flushes_like_jax(name, kwargs, noisy,
                                                  fault):
    """"corrupt": `cf` scales normal gradients into the subnormal range (a
    subnormal factor reads as 0, one factor's products round up to
    FLT_MIN). "poison": poison straddling FLT_MIN is added to gradients
    that straddle it too. The JAX engine contracts g*cf + poison into one
    FMA, which keeps the sign of a tiny g*cf that the port's flushed
    product loses, so each case passes one of the two, as the fault models
    draw them (ROADMAP section 3)."""
    jeng, teng = _engines(name, kwargs)
    rng = np.random.default_rng(31)
    c, shape = 8, (256, LANES)
    grads = rng.normal(size=(c,) + shape).astype(np.float32)
    grads[:, :, 100:] = 0.0                  # padding lanes of the pack
    cw = np.ones(c, np.float32)
    cw[7] = 0.0
    grads[7] = np.nan
    cf = poison = None
    if fault == "corrupt":
        cf = np.ones(c, np.float32)
        cf[1] = np.float32(1e-38)            # products below FLT_MIN
        cf[2] = np.float32(3e-39)            # a subnormal factor: 0
        cf[3] = np.float32(1.0 / 3.0)
        grads[3, 9, :100] = round_up_to_flt_min(cf[3], 100)
        cf[4] = np.float32(4e-38)
        grads[[0, 5, 6], :, 80:100] = 0.0    # only the faulted clients
        grads[3, :, 80:100] = 0.0
        raw = grads * cf[:, None, None]
    else:
        poison = np.zeros((c,) + shape, np.float32)
        grads[[0, 5], :, :100] = FLT_MIN * rng.uniform(
            1, 3, size=(2, 256, 100))
        poison[[0, 5], :, :100] = -FLT_MIN * rng.uniform(
            0, 3, size=(2, 256, 100))
        grads[[1, 2, 3, 4, 6], :, 80:100] = 0.0
        raw = grads + poison
    # the products and sums the flush decides are there
    assert _subnormal(raw).mean() > 0.05
    w = rng.normal(size=shape).astype(np.float32)
    v = (0.1 * rng.normal(size=shape)).astype(np.float32)
    inv = np.float32(1.0 / cw.sum())
    noise = (FLT_MIN * rng.uniform(-2, 2, size=shape)).astype(np.float32) \
        if noisy else None

    jout = jax.jit(jeng._aggregate_update)(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(grads), jnp.asarray(cw),
        inv, *(None if x is None else jnp.asarray(x)
               for x in (noise, cf, poison)))
    tout = teng._aggregate_update(
        _t(w), _t(v), _t(grads), _t(cw), inv,
        **{k: None if x is None else _t(x) for k, x in
           (("noise", noise), ("cf", cf), ("poison", poison))})
    for a, b in zip(tout[:3], jout[:3]):
        assert_bitwise(a, b)
    assert int(tout[3]) == int(jout[3]) == 7
    assert int(tout[4]) == int(jout[4])


# -- a faulted run -------------------------------------------------------------

def test_deep_fade_run_packed_equals_reference_without_subnormals():
    """Every upload scaled by 1e-36 (CorruptUpload in "scale" mode, a
    deep fade that reaches the aggregate): most uploaded coordinates are
    subnormal. Packed == reference bit for bit, and neither leaves a
    subnormal in w or v, as XLA would not."""
    n, rounds, scale = 4, 3, 1e-36
    rng = np.random.default_rng(41)
    clients = [ClientData(rng.normal(size=(24, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, 24).astype(np.int32))
               for _ in range(n)]
    a = np.ones((rounds, n))
    sched = Schedule(a=a, lam=np.full((rounds, n), 0.3), power=0.3 * a,
                     freq=3e8 * a, theta=0.0, energy=0.0, delay=0.0,
                     feasible=True)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(41),
                               device="cpu")
    loss_fn = cnn.make_loss_fn(cnn.mlp_edge_apply)
    # the uploads are subnormal: the run is not vacuous
    x = torch.as_tensor(clients[0].x[:8])
    y = torch.as_tensor(clients[0].y[:8])
    p = {k: t.clone().requires_grad_(True) for k, t in params.items()}
    grads = torch.autograd.grad(loss_fn(p, x, y), list(p.values()))
    up = torch.cat([(g.reshape(-1) * torch.tensor(np.float32(scale)))
                    for g in grads])
    assert _subnormal(up).mean() > 0.3
    ch = ChannelModel(n)
    out = {}
    for backend in ("reference", "packed"):
        tr = FederatedTrainer(
            loss_fn, params, clients, eta=0.1, batch_size=8, seed=0,
            backend=backend, device="cpu",
            fault_model=CorruptUpload(rate=1.0, mode="scale", scale=scale,
                                      seed=3))
        out[backend] = (tr, tr.run(sched, SystemParams.table1(n), ch.uplink,
                                   ch.downlink))
    (tr_ref, h_ref), (tr_pk, h_pk) = out["reference"], out["packed"]
    assert [m.train_loss for m in h_ref] == [m.train_loss for m in h_pk]
    assert tr_ref.fault_counters == tr_pk.fault_counters
    assert tr_pk.fault_counters["n_corrupt_finite"] == rounds * n
    for k, t in tr_ref.params.items():
        assert_bitwise(tr_pk.params[k], t)
        assert torch.equal(tr_pk.global_grad[k], tr_ref.global_grad[k])
        for x in (tr_pk.params[k], tr_pk.global_grad[k],
                  tr_ref.params[k], tr_ref.global_grad[k]):
            assert not _subnormal(x).any(), k
