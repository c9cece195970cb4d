"""The port's robust reducers and round tail against the JAX package's.

* Reducers (`ops.packed_robust_aggregate` through the registry's
  aggregators) on the JAX test suite's `garbage_stack` inputs — NaN, inf
  and huge values on zero-weight lanes, ragged valid counts: the
  coordinate-wise median and the trimmed mean bit for bit against the XLA
  mirror and the interpret-mode Pallas rank sort; norm clipping and
  multi-Krum to rtol 1e-6 with an absolute floor of 1e-6 times the largest
  valid input (their norms and Gram matrix reduce in torch's order, not
  XLA's, and a mean of clipped values can cancel), their counts exactly.
* The reducers' flush of subnormal values, which XLA:CPU applies and torch
  does not: held bit for bit on subnormal-range gradients.
* Inside the port: bucket-capacity and lane-permutation invariance, bit for
  bit, and the degenerate counts n = 0, 1, 2.
* The round tail (`RoundEngine._aggregate_update`): from the same stacked
  gradients, corruption factors, poison, zero weights and channel noise,
  the port's w', v', survivor count and reducer count against the jitted
  JAX tail, for the mean and all four reducers.
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
from repro.models import make_loss_fn as jmake_loss_fn  # noqa: E402
from repro_torch.core import ParamPack, RoundEngine  # noqa: E402
from repro_torch.core import aggregators as tagg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
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


AGG_CASES = [
    ("coord_median", {}),
    ("trimmed_mean", {"beta": 0.3}),
    ("norm_clip", {}),
    ("norm_clip", {"tau": 0.05}),
    ("multi_krum", {"f": 1}),
]
AGG_IDS = ["coord_median", "trimmed_mean", "norm_clip_adaptive",
           "norm_clip_fixed", "multi_krum"]
BITWISE = ("coord_median", "trimmed_mean")
FLT_MIN = np.finfo(np.float32).tiny


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).view(np.int32)


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def garbage_stack(c=8, r=4, n_valid=5, seed=0, scale=1.0):
    """[c, r, 128] stack whose invalid rows hold garbage (NaN / inf / huge)
    that must not influence any output bit; the JAX suite's inputs."""
    rng = np.random.default_rng(seed)
    g = (scale * rng.normal(size=(c, r, 128))).astype(np.float32)
    cw = np.zeros(c, np.float32)
    cw[:n_valid] = 1.0
    if n_valid < c:
        g[n_valid] = np.nan
    if n_valid + 1 < c:
        g[n_valid + 1] = np.inf
    if n_valid + 2 < c:
        g[n_valid + 2] = 1e30
    return g, cw


def _assert_close(got, want, g, cw):
    """rtol 1e-6, with an absolute floor of 1e-6 x the largest valid input:
    the last-bit differences of a norm scale whole summands, and a mean of
    summands can cancel far below their size."""
    valid = np.asarray(g)[np.asarray(cw) > 0]
    scale = float(np.abs(valid).max()) if valid.size else 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def _reduce_both(name, kwargs, g, cw, impl="xla"):
    ghat_j, st_j = jagg.make_aggregator(name, impl=impl, **kwargs).reduce(
        jnp.asarray(g), jnp.asarray(cw))
    ghat_t, st_t = tagg.make_aggregator(name, **kwargs).reduce(_t(g), _t(cw))
    assert ghat_t.dtype == torch.float32 and st_t.dtype == torch.int32
    assert ghat_t.shape == tuple(ghat_j.shape)
    return (np.asarray(ghat_j), int(st_j)), (ghat_t.numpy(), int(st_t))


# -- registry -------------------------------------------------------------------

def test_registry_and_validation_match_jax():
    assert tagg.make_aggregator("mean") is None
    assert tagg.aggregator_names() == jagg.aggregator_names()
    with pytest.raises(TypeError, match="mean takes no kwargs"):
        tagg.make_aggregator("mean", beta=0.1)
    with pytest.raises(KeyError, match="registered"):
        tagg.make_aggregator("wat")
    with pytest.raises(ValueError, match="beta"):
        tagg.make_aggregator("trimmed_mean", beta=0.5)
    with pytest.raises(ValueError, match="f must be"):
        tagg.make_aggregator("multi_krum", f=-1)
    with pytest.raises(ValueError, match="m must be"):
        tagg.make_aggregator("multi_krum", m=0)
    with pytest.raises(KeyError, match="already registered"):
        tagg.register_aggregator("mean", lambda **kw: None)
    for name, kwargs in AGG_CASES:
        t = tagg.make_aggregator(name, **kwargs)
        j = jagg.make_aggregator(name, **kwargs)
        assert t.stat_field == j.stat_field
        assert t.spec_key == j.spec_key            # same identity key
    with pytest.raises(ValueError, match="unknown impl"):
        g, cw = garbage_stack()
        tagg.CoordMedian(impl="xla").reduce(_t(g), _t(cw))


# -- reducers against JAX ---------------------------------------------------------

@pytest.mark.parametrize("name,kwargs", AGG_CASES, ids=AGG_IDS)
@pytest.mark.parametrize("c,n_valid,seed", [(8, 5, 0), (8, 6, 1), (10, 10, 2),
                                            (4, 3, 3), (16, 11, 4)])
def test_reducer_matches_jax(name, kwargs, c, n_valid, seed):
    g, cw = garbage_stack(c=c, n_valid=n_valid, seed=seed)
    (gj, sj), (gt, st) = _reduce_both(name, kwargs, g, cw)
    assert st == sj
    assert np.isfinite(gt).all()
    if name in BITWISE:
        np.testing.assert_array_equal(_bits(gt), _bits(gj))
    else:
        _assert_close(gt, gj, g, cw)


@pytest.mark.parametrize("name,kwargs", AGG_CASES[:2], ids=AGG_IDS[:2])
def test_sorted_reducers_match_pallas_rank_sort(name, kwargs):
    """The interpret-mode Pallas sort network feeds the same ranks."""
    g, cw = garbage_stack(c=8, n_valid=5, seed=9)
    (gj, sj), (gt, st) = _reduce_both(name, kwargs, g, cw, impl="pallas")
    np.testing.assert_array_equal(_bits(gt), _bits(gj))
    assert st == sj


@pytest.mark.parametrize("name,kwargs", AGG_CASES[:2], ids=AGG_IDS[:2])
def test_reducers_flush_subnormals_like_jax(name, kwargs):
    """XLA:CPU treats subnormal inputs as zero and flushes a subnormal
    result (sign kept), also where the exact result rounds up to FLT_MIN;
    the port's median and trimmed mean state the same flush. Values here
    straddle FLT_MIN, so the flush decides many output bits."""
    g, cw = garbage_stack(c=8, n_valid=7, seed=5, scale=2.0 * FLT_MIN)
    g.reshape(-1)[::17] = np.float32(FLT_MIN)
    g.reshape(-1)[5::23] = np.uint32(0x00FFFFFF).view(np.float32)
    (gj, sj), (gt, st) = _reduce_both(name, kwargs, g, cw)
    np.testing.assert_array_equal(_bits(gt), _bits(gj))
    assert st == sj
    assert not ((np.abs(gt) > 0) & (np.abs(gt) < FLT_MIN)).any()
    # without the flush torch keeps subnormals: the test is not vacuous
    sv = tops.packed_client_rank_sort(_t(g), _t(cw)).numpy()
    raw = sv[2] + sv[3]
    assert ((np.abs(raw) > 0) & (np.abs(raw) < FLT_MIN)).any()


@pytest.mark.parametrize("name,kwargs", AGG_CASES, ids=AGG_IDS)
def test_reducers_take_a_subnormal_weight_as_dead_like_jax(name, kwargs):
    """XLA:CPU compares the flushed weight, so a client of weight 3e-39 is
    excluded as if its weight were 0: from the ranks (the rank sort's key),
    the valid count, the norms' median and the Krum scores. The port flushes
    the weight before every `> 0` test: its result equals JAX's (bit for
    bit for the sorted reducers) and its own result at weight 0, bit for
    bit. The client holds large finite values, so counting it would move
    every output."""
    g, cw = garbage_stack(c=8, n_valid=6, seed=12)
    g[2] = 50.0
    cw[2] = np.float32(3e-39)
    (gj, sj), (gt, st) = _reduce_both(name, kwargs, g, cw)
    assert st == sj
    if name in BITWISE:
        np.testing.assert_array_equal(_bits(gt), _bits(gj))
    else:
        _assert_close(gt, gj, np.delete(g, 2, 0), np.delete(cw, 2))
    dead = cw.copy()
    dead[2] = 0.0
    g0, s0 = tagg.make_aggregator(name, **kwargs).reduce(_t(g), _t(dead))
    np.testing.assert_array_equal(_bits(gt), _bits(g0))
    assert st == int(s0)
    sv = tops.packed_client_rank_sort(_t(g), _t(cw)).numpy()
    np.testing.assert_array_equal(
        _bits(sv), _bits(tops.packed_client_rank_sort(_t(g), _t(dead))))


def test_reducer_stat_counts_match_jax():
    g, cw = garbage_stack(n_valid=6)
    for name, kwargs, want in (("trimmed_mean", {"beta": 0.34}, 4),
                               ("coord_median", {}, 4),
                               ("multi_krum", {"f": 2}, 2),
                               ("norm_clip", {"tau": 1e9}, 0),
                               ("norm_clip", {"tau": 1e-9}, 6)):
        (_, sj), (_, st) = _reduce_both(name, kwargs, g, cw)
        assert st == sj == want, name


# -- invariances inside the port ----------------------------------------------------

@pytest.mark.parametrize("name,kwargs", AGG_CASES, ids=AGG_IDS)
def test_reducer_bucket_capacity_invariance_bitwise(name, kwargs):
    """Zero-weight lanes (garbage included) change no output bit: the
    compact stack of the valid rows, the garbage-padded bucket and any
    permutation of the lanes agree exactly."""
    g, cw = garbage_stack()
    agg = tagg.make_aggregator(name, **kwargs)
    gb, sb = agg.reduce(_t(g), _t(cw))
    nv = int(cw.sum())
    gc, sc = agg.reduce(_t(g[:nv]), torch.ones(nv))
    np.testing.assert_array_equal(_bits(gb), _bits(gc))
    assert int(sb) == int(sc)
    perm = np.array([5, 0, 6, 1, 7, 2, 3, 4])
    gp, sp_ = agg.reduce(_t(g[perm]), _t(cw[perm]))
    np.testing.assert_array_equal(_bits(gb), _bits(gp))
    assert int(sb) == int(sp_)
    # zero padding (the reference backend's) is the same as garbage
    gz = np.zeros((16,) + g.shape[1:], np.float32)
    gz[:nv] = g[:nv]
    cz = np.zeros(16, np.float32)
    cz[:nv] = 1.0
    gzr, szr = agg.reduce(_t(gz), _t(cz))
    np.testing.assert_array_equal(_bits(gb), _bits(gzr))
    assert int(sb) == int(szr)


@pytest.mark.parametrize("name,kwargs", AGG_CASES, ids=AGG_IDS)
@pytest.mark.parametrize("n_valid", [0, 1, 2])
def test_reducer_degenerate_counts(name, kwargs, n_valid):
    """n = 0, 1, 2 agree with JAX; with a valid lane no sentinel lane is
    read, and with none (the caller then skips the update) rank 0 of
    garbage may be, in both packages alike."""
    g, cw = garbage_stack(n_valid=n_valid, seed=n_valid)
    (gj, sj), (gt, st) = _reduce_both(name, kwargs, g, cw)
    assert np.isfinite(gt).all() or n_valid == 0
    assert st == sj
    if n_valid == 0:
        # a finite stack with no valid lane stays finite (no 0/0)
        g[:] = garbage_stack(n_valid=1, seed=7)[0][0]
        gz, _ = tagg.make_aggregator(name, **kwargs).reduce(_t(g), _t(cw))
        assert bool(torch.isfinite(gz).all())
    if name in BITWISE:
        np.testing.assert_array_equal(_bits(gt), _bits(gj))
    else:
        _assert_close(gt, gj, g, cw)
    if n_valid == 1 and kwargs.get("tau") is None:
        np.testing.assert_array_equal(_bits(gt), _bits(g[0]))


# -- the round tail ------------------------------------------------------------------

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


TAIL_CASES = [("mean", {})] + AGG_CASES
TAIL_IDS = ["mean"] + AGG_IDS


@pytest.mark.parametrize("noisy", [False, True], ids=["clean", "noise"])
@pytest.mark.parametrize("name,kwargs", TAIL_CASES, ids=TAIL_IDS)
def test_round_tail_matches_jax(name, kwargs, noisy):
    jeng, teng = _engines(name, kwargs)
    rng = np.random.default_rng(3)
    c, shape = 10, (256, 128)
    w = rng.normal(size=shape).astype(np.float32)
    v = (0.1 * rng.normal(size=shape)).astype(np.float32)
    grads = rng.normal(size=(c,) + shape).astype(np.float32)
    grads[:, :, 100:] = 0.0                  # padding lanes of the pack
    grads[3, 7, 5] = -0.0
    cw = np.ones(c, np.float32)
    cw[[2, 9]] = 0.0                         # a dropped and a padding client
    grads[9] = np.nan                        # padding garbage
    cf = np.ones(c, np.float32)
    cf[1] = np.float32(np.nan)               # quarantined
    cf[4] = 10.0                             # scaled malicious
    cf[6] = -2.0                             # sign flip
    poison = np.zeros((c,) + shape, np.float32)
    poison[[0, 5]] = (0.5 * rng.normal(size=(2,) + shape)).astype(np.float32)
    poison[:, :, 100:] = 0.0
    inv = np.float32(1.0 / cw.sum())
    noise = ((1e-3 * rng.normal(size=shape)).astype(np.float32)
             if noisy else None)
    jout = jax.jit(jeng._aggregate_update)(
        jnp.asarray(w), jnp.asarray(v), jnp.asarray(grads), jnp.asarray(cw),
        inv, None if noise is None else jnp.asarray(noise),
        jnp.asarray(cf), jnp.asarray(poison))
    jw, jg, jstep, jn, jast = (np.asarray(a) for a in jout[:5])
    tw, tg, tstep, tn, tast, _ = teng._aggregate_update(
        _t(w), _t(v), _t(grads), _t(cw), inv,
        noise=None if noise is None else _t(noise), cf=_t(cf),
        poison=_t(poison))
    assert int(tn) == int(jn) == 7
    assert int(tast) == int(jast)
    if name in ("mean",) + BITWISE:
        for a, b in ((tw, jw), (tg, jg), (tstep, jstep)):
            np.testing.assert_array_equal(_bits(a), _bits(b))
    else:
        _assert_close(tg.numpy(), jg, grads, cw)
        np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6, atol=1e-7)
    assert np.isfinite(tw.numpy()).all()


@pytest.mark.parametrize("name,kwargs", TAIL_CASES, ids=TAIL_IDS)
def test_round_tail_with_no_survivor_keeps_the_model(name, kwargs):
    _, teng = _engines(name, kwargs)
    rng = np.random.default_rng(4)
    w = _t(rng.normal(size=(256, 128)).astype(np.float32))
    v = _t(rng.normal(size=(256, 128)).astype(np.float32))
    grads = _t(rng.normal(size=(4, 256, 128)).astype(np.float32))
    cf = torch.tensor([np.nan, np.nan, 1.0, 1.0])
    cw = torch.tensor([1.0, 1.0, 0.0, 0.0])
    w2, g2, _, n_ok, _, _ = teng._aggregate_update(w, v, grads, cw,
                                                   np.float32(0.5), cf=cf)
    assert int(n_ok) == 0
    assert torch.equal(w2, w) and torch.equal(g2, v)
