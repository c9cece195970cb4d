"""The port's packed layout and models against the JAX package's.

Both packages start from the same weights: the JAX package initialises the
model and `repro_torch.convert.params_from_numpy` carries its numpy export
into the port. Packing is a layout transform and must agree bit for bit;
the models run fp32 GEMMs whose reduction order differs between XLA and
PyTorch, so logits, loss and gradients agree to rtol 1e-5 / atol 1e-6.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ParamPack as JaxPack  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import packing, pruning  # noqa: E402
from repro_torch.models import cnn  # noqa: E402

MODELS = {
    "lenet": (jcnn.lenet_init, jcnn.lenet_apply, cnn.lenet_apply),
    "mlp-edge": (jcnn.mlp_edge_init, jcnn.mlp_edge_apply, cnn.mlp_edge_apply),
}


def _params(name, seed=0):
    jp = MODELS[name][0](jax.random.key(seed))
    return jp, convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jp.items()})


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().numpy()
    return np.asarray(x).view(np.int32)


@pytest.mark.parametrize("name", list(MODELS))
def test_pack_matches_jax_layout(name):
    jp, tp = _params(name)
    jpack, tpack = JaxPack.build(jp), packing.ParamPack.build(tp)
    assert tpack.paths == jpack.paths
    assert tpack.shapes == jpack.shapes
    assert (tpack.offsets, tpack.sizes) == (jpack.offsets, jpack.sizes)
    assert (tpack.rows, tpack.n_total, tpack.n_prunable) == (
        jpack.rows, jpack.n_total, jpack.n_prunable)
    assert tpack.prunable_leaf == jpack.prunable_leaf
    np.testing.assert_array_equal(tpack.prunable_mask(), jpack.prunable_mask())
    np.testing.assert_array_equal(tpack.valid_mask(), jpack.valid_mask())
    np.testing.assert_array_equal(_bits(tpack.pack(tp)),
                                  _bits(jpack.pack(jp)))


def test_lenet_layout_is_the_slice_layout():
    _, tp = _params("lenet")
    pack = packing.ParamPack.build(tp)
    assert pack.paths == ("['b1']", "['b2']", "['b3']", "['conv1']",
                          "['conv2']", "['fc1']", "['fc2']", "['fc3']")
    assert (pack.rows, pack.n_total) == (1024, 107_764)
    # LeNet's biases are named b1..b3, not "bias": every coordinate prunes
    assert pack.n_prunable == pack.n_total


@pytest.mark.parametrize("name", list(MODELS))
def test_unpack_round_trips_with_fresh_storage(name):
    _, tp = _params(name)
    pack = packing.ParamPack.build(tp)
    buf = pack.pack(tp)
    out = pack.unpack(buf)
    assert list(out) == list(pack.keys)
    base = buf.untyped_storage().data_ptr()
    for k, t in out.items():
        assert t.dtype == tp[k].dtype and t.shape == tp[k].shape
        assert t.is_contiguous()
        assert t.untyped_storage().data_ptr() != base   # not a view
        np.testing.assert_array_equal(_bits(t), _bits(tp[k]))
    with pytest.raises(ValueError):
        pack.pack({k: v for k, v in tp.items() if k != pack.keys[0]})


def test_unpack_is_differentiable():
    tp = {"a": torch.arange(4.0), "b": torch.ones(2, 2)}
    pack = packing.ParamPack.build(tp)
    wp = pack.pack(tp).requires_grad_(True)
    p = pack.unpack(wp)
    loss = (p["a"] ** 2).sum() + (p["b"] ** 2).sum()
    (g,) = torch.autograd.grad(loss, wp)
    got = pack.unpack(g)
    np.testing.assert_array_equal(got["a"].numpy(), 2 * np.arange(4.0))
    np.testing.assert_array_equal(got["b"].numpy(), 2 * np.ones((2, 2)))


def test_prune_spec_paths_decide_like_jax():
    from repro.core import pruning as jpruning
    for path in ("['fc1']", "['bias']", "['norm_scale']", "['embed_table']",
                 "['w_attn']", "['dt_bias']", "['conv2']"):
        assert pruning.default_prunable(path) == jpruning.default_prunable(path)
    assert pruning.keystr("fc1") == "['fc1']"
    assert pruning.PROTECTED_SUBSTRINGS == jpruning.PROTECTED_SUBSTRINGS


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.7])
def test_host_threshold_and_masks_match_jax(lam):
    from repro.core import pruning as jpruning
    rng = np.random.default_rng(3)
    imp = {"w1": (rng.random((33, 7)) * 10).astype(np.float32),
           "norm_scale": rng.random(16).astype(np.float32),
           "w2": rng.random(257).astype(np.float32)}
    want = jpruning.global_threshold({k: jnp.asarray(v)
                                      for k, v in imp.items()}, lam)
    got = pruning.global_threshold(convert.params_from_numpy(imp), lam)
    assert np.float32(got) == np.float32(want)
    jm = jpruning.build_masks({k: jnp.asarray(v) for k, v in imp.items()},
                              lam)
    tm = pruning.build_masks(convert.params_from_numpy(imp), lam)
    for k in imp:
        np.testing.assert_array_equal(tm[k].numpy(), np.asarray(jm[k]))


# -- models ----------------------------------------------------------------------

def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, size=n).astype(np.int32)
    return x, y


@pytest.mark.parametrize("name", list(MODELS))
def test_logits_loss_and_packed_grad_match_jax(name):
    _, japply, tapply = MODELS[name]
    jp, tp = _params(name, seed=1)
    x, y = _batch(1)
    np.testing.assert_allclose(
        tapply(tp, torch.from_numpy(x)).numpy(),
        np.asarray(japply(jp, jnp.asarray(x))), rtol=1e-5, atol=1e-6)

    jpack, tpack = JaxPack.build(jp), packing.ParamPack.build(tp)
    jloss = jcnn.make_loss_fn(japply)
    tloss = cnn.make_loss_fn(tapply)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda wp: jloss(jpack.unpack(wp), jnp.asarray(x), jnp.asarray(y))))(
            jpack.pack(jp))
    wp = tpack.pack(tp).requires_grad_(True)
    tl = tloss(tpack.unpack(wp), torch.from_numpy(x), torch.from_numpy(y))
    (tg,) = torch.autograd.grad(tl, wp)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", list(MODELS))
def test_weighted_loss_with_unit_weights_is_the_plain_loss_bitwise(name):
    """The engine threads sample weights through every round; with sw = 1
    the weighted loss must be the plain mean bit for bit, value and
    gradient."""
    _, _, tapply = MODELS[name]
    _, tp = _params(name, seed=2)
    x, y = (torch.from_numpy(a) for a in _batch(2))
    loss = cnn.make_loss_fn(tapply)

    def vg(fn, *extra):
        leaves = {k: t.clone().requires_grad_(True) for k, t in tp.items()}
        val = fn(leaves, x, y, *extra)
        return val, torch.autograd.grad(val, list(leaves.values()))

    l0, g0 = vg(loss)
    l1, g1 = vg(loss.weighted, torch.ones(len(y)))
    assert _bits(l0) == _bits(l1)
    for a, b in zip(g0, g1):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_weighted_loss_drops_zero_weight_samples():
    _, tp = _params("mlp-edge", seed=3)
    x, y = (torch.from_numpy(a) for a in _batch(3, n=8))
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    sw = torch.tensor([1.0] * 5 + [0.0] * 3)
    np.testing.assert_allclose(float(loss.weighted(tp, x, y, sw)),
                               float(loss(tp, x[:5], y[:5])), rtol=1e-6)


def test_eval_fn_matches_jax():
    jp, tp = _params("lenet", seed=4)
    x, y = _batch(4, n=120)
    jev = jcnn.make_eval_fn(jcnn.lenet_apply, x, y, batch=50)(jp)
    tev = cnn.make_eval_fn(cnn.lenet_apply, x, y, batch=50,
                          device="cpu")(tp)
    np.testing.assert_allclose(tev[0], jev[0], rtol=1e-5)
    assert tev[1] == jev[1]


def test_seeded_init_is_deterministic_with_jax_distributions():
    a = cnn.lenet_init(torch.Generator().manual_seed(0), device="cpu")
    b = cnn.lenet_init(torch.Generator().manual_seed(0), device="cpu")
    jp = jcnn.lenet_init(jax.random.key(0))
    assert list(a) == list(jp)
    for k in a:
        assert a[k].shape == tuple(jp[k].shape) and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    # dense_init: normal * 1/sqrt(fan_in)
    assert abs(float(a["fc1"].std()) * np.sqrt(784) - 1.0) < 0.02
    m = cnn.mlp_edge_init(torch.Generator().manual_seed(0), device="cpu")
    assert {k: tuple(v.shape) for k, v in m.items()} == {
        k: tuple(v.shape) for k, v in jcnn.mlp_edge_init(
            jax.random.key(0)).items()}
