"""The port's ResNet-CIFAR and parameter trees against the JAX package, on
the CPU.

* `resnet_apply` and its gradients from JAX's init equal JAX's (depth 8,
  widths 4 and 8; atol 1e-5, rtol 1e-4: XLA and oneDNN reduce the
  convolutions in other orders).
* A 3x3 stride-2 SAME convolution pads 0 rows and columns before and 1
  after, as XLA does; `padding=1` (symmetric) gives other windows.
* `ParamPack` of the full ResNet-20 (272,250 coordinates, [2304, 128])
  equals JAX's: paths, offsets, prunable mask and packed buffer bit for
  bit; `unpack` rebuilds the nested tree with fresh storage.
* The nested tree's paths decide pruning leaf for leaf as JAX's, and host
  masks of a nested importance tree equal JAX's.
* Nested trees go through `params_from_numpy` and checkpoints written by
  either package load in the other.
* The packed backend equals the reference backend bit for bit on a
  depth-8 ResNet, and its FedSGD trajectory follows JAX's from the same
  weights (atol 1e-4).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import load_checkpoint as jload  # noqa: E402
from repro.checkpoint import save_checkpoint as jsave  # noqa: E402
from repro.core import FederatedTrainer as JTrainer  # noqa: E402
from repro.core import packing as jpacking  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.models import cnn as jcnn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import load_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.core import ClientData, FederatedTrainer  # noqa: E402
from repro_torch.core import packing, pruning  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.data import make_dataset  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402
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


def _bits(t):
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor)
                      else t, np.float32).view(np.int32)


def _jax_resnet(seed=0, **kw):
    jp = jcnn.resnet_init(jax.random.PRNGKey(seed), **kw)
    return jp, convert.params_from_numpy(jax.tree.map(np.asarray, jp))


def _batch(seed, n=6):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


# -- the model -------------------------------------------------------------------

@pytest.mark.parametrize("width", [4, 8])
def test_resnet_forward_and_gradients_match_jax(width):
    jp, tp = _jax_resnet(1, depth=8, width=width)
    x, y = _batch(width)
    want = np.asarray(jcnn.resnet_apply(jp, jnp.asarray(x)))
    got = cnn.resnet_apply(tp, torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    jv, jg = jax.value_and_grad(jcnn.make_loss_fn(jcnn.resnet_apply))(
        jp, jnp.asarray(x), jnp.asarray(y))
    ps = [t.requires_grad_(True) for t in leaves(tp)]
    tv = cnn.make_loss_fn(cnn.resnet_apply)(tp, torch.as_tensor(x),
                                            torch.as_tensor(y))
    tg = torch.autograd.grad(tv, ps)
    np.testing.assert_allclose(float(tv.detach()), float(jv), atol=1e-5,
                               rtol=1e-4)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(jflat) == len(tg)
    for (kp, a), (path, _), b in zip(jflat, flatten_with_path(tp), tg):
        assert jax.tree_util.keystr(kp) == path
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-5,
                                   rtol=1e-4, err_msg=path)


def test_stride2_same_padding_is_asymmetric_like_xla():
    """XLA pads a 3x3 stride-2 SAME convolution of a 32-wide input by 0
    before and 1 after; the port's `_conv` matches lax (atol 1e-5), while
    the symmetric padding=1 reads other windows and misses by far more."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 32, 32, 5)).astype(np.float32)
    w = rng.normal(size=(3, 3, 5, 7)).astype(np.float32)
    want = np.asarray(jcnn._conv(jnp.asarray(x), jnp.asarray(w), stride=2))
    xt = torch.as_tensor(x).permute(0, 3, 1, 2).contiguous()
    got = cnn._conv(xt, torch.as_tensor(w), 2).permute(0, 2, 3, 1).numpy()
    assert cnn._same_pads(32, 3, 2) == (0, 1)
    assert cnn._same_pads(32, 3, 1) == (1, 1)
    assert cnn._same_pads(32, 1, 2) == (0, 0)
    assert got.shape == want.shape == (2, 16, 16, 7)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)
    sym = torch.nn.functional.conv2d(
        xt, torch.as_tensor(w).permute(3, 2, 0, 1), stride=2,
        padding=1).permute(0, 2, 3, 1).numpy()
    assert sym.shape == want.shape
    assert np.abs(sym - want).max() > 1e-1
    # the 1x1 stride-2 projection pads nothing
    w1 = rng.normal(size=(1, 1, 5, 7)).astype(np.float32)
    np.testing.assert_allclose(
        cnn._conv(xt, torch.as_tensor(w1), 2).permute(0, 2, 3, 1).numpy(),
        np.asarray(jcnn._conv(jnp.asarray(x), jnp.asarray(w1), stride=2)),
        atol=1e-5, rtol=1e-4)


def test_resnet_init_has_jaxs_tree():
    jp = jcnn.resnet_init(jax.random.PRNGKey(0))
    tp = cnn.resnet_init(torch.Generator().manual_seed(0), device="cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = flatten_with_path(tp)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [p for p, _ in tflat]
    for (_, a), (p, b) in zip(jflat, tflat):
        assert tuple(a.shape) == tuple(b.shape), p
    # scale and shift start at one and zero, as JAX's
    assert torch.equal(tp["blocks"][4]["scale2"], torch.ones(32))
    assert torch.equal(tp["blocks"][4]["bias1"], torch.zeros(32))
    assert "proj" in tp["blocks"][3] and "proj" not in tp["blocks"][4]


# -- parameter trees and the packed layout -----------------------------------------

def test_resnet20_param_pack_matches_jax_bit_for_bit():
    jp, tp = _jax_resnet(0)
    jpack = jpacking.ParamPack.build(jp)
    tpack = packing.ParamPack.build(tp)
    assert tpack.paths == jpack.paths
    assert tpack.offsets == jpack.offsets and tpack.sizes == jpack.sizes
    assert tpack.shapes == jpack.shapes
    assert (tpack.n_total, tpack.rows) == (272_250, 2304)
    assert (tpack.n_total, tpack.rows, tpack.n_prunable) == \
        (jpack.n_total, jpack.rows, jpack.n_prunable)
    assert tpack.prunable_leaf == jpack.prunable_leaf
    assert "['blocks'][0]['scale1']" in tpack.paths
    np.testing.assert_array_equal(tpack.prunable_mask(),
                                  np.asarray(jpack.prunable_mask()))
    np.testing.assert_array_equal(_bits(tpack.pack(tp)),
                                  _bits(jpack.pack(jp)))


def test_unpack_rebuilds_the_nested_tree_with_fresh_storage():
    _, tp = _jax_resnet(3, depth=8, width=4)
    pack = packing.ParamPack.build(tp)
    buf = pack.pack(tp)
    out = pack.unpack(buf)
    assert list(out) == list(pack.keys) == ["blocks", "head", "head_b",
                                            "stem"]
    assert isinstance(out["blocks"], list) and len(out["blocks"]) == 3
    assert sorted(out["blocks"][1]) == sorted(tp["blocks"][1])
    base = buf.untyped_storage().data_ptr()
    for (p, a), (q, b) in zip(flatten_with_path(out),
                              flatten_with_path(tp)):
        assert p == q and a.is_contiguous()
        assert a.untyped_storage().data_ptr() != base
        np.testing.assert_array_equal(_bits(a), _bits(b))
    with pytest.raises(ValueError, match="paths"):
        pack.pack({**tp, "blocks": tp["blocks"][:2]})


@pytest.mark.parametrize("lam", [0.0, 0.4, 0.8])
def test_nested_host_masks_match_jax(lam):
    rng = np.random.default_rng(4)
    imp = {"blocks": [{"conv1": rng.random((3, 3, 2, 4)).astype(np.float32),
                       "scale1": rng.random(4).astype(np.float32)},
                      {"conv1": rng.random((3, 3, 4, 4)).astype(np.float32),
                       "bias1": rng.random(4).astype(np.float32)}],
           "head": rng.random((4, 3)).astype(np.float32)}
    jimp = jax.tree.map(jnp.asarray, imp)
    timp = convert.params_from_numpy(imp)
    assert np.float32(pruning.global_threshold(timp, lam)) == \
        np.float32(jpruning.global_threshold(jimp, lam))
    jm = jax.tree_util.tree_leaves(jpruning.build_masks(jimp, lam))
    tm = leaves(pruning.build_masks(timp, lam))
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # protected leaves by path, as JAX decides them
    assert [pruning.default_prunable(p) for p, _ in
            flatten_with_path(timp)] == [True, False, False, True, True]


def test_nested_checkpoints_load_in_either_package(tmp_path):
    jp, tp = _jax_resnet(5, depth=8, width=4)
    tree = {"params": tp, "v": tp}
    save_checkpoint(str(tmp_path / "port"), tree, step=3)
    got, meta = jload(str(tmp_path / "port"), {"params": jp, "v": jp})
    assert meta["step"] == 3
    for a, b in zip(jax.tree_util.tree_leaves(got), leaves(tree)):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(b))
    jsave(str(tmp_path / "jax"), {"params": jp}, step=4)
    back, _ = load_checkpoint(str(tmp_path / "jax"), {"params": tp})
    assert isinstance(back["params"]["blocks"], list)
    for a, b in zip(leaves(back), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(_bits(a), _bits(np.asarray(b)))


# -- training --------------------------------------------------------------------

def _cifar_clients(n_clients=3, per=24, seed=0):
    ds = make_dataset("synthetic-cifar10", n_train=n_clients * per, n_test=20,
                      seed=seed)
    return [ClientData(ds.x_train[i * per:(i + 1) * per],
                       ds.y_train[i * per:(i + 1) * per])
            for i in range(n_clients)]


def _schedule(a, lam):
    a = np.asarray(a, np.float64)
    lam = np.broadcast_to(np.asarray(lam, np.float64), a.shape).copy()
    lam[a == 0] = 0.0
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def test_resnet_packed_matches_reference_and_follows_jax():
    """Four FedSGD rounds of a depth-8 ResNet (per-client lambda on round
    2): the port's packed backend equals its reference backend bit for bit
    (parameters, v as values, losses); against the JAX package's packed
    trajectory from the same weights, losses to rtol 1e-4 and parameters
    to atol 1e-4."""
    clients = _cifar_clients()
    jp, tp = _jax_resnet(6, depth=8, width=4)
    lam = np.full((4, 3), 0.3)
    lam[2] = [0.2, 0.4, 0.3]
    sched = _schedule(np.ones((4, 3)), lam)
    ch = ChannelModel(3)
    sp = SystemParams.table1(3)
    out = {}
    for backend in ("packed", "reference"):
        tr = FederatedTrainer(cnn.make_loss_fn(cnn.resnet_apply), tp,
                              clients, eta=0.1, batch_size=8, seed=0,
                              backend=backend, device="cpu")
        out[backend] = (tr, tr.run(sched, sp, ch.uplink, ch.downlink))
    (tp_, hp), (tr_, hr) = out["packed"], out["reference"]
    assert [m.train_loss for m in hp] == [m.train_loss for m in hr]
    for a, b in zip(leaves(tp_.params), leaves(tr_.params)):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    for a, b in zip(leaves(tp_.global_grad), leaves(tr_.global_grad)):
        assert torch.equal(a, b)
    jtr = JTrainer(jcnn.make_loss_fn(jcnn.resnet_apply), jp, clients,
                   eta=0.1, batch_size=8, seed=0, shards=1)
    jh = jtr.run(sched, sp, ch.uplink, ch.downlink)
    np.testing.assert_allclose([m.train_loss for m in hp],
                               [m.train_loss for m in jh], rtol=1e-4)
    for a, b in zip(leaves(tp_.params),
                    jax.tree_util.tree_leaves(jtr.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
