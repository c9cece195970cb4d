"""The train step that holds only its state (launch/steps.py) against the
straightforward step it replaced (tests/_torch_train_step_reference.py),
on the CPU, bit for bit: the loss and every new parameter viewed as
integers, pruned coordinates included.

The reduced configurations cover one microbatch (granite, qwen with its
q/k/v biases drawn non-zero) and two (mixtral's expert leaves,
llama-vision with its gates opened and a vision input beside the batch,
arctic with the bf16 accumulator taken as above 1e11 parameters), in fp32
and in bf16, and the width-pruned step; the leaf update runs whole and a
slice at a time. Planted cases: a pruned coordinate holding -0.0 whose
gradient is negative (the accumulator starts at +0.0 and adds the masked
gradient, so with microbatches the weight keeps its bits; with one
microbatch the reference's w - eta (g m) turns it into +0.0, and the step
does the same), and a pruned coordinate whose gradient is inf (inf * 0 is
NaN, so the weight becomes NaN, as in JAX's step).

The warm-up: each leaf's importance taken as backward completes it equals
taylor_importance over the whole gradient tree, and build_masks in uint8
equals the fp32 masks cast, bit for bit. With llama-vision's gates at 0
(both packages' init) the cross-attention projections get no gradient,
so their Taylor importance and the gates' own are 0 and the warm-up masks
prune every one of them, in the port and in JAX alike; with the gates
open they keep some and prune no gate.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_train_step_reference as reference  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test (the suite runs in parallel
    workers), and deterministic algorithms, as the card's training runs."""
    n = torch.get_num_threads()
    det = torch.are_deterministic_algorithms_enabled()
    torch.set_num_threads(1)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.set_num_threads(n)
        torch.use_deterministic_algorithms(det)


BATCH, SEQ, CHUNK = 4, 32, 16
GATE = 1.0                          # the card's training opens them to 1
PLANT_LEAF = "['blocks']['attn']['wq']"
SMALL_CHUNK = 777                   # the update a slice at a time


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _assert_bitwise(got, want):
    (lg, ng), (lw, nw) = got, want
    assert _bits(lg.reshape(1)).tolist() == _bits(lw.reshape(1)).tolist()
    assert len(leaves(ng)) == len(leaves(nw))
    for (path, a), b in zip(flatten_with_path(ng), leaves(nw)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        assert torch.equal(_bits(a), _bits(b)), path


def _case(arch, dtype, *, gate=None, bias=False):
    """(config, runtime, params, uint8 masks, batch) of a reduced config
    in `dtype`: specialize's train runtime with chunks cut to SEQ, random
    masks at 0.3 on the prunable leaves (numpy seed 1), tokens and the
    family's memory input from numpy seed 2."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    cfg, rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])
    rt = dataclasses.replace(rt, q_chunk=CHUNK, kv_chunk=CHUNK,
                             loss_chunk=CHUNK)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    if gate is not None:
        params["blocks"]["cross"]["gate"].fill_(gate)
    rng = np.random.default_rng(1)
    if bias:
        for name in ("bq", "bk", "bv"):
            b = params["blocks"]["attn"][name]
            b.copy_(torch.from_numpy(rng.normal(size=tuple(b.shape))))
    masks = unflatten(params, [
        torch.from_numpy((rng.random(tuple(w.shape)) >= 0.3).astype(
            np.uint8)) if pruning.default_prunable(p)
        else torch.ones(w.shape, dtype=torch.uint8)
        for p, w in flatten_with_path(params)])
    batch = ttrain.synthetic_batch(np.random.default_rng(2), cfg, BATCH, SEQ,
                                   "cpu")
    return cfg, rt, params, masks, batch


def _both(cfg, rt, params, masks, batch, **kw):
    got = steps.make_train_step(cfg, rt, **kw)(params, masks, batch)
    want = reference.make_train_step(cfg, rt, **kw)(params, masks, batch)
    return got, want


STEP_CASES = {
    "granite-mb1-fp32": ("granite-3-2b", "float32", 1, {}),
    "granite-mb1-bf16": ("granite-3-2b", "bfloat16", 1, {}),
    "granite-mb2-bf16-structured": ("granite-3-2b", "bfloat16", 2,
                                    {"structured_lambda": 0.25}),
    "mixtral-mb2-bf16": ("mixtral-8x22b", "bfloat16", 2, {}),
    "mixtral-mb2-fp32": ("mixtral-8x22b", "float32", 2, {}),
    "llama-vision-mb2-bf16": ("llama-3.2-vision-90b", "bfloat16", 2, {}),
    "qwen-mb1-bf16-biases": ("qwen2.5-3b", "bfloat16", 1, {}),
    "qwen-mb2-fp32-biases": ("qwen2.5-3b", "float32", 2, {}),
}


@pytest.mark.parametrize("chunk", [None, SMALL_CHUNK])
@pytest.mark.parametrize("name", list(STEP_CASES))
def test_step_is_the_reference_bit_for_bit(name, chunk, monkeypatch):
    """The loss and every new leaf equal the reference step's bits, with
    the update taken whole and SMALL_CHUNK values at a time."""
    if chunk:
        monkeypatch.setattr(steps, "UPDATE_CHUNK", chunk)
    arch, dtype, mb, kw = STEP_CASES[name]
    cfg, rt, params, masks, batch = _case(
        arch, dtype, gate=GATE if "vision" in arch else None,
        bias="qwen" in arch)
    got, want = _both(cfg, rt, params, masks, batch, eta=0.5,
                      microbatches=mb, **kw)
    _assert_bitwise(got, want)
    assert float(got[0]) == float(got[0])       # finite, not NaN
    moved = sum(int(((_bits(a) != _bits(b)) & (m == 0)).sum())
                for a, b, m in zip(leaves(got[1]), leaves(params),
                                   leaves(masks)))
    assert moved == 0


@pytest.mark.parametrize("chunk", [None, SMALL_CHUNK])
def test_bf16_accumulator_above_1e11_parameters(chunk, monkeypatch):
    """Reduced arctic taken as a model above 1e11 parameters: both steps
    accumulate in bf16, bit for bit alike, and the result differs from
    the fp32 accumulator's."""
    if chunk:
        monkeypatch.setattr(steps, "UPDATE_CHUNK", chunk)
    cfg, rt, params, masks, batch = _case("arctic-480b", "bfloat16")
    _, fp32_new = steps.make_train_step(cfg, rt, eta=0.5, microbatches=2)(
        params, masks, batch)
    monkeypatch.setattr(T, "param_count", lambda c: 2e11)
    got, want = _both(cfg, rt, params, masks, batch, eta=0.5,
                      microbatches=2)
    _assert_bitwise(got, want)
    assert any(not torch.equal(_bits(a), _bits(b))
               for a, b in zip(leaves(got[1]), leaves(fp32_new)))


class _Plant(torch.autograd.Function):
    """The identity, whose backward writes `vals` into the gradient at
    the flat indices `idx`."""

    @staticmethod
    def forward(ctx, x, idx, vals):
        ctx.idx, ctx.vals = idx, vals
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g.view(-1)[ctx.idx] = ctx.vals.to(g.dtype)
        return g, None, None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mb", [1, 2])
def test_planted_negative_zero_and_inf_at_pruned_coordinates(mb, dtype,
                                                             monkeypatch):
    """PLANT_LEAF holds -0.0 at a pruned coordinate whose gradient (into
    the masked copy the forward reads) is -1, and at another pruned
    coordinate the gradient inf. Both steps give the same bits: with two
    microbatches the -0.0 stays -0.0 (+0.0 + (-1 * 0) is +0.0 in the
    accumulator; an update that masked only at the end would move it to
    +0.0), with one it becomes +0.0 as the reference's update makes it;
    the inf coordinate becomes NaN (inf * 0)."""
    cfg, rt, params, masks, batch = _case("granite-3-2b", dtype)
    w = dict(flatten_with_path(params))[PLANT_LEAF]
    m = dict(flatten_with_path(masks))[PLANT_LEAF]
    zero_at, inf_at = 3, 5
    w.view(-1)[zero_at] = -0.0
    m.view(-1)[[zero_at, inf_at]] = 0
    idx = torch.tensor([zero_at, inf_at])
    vals = torch.tensor([-1.0, float("inf")])
    loss_fn = T.loss_fn

    def planted(p, *args, **kw):
        flat = flatten_with_path(p)
        return loss_fn(unflatten(p, [
            _Plant.apply(x, idx, vals) if path == PLANT_LEAF else x
            for path, x in flat]), *args, **kw)

    monkeypatch.setattr(T, "loss_fn", planted)
    got, want = _both(cfg, rt, params, masks, batch, eta=0.5,
                      microbatches=mb)
    _assert_bitwise(got, want)
    new = dict(flatten_with_path(got[1]))[PLANT_LEAF].view(-1)
    zero = torch.zeros((), dtype=new.dtype)
    assert torch.equal(_bits(new[zero_at]),
                       _bits(-zero if mb > 1 else zero))
    assert bool(torch.isnan(new[inf_at]))


# -- the leaf-wise gradient and the warm-up -----------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "llama-3.2-vision-90b",
                                  "whisper-small"])
def test_leaf_grads_are_autograds_bit_for_bit(arch):
    """loss_and_leaf_grads hands on, leaf by leaf, the gradients
    value_and_grad returns, bit for bit, zeros for the leaves the loss does
    not read (llama-vision's cross layers' ln_self), each leaf once."""
    cfg, rt, params, _, batch = _case(arch, "bfloat16")

    def loss_of(p):
        return T.loss_fn(p, batch["tokens"], batch["labels"], cfg, rt,
                         ttrain.batch_extra(batch))

    want_loss, want = steps.value_and_grad(loss_of, params)
    got = {}

    def take(i, g):
        assert i not in got
        got[i] = g

    loss = steps.loss_and_leaf_grads(loss_of, params, take)
    assert _bits(loss.reshape(1)).tolist() == \
        _bits(want_loss.reshape(1)).tolist()
    assert sorted(got) == list(range(len(leaves(params))))
    for i, b in enumerate(leaves(want)):
        assert torch.equal(_bits(got[i]), _bits(b)), i


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b",
                                  "llama-3.2-vision-90b", "qwen2.5-3b"])
def test_warmup_masks_leaf_by_leaf_are_the_tree_built_ones(arch):
    """warmup_importance (each leaf's importance as backward completes
    its gradient) equals taylor_importance over value_and_grad's tree, and
    warmup_masks (build_masks made in uint8) equals the fp32 masks cast,
    bit for bit; build_masks keeps its fp32 return."""
    cfg, rt, params, _, batch = _case(
        arch, "bfloat16", gate=GATE if "vision" in arch else None,
        bias="qwen" in arch)
    _, g = steps.value_and_grad(lambda p: T.loss_fn(
        p, batch["tokens"], batch["labels"], cfg, rt,
        ttrain.batch_extra(batch)), params)
    want_imp = pruning.taylor_importance(params, g)
    got_imp = ttrain.warmup_importance(params, batch, cfg, rt)
    for a, b in zip(leaves(got_imp), leaves(want_imp)):
        assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))
    fp32 = pruning.build_masks(want_imp, 0.3)
    assert all(m.dtype == torch.float32 for m in leaves(fp32))
    got = ttrain.warmup_masks(params, batch, cfg, rt, 0.3)
    for a, b in zip(leaves(got), leaves(fp32)):
        assert a.dtype == torch.uint8 and torch.equal(a, b.to(torch.uint8))


def _cross_masks(masks, path_of):
    """(mask values of every cross-attention projection, of the gates)."""
    flat = path_of(masks)
    cross = np.concatenate([np.asarray(m, np.float32).reshape(-1)
                            for p, m in flat if "['cross']['cross']" in p])
    gate = np.concatenate([np.asarray(m, np.float32).reshape(-1)
                           for p, m in flat if p.endswith("['gate']")])
    return cross, gate


@pytest.mark.parametrize("gate", [0.0, GATE])
def test_closed_gates_prune_the_cross_path_in_both_packages(gate):
    """Reduced llama-vision (fp32, from JAX's weights) with its gates at
    `gate`, warm-up masks at lambda 0.3 from one gradient on the same
    batch and vision input in both packages (the port's launcher,
    JAX's value_and_grad, taylor_importance and build_masks): at 0 (both
    packages' init) each prunes every cross-attention coordinate and
    every gate, so training could never open them; opened, each keeps
    some cross-attention coordinates and prunes no gate."""
    jcfg = jax_get_config("llama-3.2-vision-90b").reduced()
    cfg = get_config("llama-3.2-vision-90b").reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    jp = jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.full_like(x, gate)
        if jax.tree_util.keystr(kp).endswith("['gate']") else x, jp)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    batch = ttrain.synthetic_batch(np.random.default_rng(0), cfg, 2, SEQ,
                                   "cpu")
    rt = Runtime(attn_impl="naive")
    tm = ttrain.warmup_masks(tp, batch, cfg, rt, 0.3)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    _, jg = jax.value_and_grad(JT.loss_fn)(
        jp, jb["tokens"], jb["labels"], jcfg, JRuntime(attn_impl="naive"),
        {"vision_embeddings": jb["vision_embeddings"]})
    jm = jpruning.build_masks(jpruning.taylor_importance(jp, jg), 0.3)
    for masks, path_of in (
            (tm, flatten_with_path),
            (jm, lambda t: [(jax.tree_util.keystr(kp), m) for kp, m in
                            jax.tree_util.tree_flatten_with_path(t)[0]])):
        cross, gates = _cross_masks(masks, path_of)
        assert cross.size and gates.size
        if gate == 0.0:
            assert not cross.any() and not gates.any()
        else:
            assert cross.any() and gates.all()
