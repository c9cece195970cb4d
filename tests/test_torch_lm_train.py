"""The port's LM training path against the JAX package, on the CPU.

The data pipeline, the optimizers, flash_vjp's plain forward and backward,
`loss_fn` and its gradient, the masked-FedSGD train step (microbatches,
structured width pruning), bf16 pruning masks and bf16 checkpoints, and the
train launcher, on reduced granite, gemma2 (softcaps, local/global layers
with a window that masks keys) and mamba2, from JAX's parameters
(repro_torch.convert) and the same numpy inputs.

Tolerances: the data pipeline, the masks and the checkpoint bytes are
exact. Elsewhere the two packages run the same fp32 arithmetic in other
reduction orders: 1e-5 relative on losses and relative L2 on gradient
trees and updated parameters (two layers, a 512-token vocabulary; both
read ~2e-6 and ~7e-6 for mamba2's scan), 1e-5 absolute on the flash_vjp
blocks (values of order 1), 1e-6 relative on the optimizers (a few
elementwise ops a step). The one bf16 flash case is held within the LM
kernels' bf16 tolerance (2e-2).
"""
import dataclasses
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.data import lm_pipeline as jlm  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import flash_vjp as jfv  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro import optim as jopt  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.data import lm_pipeline as tlm  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import flash_vjp as tfv  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves, unflatten  # noqa: E402


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


RTOL = 1e-5
ARCHS = ("granite-3-2b", "gemma2-9b", "mamba2-130m", "mixtral-8x22b",
         "arctic-480b", "hymba-1.5b", "qwen2.5-3b", "yi-9b")
SEQ, BATCH, CHUNK = 128, 2, 32


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _rel_l2(got, want) -> float:
    num = sum(float(((_np(g).astype(np.float64)
                      - np.asarray(w, np.float64)) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


def _model(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


def _tokens(cfg, seed=0, batch=BATCH, seq=SEQ):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1)).astype(
        np.int32)
    return t[:, :-1], t[:, 1:]


def _train_runtimes(jcfg, cfg):
    """(JAX, port) runtimes: specialize's train runtime (flash_vjp, remat,
    loss_chunk) with chunks cut to the test's length, and the naive one."""
    jrt = jsteps.specialize(jcfg, JAX_SHAPES["train_4k"])[1]
    rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])[1]
    small = dict(q_chunk=CHUNK, kv_chunk=CHUNK, loss_chunk=CHUNK)
    return {"train": (dataclasses.replace(jrt, **small),
                      dataclasses.replace(rt, **small)),
            "naive": (JRuntime(attn_impl="naive"), Runtime(attn_impl="naive"))}


def _value_and_grad(params, tokens, labels, cfg, rt):
    req = [w.detach().clone().requires_grad_() for w in leaves(params)]
    loss = T.loss_fn(unflatten(params, req), torch.from_numpy(tokens),
                     torch.from_numpy(labels), cfg, rt)
    return loss.detach(), torch.autograd.grad(loss, req)


# -- data pipeline --------------------------------------------------------------

@pytest.mark.parametrize("host,hosts", [(0, 1), (0, 2), (1, 2)])
def test_lm_pipeline_batches_match_jax(host, hosts):
    """Tokens, labels, segment ids and positions bit for bit over several
    steps, after a seek, on one and two shards."""
    def make(mod):
        return mod.PackedLMIterator(
            mod.SyntheticDocumentSource(1000, mean_len=60, seed=3),
            mod.ShardSpec(host, hosts), batch=3, seq=200)

    jit, tit = make(jlm), make(tlm)
    for step in range(6):
        if step == 3:
            jit.seek(11)
            tit.seek(11)
        jb, tb = next(jit), next(tit)
        for f in ("tokens", "labels", "segment_ids", "positions"):
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (step, f)
    docs = [tlm.SyntheticDocumentSource(500, seed=1).doc(i) for i in range(9)]
    jd = [jlm.SyntheticDocumentSource(500, seed=1).doc(i) for i in range(9)]
    assert all(np.array_equal(a, b) for a, b in zip(docs, jd))


# -- optimizers ---------------------------------------------------------------

OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "momentum": lambda m: m.momentum(0.05),
    "nesterov": lambda m: m.momentum(0.05, beta=0.8, nesterov=True),
    "adam": lambda m: m.adam(0.2),
    "adamw": lambda m: m.adam(0.01, weight_decay=0.1),
}


def _opt_tree(rng):
    return {"layer": {"w": rng.normal(size=(4, 3)).astype(np.float32),
                      "b": rng.normal(size=3).astype(np.float32)},
            "head": [rng.normal(size=5).astype(np.float32)]}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_jax(name):
    """Five steps on the same parameters and gradients: updates, states
    and parameters within 1e-6 relative."""
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    jp, tp = jax.tree.map(jnp.asarray, p0), jax.tree.map(torch.from_numpy,
                                                         p0)
    jo, to = OPTIMIZERS[name](jopt), OPTIMIZERS[name](topt)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = _opt_tree(rng)
        ju, js = jo.update(jax.tree.map(jnp.asarray, g), js, jp)
        tu, ts = to.update(jax.tree.map(torch.from_numpy, g), ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        for a, b in zip(jax.tree.leaves(ju) + jax.tree.leaves(jp)
                        + jax.tree.leaves(js), leaves(tu) + leaves(tp)
                        + leaves(ts)):
            np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6,
                                       atol=1e-7)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    rng = np.random.default_rng(1)
    g = _opt_tree(rng)
    jg, tg = jax.tree.map(jnp.asarray, g), jax.tree.map(torch.from_numpy, g)
    np.testing.assert_allclose(float(topt.global_norm(tg)),
                               float(jopt.global_norm(jg)), rtol=1e-6)
    for a, b in zip(jax.tree.leaves(jopt.clip_by_global_norm(jg, max_norm)),
                    leaves(topt.clip_by_global_norm(tg, max_norm))):
        np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6)


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_converge_on_quadratic(name):
    """tests/test_data_optim_ckpt.py's quadratic, through the port."""
    opt = {"sgd": topt.sgd(0.1), "momentum": topt.momentum(0.05),
           "adam": topt.adam(0.2)}[name]
    target = torch.from_numpy(np.random.default_rng(0).normal(
        size=(8,)).astype(np.float32))
    params = {"w": torch.zeros(8)}
    state = opt.init(params)
    for _ in range(200):
        w = params["w"].clone().requires_grad_()
        (g,) = torch.autograd.grad(torch.sum((w - target) ** 2), [w])
        upd, state = opt.update({"w": g}, state, params)
        params = topt.apply_updates(params, upd)
    assert float(torch.sum((params["w"] - target) ** 2)) < 1e-3


# -- flash_vjp -----------------------------------------------------------------

def _flash_inputs(g, dtype=np.float32, b=2, s=64, hkv=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(dtype)
            for h in (hkv * g, hkv, hkv, hkv * g)]


@pytest.mark.parametrize("bq,bk", [(16, 16), (16, 32)])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_vjp_plain_matches_jax(causal, window, cap, g, bq, bk):
    """o and lse of flash_vjp_plain_fwd against `_fwd_scan`, and (dq, dk,
    dv) of the autograd Function (flash_vjp_plain_bwd on the CPU) against
    jax.vjp of `flash_chunked`; fp32, atol 1e-5."""
    q, k, v, do = _flash_inputs(g, seed=g + bq + bk)
    args = (causal, window, cap, bq, bk)
    jo, jlse = jfv._fwd_scan(*(jnp.asarray(x) for x in (q, k, v)), *args)
    to, tlse = tfv.flash_vjp_plain_fwd(*(torch.from_numpy(x)
                                         for x in (q, k, v)), *args)
    np.testing.assert_allclose(_np(to), np.asarray(jo), atol=1e-5)
    np.testing.assert_allclose(_np(tlse), np.asarray(jlse), atol=1e-5)
    _, vjp = jax.vjp(lambda a, b, c: jfv.flash_chunked(a, b, c, *args),
                     *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tfv.FlashChunked.apply(*tq, *args)
    np.testing.assert_allclose(_np(out), np.asarray(jo), atol=1e-5)
    out.backward(torch.from_numpy(do))
    for t, w in zip(tq, want):
        np.testing.assert_allclose(_np(t.grad), np.asarray(w), atol=1e-5)


def test_flash_vjp_plain_bf16_matches_jax():
    """bf16 inputs (the LM configs' type): o and the gradients within the
    LM kernels' bf16 tolerance of JAX's."""
    q, k, v, do = _flash_inputs(2, seed=5)
    args = (True, 16, 50.0, 16, 32)
    jx = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    tx = [lm_params_from_numpy(np.asarray(x)).requires_grad_() for x in jx]
    jo, vjp = jax.vjp(lambda a, b, c: jfv.flash_chunked(a, b, c, *args), *jx)
    want = vjp(jnp.asarray(do, jnp.bfloat16))
    out = tfv.FlashChunked.apply(*tx, *args)
    assert out.dtype == torch.bfloat16
    out.backward(lm_params_from_numpy(np.asarray(jnp.asarray(
        do, jnp.bfloat16))))
    tol = dict(rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(_np(out), np.asarray(jo, np.float32), **tol)
    for t, w in zip(tx, want):
        assert t.grad.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(t.grad), np.asarray(w, np.float32),
                                   **tol)


@pytest.mark.parametrize("causal,window,cap,g", [
    (True, 0, 0.0, 2), (True, 16, 50.0, 1), (False, 0, 30.0, 2)])
def test_flash_wrappers_cpu_path_matches_jax(causal, window, cap, g):
    """The kernel wrappers given CPU tensors in the kernel layout (kernel
    8 with lse, the backward) take the blocked plain scans and count
    nothing: o, lse and (dq, dk, dv) against `_fwd_scan` and jax.vjp of
    `flash_chunked` (blocks of 16); fp32, atol 1e-5."""
    from repro_torch.kernels import counters
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    q, k, v, do = _flash_inputs(g, seed=11 + g)
    args = (causal, window, cap, 16, 16)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    jo, jlse = jfv._fwd_scan(*jx, *args)
    _, vjp = jax.vjp(lambda a, b, c: jfv.flash_chunked(a, b, c, *args), *jx)
    want = vjp(jnp.asarray(do))
    kq, kk, kv, kdo = (torch.from_numpy(x).transpose(1, 2)
                       for x in (q, k, v, do))
    kw = dict(causal=causal, window=window, cap=cap)
    counters.reset_launches()
    o, lse = fa.flash_attention(kq, kk, kv, lse=True, **kw)
    grads = fab.flash_attention_bwd(kq, kk, kv, o, kdo, lse, **kw)
    assert set(counters.LAUNCHES.values()) == {0}
    np.testing.assert_allclose(_np(o.transpose(1, 2)), np.asarray(jo),
                               atol=1e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(jlse).reshape(
        lse.shape), atol=1e-5)
    for t, w in zip(grads, want):
        np.testing.assert_allclose(_np(t.transpose(1, 2)), np.asarray(w),
                                   atol=1e-5)


def test_chunked_attention_vjp_needs_dividing_chunks():
    q, k, v, _ = _flash_inputs(1, s=48)
    with pytest.raises(ValueError, match="must divide chunks"):
        tfv.chunked_attention_vjp(*(torch.from_numpy(x) for x in (q, k, v)),
                                  q_chunk=32, kv_chunk=32)


# -- loss and gradient ----------------------------------------------------------

def test_specialize_matches_jax():
    for arch in ARCHS + ("whisper-small",):
        for shape in INPUT_SHAPES:
            jcfg, jrt = jsteps.specialize(jax_get_config(arch),
                                          JAX_SHAPES[shape])
            cfg, rt = steps.specialize(get_config(arch), INPUT_SHAPES[shape])
            assert dataclasses.asdict(rt) == dataclasses.asdict(jrt)
            assert cfg.max_seq == jcfg.max_seq
        assert steps.train_microbatches(get_config(arch)) == \
            jsteps.train_microbatches(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS + ("whisper-small",
                                          "llama-3.2-vision-90b"))
def test_param_count_matches_jax(arch):
    """param_count and active_param_count (MoE: the top-k experts' share)
    at full and reduced size."""
    for full in (True, False):
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        if not full:
            cfg, jcfg = cfg.reduced(), jcfg.reduced()
        assert T.param_count(cfg) == JT.param_count(jcfg)
        assert T.active_param_count(cfg) == JT.active_param_count(jcfg)
        assert (T.active_param_count(cfg) < T.param_count(cfg)) == \
            bool(cfg.num_experts)


@pytest.mark.parametrize("runtime", ["train", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, runtime):
    """loss_fn and its gradient tree against jax.value_and_grad: under the
    train runtime (flash_vjp, chunks of 32 over 128 tokens, loss chunks
    of 32, remat) and the naive one; fp32, 1e-5."""
    jcfg, cfg, jp, tp = _model(arch)
    jrt, rt = _train_runtimes(jcfg, cfg)[runtime]
    toks, labs = _tokens(cfg)
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(toks),
                                            jnp.asarray(labs), jcfg, jrt)
    tl, tg = _value_and_grad(tp, toks, labs, cfg, rt)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert _rel_l2(tg, [np.asarray(x) for x in jax.tree.leaves(jg)]) < RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gives_bit_identical_gradients(arch):
    """Activation checkpointing recomputes the same ops: the loss and every
    gradient bit are the same with remat on and off."""
    _, cfg, _, tp = _model(arch)
    toks, labs = _tokens(cfg, seed=1)
    rt = Runtime(attn_impl="flash_vjp", q_chunk=CHUNK, kv_chunk=CHUNK,
                 loss_chunk=CHUNK)
    l0, g0 = _value_and_grad(tp, toks, labs, cfg, rt)
    l1, g1 = _value_and_grad(tp, toks, labs, cfg,
                             dataclasses.replace(rt, remat=True))
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_loss_chunks_that_do_not_divide_fall_back_to_one():
    """A loss_chunk that does not divide S is one chunk (the JAX rule)."""
    _, cfg, _, tp = _model("granite-3-2b")
    toks, labs = _tokens(cfg, seq=96)
    a = T.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(labs), cfg,
                  Runtime(attn_impl="naive", loss_chunk=64))
    b = T.loss_fn(tp, torch.from_numpy(toks), torch.from_numpy(labs), cfg,
                  Runtime(attn_impl="naive", loss_chunk=96))
    assert torch.equal(a, b)


# -- the train step ---------------------------------------------------------------

def _masks(tp, jp, lam=0.3, seed=0):
    """The same uint8 masks in both packages (random, prunable leaves)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in flatten_with_path(tp):
        m = np.ones(tuple(leaf.shape), np.uint8)
        if pruning.default_prunable(path):
            m = (rng.random(m.shape) >= lam).astype(np.uint8)
        out[path] = m
    tm = unflatten(tp, [torch.from_numpy(out[p]) for p, _ in
                        flatten_with_path(tp)])
    jm = jax.tree_util.tree_map_with_path(
        lambda kp, _: jnp.asarray(out[jax.tree_util.keystr(kp)]), jp)
    return jm, tm


@pytest.mark.parametrize("mb,structured", [(1, 0.0), (2, 0.0), (1, 0.25)])
@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m",
                                  "mixtral-8x22b", "hymba-1.5b"])
def test_make_train_step_matches_jax(arch, mb, structured):
    """One masked-FedSGD step: the loss and the new parameters against
    JAX's jitted step (1e-5); pruned coordinates bit for bit unchanged.
    Mixtral's masks and structured slice cover the [L, E, D, F] expert
    leaves and its fp32 router."""
    jcfg, cfg, jp, tp = _model(arch)
    jrt, rt = _train_runtimes(jcfg, cfg)["train"]
    jm, tm = _masks(tp, jp)
    toks, labs = _tokens(cfg, seed=2)
    kw = dict(eta=0.5, microbatches=mb, structured_lambda=structured)
    jl, jnew = jax.jit(jsteps.make_train_step(jcfg, jrt, **kw))(
        jp, jm, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tl, tnew = steps.make_train_step(cfg, rt, **kw)(
        tp, tm, {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jnew)]
    moved = [np.asarray(a) - np.asarray(b) for a, b in
             zip(jleaves, jax.tree.leaves(jp))]
    assert _rel_l2([_np(a) - _np(b) for a, b in zip(leaves(tnew),
                                                    leaves(tp))],
                   moved) < 1e-4
    assert _rel_l2(leaves(tnew), jleaves) < RTOL
    for new, old, m in zip(leaves(tnew), leaves(tp), leaves(tm)):
        pruned = m == 0
        assert torch.equal(new[pruned].view(torch.int32),
                           old[pruned].view(torch.int32))


@pytest.mark.parametrize("arch", ["granite-3-2b", "mixtral-8x22b"])
def test_structured_slice_matches_jax(arch):
    jcfg, cfg, jp, tp = _model(arch)
    js, _ = jsteps.structured_slice(jp, 0.25)
    ts, none = steps.structured_slice(tp, 0.25)
    assert none is None
    jflat = {jax.tree_util.keystr(kp): np.asarray(x) for kp, x in
             jax.tree_util.tree_flatten_with_path(js)[0]}
    for path, leaf in flatten_with_path(ts):
        assert tuple(leaf.shape) == jflat[path].shape, path
        assert np.array_equal(_np(leaf), jflat[path])
    assert steps.structured_slice(tp, 0.0)[0] is tp


def test_prefill_and_serve_steps_are_the_models():
    _, cfg, _, tp = _model("granite-3-2b")
    toks, _ = _tokens(cfg, batch=1, seq=16)
    rt = Runtime(attn_impl="naive")
    cache = T.init_cache(cfg, 1, 32, device="cpu")
    lg, cache = steps.make_prefill_step(cfg, rt)(
        tp, {"tokens": torch.from_numpy(toks).long()}, cache)
    ref_cache = T.init_cache(cfg, 1, 32, device="cpu")
    want, _ = T.prefill(tp, torch.from_numpy(toks).long(), ref_cache, cfg, rt)
    assert torch.equal(lg, want)
    tok = torch.tensor([[3]])
    got, _ = steps.make_serve_step(cfg, rt)(tp, cache, tok, 16)
    assert torch.equal(got, T.decode_step(tp, tok, ref_cache, 16, cfg,
                                          rt)[0])


# -- the two repairs: bf16 masks and bf16 checkpoints -------------------------

@pytest.mark.parametrize("lam", [0.1, 0.3, 0.5])
def test_bf16_masks_match_jax(lam):
    """A bf16 tree: importance bit for bit, the threshold, every mask bit
    and the realized ratio equal to JAX's (the port once took fp32
    importance and pruned 3 of 6,144 coordinates more at lam 0.3)."""
    rng = np.random.default_rng(0)
    shapes = {"w_up": (64, 96), "wq": (40, 7), "norm": (64,)}
    jw = {k: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
          for k, s in shapes.items()}
    jg = {k: jnp.asarray(rng.normal(size=s), jnp.bfloat16)
          for k, s in shapes.items()}
    jimp = jpruning.taylor_importance(jw, jg)
    timp = pruning.taylor_importance(
        lm_params_from_numpy(jax.tree.map(np.asarray, jw)),
        lm_params_from_numpy(jax.tree.map(np.asarray, jg)))
    for k in shapes:
        assert timp[k].dtype == torch.bfloat16
        assert np.array_equal(timp[k].view(torch.int16).numpy(),
                              np.asarray(jimp[k]).view(np.int16))
    assert pruning.global_threshold(timp, lam) == \
        jpruning.global_threshold(jimp, lam)
    jm, tm = jpruning.build_masks(jimp, lam), pruning.build_masks(timp, lam)
    for k in shapes:
        assert np.array_equal(tm[k].numpy(), np.asarray(jm[k]))
    assert pruning.actual_ratio(tm) == jpruning.actual_ratio(jm)


@pytest.mark.parametrize("lam", [0.0, 0.3, 0.9])
def test_fp32_threshold_with_nan_and_negatives_matches_jax(lam):
    """The counting select on fp32: NaN sorts last, negatives first, as in
    np.partition."""
    rng = np.random.default_rng(4)
    imp = {"a": rng.normal(size=300).astype(np.float32),
           "b": np.abs(rng.normal(size=(7, 11))).astype(np.float32)}
    imp["a"][::37] = np.nan
    imp["b"][0, :3] = 0.0
    want = jpruning.global_threshold(jax.tree.map(jnp.asarray, imp), lam)
    got = pruning.global_threshold(jax.tree.map(torch.from_numpy, imp), lam)
    assert np.float32(got) == np.float32(want) or (np.isnan(got)
                                                   and np.isnan(want))


def test_actual_ratio_and_distortion_match_jax():
    rng = np.random.default_rng(5)
    w = {"w1": rng.normal(size=(9, 4)).astype(np.float32),
         "norm_scale": rng.normal(size=4).astype(np.float32)}
    m = {"w1": (rng.random((9, 4)) > 0.4).astype(np.float32),
         "norm_scale": np.ones(4, np.float32)}
    t = jax.tree.map(torch.from_numpy, w), jax.tree.map(torch.from_numpy, m)
    j = jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, m)
    assert pruning.actual_ratio(t[1]) == jpruning.actual_ratio(j[1])
    np.testing.assert_allclose(pruning.pruning_distortion(*t),
                               jpruning.pruning_distortion(*j), rtol=1e-12)


def test_exact_importance_matches_jax():
    """Eq. (3)'s oracle on a tiny quadratic loss."""
    rng = np.random.default_rng(6)
    p = {"a": rng.normal(size=(2, 3)).astype(np.float32),
         "b": rng.normal(size=4).astype(np.float32)}
    c = rng.normal(size=10).astype(np.float32)

    def jloss(t):
        return jnp.sum((jnp.concatenate([t["a"].ravel(), t["b"]])
                        - jnp.asarray(c)) ** 2)

    def tloss(t):
        return torch.sum((torch.cat([t["a"].reshape(-1), t["b"]])
                          - torch.from_numpy(c)) ** 2)

    want = jpruning.exact_importance(jloss, jax.tree.map(jnp.asarray, p))
    got = pruning.exact_importance(tloss, jax.tree.map(torch.from_numpy, p))
    for k in p:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def _bf16_tree(seed=0):
    rng = np.random.default_rng(seed)
    jt = {"blocks": {"w_up": jnp.asarray(rng.normal(size=(2, 8, 16)),
                                         jnp.bfloat16),
                     "norm": jnp.asarray(rng.normal(size=(2, 8)),
                                         jnp.float32)},
          "embed": jnp.asarray(rng.normal(size=(32, 8)), jnp.bfloat16)}
    return jt, lm_params_from_numpy(jax.tree.map(np.asarray, jt))


def test_bf16_checkpoint_bytes_match_jax(tmp_path, monkeypatch):
    """The port writes a bf16 tree as the JAX package does: the same .npz
    bytes (zip timestamps pinned, which np.savez takes from the clock) and
    the same metadata; it reads the file back bit for bit."""
    jt, tt = _bf16_tree()
    fixed = time.struct_time((2024, 1, 2, 3, 4, 5, 1, 2, 0))
    monkeypatch.setattr(time, "localtime", lambda *a: fixed)
    jio.save_checkpoint(str(tmp_path / "jax"), jt, step=5)
    tio.save_checkpoint(str(tmp_path / "port"), tt, step=5)
    for suffix in (".npz", ".meta.json"):
        assert (tmp_path / ("jax" + suffix)).read_bytes() == \
            (tmp_path / ("port" + suffix)).read_bytes()
    back, meta = tio.load_checkpoint(str(tmp_path / "port"), tt)
    assert meta["step"] == 5
    for a, b in zip(leaves(back), leaves(tt)):
        assert a.dtype == b.dtype
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b)


def test_port_reads_jax_bf16_checkpoint(tmp_path):
    """A JAX-written bf16 file reads into the port bit for bit (JAX's own
    load_checkpoint cannot cast its "<V2" records back: ROADMAP section 3)."""
    jt, tt = _bf16_tree(seed=1)
    path = str(tmp_path / "ck")
    jio.save_checkpoint(path, jt, step=2)
    like = jax.tree.map(torch.zeros_like, tt)
    back, _ = tio.load_checkpoint(path, like)
    for a, b in zip(leaves(back), leaves(tt)):
        assert a.dtype == b.dtype
        assert np.array_equal(_np(a), _np(b))
    with pytest.raises(ValueError, match="No cast function"):
        jio.load_checkpoint(path, jt)


# -- the launcher -------------------------------------------------------------

def test_train_launcher_on_the_cpu(tmp_path, capsys):
    """--device cpu on a reduced arch for 2 steps with --ckpt-dir: finite
    losses, the printed realized lambda is actual_ratio of the masks, the
    checkpoint reads back bit for bit."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch import train
    params, masks, losses = train.main([
        "--arch", "granite-3-2b", "--device", "cpu", "--steps", "2",
        "--seq", "64", "--batch", "2", "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert f"realized lambda={pruning.actual_ratio(masks):.3f}" in out
    assert 0.29 < pruning.actual_ratio(masks) <= 0.3
    assert all(m.dtype == torch.uint8 for m in leaves(masks))
    back, meta = CheckpointManager(str(tmp_path)).restore(params)
    assert meta["step"] == 2
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(params)))


def test_train_launcher_cli_runs():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "mamba2-130m", "--device", "cpu", "--steps", "1", "--seq", "32",
         "--batch", "1", "--data", "random"],
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "step   0 loss" in out.stdout
