"""The port's audio (whisper) and vlm (llama-vision) families against the
JAX package, on the CPU, in fp32 from JAX's parameters.

The encoder block and the cross-attention block (whisper's decoder layer
with its self-attention cache; llama-vision's cross layer, gated and
ungated), `forward`, `loss_fn` and its gradient, `prefill` then four
`decode_step`s with every cache leaf (the memory written by the prefill
among them), the serving engine against JAX's engine with one shared
batch-1 memory, the masked-FedSGD train step with and without
microbatches, the learned positions' clamp at the end of the table, the
launchers' batches and both launchers on the CPU. Reduced configs, with
llama-vision's gates opened to 0.7 wherever the cross path is held: at
init its gates are 0, tanh(0) = 0 and the cross layers add nothing, so a
broken cross path would pass every check. The engine's vlm runs 6 layers
in 2 groups of 2 self layers and a cross layer, its self stack and caches
[2, 2, ...] beside 2 slots, so a batch axis mistaken for a layer axis
shows.

Tolerances, as tests/test_torch_lm.py's: 2e-5 for single blocks (the
JAX package's fp32 kernel tolerance), 1e-4 for logits through a whole
model and 1e-3 after decode steps, 1e-5 relative on losses, gradient
trees and updated parameters (tests/test_torch_lm_train.py's); the
engines' greedy tokens and the launchers' fp32 batches are exact. One
exception, measured: the reduced llama-vision's gradient is ill-conditioned
in fp32. Against the port run in fp64 on the same inputs (its logits
cast to fp32, as loss_fn casts them), JAX's fp32
gradient reads 6.1e-5 (train runtime) and 6.9e-5 (naive) relative L2, the
port's 1.0e-4 and 4.6e-5, and the two read 8.8e-5 apart (naive), where
whisper's read under 1e-6 from fp64; so the vlm's gradient is held at
2e-4, to JAX and to fp64 alike.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.tree import (flatten_with_path, leaves,  # noqa: E402
                              tree_map, unflatten)


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


LAYER_TOL = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
RTOL = 1e-5
GRAD_RTOL = {"audio": 1e-5, "vlm": 2e-4}    # see the module docstring
ARCHS = ("whisper-small", "llama-3.2-vision-90b")
GATE = 0.7                      # tanh(0.7) = 0.60: the cross path open
MEMORY = {"audio": "encoder_input", "vlm": "vision_embeddings"}


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _close(a, b, tol=LAYER_TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _open_gates(jp, gate=GATE):
    return jax.tree_util.tree_map_with_path(
        lambda kp, x: jnp.full_like(x, gate)
        if "gate" in jax.tree_util.keystr(kp) else x, jp)


def _model(arch, gate=GATE, **replace):
    """(JAX config, port config, JAX params, port params): the reduced
    config (fields replaced by `replace`), JAX's weights carried over,
    the vlm's gates set to `gate`."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    jp = JT.init_params(jax.random.key(0), jcfg)
    if jcfg.family == "vlm":
        jp = _open_gates(jp, gate)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


def _memory(cfg, batch=2, seed=5):
    """The family's extra input, random (the encoder's LayerNorm cancels a
    constant one), as (JAX dict, port dict)."""
    n = cfg.encoder_tokens if cfg.family == "audio" else cfg.vision_tokens
    x = np.random.default_rng(seed).normal(
        size=(batch, n, cfg.d_model)).astype(np.float32)
    j, t = _both(x)
    return {MEMORY[cfg.family]: j}, {MEMORY[cfg.family]: t}


def _leaf_pairs(tree, jtree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(jtree):
        t = tree
        for key in path:
            t = t[key.key]
        yield jax.tree_util.keystr(path), t, leaf


# -- blocks -------------------------------------------------------------------

def test_encoder_block_matches_jax():
    """Whisper's encoder layer 0 (LayerNorm, bidirectional naive attention,
    GELU MLP) on random frames, and the whole encoder."""
    jcfg, cfg, jp, tp = _model("whisper-small")
    jx, tx = _both(np.random.default_rng(1).normal(
        size=(2, cfg.encoder_tokens, cfg.d_model)).astype(np.float32))
    jrt, rt = JRuntime(attn_impl="naive"), Runtime(attn_impl="naive")
    jbp = jax.tree.map(lambda a: a[0], jp["enc_blocks"])
    _close(B.encoder_block(tx, T._layer(tp["enc_blocks"], 0), cfg, rt),
           JB.encoder_block(jx, jbp, jcfg, jrt))
    _close(T._encode(tp, tx, cfg, rt), JT._encode(jp, jx, jcfg, jrt))


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_cross_block_matches_jax(arch, gated):
    """Layer 0's cross block on a random memory, gated (the gate at 0.7)
    and ungated. Whisper's holds a self-attention: a prefill of 40 tokens
    into its cache, then two decode steps, the outputs and the cache
    against JAX's; llama-vision's has none and no cache."""
    jcfg, cfg, jp, tp = _model(arch)
    if cfg.family == "vlm":
        jbp = jax.tree.map(lambda a: a[0], jp["blocks"]["cross"])
        tbp = T._layer(tp["blocks"]["cross"], 0)
    else:
        jbp = _open_gates(jax.tree.map(lambda a: a[0], jp["blocks"]))
        tbp = lm_params_from_numpy(jax.tree.map(np.asarray, jbp))
    rng = np.random.default_rng(2)
    jenc, tenc = _both(rng.normal(size=(2, 64, cfg.d_model)).astype(
        np.float32))
    jx, tx = _both(rng.normal(size=(2, 42, cfg.d_model)).astype(np.float32))
    jrt, rt = JRuntime(attn_impl="naive"), Runtime(attn_impl="naive")
    if cfg.family == "vlm":
        jy, _ = JB.cross_block(jx, jbp, jcfg, jrt, enc=jenc, gated=gated,
                               use_gelu_mlp=False)
        ty, tc = B.cross_block(tx, tbp, cfg, rt, enc=tenc, gated=gated)
        assert tc is None
        _close(ty, jy)
        return
    jc = {k: v[0] for k, v in JT.init_cache(jcfg, 2, 64).items()
          if k in ("k", "v")}
    tc = {k: v[0] for k, v in T.init_cache(cfg, 2, 64, device="cpu").items()
          if k in ("k", "v")}
    for sl, pos in ((slice(0, 40), None), (slice(40, 41), 40),
                    (slice(41, 42), 41)):
        jy, jc = JB.cross_block(jx[:, sl], jbp, jcfg, jrt, enc=jenc,
                                cache=jc, pos=pos, gated=gated)
        ty, tc = B.cross_block(tx[:, sl], tbp, cfg, rt, enc=tenc, cache=tc,
                               pos=pos, gated=gated)
        _close(ty, jy)
    for _, t, j in _leaf_pairs(tc, jc):
        _close(t, j)


# -- whole models -------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    """forward over 40 tokens; prefill of 256 tokens through the kernel
    path's plain version (JAX's Pallas kernel in interpret mode), then 4
    decode steps reading the memory from the cache, and every cache leaf
    (the memory written by the prefill among them)."""
    jcfg, cfg, jp, tp = _model(arch)
    rt, jrt = Runtime(attn_impl="cuda"), JRuntime(attn_impl="pallas")
    jm, tm = _memory(cfg)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=(2, 260)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    _close(T.forward(tp, tt[:, :40], cfg, rt, tm),
           JT.forward(jp, jt[:, :40], jcfg, jrt, jm), MODEL_TOL)
    jc = JT.init_cache(jcfg, 2, 320)
    tc = T.init_cache(cfg, 2, 320, device="cpu")
    jl, jc = JT.prefill(jp, jt[:, :256], jc, jcfg, jrt, jm)
    tl, tc = T.prefill(tp, tt[:, :256], tc, cfg, rt, tm)
    _close(tl, jl, MODEL_TOL)
    for pos in range(256, 260):
        jl, jc = JT.decode_step(jp, jt[:, pos:pos + 1], jc, pos, jcfg, jrt)
        tl, tc = T.decode_step(tp, tt[:, pos:pos + 1], tc, pos, cfg, rt)
        _close(tl, jl, DECODE_TOL)
    names = [p for p, _, _ in _leaf_pairs(tc, jc)]
    assert sorted(names) == sorted(["['k']", "['v']", "['enc_out']" if
                                    cfg.family == "audio" else "['vision']"])
    for _, t, j in _leaf_pairs(tc, jc):
        _close(t, j, MODEL_TOL)


def test_vlm_stack_of_two_groups_matches_jax():
    """Six layers in two groups of two self layers and a cross layer (self
    params and K/V [2, 2, ...]): forward, prefill and decode against JAX,
    so each (group, layer) index reaches its own weights and cache."""
    jcfg, cfg, jp, tp = _model("llama-3.2-vision-90b",
                               **dict(num_layers=6, cross_attn_every=3))
    assert tuple(tp["blocks"]["self"]["attn"]["wq"].shape[:2]) == (2, 2)
    rt, jrt = Runtime(attn_impl="naive"), JRuntime(attn_impl="naive")
    jm, tm = _memory(cfg, batch=1)
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=(1, 24)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    _close(T.forward(tp, tt, cfg, rt, tm), JT.forward(jp, jt, jcfg, jrt, jm),
           MODEL_TOL)
    jc, tc = JT.init_cache(jcfg, 1, 32), T.init_cache(cfg, 1, 32,
                                                      device="cpu")
    assert tuple(tc["k"].shape[:3]) == (2, 2, 1)
    jl, jc = JT.prefill(jp, jt[:, :20], jc, jcfg, jrt, jm)
    tl, tc = T.prefill(tp, tt[:, :20], tc, cfg, rt, tm)
    _close(tl, jl, MODEL_TOL)
    for pos in range(20, 24):
        jl, jc = JT.decode_step(jp, jt[:, pos:pos + 1], jc, pos, jcfg, jrt)
        tl, tc = T.decode_step(tp, tt[:, pos:pos + 1], tc, pos, cfg, rt)
        _close(tl, jl, DECODE_TOL)
    for _, t, j in _leaf_pairs(tc, jc):
        _close(t, j, MODEL_TOL)


@pytest.mark.parametrize("gate,changes", [(GATE, True), (0.0, False)])
def test_vision_input_changes_logits_only_with_open_gates(gate, changes):
    """Two random vision inputs: different logits with the gates opened;
    with the gates closed (tanh(0) = 0) the same logits, bit for bit, in
    forward and in decode."""
    _, cfg, _, tp = _model("llama-3.2-vision-90b", gate=gate)
    rt = Runtime(attn_impl="naive")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, 17)).astype(np.int64))
    outs = []
    for seed in (7, 8):
        _, tm = _memory(cfg, batch=1, seed=seed)
        cache = T.init_cache(cfg, 1, 32, device="cpu")
        T.prefill(tp, toks[:, :16], cache, cfg, rt, tm)
        outs.append((T.forward(tp, toks, cfg, rt, tm),
                     T.decode_step(tp, toks[:, 16:], cache, 16, cfg, rt)[0]))
    for a, b in zip(*outs):
        if changes:
            assert float((a - b).abs().max()) > 1e-4
        else:
            assert torch.equal(a, b)


def test_encoder_input_changes_logits():
    """Two random encoder inputs give different logits, in forward and in
    a decode step that reads the encoder output from the cache."""
    _, cfg, _, tp = _model("whisper-small")
    rt = Runtime(attn_impl="naive")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, size=(1, 17)).astype(np.int64))
    outs = []
    for seed in (7, 8):
        _, tm = _memory(cfg, batch=1, seed=seed)
        cache = T.init_cache(cfg, 1, 32, device="cpu")
        T.prefill(tp, toks[:, :16], cache, cfg, rt, tm)
        outs.append((T.forward(tp, toks, cfg, rt, tm),
                     T.decode_step(tp, toks[:, 16:], cache, 16, cfg, rt)[0]))
    for a, b in zip(*outs):
        assert float((a - b).abs().max()) > 1e-4


@pytest.mark.parametrize("pos0", [0, 30, 60, 61, 62, 100])
def test_learned_positions_clamp_like_jax(pos0):
    """Whisper's learned positions of 4 tokens from pos0 in a 64-entry
    table: past the end the start is clamped to 60, as
    jax.lax.dynamic_slice_in_dim clamps it; and decode steps at the
    table's last position match JAX's."""
    jcfg, cfg, jp, tp = _model("whisper-small", max_seq=64)
    toks = np.random.default_rng(pos0).integers(
        0, cfg.vocab_size, size=(2, 4)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    got = T._embed_tokens(tp, tt, cfg, pos0=pos0)
    want = JT._embed_tokens(jp, jt, jcfg, pos0=pos0)
    assert np.array_equal(_np(got), np.asarray(want))
    start = min(pos0, 60)
    assert torch.equal(got, tp["embed"][tt]
                       + tp["pos_embed"][None, start:start + 4])
    jm, tm = _memory(cfg)
    jc, tc = JT.init_cache(jcfg, 2, 64), T.init_cache(cfg, 2, 64,
                                                      device="cpu")
    rt, jrt = Runtime(attn_impl="naive"), JRuntime(attn_impl="naive")
    _, jc = JT.prefill(jp, jt[:, :2], jc, jcfg, jrt, jm)
    T.prefill(tp, tt[:, :2], tc, cfg, rt, tm)
    pos = min(pos0, 63)
    jl, _ = JT.decode_step(jp, jt[:, 2:3], jc, pos, jcfg, jrt)
    tl, _ = T.decode_step(tp, tt[:, 2:3], tc, pos, cfg, rt)
    _close(tl, jl, MODEL_TOL)


# -- serving ------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(arch):
    """One batch-1 memory shared by every request, prompts up to 200
    tokens (those past 129 prefill through the kernel path's plain
    version, JAX's through its naive path), 2 slots reused, padded
    buckets:
    the port's engine gives JAX engine's tokens, slot for slot. The vlm
    runs two groups, so its self caches are [2, 2, B = 2, ...]: the
    engine's batch axis is found by the leaf's role, not its size."""
    replace = dict(num_layers=6, cross_attn_every=3) \
        if arch == "llama-3.2-vision-90b" else {}
    jcfg, cfg, jp, tp = _model(arch, **replace)
    jm, tm = _memory(cfg, batch=1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 150, 7, 30, 200)]
    kw = dict(max_batch=2, max_seq=320, prompt_buckets=(32, 256))
    eng = ServingEngine(tp, cfg, rt=Runtime(attn_impl="cuda"), extra=tm,
                        device="cpu", **kw)
    jeng = JaxEngine(jp, jcfg, rt=JRuntime(attn_impl="naive"), extra=jm,
                     **kw)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=4)
        jeng.submit(pr, max_new_tokens=4)
    done, jdone = eng.run_to_completion(), jeng.run_to_completion()
    assert len(done) == len(prompts)
    assert len({st.slot for st in done}) < len(done)      # slots reused
    assert [(st.request.uid, st.slot, st.generated) for st in done] == \
        [(st.request.uid, st.slot, st.generated) for st in jdone]
    name = "enc_out" if cfg.family == "audio" else "vision"
    _close(eng.cache[name], jeng.cache[name], MODEL_TOL)


# -- training -----------------------------------------------------------------

def _tokens(cfg, seed=0, batch=2, seq=128):
    t = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _rel_l2(got, want) -> float:
    num = sum(float(((_np(g).astype(np.float64)
                      - np.asarray(w, np.float64)) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


def _train_runtimes(jcfg, cfg):
    """(JAX, port): specialize's train runtime (flash_vjp, remat) with
    chunks of 32 over 128 tokens, and the naive one."""
    from repro.configs.registry import INPUT_SHAPES as JAX_SHAPES
    jrt = jsteps.specialize(jcfg, JAX_SHAPES["train_4k"])[1]
    rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])[1]
    small = dict(q_chunk=32, kv_chunk=32, loss_chunk=32)
    return {"train": (dataclasses.replace(jrt, **small),
                      dataclasses.replace(rt, **small)),
            "naive": (JRuntime(attn_impl="naive"),
                      Runtime(attn_impl="naive"))}


@pytest.mark.parametrize("runtime", ["train", "naive"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradient_match_jax(arch, runtime):
    """loss_fn with the memory input and its gradient tree (the encoder's,
    the vision projection's and the gates' leaves among them, zeros for
    the leaves the loss does not read) against jax.value_and_grad, and
    against the port's own fp64 gradient, under the train runtime and the
    naive one."""
    jcfg, cfg, jp, tp = _model(arch)
    jrt, rt = _train_runtimes(jcfg, cfg)[runtime]
    toks, labs = _tokens(cfg)
    jm, tm = _memory(cfg)
    jl, jg = jax.value_and_grad(JT.loss_fn)(
        jp, jnp.asarray(toks), jnp.asarray(labs), jcfg, jrt, jm)

    def grad(params, memory, dtype):
        tcfg = dataclasses.replace(cfg, dtype=dtype)
        return steps.value_and_grad(lambda p: T.loss_fn(
            p, torch.from_numpy(toks).long(), torch.from_numpy(labs).long(),
            tcfg, rt, memory), params)

    loss, tg = grad(tp, tm, "float32")
    _, g64 = grad(tree_map(torch.Tensor.double, tp),
                  {k: v.double() for k, v in tm.items()}, "float64")
    tg = leaves(tg)
    np.testing.assert_allclose(float(loss), float(jl), rtol=RTOL)
    assert _rel_l2(tg, jax.tree.leaves(jg)) < GRAD_RTOL[cfg.family]
    assert _rel_l2(tg, [_np(g) for g in leaves(g64)]) < \
        GRAD_RTOL[cfg.family]
    assert not any(bool(g.isnan().any()) for g in tg)
    flat = dict(zip([p for p, _ in flatten_with_path(tp)], tg))
    key = "['enc_blocks']['attn']['wq']" if cfg.family == "audio" else \
        "['vision_proj']"
    assert float(flat[key].abs().max()) > 0       # the memory's path trains


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


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_make_train_step_matches_jax(arch, mb):
    """One masked-FedSGD step with the memory input in the batch (cut into
    microbatches with the tokens): the loss and the new parameters against
    JAX's jitted step; pruned coordinates bit for bit unchanged."""
    jcfg, cfg, jp, tp = _model(arch)
    jrt, rt = _train_runtimes(jcfg, cfg)["train"]
    jmask, tmask = _masks(tp, jp)
    toks, labs = _tokens(cfg, seed=2)
    jm, tm = _memory(cfg)
    jl, jnew = jax.jit(jsteps.make_train_step(
        jcfg, jrt, eta=0.5, microbatches=mb))(
        jp, jmask, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs),
                    **jm})
    tl, tnew = steps.make_train_step(cfg, rt, eta=0.5, microbatches=mb)(
        tp, tmask, {"tokens": torch.from_numpy(toks).long(),
                    "labels": torch.from_numpy(labs).long(), **tm})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jnew)]
    moved = [np.asarray(a) - np.asarray(b) for a, b in
             zip(jleaves, jax.tree.leaves(jp))]
    assert _rel_l2([_np(a) - _np(b) for a, b in zip(leaves(tnew),
                                                    leaves(tp))],
                   moved) < 1e-4
    assert _rel_l2(leaves(tnew), jleaves) < RTOL
    for new, old, m in zip(leaves(tnew), leaves(tp), leaves(tmask)):
        pruned = m == 0
        assert torch.equal(new[pruned].view(torch.int32),
                           old[pruned].view(torch.int32))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_takes_the_memory_from_the_batch(arch):
    """make_prefill_step hands the batch's memory input to prefill."""
    _, cfg, _, tp = _model(arch)
    _, tm = _memory(cfg, batch=1)
    toks = torch.from_numpy(_tokens(cfg, batch=1, seq=16)[0]).long()
    rt = Runtime(attn_impl="naive")
    got, cache = steps.make_prefill_step(cfg, rt)(
        tp, {"tokens": toks, **tm}, T.init_cache(cfg, 1, 32, device="cpu"))
    want, ref = T.prefill(tp, toks, T.init_cache(cfg, 1, 32, device="cpu"),
                          cfg, rt, tm)
    assert torch.equal(got, want)
    assert all(torch.equal(cache[k], ref[k]) for k in cache)


# -- the launchers ------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_batches_match_jax(arch):
    """synthetic_batch and packed_batch carry the memory input, drawn as
    the JAX launcher's `_add_extra` draws it: equal in fp32."""
    from repro.data.lm_pipeline import (PackedLMIterator as JIt,
                                        ShardSpec as JShard,
                                        SyntheticDocumentSource as JSrc)
    from repro_torch.data.lm_pipeline import (PackedLMIterator, ShardSpec,
                                              SyntheticDocumentSource)
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    name = MEMORY[cfg.family]
    jb = jtrain.synthetic_batch(np.random.default_rng(0), jcfg, 2, 16)
    tb = ttrain.synthetic_batch(np.random.default_rng(0), cfg, 2, 16, "cpu")
    jpb = jtrain.packed_batch(JIt(JSrc(cfg.vocab_size, seed=0), JShard(0, 1),
                                  batch=2, seq=16), jcfg, 2, 16)
    tpb = ttrain.packed_batch(PackedLMIterator(
        SyntheticDocumentSource(cfg.vocab_size, seed=0), ShardSpec(0, 1),
        batch=2, seq=16), cfg, 2, "cpu")
    for t, j in ((tb, jb), (tpb, jpb)):
        assert sorted(t) == sorted(j) == sorted(["tokens", "labels", name])
        for k in t:
            assert np.array_equal(_np(t[k]), np.asarray(j[k])), k
    assert ttrain.batch_extra(tb) == {name: tb[name]}


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_run_on_the_cpu(arch, capsys):
    """The serve and train launchers on the reduced config: batched prefill
    with the memory input and decode; masks from a warm-up gradient with
    the memory and one masked-FedSGD step with a finite loss."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decode 2 steps" in out
    _, masks, losses = ttrain.main(["--arch", arch, "--device", "cpu",
                                    "--steps", "1", "--seq", "32",
                                    "--batch", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert 0.29 < pruning.actual_ratio(masks) <= 0.3
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "step   0 loss" in out
