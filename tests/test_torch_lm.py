"""The port's LM stack against the JAX package, on the CPU, in fp32.

Layers, every path of `attend` (naive, chunked with and without a window,
the causal skip, the kernel path's plain version), the ring and int8 KV
caches, the dense, MoE, SSM and hybrid blocks, and `forward`, `prefill`
and `decode_step` logits on reduced granite, gemma2 (window, softcaps,
local/global layers, embedding scale), mamba2, mixtral and arctic (MoE
with capacity drops; arctic's parallel dense MLP) and hymba (ring-window
attention beside the SSM), all from JAX's parameters (repro_torch.convert)
and the same numpy inputs.

Tolerances: the two packages run the same fp32 arithmetic, but XLA and
torch reduce matmuls and softmax sums in different orders, so values agree
to a few ulps per op: 2e-5 (the JAX package's fp32 kernel tolerance) for
single layers and attention, 1e-4 for logits through a whole model (two
layers plus the vocab projection, |logits| up to about 2), 1e-3 for the
int8 cache, where a value next to a rounding boundary of the quantisation
can land one int8 step apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402


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


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _close(a, b, tol=LAYER_TOL):
    np.testing.assert_allclose(_np(a), _np(b), **tol)


def _both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _model(arch):
    jcfg = jax_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


def test_configs_are_the_jax_packages():
    from repro.configs import list_configs as jax_list
    assert list_configs() == jax_list()
    for name in list_configs():
        assert repr(get_config(name)) == repr(jax_get_config(name))
        assert repr(get_config(name).reduced()) == \
            repr(jax_get_config(name).reduced())


# -- layers -------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    jx, tx = _both(rng.normal(size=(2, 5, 3, 16)).astype(np.float32))
    js, ts = _both(0.1 * rng.normal(size=(16,)).astype(np.float32))
    jb, tb = _both(0.1 * rng.normal(size=(16,)).astype(np.float32))
    _close(layers.rms_norm(tx, ts), jlayers.rms_norm(jx, js))
    _close(layers.layer_norm(tx, ts, tb), jlayers.layer_norm(jx, js, jb))
    jpos, tpos = _both(np.arange(5)[None].repeat(2, 0) + 7)
    _close(layers.apply_rope(tx, tpos, 10000.0),
           jlayers.apply_rope(jx, jpos, 10000.0))
    _close(layers.softcap(tx * 40, 30.0), jlayers.softcap(jx * 40, 30.0))
    w = {k: rng.normal(size=s).astype(np.float32) / 4 for k, s in
         (("w_gate", (16, 24)), ("w_up", (16, 24)), ("w_down", (24, 16)),
          ("w_in", (16, 24)), ("b_in", (24,)), ("w_out", (24, 16)),
          ("b_out", (16,)))}
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    _close(layers.gated_mlp(tx, tw), jlayers.gated_mlp(jx, jw))
    _close(layers.mlp(tx, tw), jlayers.mlp(jx, jw))


def test_bf16_leaves_cross_the_boundary():
    jcfg = jax_get_config("granite-3-2b").reduced(layers=1)
    import dataclasses
    jcfg = dataclasses.replace(jcfg, dtype="bfloat16")
    jp = JT.init_params(jax.random.key(1), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    np.testing.assert_array_equal(
        tp["blocks"]["attn"]["wq"].float().numpy(),
        np.asarray(jp["blocks"]["attn"]["wq"], np.float32))


# -- attention ----------------------------------------------------------------

def _qkv(b, s, hq, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [_both(rng.normal(size=(b, s, h, d)).astype(np.float32))
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("impl,causal,window,cap", [
    ("naive", True, 0, 0.0), ("chunked", True, 0, 0.0),
    ("chunked", False, 0, 0.0), ("chunked", True, 96, 0.0),
    ("chunked_skip", True, 0, 20.0), ("cuda", True, 0, 0.0),
    ("cuda", True, 64, 30.0), ("flash_vjp", True, 0, 0.0),
    ("flash_vjp", True, 64, 30.0), ("flash_vjp", False, 0, 0.0)])
def test_attend_paths_match_jax(impl, causal, window, cap):
    """S = 256 > 128, so every impl takes its own path (the kernel path's
    plain version on the CPU, JAX's Pallas kernel in interpret mode)."""
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 256, 4, 2, 64)
    kw = dict(causal=causal, window=window, cap=cap, q_chunk=128,
              kv_chunk=64)
    out = attn.attend(tq, tk, tv, impl=impl, **kw)
    jimpl = "pallas" if impl == "cuda" else impl
    _close(out, jattn.attend(jq, jk, jv, impl=jimpl, **kw))
    _close(out, jattn.naive_attention(jq, jk, jv, causal=causal,
                                      window=window, cap=cap))


def test_attend_sends_short_sequences_to_the_naive_path(monkeypatch):
    """JAX's rule: Sq <= max(q_chunk, 128) // 4 is naive whatever impl
    asks (128 at the default q_chunk 512), the training path's flash_vjp
    included."""
    from repro_torch.kernels import ops
    from repro_torch.models import flash_vjp
    called = []
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: called.append("cuda"))
    monkeypatch.setattr(flash_vjp, "chunked_attention_vjp",
                        lambda *a, **k: called.append("flash_vjp"))
    (_, tq), (_, tk), (_, tv) = _qkv(1, 128, 4, 2, 64)
    attn.attend(tq, tk, tv, impl="cuda")
    attn.attend(tq, tk, tv, impl="flash_vjp")
    assert not called
    (_, tq), (_, tk), (_, tv) = _qkv(1, 256, 4, 2, 64)
    attn.attend(tq, tk, tv, impl="cuda")
    attn.attend(tq, tk, tv, impl="flash_vjp")
    assert called == ["cuda", "flash_vjp"]
    with pytest.raises(ValueError, match="unknown attention impl"):
        attn.attend(tq, tk, tv, impl="pallas")


@pytest.mark.parametrize("pos,window", [(37, 0), (37, 16), (200, 64)])
def test_decode_attention_and_ring_match_jax(pos, window):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 256, 4, 2, 32, seed=pos)
    jq1, tq1 = jq[:, :1], tq[:, :1]
    _close(attn.decode_attention(tq1, tk, tv, pos, window=window, cap=5.0),
           jattn.decode_attention(jq1, jk, jv, pos, window=window, cap=5.0))
    if window:
        ring_k, jring_k = attn.fill_ring(tk[:, :pos + 1], window), \
            jattn.fill_ring(jk[:, :pos + 1], window)
        _close(ring_k, jring_k, dict(rtol=0, atol=0))
        np.testing.assert_array_equal(_np(attn.ring_slots(pos, window)),
                                      _np(jattn.ring_slots(pos, window)))
        ring_v = attn.fill_ring(tv[:, :pos + 1], window)
        _close(attn.decode_attention_ring(tq1, ring_k, ring_v, pos),
               jattn.decode_attention_ring(jq1, jring_k,
                                           jattn.fill_ring(jv[:, :pos + 1],
                                                           window), pos))


def test_quantized_kv_matches_jax():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(1, 64, 4, 2, 32, seed=3)
    k8, ks = attn.quantize_kv(tk)
    jk8, jks = jattn.quantize_kv(jk)
    np.testing.assert_array_equal(_np(k8), _np(jk8))
    _close(ks, jks)
    v8, vs = attn.quantize_kv(tv)
    jv8, jvs = jattn.quantize_kv(jv)
    _close(attn.decode_attention(tq[:, :1], k8, v8, 40, k_scale=ks,
                                 v_scale=vs),
           jattn.decode_attention(jq[:, :1], jk8, jv8, 40, k_scale=jks,
                                  v_scale=jvs))


# -- blocks -------------------------------------------------------------------

def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


BLOCK_FNS = {"dense": (JB.dense_block, B.dense_block),
             "moe": (JB.moe_block, B.moe_block),
             "ssm": (JB.ssm_block, B.ssm_block),
             "hybrid": (JB.hybrid_block, B.hybrid_block)}


def _leaf_pairs(t, j, path=()):
    """(path, port leaf, JAX leaf) over a nested cache dict."""
    if isinstance(j, dict):
        for k in j:
            yield from _leaf_pairs(t[k], j[k], path + (k,))
    else:
        yield path, t, j


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b",
                                  "mamba2-130m", "mixtral-8x22b",
                                  "arctic-480b", "hymba-1.5b",
                                  "qwen2.5-3b", "yi-9b"])
def test_blocks_prefill_then_decode_match_jax(arch):
    """One block of each family with a cache: prefill 256 tokens (past
    the reduced window of 64 of gemma2, mixtral and hymba, so their rings
    wrap; through the kernel path), then two decode steps, outputs (and
    the MoE block's aux) and every cache leaf against JAX's."""
    jcfg, cfg, jp, tp = _model(arch)
    rt, jrt = B.Runtime(attn_impl="cuda"), JB.Runtime(attn_impl="pallas")
    blk = jp["blocks"]["local"] if cfg.local_global else jp["blocks"]
    jbp = _layer0(blk)
    tbp = T._layer(tp["blocks"]["local"] if cfg.local_global
                   else tp["blocks"], 0)
    jcache = JT.init_cache(jcfg, 1, 320)
    jcache = _layer0(jcache["local"] if cfg.local_global else jcache)
    tcache = T.init_cache(cfg, 1, 320, device="cpu")
    tcache = T._layer(tcache["local"] if cfg.local_global else tcache, 0)
    jfn, tfn = BLOCK_FNS[cfg.family]
    rng = np.random.default_rng(1)
    jx, tx = _both(rng.normal(size=(1, 258, cfg.d_model)).astype(np.float32))
    for sl, pos in ((slice(0, 256), None), (slice(256, 257), 256),
                    (slice(257, 258), 257)):
        jy, jcache = jfn(jx[:, sl], jbp, jcfg, jrt, cache=jcache, pos=pos)
        ty, tcache = tfn(tx[:, sl], tbp, cfg, rt, cache=tcache, pos=pos)
        if cfg.family == "moe":
            (jcache, jaux), (tcache, taux) = jcache, tcache
            _close(taux, jaux)
        _close(ty, jy)
    for path, t, j in _leaf_pairs(tcache, jcache):
        _close(t, j)


# -- whole models -------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b",
                                  "mamba2-130m", "mixtral-8x22b",
                                  "arctic-480b", "hymba-1.5b",
                                  "qwen2.5-3b", "yi-9b"])
def test_forward_prefill_decode_match_jax(arch):
    jcfg, cfg, jp, tp = _model(arch)
    rt, jrt = B.Runtime(attn_impl="cuda"), JB.Runtime(attn_impl="pallas")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 260)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    _close(T.forward(tp, tt[:, :40], cfg, rt),
           JT.forward(jp, jt[:, :40], jcfg, jrt), MODEL_TOL)
    jc = JT.init_cache(jcfg, 2, 320)
    tc = T.init_cache(cfg, 2, 320, device="cpu")
    jl, jc = JT.prefill(jp, jt[:, :256], jc, jcfg, jrt)
    tl, tc = T.prefill(tp, tt[:, :256], tc, cfg, rt)
    _close(tl, jl, MODEL_TOL)
    for pos in range(256, 260):
        jl, jc = JT.decode_step(jp, jt[:, pos:pos + 1], jc, pos, jcfg, jrt)
        tl, tc = T.decode_step(tp, tt[:, pos:pos + 1], tc, pos, cfg, rt)
        _close(tl, jl, MODEL_TOL)
    flat_j = jax.tree_util.tree_leaves_with_path(jc)
    for path, leaf in flat_j:
        t = tc
        for key in path:
            t = t[key.key]
        _close(t, leaf, MODEL_TOL)


def test_int8_cache_prefill_decode_match_jax():
    jcfg, cfg, jp, tp = _model("granite-3-2b")
    rt, jrt = B.Runtime(attn_impl="naive"), JB.Runtime(attn_impl="naive")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                             size=(1, 24)).astype(np.int32)
    jc = JT.init_cache(jcfg, 1, 64, kv_quant=True)
    tc = T.init_cache(cfg, 1, 64, kv_quant=True, device="cpu")
    assert tc["k"].dtype == torch.int8 and "v_scale" in tc
    jl, jc = JT.prefill(jp, jnp.asarray(toks[:, :20]), jc, jcfg, jrt)
    tl, tc = T.prefill(tp, torch.from_numpy(toks[:, :20]).long(), tc, cfg,
                       rt)
    _close(tl, jl, MODEL_TOL)
    for pos in range(20, 24):
        jl, jc = JT.decode_step(jp, jnp.asarray(toks[:, pos:pos + 1]), jc,
                                pos, jcfg, jrt)
        tl, tc = T.decode_step(tp, torch.from_numpy(
            toks[:, pos:pos + 1]).long(), tc, pos, cfg, rt)
        _close(tl, jl, dict(rtol=1e-3, atol=1e-3))


def test_init_params_has_the_jax_tree_and_shapes():
    for arch in ("granite-3-2b", "gemma2-9b", "mamba2-130m", "qwen2.5-3b",
                 "mixtral-8x22b", "arctic-480b", "hymba-1.5b",
                 "whisper-small", "llama-3.2-vision-90b"):
        jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
        shapes = jax.eval_shape(lambda: JT.init_params(jax.random.key(0),
                                                       jcfg))
        tp = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes):
            t = tp
            for key in path:
                t = t[key.key]
            assert tuple(t.shape) == leaf.shape, path
            assert str(t.dtype).split(".")[-1] == str(leaf.dtype), path
        n_leaves = len(jax.tree_util.tree_leaves(shapes))

        def count(t):
            return sum(count(v) for v in t.values()) if isinstance(t, dict) \
                else 1
        assert count(tp) == n_leaves
