"""The port's MoE (mixtral, arctic) and hybrid (hymba) families against the
JAX package, on the CPU, in fp32 from JAX's parameters.

The router and the dispatch: `pick_groups` and `_group_dispatch` equal
JAX's bit for bit, the capacity-overflow probe included (the reference
writes its padding id over the last kept token of an overflowing expert,
and the port does the same, deterministically); `route_topk` picks the same
experts with JAX's tie order, its weights within 2e-7 relative and its aux
within 1e-6 (XLA:CPU's exp is not torch's: they differ in the last bit on
about one value in ten, and the mean over tokens reduces in another
order). `moe_apply` against JAX's and against tests/test_moe.py's
dense oracle without drops, and against JAX's with drops (capacity
factors 0.25 and the default 1.25), at 4 and 128 experts; its gradients
against jax.grad. Whole reduced models route every token of every layer
to the same experts as JAX's. The serving engine: mixtral's engine equals
JAX's engine with the same buckets (padding shares expert capacity, so
both must pad alike), and hymba's equals JAX's sequential generation at
the exact prompt length, since JAX's engine cannot serve the hybrid
family (its cache-row axis rule takes the conv leaf's layer axis); a
reused hybrid slot starts from zero SSM state. Parameter trees cross
`lm_params_from_numpy` bit for bit in bf16; the launchers run on the CPU.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import blocks as JB  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import blocks as B  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402


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


TOL = dict(rtol=2e-5, atol=2e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ROUTE_RTOL = 2e-7


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
    return np.asarray(x)


def _moe_cfgs(arch="mixtral-8x22b", **kw):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _moe_params(jcfg, seed=0):
    jp = jmoe.moe_params(jax.random.key(seed), jcfg)
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


def _x(cfg, shape=(2, 32), seed=1):
    x = np.random.default_rng(seed).normal(
        size=(*shape, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _bits_equal(a, b):
    a, b = _np(a), _np(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.int32) if a.dtype == np.float32 else a,
        b.view(np.int32) if b.dtype == np.float32 else b)


# -- the router and the dispatch ----------------------------------------------

@pytest.mark.parametrize("e", [4, 8, 128])
def test_route_topk_matches_jax(e):
    """Random logits with exact ties (a row of zeros, pairs of equal
    columns): the same experts in the same order as jax.lax.top_k (the
    lower index first on a tie), bit for bit; the weights within 2e-7
    relative, the aux within 1e-6."""
    rng = np.random.default_rng(e)
    lg = rng.normal(size=(96, e)).astype(np.float32)
    lg[:6] = 0.0
    lg[6:12, 1] = lg[6:12, 0]
    lg[12:18, e - 1] = lg[12:18, 2]
    jw, ji, ja = jax.jit(lambda a: jmoe.route_topk(a, 2))(jnp.asarray(lg))
    tw, ti, ta = moe.route_topk(torch.from_numpy(lg), 2)
    assert np.array_equal(_np(ti), np.asarray(ji))
    assert np.array_equal(_np(ti)[:6], np.tile([0, 1], (6, 1)))
    np.testing.assert_allclose(_np(tw), np.asarray(jw), rtol=ROUTE_RTOL,
                               atol=0)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-6)


def test_pick_groups_matches_jax():
    for t in (1, 7, 96, 100, 128, 4096, 65536):
        assert moe.pick_groups(t) == jmoe.pick_groups(t)
        assert moe.pick_groups(t, target=8) == jmoe.pick_groups(t, target=8)


@pytest.mark.parametrize("g,tg,k,e,cap", [(2, 32, 2, 4, 10), (3, 17, 1, 5, 2),
                                          (1, 40, 2, 8, 3), (4, 8, 2, 2, 5)])
def test_group_dispatch_matches_jax_bit_for_bit(g, tg, k, e, cap):
    """Buckets, combine indices and combine weights, with capacities from
    no drops to most entries dropped."""
    rng = np.random.default_rng(g * 100 + tg)
    f = jax.jit(jax.vmap(lambda i, w: jmoe._group_dispatch(i, w, cap, e)))
    for _ in range(5):
        idx = np.stack([np.stack([rng.choice(e, k, replace=False)
                                  for _ in range(tg)]) for _ in range(g)])
        w = rng.random((g, tg, k)).astype(np.float32)
        want = f(jnp.asarray(idx, jnp.int32), jnp.asarray(w))
        got = moe._group_dispatch(torch.from_numpy(idx), torch.from_numpy(w),
                                  cap, e)
        for a, b in zip(got, want):
            assert _bits_equal(a, b)


def test_overflow_probe_zeroes_the_last_kept_token_like_jax():
    """6 tokens, k = 1, 2 experts, capacity 2; tokens 0, 1, 2 and 4 go to
    expert 0. The reference's scatter writes the dropped entries' padding
    id over slot 1, which token 1 holds, yet its combine weight stays 1:
    token 1 gets exactly 0 from expert 0 in both packages, token 0 does
    not (ROADMAP.md section 3)."""
    idx = np.array([0, 0, 0, 1, 0, 1])[None, :, None]
    w = np.ones((1, 6, 1), np.float32)
    jb, jc, jw = jax.vmap(lambda i, ww: jmoe._group_dispatch(i, ww, 2, 2))(
        jnp.asarray(idx, jnp.int32), jnp.asarray(w))
    tb, tc, tw = moe._group_dispatch(torch.from_numpy(idx), torch.from_numpy(w),
                                     2, 2)
    assert np.asarray(jb).tolist() == _np(tb).tolist() == [[[0, 6], [3, 5]]]
    assert np.asarray(jc).tolist() == _np(tc).tolist() == [[0, 1, 1, 2, 1, 3]]
    assert np.asarray(jw).tolist() == _np(tw).tolist() == [[1, 1, 0, 1, 0, 1]]
    # the same routing through moe_apply: x[:, 0] = +1 routes to expert 0
    jcfg, cfg = _moe_cfgs(num_experts=2, experts_per_token=1,
                          moe_capacity_factor=0.5)
    jp, tp = _moe_params(jcfg)
    sign = np.array([1, 1, 1, -1, 1, -1], np.float32)
    x = np.random.default_rng(3).normal(size=(1, 6, cfg.d_model)).astype(
        np.float32) * 0.1
    x[0, :, 0] = sign * 10.0
    router = np.zeros((cfg.d_model, 2), np.float32)
    router[0] = [1.0, -1.0]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    jy, _ = jmoe.moe_apply(jnp.asarray(x), jp, jcfg, groups=1)
    ty, _ = moe.moe_apply(torch.from_numpy(x), tp, cfg, groups=1)
    for y in (np.asarray(jy), _np(ty)):
        assert not y[0, 1].any()
        assert np.abs(y[0, [0, 3, 5]]).min() > 0
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)


# -- moe_apply ------------------------------------------------------------------

def _dense_oracle(x, p, cfg):
    """tests/test_moe.py's oracle: every token through its top-k experts,
    no capacity."""
    xt = np.asarray(x).reshape(-1, cfg.d_model)
    logits = xt @ np.asarray(p["router"])
    w, idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits), -1),
                           cfg.experts_per_token)
    w = np.asarray(w / w.sum(-1, keepdims=True))
    idx = np.asarray(idx)
    y = np.zeros_like(xt)
    for e in range(cfg.num_experts):
        h = jax.nn.silu(xt @ p["w_gate"][e]) * (xt @ p["w_up"][e])
        ye = np.asarray(h @ p["w_down"][e])
        for kk in range(cfg.experts_per_token):
            m = idx[:, kk] == e
            y[m] += w[m, kk, None] * ye[m]
    return y


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_moe_apply_matches_jax_and_the_dense_oracle(groups):
    jcfg, cfg = _moe_cfgs(moe_capacity_factor=8.0)       # no drops
    jp, tp = _moe_params(jcfg)
    jx, tx = _x(cfg)
    jy, jaux = jmoe.moe_apply(jx, jp, jcfg, groups=groups)
    ty, taux = moe.moe_apply(tx, tp, cfg, groups=groups)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(_np(ty).reshape(-1, cfg.d_model),
                               _dense_oracle(jx, jp, jcfg), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("groups", [1, 2, 8, None])
@pytest.mark.parametrize("cf", [0.25, 1.25])
def test_moe_apply_with_drops_matches_jax(cf, groups):
    """Capacity factors 0.25 (most entries dropped) and 1.25 (the default:
    a few), groups given and picked (pick_groups)."""
    jcfg, cfg = _moe_cfgs(moe_capacity_factor=cf)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x(cfg)
    jy, jaux = jmoe.moe_apply(jx, jp, jcfg, groups=groups)
    ty, taux = moe.moe_apply(tx, tp, cfg, groups=groups)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)


def test_moe_apply_at_arctics_128_experts_matches_jax():
    jcfg, cfg = _moe_cfgs("arctic-480b", num_experts=128)
    jp, tp = _moe_params(jcfg)
    jx, tx = _x(cfg, shape=(2, 128))
    jy, _ = jmoe.moe_apply(jx, jp, jcfg)
    ty, _ = moe.moe_apply(tx, tp, cfg)
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **TOL)


def test_moe_gradients_match_jax():
    """d/d(x, params) of sum(y * r) + aux, with drops (factor 1.25)."""
    jcfg, cfg = _moe_cfgs()
    jp, tp = _moe_params(jcfg)
    jx, tx = _x(cfg)
    r = np.random.default_rng(4).normal(size=tx.shape).astype(np.float32)

    def jloss(x, p):
        y, aux = jmoe.moe_apply(x, p, jcfg)
        return (y * r).sum() + aux

    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jx, jp)
    tx.requires_grad_()
    tpr = {k: v.clone().requires_grad_() for k, v in tp.items()}
    y, aux = moe.moe_apply(tx, tpr, cfg)
    tgrads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + aux,
                                 [tx] + [tpr[k] for k in sorted(tpr)])
    np.testing.assert_allclose(_np(tgrads[0]), np.asarray(jgx), **TOL)
    for g, k in zip(tgrads[1:], sorted(tpr)):
        np.testing.assert_allclose(_np(g), np.asarray(jgp[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# -- whole models: the same experts as JAX's ------------------------------------

def _model(arch):
    jcfg = jax_get_config(arch).reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    return (jcfg, jp, get_config(arch).reduced(),
            lm_params_from_numpy(jax.tree.map(np.asarray, jp)))


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "arctic-480b"])
def test_models_route_every_token_like_jax(arch, monkeypatch):
    """Layer by layer over 2 x 64 tokens (JAX eagerly, so each layer's
    routing is read): the experts of every token in every layer are JAX's,
    at each package's own inputs, and the hidden states stay within 2e-5."""
    jcfg, jp, cfg, tp = _model(arch)
    routes = {"jax": [], "port": []}
    jroute, troute = jmoe.route_topk, moe.route_topk

    def rec(name, fn):
        def wrapped(logits, k):
            out = fn(logits, k)
            routes[name].append((np.asarray(_np(out[1])),
                                 np.sort(_np(logits), axis=-1)))
            return out
        return wrapped

    monkeypatch.setattr(jmoe, "route_topk", rec("jax", jroute))
    monkeypatch.setattr(moe, "route_topk", rec("port", troute))
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(2, 64))
    jx = JT._embed_tokens(jp, jnp.asarray(toks), jcfg)
    tx = T._embed_tokens(tp, torch.from_numpy(toks), cfg)
    rt, jrt = Runtime(attn_impl="naive"), JRuntime(attn_impl="naive")
    for i in range(cfg.num_layers):
        jx, _ = JB.moe_block(jx, jax.tree.map(lambda a: a[i], jp["blocks"]),
                             jcfg, jrt)
        tx, _ = B.moe_block(tx, T._layer(tp["blocks"], i), cfg, rt)
        np.testing.assert_allclose(_np(tx), np.asarray(jx), **TOL)
    assert len(routes["jax"]) == len(routes["port"]) == cfg.num_layers
    for (ji, jl), (ti, tl) in zip(routes["jax"], routes["port"]):
        assert np.array_equal(ji, ti)
        # the margin between each token's k-th and (k+1)-th logit, far
        # above the packages' difference in the logits themselves
        k = cfg.experts_per_token
        margin = float((jl[:, -k] - jl[:, -k - 1]).min())
        assert margin > 100 * float(np.abs(jl - tl).max())


# -- serving ----------------------------------------------------------------------

JRT = JRuntime(attn_impl="naive")
RT = Runtime(attn_impl="cuda")       # the kernel path's plain version here


def _jax_generate(jp, jcfg, prompt, new, max_seq):
    """Greedy sequential generation in JAX, prefilling prompt[:-1]."""
    cache = JT.init_cache(jcfg, 1, max_seq)
    _, cache = JT.prefill(jp, jnp.asarray(prompt[:-1])[None], cache, jcfg,
                          JRT, None)
    tok, pos, toks = int(prompt[-1]), len(prompt) - 1, []
    for _ in range(new):
        lg, cache = JT.decode_step(jp, jnp.asarray([[tok]], jnp.int32), cache,
                                   pos, jcfg, JRT)
        tok = int(lg[0].argmax())
        toks.append(tok)
        pos += 1
    return toks


def test_mixtral_engine_matches_jax_engine():
    """The same prompts, slots and buckets (prompts longer than 129 tokens
    prefill the kernel path's plain version): the port's engine gives JAX
    engine's tokens, slot for slot, with slots reused; the MoE block's aux
    never reaches the engine's cache."""
    jcfg, jp, cfg, tp = _model("mixtral-8x22b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 150, 7, 30, 200)]
    kw = dict(max_batch=2, max_seq=320, prompt_buckets=(32, 256))
    eng = ServingEngine(tp, cfg, rt=RT, device="cpu", **kw)
    jeng = JaxEngine(jp, jcfg, rt=JRT, **kw)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=4)
        jeng.submit(pr, max_new_tokens=4)
    done, jdone = eng.run_to_completion(), jeng.run_to_completion()
    assert len(done) == len(prompts)
    assert [(st.request.uid, st.slot, st.generated) for st in done] == \
        [(st.request.uid, st.slot, st.generated) for st in jdone]
    assert sorted(eng.cache) == ["k", "v"]


def test_hymba_engine_matches_jax_sequential_generation():
    """Exact-length prefill (as JAX's engine does for the hybrid family),
    prompts up to 257 tokens (past the reduced window of 64), a ragged 199
    and an even 256 prefilled through the kernel path's plain version,
    slots reused: each request's tokens
    equal JAX's sequential generation. JAX's own engine cannot serve the
    family: its row rule slices the conv leaf ['ssm']['conv'] on the
    layer axis (its path holds "ssm"), and the layer scan refuses."""
    jcfg, jp, cfg, tp = _model("hymba-1.5b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 257, 7, 200, 30)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=320, rt=RT,
                        device="cpu")
    for pr in prompts:
        eng.submit(pr, max_new_tokens=4)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    assert len({st.slot for st in done}) < len(done)      # slots reused
    for st in done:
        pr = prompts[st.request.uid]
        assert len(eng.prefill_tokens(pr)) == len(pr) - 1
        assert st.generated == _jax_generate(jp, jcfg, pr, 4, 320)
    jeng = JaxEngine(jp, jcfg, max_batch=2, max_seq=320, rt=JRT)
    jeng.submit(prompts[0], max_new_tokens=4)
    with pytest.raises(ValueError, match="leading axis"):
        jeng.run_to_completion()


def test_hybrid_ssm_state_is_not_carried_across_slot_reuse():
    """On a one-slot engine, a request admitted after another one starts
    from the state a fresh engine gives it: the slot's SSM state and conv
    window are zeroed at admission (the port's repair of the reference's
    carry-over, ROADMAP.md section 3), and equal JAX's prefill of the same
    tokens from a zero cache."""
    jcfg, jp, cfg, tp = _model("hymba-1.5b")
    rng = np.random.default_rng(7)
    first = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    engines = []
    for prompts in ((first, second), (second,)):
        eng = ServingEngine(tp, cfg, max_batch=1, max_seq=64, rt=RT,
                            device="cpu")
        for pr in prompts[:-1]:
            eng.submit(pr, max_new_tokens=4)
            eng.run_to_completion()
        eng.submit(prompts[-1], max_new_tokens=4)
        eng._admit()
        engines.append(eng)
    reused, fresh = (e.cache["ssm"] for e in engines)
    for name in ("ssm", "conv"):
        assert torch.equal(reused[name], fresh[name])
    jc = JT.init_cache(jcfg, 1, 64)
    _, jc = JT.prefill(jp, jnp.asarray(second[:-1])[None], jc, jcfg, JRT)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(_np(fresh[name]),
                                   np.asarray(jc["ssm"][name]), **TOL)
    assert float(np.abs(np.asarray(jc["ssm"]["ssm"])).max()) > 0


# -- parameters and launchers -------------------------------------------------------

@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b",
                                  "arctic-480b", "whisper-small",
                                  "llama-3.2-vision-90b"])
def test_lm_params_from_numpy_carries_the_trees(arch):
    """A JAX-initialised reduced model in bf16 (its fp32 router, norms,
    gates and SSM leaves kept): the same nesting, shapes, dtypes and bits;
    whisper's encoder and learned positions, llama-vision's self stack of
    [n_groups, k - 1, ...] beside its cross layers."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="bfloat16")
    jp = JT.init_params(jax.random.key(0), jcfg)
    tp = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        t = tp
        for key in path:
            t = t[key.key]
        a = np.asarray(leaf)
        assert str(t.dtype).split(".")[-1] == str(a.dtype), path
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.array_equal(bits.numpy(), a.view(np.int16) if
                              a.dtype.name == "bfloat16" else a), path
        n += 1
    assert n == len(jax.tree.leaves(jp))
    if jcfg.family == "audio":
        assert tp["enc_blocks"]["ln1_s"].dtype == torch.float32
        assert tp["pos_embed"].shape == (jcfg.max_seq, jcfg.d_model)
        assert tp["blocks"]["gate"].dtype == torch.float32
        assert tp["blocks"]["self"]["wq"].dtype == torch.bfloat16
    elif jcfg.family == "vlm":
        n_groups = jcfg.num_layers // jcfg.cross_attn_every
        assert tp["blocks"]["self"]["attn"]["wq"].shape[:2] == (
            n_groups, jcfg.cross_attn_every - 1)
        assert tp["blocks"]["cross"]["gate"].dtype == torch.float32
        assert tp["blocks"]["cross"]["cross"]["wk"].dtype == torch.bfloat16
        assert tp["vision_proj"].dtype == torch.bfloat16
    else:
        assert tp["blocks"]["moe" if jcfg.num_experts else "mixer"]
    if jcfg.num_experts:
        assert tp["blocks"]["moe"]["router"].dtype == torch.float32
        assert tp["blocks"]["moe"]["w_gate"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mixtral-8x22b"])
def test_launchers_run_on_the_cpu(arch, capsys):
    """The serve and train launchers on the reduced config: batched prefill
    and decode; masks and one masked-FedSGD step with a finite loss."""
    from repro_torch.launch import serve, train
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decode 2 steps" in out
    _, masks, losses = train.main(["--arch", arch, "--device", "cpu",
                                   "--steps", "1", "--seq", "32",
                                   "--batch", "2"])
    assert len(losses) == 1 and np.isfinite(losses[0])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out and "step   0 loss" in out
