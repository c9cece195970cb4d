"""qwen2.5-3b, yi-9b and arctic-480b through the port against the JAX
package, on the CPU, at reduced size in fp32.

Both packages initialise qwen's q/k/v biases to zero, so a model drawn by
either computes nothing through them. Here they are drawn non-zero with
numpy and carried into both packages through `repro_torch.convert`, and
every qwen case runs on those biases: the prefill and decode logits, the
train step's loss, gradient and update, and the masks (the biases are
prunable: no name in PROTECTED_SUBSTRINGS matches them). The engines of
reduced qwen, yi and arctic (128 experts of top 2, the dense residual MLP)
are held to JAX's sequential generation over the same (padded) prefill.

Tolerances as in tests/test_torch_lm.py and tests/test_torch_lm_train.py:
1e-4 on logits through a whole model, 1e-5 relative on losses and relative
L2 on gradient and parameter trees; masks and tokens exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.core import pruning as jpruning  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core import pruning  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.models.layers import dense_init  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
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


MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
RTOL = 1e-5
SEQ, BATCH, CHUNK = 128, 2, 32
BIASES = ("bq", "bk", "bv")
# arctic reduced in width (d_model 128) but with all its 128 experts
REDUCED = {"arctic-480b": dict(d_model=128, experts=128)}


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x)


def _rel_l2(got, want) -> float:
    num = sum(float(((_np(g).astype(np.float64)
                      - np.asarray(w, np.float64)) ** 2).sum())
              for g, w in zip(got, want))
    den = sum(float((np.asarray(w, np.float64) ** 2).sum()) for w in want)
    return (num / den) ** 0.5


def _model(arch, bias_scale=1.0):
    """(JAX config, port config, JAX params, port params) from JAX's
    reduced init; a model with q/k/v biases gets them drawn standard normal
    times `bias_scale` (numpy seed 11) in both packages."""
    kw = REDUCED.get(arch, {})
    jcfg = jax_get_config(arch).reduced(**kw)
    cfg = get_config(arch).reduced(**kw)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.key(0), jcfg))
    attn = tree["blocks"].get("attn", {})
    rng = np.random.default_rng(11)
    for name in BIASES:
        if name in attn:
            attn[name] = (bias_scale * rng.normal(
                size=attn[name].shape)).astype(attn[name].dtype)
    return (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
            lm_params_from_numpy(tree))


def _zero_bias(tp):
    attn = {k: torch.zeros_like(v) if k in BIASES else v
            for k, v in tp["blocks"]["attn"].items()}
    return {**tp, "blocks": {**tp["blocks"], "attn": attn}}


def _tokens(cfg, seed=0, batch=BATCH, seq=SEQ):
    t = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, seq + 1)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def test_qwen_biases_are_drawn_and_move_the_logits():
    """The drawn biases are non-zero in both trees, equal bit for bit, and
    zeroing them moves the port's prefill logits far past the 1e-4 the
    comparisons below allow."""
    jcfg, cfg, jp, tp = _model("qwen2.5-3b")
    for name in BIASES:
        t, j = tp["blocks"]["attn"][name], jp["blocks"]["attn"][name]
        assert t.shape == (cfg.num_layers, cfg.q_dim if name == "bq"
                           else cfg.kv_dim)
        assert float(t.abs().min()) > 0
        np.testing.assert_array_equal(_np(t), np.asarray(j))
    toks = torch.from_numpy(_tokens(cfg)[0]).long()
    rt = Runtime(attn_impl="cuda")

    def last(p):
        return T.prefill(p, toks, T.init_cache(cfg, BATCH, SEQ,
                                               device="cpu"), cfg, rt)[0]

    with_bias = last(tp)
    rel = float((last(_zero_bias(tp)) - with_bias).norm() / with_bias.norm())
    assert rel > 1e-2


def test_qwen_prefill_and_decode_with_biases_match_jax():
    """forward, prefill over 256 tokens (the kernel path's plain version)
    and four decode steps, logits and the whole cache against JAX's."""
    jcfg, cfg, jp, tp = _model("qwen2.5-3b")
    rt, jrt = Runtime(attn_impl="cuda"), JRuntime(attn_impl="pallas")
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(2, 260)).astype(np.int32)
    jt, tt = jnp.asarray(toks), torch.from_numpy(toks).long()
    np.testing.assert_allclose(_np(T.forward(tp, tt[:, :40], cfg, rt)),
                               np.asarray(JT.forward(jp, jt[:, :40], jcfg,
                                                     jrt)), **MODEL_TOL)
    jc = JT.init_cache(jcfg, 2, 320)
    tc = T.init_cache(cfg, 2, 320, device="cpu")
    jl, jc = JT.prefill(jp, jt[:, :256], jc, jcfg, jrt)
    tl, tc = T.prefill(tp, tt[:, :256], tc, cfg, rt)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **MODEL_TOL)
    for pos in range(256, 260):
        jl, jc = JT.decode_step(jp, jt[:, pos:pos + 1], jc, pos, jcfg, jrt)
        tl, tc = T.decode_step(tp, tt[:, pos:pos + 1], tc, pos, cfg, rt)
        np.testing.assert_allclose(_np(tl), np.asarray(jl), **MODEL_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tc[name]), np.asarray(jc[name]),
                                   **MODEL_TOL)


def _train_runtimes(jcfg, cfg):
    """specialize's train runtime (flash_vjp, remat, loss chunks) in both
    packages, chunks cut to the test's length."""
    small = dict(q_chunk=CHUNK, kv_chunk=CHUNK, loss_chunk=CHUNK)
    jrt = jsteps.specialize(jcfg, JAX_SHAPES["train_4k"])[1]
    rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])[1]
    return dataclasses.replace(jrt, **small), dataclasses.replace(rt, **small)


def _masks(tp, jp, lam=0.3, seed=0):
    """The same random uint8 masks in both packages over the prunable
    leaves (the biases among them)."""
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


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "yi-9b"])
def test_train_step_matches_jax(arch):
    """The loss and gradient tree against jax.value_and_grad under the
    train runtime, then one masked-FedSGD step against JAX's jitted step:
    the loss, the update and the new parameters, pruned coordinates (qwen's
    bias coordinates among them) unchanged bit for bit."""
    jcfg, cfg, jp, tp = _model(arch)
    jrt, rt = _train_runtimes(jcfg, cfg)
    toks, labs = _tokens(cfg)
    jl, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(toks),
                                            jnp.asarray(labs), jcfg, jrt)
    tl, tg = steps.value_and_grad(lambda p: T.loss_fn(
        p, torch.from_numpy(toks), torch.from_numpy(labs), cfg, rt), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    assert _rel_l2(leaves(tg), [np.asarray(x) for x in
                                jax.tree.leaves(jg)]) < RTOL
    if cfg.qkv_bias:                     # a live bias has a gradient
        assert all(float(tg["blocks"]["attn"][b].abs().max()) > 0
                   for b in BIASES)

    jm, tm = _masks(tp, jp)
    kw = dict(eta=0.5, microbatches=1, structured_lambda=0.0)
    batch = {"tokens": toks, "labels": labs}
    jl, jnew = jax.jit(jsteps.make_train_step(jcfg, jrt, **kw))(
        jp, jm, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tnew = steps.make_train_step(cfg, rt, **kw)(
        tp, tm, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    jleaves = [np.asarray(x) for x in jax.tree.leaves(jnew)]
    moved = [a - np.asarray(b) for a, b in zip(jleaves, jax.tree.leaves(jp))]
    assert _rel_l2([_np(a) - _np(b) for a, b in zip(leaves(tnew),
                                                    leaves(tp))],
                   moved) < 1e-4
    assert _rel_l2(leaves(tnew), jleaves) < RTOL
    for new, old, m in zip(leaves(tnew), leaves(tp), leaves(tm)):
        pruned = m == 0
        assert torch.equal(new[pruned].view(torch.int32),
                           old[pruned].view(torch.int32))


@pytest.mark.parametrize("lam", [0.3, 0.7])
def test_qwen_bias_masks_match_jax(lam):
    """Taylor importance of the same gradient (JAX's, on a batch under the
    naive runtime) and the masks at lam in both packages: every mask bit
    equal, the bias leaves' included, with some bias coordinates kept and
    some pruned."""
    jcfg, cfg, jp, tp = _model("qwen2.5-3b")
    toks, labs = _tokens(cfg, seed=3)
    _, jg = jax.value_and_grad(JT.loss_fn)(jp, jnp.asarray(toks),
                                           jnp.asarray(labs), jcfg,
                                           JRuntime(attn_impl="naive"))
    tg = lm_params_from_numpy(jax.tree.map(np.asarray, jg))
    jm = jpruning.build_masks(jpruning.taylor_importance(jp, jg), lam)
    tm = pruning.build_masks(pruning.taylor_importance(tp, tg), lam)
    jflat = {jax.tree_util.keystr(kp): np.asarray(m) for kp, m in
             jax.tree_util.tree_flatten_with_path(jm)[0]}
    for path, m in flatten_with_path(tm):
        np.testing.assert_array_equal(_np(m).astype(bool),
                                      jflat[path].astype(bool), err_msg=path)
    bias = np.concatenate([_np(tm["blocks"]["attn"][b]).reshape(-1)
                           for b in BIASES]).astype(bool)
    assert 0 < bias.sum() < bias.size
    assert all(pruning.default_prunable(p) for p, _ in flatten_with_path(tm)
               if p.endswith(("['bq']", "['bk']", "['bv']")))


JRT = JRuntime(attn_impl="naive")
RT = Runtime(attn_impl="cuda")       # the kernel path's plain version here
# JAX's prefill and decode step jitted as its engine jits them (one
# compile a prefill length, the decode position traced)
JPREFILL = jax.jit(JT.prefill, static_argnums=(3, 4))
JDECODE = jax.jit(JT.decode_step, static_argnums=(4, 5))


def _jax_generate(jp, jcfg, prefill, last, pos, new, max_seq):
    """JAX's greedy sequential generation over `prefill` (the engine's
    padded prefill tokens), then decode from `last` at `pos`; each step's
    logits kept."""
    cache = JT.init_cache(jcfg, 1, max_seq)
    _, cache = JPREFILL(jp, jnp.asarray(prefill)[None], cache, jcfg, JRT,
                        None)
    tok, toks, logits = last, [], []
    for _ in range(new):
        lg, cache = JDECODE(jp, jnp.asarray([[tok]], jnp.int32), cache,
                            jnp.int32(pos), jcfg, JRT)
        logits.append(np.asarray(lg[0]))
        tok = int(lg[0].argmax())
        toks.append(tok)
        pos += 1
    return toks, logits


def _port_logits(tp, cfg, prefill, last, pos, tokens, max_seq):
    """The port's sequential path over the same prefill, fed `tokens`."""
    cache = T.init_cache(cfg, 1, max_seq, device="cpu")
    T.prefill(tp, torch.from_numpy(prefill).long()[None], cache, cfg, RT)
    out = []
    for tok in [last] + tokens[:-1]:
        lg, _ = T.decode_step(tp, torch.tensor([[tok]]), cache, pos, cfg, RT)
        out.append(lg[0].numpy())
        pos += 1
    return out


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "yi-9b", "arctic-480b"])
def test_engine_matches_jax_sequential_generation(arch):
    """Five prompts on two slots (slots reused), buckets 32 and 256 (the
    prompts past 129 tokens prefill the kernel path's plain version):
    every request's tokens equal JAX's sequential generation over the
    engine's own padded prefill (arctic's padding shares expert capacity
    with the prompt), and the port's sequential path fed JAX's tokens
    gives JAX's logits at every step, so a near tie cannot decide it."""
    jcfg, cfg, jp, tp = _model(arch)
    new, max_seq = 4, 320
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 150, 7, 30, 200)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=max_seq, rt=RT,
                        prompt_buckets=(32, 256), device="cpu")
    for pr in prompts:
        eng.submit(pr, max_new_tokens=new)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    assert len({st.slot for st in done}) == 2
    by_uid = {st.request.uid: st.generated for st in done}
    for i, pr in enumerate(prompts):
        pre, last, pos = eng.prefill_tokens(pr), int(pr[-1]), len(pr) - 1
        toks, jlogits = _jax_generate(jp, jcfg, pre, last, pos, new, max_seq)
        for a, b in zip(_port_logits(tp, cfg, pre, last, pos, toks, max_seq),
                        jlogits):
            np.testing.assert_allclose(a, b, **MODEL_TOL)
        assert by_uid[i] == toks, f"request {i}"


def test_dense_init_is_the_scaled_draw_cast():
    """dense_init scales its fp32 draw in place (one fp32 copy on the
    device at a time): the same bits as the draw times the scale, cast."""
    shape = (3, 64, 48)
    got = dense_init(torch.Generator().manual_seed(5), 64, shape, "cpu",
                     torch.bfloat16)
    draw = torch.randn(shape, generator=torch.Generator().manual_seed(5))
    want = (draw * (1.0 / np.sqrt(64))).to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
