"""gemma2-9b served by the port's engine against the JAX package, on the
CPU, on reduced gemma2 in fp32 (window 64, one local and one global layer,
JAX's parameters, the same numpy prompts).

The engine is held to JAX's sequential generation (JT.prefill of the
exact prompt, then JT.decode_step): one prompt past the window prefills an
exact bucket, so its local layers' ring wraps before decode, and short
prompts prefill padded buckets in reused slots. The port's own sequential
path, fed JAX's tokens, must give JAX's logits at every step (1e-4), so a
near tie cannot decide the test.

A padded bucket longer than both the prompt and the window is a property
of the reference (ROADMAP section 3): `fill_ring` keeps the last `window`
positions of the padded prefill, so the local ring holds padding keys
where the prompt's should be, and the next logits differ from the exact
prefill's. The port keeps that behaviour; both packages leave the same ring
and give the same next logits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro.serving import ServingEngine as JaxEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
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


ARCH = "gemma2-9b"
JRT = JRuntime(attn_impl="naive")
RT = Runtime(attn_impl="cuda")       # the kernel path's plain version here
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEW = 5
MAX_SEQ = 192


@pytest.fixture(scope="module")
def model():
    jcfg = jax_get_config(ARCH).reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    cfg = get_config(ARCH).reduced()
    assert cfg.local_global and cfg.sliding_window == 64
    assert cfg.attn_softcap and cfg.final_softcap
    return jcfg, jp, cfg, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


def _jax_prefill(jp, jcfg, tokens, max_seq=MAX_SEQ):
    cache = JT.init_cache(jcfg, 1, max_seq)
    _, cache = JT.prefill(jp, jnp.asarray(tokens)[None], cache, jcfg, JRT,
                          None)
    return cache


def _jax_generate(jp, jcfg, prompt, new=NEW, tokens=None):
    """JAX's sequential generation of `prompt`, prefilling `tokens`
    (default: the exact prompt minus its last token); (tokens, logits of
    each step)."""
    tokens = prompt[:-1] if tokens is None else tokens
    cache = _jax_prefill(jp, jcfg, tokens)
    tok, pos, toks, logits = int(prompt[-1]), len(prompt) - 1, [], []
    for _ in range(new):
        lg, cache = JT.decode_step(jp, jnp.asarray([[tok]], jnp.int32), cache,
                                   pos, jcfg, JRT)
        logits.append(np.asarray(lg[0]))
        tok = int(lg[0].argmax())
        toks.append(tok)
        pos += 1
    return toks, logits


def _port_prefill(tp, cfg, tokens, max_seq=MAX_SEQ):
    cache = T.init_cache(cfg, 1, max_seq, device="cpu")
    T.prefill(tp, torch.from_numpy(np.asarray(tokens)).long()[None], cache,
              cfg, RT)
    return cache


def _port_logits(tp, cfg, prompt, tokens):
    """The port's sequential path (exact prefill) fed `tokens`."""
    cache = _port_prefill(tp, cfg, prompt[:-1])
    feed, pos, out = [int(prompt[-1])] + tokens[:-1], len(prompt) - 1, []
    for tok in feed:
        lg, _ = T.decode_step(tp, torch.tensor([[tok]]), cache, pos, cfg, RT)
        out.append(lg[0].numpy())
        pos += 1
    return out


def test_engine_matches_jax_sequential_past_the_window(model):
    """Five requests on two slots (three reuse a slot): one of 129 tokens
    whose 128-token prefill fills the 128 bucket exactly (past the 64-token
    window: the local ring wraps by 64 positions before decode, and the
    prefill crosses the naive rule into the kernel path), and four short
    prompts padded to the 32 bucket. Every request's tokens equal JAX's
    sequential generation over the exact prompt, and the port's own
    sequential path gives JAX's logits at every step."""
    jcfg, jp, cfg, tp = model
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (129, 12, 20, 7, 30)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=MAX_SEQ, rt=RT,
                        prompt_buckets=(32, 128), device="cpu")
    assert len(eng.prefill_tokens(prompts[0])) == 128 > cfg.sliding_window
    assert all(len(eng.prefill_tokens(p)) == 32 for p in prompts[1:])
    for pr in prompts:
        eng.submit(pr, max_new_tokens=NEW)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    slots = [st.slot for st in sorted(done, key=lambda st: st.request.uid)]
    assert len(set(slots)) == 2 < len(slots)            # slots reused
    by_uid = {st.request.uid: st.generated for st in done}
    for i, pr in enumerate(prompts):
        toks, jlogits = _jax_generate(jp, jcfg, pr)
        for a, b in zip(_port_logits(tp, cfg, pr, toks), jlogits):
            np.testing.assert_allclose(a, b, **LOGIT_TOL)
        assert by_uid[i] == toks, f"request {i}"


def test_ring_wraps_like_jax_after_an_exact_prefill(model):
    """The 128-token prefill leaves the local layers' ring (64 slots)
    holding positions 64..127 in ring order (slot p % 64 holds position p)
    and the global layers' cache the whole prompt, equal in both
    packages."""
    jcfg, jp, cfg, tp = model
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, size=128).astype(np.int32)
    jc, tc = _jax_prefill(jp, jcfg, tokens), _port_prefill(tp, cfg, tokens)
    for part in ("local", "global"):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(tc[part][leaf].numpy(),
                                       np.asarray(jc[part][leaf]),
                                       rtol=1e-5, atol=1e-5)
    assert tc["local"]["k"].shape[2] == cfg.sliding_window
    assert tc["global"]["k"].shape[2] == MAX_SEQ


def test_padded_prefill_past_the_window_matches_jax(model):
    """A 40-token prompt in a 96-token bucket (longer than the prompt and
    than the 64-token window): the engine prefills the padded bucket, so
    the local ring keeps positions 32..95, mostly padding, and the first
    decode step reads padding keys in the slots of positions 0..31. Both
    packages leave the same ring and give the same next logits (JAX's
    engine's cache and JAX's prefill of the same padded tokens); those
    logits differ from the exact prefill's, which is the reference's
    behaviour, kept by the port (ROADMAP section 3). The port's engine
    emits the same first token as JAX's engine."""
    jcfg, jp, cfg, tp = model
    prompt = np.random.default_rng(4).integers(
        0, cfg.vocab_size, size=41).astype(np.int32)
    eng = ServingEngine(tp, cfg, max_batch=1, max_seq=MAX_SEQ, rt=RT,
                        prompt_buckets=(96,), device="cpu")
    padded = eng.prefill_tokens(prompt)
    assert len(padded) == 96 > cfg.sliding_window > len(prompt) - 1
    jeng = JaxEngine(jp, jcfg, max_batch=1, max_seq=MAX_SEQ, rt=JRT,
                     prompt_buckets=(96,))
    eng.submit(prompt, max_new_tokens=1)
    jeng.submit(prompt, max_new_tokens=1)
    eng._admit()
    jeng._admit()
    for part in ("local", "global"):
        for leaf in ("k", "v"):
            np.testing.assert_allclose(eng.cache[part][leaf].numpy(),
                                       np.asarray(jeng.cache[part][leaf]),
                                       rtol=1e-5, atol=1e-5)
    pos = len(prompt) - 1
    jcache = _jax_prefill(jp, jcfg, padded)
    jlg, _ = JT.decode_step(jp, jnp.asarray([[int(prompt[-1])]], jnp.int32),
                            jcache, pos, jcfg, JRT)
    tcache = _port_prefill(tp, cfg, padded)
    tlg, _ = T.decode_step(tp, torch.tensor([[int(prompt[-1])]]), tcache,
                           pos, cfg, RT)
    np.testing.assert_allclose(tlg[0].numpy(), np.asarray(jlg[0]),
                               **LOGIT_TOL)
    exact = _jax_generate(jp, jcfg, prompt, new=1)[1][0]
    assert float(np.abs(np.asarray(jlg[0]) - exact).max()) > 1e-2
    first = eng.run_to_completion()[0].generated
    jfirst = jeng.run_to_completion()[0].generated
    assert first == jfirst == [int(np.asarray(jlg[0]).argmax())]
