"""The port's continuous-batching engine against the JAX package, on the
CPU, on reduced granite and mamba2 in fp32 (JAX's parameters, the same
numpy prompts).

The engine is held to JAX's sequential generation (the reference of
tests/test_serving.py): its tokens must equal JAX's, and the port's own
sequential path, fed JAX's tokens step by step, must give JAX's logits at
every step (1e-4: two layers and the vocab projection in a different
reduction order), so a near tie cannot decide the test. Slot reuse,
ragged positions and EOS as in the JAX package's tests, and the SSM
carry-over: the JAX engine carries a finished request's state into the
next request given the same slot (pinned with its size), the port's engine
does not.
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


JRT = JRuntime(attn_impl="naive")
RT = Runtime(attn_impl="cuda")       # the kernel path's plain version here
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
NEW = 6


def _model(arch):
    jcfg = jax_get_config(arch).reduced()
    jp = JT.init_params(jax.random.key(0), jcfg)
    return (jcfg, jp, get_config(arch).reduced(),
            lm_params_from_numpy(jax.tree.map(np.asarray, jp)))


def _jax_generate(jp, jcfg, prompt, new=NEW, max_seq=256):
    """tests/test_serving.py's _gen_ref, keeping each step's logits."""
    cache = JT.init_cache(jcfg, 1, max_seq)
    _, cache = JT.prefill(jp, jnp.asarray(prompt[:-1])[None], cache, jcfg,
                          JRT, None)
    tok, pos, toks, logits = int(prompt[-1]), len(prompt) - 1, [], []
    for _ in range(new):
        lg, cache = JT.decode_step(jp, jnp.asarray([[tok]], jnp.int32), cache,
                                   pos, jcfg, JRT)
        logits.append(np.asarray(lg[0]))
        tok = int(lg[0].argmax())
        toks.append(tok)
        pos += 1
    return toks, logits


def _port_logits(tp, cfg, prompt, tokens, max_seq=256):
    """The port's sequential path fed `tokens` (teacher forcing)."""
    cache = T.init_cache(cfg, 1, max_seq, device="cpu")
    T.prefill(tp, torch.from_numpy(prompt[:-1]).long()[None], cache, cfg, RT)
    feed, pos, out = [int(prompt[-1])] + tokens[:-1], len(prompt) - 1, []
    for tok in feed:
        lg, _ = T.decode_step(tp, torch.tensor([[tok]]), cache, pos, cfg, RT)
        out.append(lg[0].numpy())
        pos += 1
    return out


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_engine_matches_jax_sequential_generation(arch):
    jcfg, jp, cfg, tp = _model(arch)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (12, 20, 7, 30, 16)]
    eng = ServingEngine(tp, cfg, max_batch=3, max_seq=256, rt=RT,
                        prompt_buckets=(32,), device="cpu")
    for pr in prompts:
        eng.submit(pr, max_new_tokens=NEW)
    done = eng.run_to_completion()
    assert len(done) == len(prompts)
    by_uid = {st.request.uid: st.generated for st in done}
    for i, pr in enumerate(prompts):
        toks, jlogits = _jax_generate(jp, jcfg, pr)
        for a, b in zip(_port_logits(tp, cfg, pr, toks), jlogits):
            np.testing.assert_allclose(a, b, **LOGIT_TOL)
        assert by_uid[i] == toks, f"request {i}"


def test_bucketed_prefill_crosses_the_kernel_path():
    """Prompts longer than 129 tokens prefill a bucket past the naive
    rule's 128, so the engine's prefill goes through the kernel path (its
    plain version on the CPU); tokens still equal JAX's sequential
    generation."""
    jcfg, jp, cfg, tp = _model("granite-3-2b")
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (140, 200)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=320, rt=RT,
                        prompt_buckets=(256,), device="cpu")
    for pr in prompts:
        eng.submit(pr, max_new_tokens=4)
    by_uid = {st.request.uid: st.generated for st in eng.run_to_completion()}
    for i, pr in enumerate(prompts):
        assert len(eng.prefill_tokens(pr)) == 256
        assert by_uid[i] == _jax_generate(jp, jcfg, pr, new=4,
                                          max_seq=320)[0]


def test_slots_reused_and_ragged_positions_like_jax():
    jcfg, jp, cfg, tp = _model("granite-3-2b")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (5, 9, 13, 6, 11, 8)]
    eng = ServingEngine(tp, cfg, max_batch=2, max_seq=128, rt=RT,
                        prompt_buckets=(16,), device="cpu")
    jeng = JaxEngine(jp, jcfg, max_batch=2, max_seq=128, rt=JRT,
                     prompt_buckets=(16,))
    for pr in prompts:
        eng.submit(pr, max_new_tokens=4)
        jeng.submit(pr, max_new_tokens=4)
    done, jdone = eng.run_to_completion(), jeng.run_to_completion()
    assert len(done) == 6 and all(len(st.generated) == 4 for st in done)
    assert {st.slot for st in done} == {0, 1}
    # the same slot for every request, finished in the same order
    assert [(st.request.uid, st.slot, st.generated) for st in done] == \
        [(st.request.uid, st.slot, st.generated) for st in jdone]


def test_eos_stops_early():
    jcfg, jp, cfg, tp = _model("granite-3-2b")
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=10).astype(np.int32)
    eos = _jax_generate(jp, jcfg, prompt, new=1, max_seq=128)[0][0]
    eng = ServingEngine(tp, cfg, max_batch=1, max_seq=128, rt=RT,
                        prompt_buckets=(16,), device="cpu")
    eng.submit(prompt, max_new_tokens=16, eos_id=eos)
    done = eng.run_to_completion()
    assert len(done) == 1 and done[0].generated == [eos]


def test_temperature_sampling_follows_the_engine_seed():
    _, _, cfg, tp = _model("granite-3-2b")
    prompt = np.arange(1, 12, dtype=np.int32)
    runs = []
    for seed in (3, 3, 4):
        eng = ServingEngine(tp, cfg, max_batch=1, max_seq=64, rt=RT,
                            prompt_buckets=(16,), seed=seed, device="cpu")
        eng.submit(prompt, max_new_tokens=8, temperature=5.0)
        runs.append(eng.run_to_completion()[0].generated)
    assert runs[0] == runs[1] != runs[2]
    assert all(0 <= t < cfg.vocab_size for t in runs[0])


def _second_admission(engine_cls, params, cfg, first, second, **kw):
    """The slot's SSM state right after `second` is admitted, once behind
    `first` (4 new tokens) on a one-slot engine and once on a fresh one."""
    eng = engine_cls(params, cfg, max_batch=1, max_seq=64,
                     prompt_buckets=(32,), **kw)
    eng.submit(first, max_new_tokens=4)
    eng.run_to_completion()
    eng.submit(second, max_new_tokens=4)
    eng._admit()
    fresh = engine_cls(params, cfg, max_batch=1, max_seq=64,
                       prompt_buckets=(32,), **kw)
    fresh.submit(second, max_new_tokens=4)
    fresh._admit()
    return (np.asarray(eng.cache["ssm"], np.float32),
            np.asarray(fresh.cache["ssm"], np.float32))


def test_ssm_state_is_not_carried_across_slot_reuse():
    """The JAX engine prefills a request from its slot's cache row and
    never zeroes it, so a request that reuses a slot starts from the state
    the previous one left (reference behaviour, ROADMAP section 3). On
    reduced mamba2, after a 20-token request and 4 new tokens, a 5-token
    request's state differs from a fresh engine's by 5.62 max-abs, against
    state values up to 12.4. The port zeroes the slot's state at
    admission: its state equals a fresh engine's exactly, and JAX's fresh
    state."""
    jcfg, jp, cfg, tp = _model("mamba2-130m")
    rng = np.random.default_rng(7)
    first = rng.integers(0, cfg.vocab_size, size=20).astype(np.int32)
    second = rng.integers(0, cfg.vocab_size, size=5).astype(np.int32)
    j_reused, j_fresh = _second_admission(JaxEngine, jp, jcfg, first, second,
                                          rt=JRT)
    carried = float(np.abs(j_reused - j_fresh).max())
    assert carried > 1.0, carried                  # the reference carries
    assert np.abs(j_fresh).max() > 10.0
    t_reused, t_fresh = _second_admission(
        ServingEngine, tp, cfg, first, second, rt=RT, device="cpu")
    np.testing.assert_array_equal(t_reused, t_fresh)
    np.testing.assert_allclose(t_fresh, j_fresh, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "mamba2-130m"])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    """The port's launcher, with the JAX launcher's flags, on a reduced
    config: batched prefill then greedy decode steps."""
    from repro_torch.launch import serve
    serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "16",
                "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefill 2x16" in out and "decode 2 steps" in out
    ids = out.split("sample token ids:")[1]
    assert len(ids.strip().strip("[]").split(",")) == 3
