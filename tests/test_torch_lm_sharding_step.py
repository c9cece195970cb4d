"""The port's sharded masked-FedSGD train step (sharding/rules.py on
DTensor) on 8 gloo ranks (4 x 2, CPU) against the JAX package's unsharded
step and the port's, and its sharded prefill and decode against its
unsharded ones.

One spawn runs every case: reduced fp32 granite (naive attention),
reduced mixtral (expert parallel) in one batch and in two microbatches
(each rank's rows of JAX's global cut, brought by an all-to-all), a GQA
granite with one KV head, fewer than the model axis's 2 ranks (the
training runtime: flash_vjp under local_map, remat, chunked loss),
reduced mamba2 (the SSD scan under local_map) and reduced hymba (heads
that do not split, the SSM beside them). Each is held against JAX's
unsharded step from the same numpy parameters at JAX's own tolerances
(loss rtol 2e-4, parameters max-abs 5e-4: tests/test_system.py), and
against the port's unsharded step at loss rtol 1e-6, parameters max-abs
1e-6: the mesh only reorders fp32 sums (the data ranks' gradient partials
are reduce-scattered), which moves a gradient by a few ulps, scaled by
eta = 1e-2 in the update (1.5e-8 read); a wrong gradient placement reads
3e-5 (the MoE down product's, before its partial sum over the data axis
was declared), and microbatches cut on each rank's own rows (not JAX's
global cut) give mixtral's loss a relative 1.2e-5 (its load-balance loss
and capacity see other tokens together).

The same spawn serves reduced granite, gemma2 (its local layers' ring
filled from the prompt) and mixtral: a prefill and two decode steps with
the cache's sequence split on the model axis, every logit and cache entry
within 1e-5 of its peak of the unsharded run's (the cache written through
DTensor's setitem lost its writes: logits off by 1.7).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.blocks import Runtime as JRuntime  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.registry import INPUT_SHAPES, InputShape  # noqa: E402,E501
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.mesh import spawn_shards  # noqa: E402
from repro_torch.models.blocks import Runtime  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import flatten_with_path, tree_map  # noqa: E402

import _torch_lm_shards as shards  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


SEQ, BATCH = 64, 8


def _case(arch, seed, *, kv_heads=None, train_rt=False, microbatches=1):
    """(port case, JAX config, JAX runtime) from JAX's parameters."""
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(
        layers=2, d_model=256), dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(
        layers=2, d_model=256), dtype="float32")
    if kv_heads:
        jcfg = dataclasses.replace(jcfg, num_kv_heads=kv_heads)
        cfg = dataclasses.replace(cfg, num_kv_heads=kv_heads)
    if train_rt:
        small = dict(q_chunk=32, kv_chunk=32, loss_chunk=32)
        jrt = dataclasses.replace(jsteps.specialize(
            jcfg, JAX_SHAPES["train_4k"])[1], **small)
        rt = dataclasses.replace(steps.specialize(
            cfg, INPUT_SHAPES["train_4k"])[1], **small)
    else:
        jrt, rt = JRuntime(attn_impl="naive"), Runtime(attn_impl="naive")
    jp = jax.tree.map(np.asarray, JT.init_params(jax.random.key(seed),
                                                 jcfg))
    rng = np.random.default_rng(seed)
    masks = jax.tree.map(lambda w: (rng.random(w.shape) > 0.3).astype(
        np.uint8), jp)
    t = rng.integers(0, cfg.vocab_size, (BATCH, SEQ + 1)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    return (arch, cfg, rt, jp, masks, batch, microbatches), jcfg, jrt


CASES = {"granite": dict(arch="granite-3-2b", seed=0),
         "mixtral": dict(arch="mixtral-8x22b", seed=1),
         "mixtral-mb2": dict(arch="mixtral-8x22b", seed=5, microbatches=2),
         "granite-gqa": dict(arch="granite-3-2b", seed=2, kv_heads=1,
                             train_rt=True),
         "mamba2": dict(arch="mamba2-130m", seed=3),
         "hymba": dict(arch="hymba-1.5b", seed=4, train_rt=True)}


# serving: a prompt of PROMPT tokens, then DECODE steps, against a cache of
# CACHE slots (gemma2's local layers keep a ring of its reduced window, 64
# slots, which the prompt wraps)
PROMPT, DECODE, CACHE = 96, 2, 128
SERVE = {"granite": dict(arch="granite-3-2b", seed=6),
         "gemma2": dict(arch="gemma2-9b", seed=7),
         "mixtral": dict(arch="mixtral-8x22b", seed=8)}


def _serve_case(name, arch, seed):
    """A serving case for shards.serve_cases: reduced fp32 parameters, the
    prefill and decode runtimes of specialize with chunks of 32."""
    cfg = dataclasses.replace(get_config(arch).reduced(
        layers=2, d_model=256), dtype="float32")
    rts = [dataclasses.replace(steps.specialize(
        cfg, InputShape("s", CACHE, BATCH, kind))[1], q_chunk=32,
        kv_chunk=32) for kind in ("prefill", "decode")]
    params = T.init_params(torch.Generator().manual_seed(seed), cfg,
                           device="cpu")
    rng = np.random.default_rng(seed)
    prompt = rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    new = rng.integers(0, cfg.vocab_size, (DECODE, BATCH, 1)).astype(
        np.int32)
    return (name, cfg, *rts, tree_map(lambda w: w.numpy(), params), prompt,
            new, CACHE)


@pytest.fixture(scope="module")
def sharded_runs():
    """Every case on 8 gloo ranks in one spawn, and JAX's unsharded steps
    on the same numpy inputs."""
    built = {name: _case(**kw) for name, kw in CASES.items()}
    cases = [(name,) + c[0][1:] for name, c in built.items()]
    port, serve = spawn_shards(shards.run_cases, 8, args=(
        cases, [_serve_case(name, **kw) for name, kw in SERVE.items()]),
        device="cpu", timeout_s=300)[0]
    out = {}
    for name, (case, jcfg, jrt) in built.items():
        _, _, _, jp, masks, batch, mb = case
        step = jax.jit(jsteps.make_train_step(jcfg, jrt, microbatches=mb))
        jl, jn = step(jax.tree.map(jnp.asarray, jp),
                      jax.tree.map(jnp.asarray, masks),
                      {k: jnp.asarray(v) for k, v in batch.items()})
        out[name] = (port[name], float(jl),
                     [np.asarray(x) for x in jax.tree.leaves(jn)], case)
    return out, serve


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax_unsharded(sharded_runs, name):
    """JAX's own tolerances for its sharded step (tests/test_system.py)."""
    port, jloss, jnew, _ = sharded_runs[0][name]
    np.testing.assert_allclose(port["loss"], jloss, rtol=2e-4)
    assert len(port["new"]) == len(jnew)
    d = max(float(np.abs(a - b).max()) for a, b in zip(port["new"], jnew))
    assert d < 5e-4, d


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_the_ports_unsharded_step(sharded_runs, name):
    """Tighter, inside the port (module docstring); the new parameters
    keep their placements (the update works on the local shards)."""
    port = sharded_runs[0][name][0]
    np.testing.assert_allclose(port["loss"], port["loss_unsharded"],
                               rtol=1e-6)
    d = max(float(np.abs(a - b).max())
            for a, b in zip(port["new"], port["new_unsharded"]))
    assert d < 1e-6, d
    assert port["placements_kept"]


def test_sharded_step_moves_the_parameters(sharded_runs):
    """The comparisons above are not vacuous: the step changes unpruned
    coordinates by more than the tolerances."""
    port, _, _, case = sharded_runs[0]["granite"]
    before = [np.asarray(v, np.float32) for _, v in flatten_with_path(
        lm_params_from_numpy(case[3]))]
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(port["new"], before))
    assert moved > 1e-4


@pytest.mark.parametrize("name", list(SERVE))
def test_sharded_prefill_and_decode_match_the_unsharded_run(sharded_runs,
                                                            name):
    """Prefill and two decode steps on the 4 x 2 mesh (the cache's
    sequence sharded on the model axis, the KV heads whole on each rank,
    gemma2's ring filled on local shards) against the unsharded run on the
    same tensors: every logit, and the cache written in place, within
    1e-5 of its peak (the mesh reorders fp32 sums only)."""
    got, want, cache, cache0 = sharded_runs[1][name]
    assert len(got) == len(want) == 1 + DECODE
    for a, b in zip(got, want):
        assert a.shape == b.shape and np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-5 * np.abs(b).max()
    assert len(cache) == len(cache0)
    for a, b in zip(cache, cache0):
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1.0)
    assert any(np.abs(b).max() > 0 for b in cache0)
