"""The LM half of sharding in the port (sharding/rules.py, the model's
constraints, launch/dryrun.py) against the JAX package, on the CPU.

* The partition rules leaf by leaf: `param_specs` for every config, train
  and serve, on the 16x16 and 2x16x16 production meshes and the tests' 4x2,
  and `batch_spec` / `cache_specs` for every applicable input shape, equal
  JAX's PartitionSpecs built on ``jax.sharding.AbstractMesh`` in this
  process (no devices are forced).
* The dry run's per-device input bytes equal the sum of JAX's local shard
  bytes under JAX's specs, for every applicable (arch, shape) at both
  production meshes (arithmetic only).
* The dry run end to end (`lower_step` / `run_one`) on a fake process group
  of 8 at ``REPRO_FORCE_MESH=4,2`` for the JAX test suite's six pairs,
  reduced (layers 2, d_model 256), including the three whose JAX dry runs
  fail to compile on the CPU under JAX 0.9.
* A 1x1 mesh is bit for bit the unsharded step; `constrain` is the
  identity off a mesh and places a DTensor as JAX's constraint would.

The sharded step on 8 gloo ranks is tests/test_torch_lm_sharding_step.py.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.registry import INPUT_SHAPES as JAX_SHAPES  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.sharding import rules as jrules  # noqa: E402
from repro_torch.configs import get_config, list_configs  # noqa: E402
from repro_torch.configs.registry import (INPUT_SHAPES, InputShape,  # noqa: E402
                                          shape_applicable)
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.tree import flatten_with_path, unflatten  # noqa: E402

import _torch_lm_shards as shards  # noqa: E402


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test: the suite runs in parallel
    workers beside XLA's thread pools."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture
def no_group():
    """Leave no process group behind: the dry run makes a fake one in
    this process, and the round engine reads a live default group as a
    sharded run."""
    yield
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
ARCHS = list_configs()


def _meshes(name):
    sizes, names = MESHES[name]
    return AbstractMesh(sizes, names), rules.MeshShape(names, sizes)


def _jax_spec_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, P))[0]
    return [(jax.tree_util.keystr(kp), tuple(s)) for kp, s in flat]


def _port_spec_leaves(tree):
    return [(p, tuple(s)) for p, s in rules.spec_leaves(tree)]


_JAX_SHAPES_CACHE = {}


def _jax_param_shapes(arch):
    if arch not in _JAX_SHAPES_CACHE:
        _JAX_SHAPES_CACHE[arch] = JT.param_shapes(jax_get_config(arch))
    return _JAX_SHAPES_CACHE[arch]


# -- the rules, leaf by leaf ----------------------------------------------------

def test_port_arch_list_is_jax_s():
    from repro.configs.registry import list_configs as jax_list
    assert ARCHS == jax_list() and len(ARCHS) == 10


@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, mesh, mode):
    """Every parameter leaf's spec, and the serve policy's FSDP decision."""
    amesh, mshape = _meshes(mesh)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jpol = jrules.make_policy(jcfg, amesh, mode)
    pol = rules.make_policy(cfg, mshape, mode)
    assert pol.fsdp == jpol.fsdp
    want = _jax_spec_leaves(jrules.param_specs(jcfg, jpol,
                                               _jax_param_shapes(arch)))
    got = _port_spec_leaves(rules.param_specs(cfg, pol))
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_match_jax(arch, mesh):
    """batch_spec of every input of every applicable shape, and cache_specs
    of the prefill and decode shapes' caches."""
    amesh, mshape = _meshes(mesh)
    jcfg0, cfg0 = jax_get_config(arch), get_config(arch)
    checked = 0
    for name, shape in INPUT_SHAPES.items():
        if not shape_applicable(cfg0, shape)[0]:
            continue
        jcfg, jrt = jsteps.specialize(jcfg0, JAX_SHAPES[name])
        cfg, rt = steps.specialize(cfg0, shape)
        mode = "train" if shape.kind == "train" else "serve"
        jpol = jrules.make_policy(jcfg, amesh, mode)
        pol = rules.make_policy(cfg, mshape, mode)
        jbatch = jsteps.batch_specs(jcfg, JAX_SHAPES[name],
                                    with_labels=shape.kind == "train")
        batch = steps.batch_specs(cfg, shape,
                                  with_labels=shape.kind == "train")
        assert list(batch) == list(jbatch)
        for k, v in batch.items():
            assert tuple(v.shape) == tuple(jbatch[k].shape)
            assert tuple(rules.batch_spec(v.shape[0], pol, rank=v.ndim)) == \
                tuple(jrules.batch_spec(v.shape[0], jpol,
                                        rank=len(jbatch[k].shape)))
        if shape.kind == "train":
            continue
        jcache = jax.eval_shape(lambda: JT.init_cache(
            jcfg, shape.global_batch, shape.seq_len, swa_only=jrt.swa_only))
        cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                             swa_only=rt.swa_only, device="meta")
        want = _jax_spec_leaves(jrules.cache_specs(jcfg, jpol, jcache,
                                                   shape.global_batch))
        got = _port_spec_leaves(rules.cache_specs(cfg, pol, cache,
                                                  shape.global_batch))
        assert got == want
        checked += 1
    assert checked >= 2


def test_specs_compare_as_jax_partition_specs():
    """The spec type's own contract: JAX's tuple form, one-name tuples
    normalised, the empty spec replicated; placements per mesh dim, two
    mesh dims on one tensor dim major first."""
    from torch.distributed.tensor import Replicate, Shard
    assert rules.Spec(("data",), None, "model") == \
        tuple(P(("data",), None, "model"))
    assert rules.Spec(("pod", "data"), None) == tuple(P(("pod", "data"),
                                                        None))
    assert rules.Spec() == tuple(P())
    three = rules.MeshShape(("pod", "data", "model"), (2, 16, 16))
    assert rules.placements(rules.Spec(None, ("pod", "data"), "model"),
                            three) == (Shard(1), Shard(1), Shard(2))
    assert rules.placements(rules.Spec(), three) == (Replicate(),) * 3
    assert rules.local_shape((4, 64, 32), rules.Spec(
        None, ("pod", "data"), "model"), three) == (4, 2, 2)


def test_param_shardings_place_granite_on_the_production_mesh(no_group):
    """DTensor placements of every leaf over a 16 x 16 DeviceMesh (a fake
    world of 256): Shard(d) on the mesh dim its spec names, major first;
    the local shard of each leaf the rules' local shape."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard
    dryrun.fake_world(256)
    mesh = init_device_mesh("cpu", (16, 16), mesh_dim_names=("data",
                                                              "model"))
    cfg = get_config("granite-3-2b")
    pol = rules.make_policy(cfg, mesh, "train")
    shard = dict(flatten_with_path(rules.param_shardings(cfg, pol),
                                   is_leaf=lambda x: isinstance(x, tuple)))
    assert shard["['blocks']['attn']['wq']"] == (Shard(1), Shard(2))
    assert shard["['blocks']['attn']['wo']"] == (Shard(2), Shard(1))
    assert shard["['embed']"] == (Replicate(), Shard(1))    # 49155 % 16
    assert shard["['final_norm']"] == (Replicate(), Replicate())
    meta = rules.param_shapes(cfg)
    dist_meta = rules.distribute(meta, rules.param_specs(cfg, pol), mesh)
    for (path, w), (_, spec) in zip(flatten_with_path(dist_meta),
                                    rules.spec_leaves(rules.param_specs(
                                        cfg, pol))):
        assert tuple(w.placements) == shard[path]
        assert tuple(w.to_local().shape) == rules.local_shape(
            w.shape, spec, mesh)


@pytest.mark.parametrize("hq,hkv,rep,sharded", [
    (32, 8, 2, True),    # granite at 16: one KV head for two ranks
    (32, 32, 1, True),
    (48, 8, 2, True),    # mixtral
    (25, 5, 1, False),   # hymba: 25 heads do not split 16 ways
    (56, 8, 1, False),   # arctic
    (16, 2, 8, True),
])
def test_head_layout_gives_each_rank_the_kv_head_its_queries_read(
        hq, hkv, rep, sharded):
    """On 16 model ranks, rank i's query heads [i*Hq/16, (i+1)*Hq/16) read
    KV head h // (Hq/Hkv); with the repeat, rank i holds KV head i // r."""
    from torch.distributed.tensor import Shard
    mesh = rules.MeshShape(("data", "model"), (16, 16))
    pl, r = rules.head_layout(mesh, 256, hq, hkv)
    assert (r, pl[1] == Shard(2)) == (rep, sharded)
    assert pl[0] == Shard(0)
    if sharded:
        per, g = hq // 16, hq // hkv
        for i in range(16):
            groups = {h // g for h in range(i * per, (i + 1) * per)}
            if r > 1:
                assert groups == {i // r}
            else:
                assert groups <= set(range(i * hkv // 16,
                                           (i + 1) * hkv // 16))


# -- the dry run ----------------------------------------------------------------

def _jax_local_bytes(tree, specs, sizes: dict) -> int:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sp = [s for _, s in _jax_spec_leaves(specs)]
    total = 0
    for (_, leaf), spec in zip(flat, sp):
        shape = list(leaf.shape)
        for d, e in enumerate(spec):
            if e is not None:
                names = e if isinstance(e, tuple) else (e,)
                shape[d] //= math.prod(sizes[n] for n in names)
        total += math.prod(shape) * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_input_bytes_match_jax(arch, mesh):
    """Per-device bytes of params, masks, batch and cache: the port's
    record against JAX's specs applied to JAX's abstract inputs."""
    amesh, mshape = _meshes(mesh)
    sizes = dict(zip(mshape.axis_names, mshape.sizes))
    for name, shape in INPUT_SHAPES.items():
        cfg0 = get_config(arch)
        if not shape_applicable(cfg0, shape)[0]:
            continue
        cfg, rt = steps.specialize(cfg0, shape)
        jcfg, jrt = jsteps.specialize(jax_get_config(arch), JAX_SHAPES[name])
        got = dryrun.input_bytes(cfg, shape, rt, mshape)
        mode = "train" if shape.kind == "train" else "serve"
        jpol = jrules.make_policy(jcfg, amesh, mode)
        js = jsteps.input_specs(jcfg, JAX_SHAPES[name], jrt)
        pspec = jrules.param_specs(jcfg, jpol, js["params"])
        want = {"params": _jax_local_bytes(js["params"], pspec, sizes)}
        if "masks" in js:
            want["masks"] = _jax_local_bytes(js["masks"], pspec, sizes)
        batch = js.get("batch") or {"token": js["token"]}
        want["batch"] = _jax_local_bytes(batch, {
            k: jrules.batch_spec(v.shape[0], jpol, rank=len(v.shape))
            for k, v in batch.items()}, sizes)
        if "cache" in js:
            want["cache"] = _jax_local_bytes(js["cache"], jrules.cache_specs(
                jcfg, jpol, js["cache"], shape.global_batch), sizes)
        assert got == want, (name, got, want)


SIX = [("yi-9b", "train"), ("mixtral-8x22b", "train"),
       ("mamba2-130m", "decode"), ("gemma2-9b", "prefill"),
       ("whisper-small", "decode"), ("llama-3.2-vision-90b", "train")]


@pytest.mark.parametrize("arch,kind", SIX)
def test_dryrun_path_small_mesh(arch, kind, monkeypatch, no_group):
    """lower_step + run_one through the real dry-run code on a fake group
    of 8 (4 x 2): FLOPs a device > 0, collectives > 0 (the mesh shards
    every one of these steps), per-device input bytes from the rules."""
    monkeypatch.setenv("REPRO_FORCE_MESH", "4,2")
    shapes = dict(dryrun.INPUT_SHAPES)
    shapes["tiny"] = InputShape("tiny", 256, 8, kind)
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(dryrun, "get_config", lambda n: get_config(
        n).reduced(layers=2, d_model=256))
    lowered, meta = dryrun.lower_step(arch, "tiny")
    assert meta == {"arch": arch, "shape": "tiny", "mesh": "4x2",
                    "mode": kind, "fsdp": kind == "train"}
    rec = dryrun.run_one(arch, "tiny", out_dir=None)
    assert rec["status"] == "ok"
    assert rec["cost"]["flops"] > 0
    coll = rec["collectives"]
    assert sum(coll["counts"].values()) > 0 and coll["total_bytes"] > 0
    assert set(coll["counts"]) <= {"all-gather", "all-reduce",
                                   "reduce-scatter", "all-to-all"}
    mem = rec["memory"]
    assert mem["temp_size_in_bytes"] is None
    assert mem["argument_size_in_bytes"] == sum(
        v for k, v in mem.items() if k.endswith("_bytes") and
        k not in ("argument_size_in_bytes", "temp_size_in_bytes"))


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b"])
def test_loss_chunk_logits_keep_the_vocab_sharded(arch, monkeypatch,
                                                  no_group):
    """The loss chunks' fp32 logits sit as JAX's constrain_batch_model(
    logits, d_threshold=1) puts them: batch over "data", vocab over
    "model" (a 1/M share of the vocab on each rank), and the
    cross-entropy takes the vocab-parallel path, which gathers one
    logsumexp a row and rank in place of the chunk's logits."""
    from torch.distributed.tensor import Shard
    monkeypatch.setenv("REPRO_FORCE_MESH", "4,2")
    shapes = dict(dryrun.INPUT_SHAPES)
    shapes["tiny"] = InputShape("tiny", 256, 8, "train")
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(dryrun, "get_config", lambda n: get_config(
        n).reduced(layers=2, d_model=256))
    seen, vocab_parallel = [], []
    ce_sum, vp = T.ce_sum, T._vocab_parallel_ce

    def spy_ce(logits, labels):
        seen.append((tuple(logits.shape), tuple(logits.placements),
                     tuple(logits.to_local().shape)))
        return ce_sum(logits, labels)

    def spy_vp(logits, labels):
        vocab_parallel.append(tuple(logits.shape))
        return vp(logits, labels)

    monkeypatch.setattr(T, "ce_sum", spy_ce)
    monkeypatch.setattr(T, "_vocab_parallel_ce", spy_vp)
    lowered, _ = dryrun.lower_step(arch, "tiny")
    lowered.run()
    cfg = get_config(arch).reduced(layers=2, d_model=256)
    chunk = steps.specialize(cfg, shapes["tiny"])[1].loss_chunk
    assert seen and len(vocab_parallel) == len(seen)
    for shape, placements, local in seen:
        assert shape == (8, chunk, cfg.vocab_size)
        assert placements == (Shard(0), Shard(2))
        assert local == (2, chunk, cfg.vocab_size // 2)


def test_a_new_fake_world_runs_on_its_own_groups(monkeypatch, no_group):
    """A dry run in a fake world made after another one with an equal
    mesh (two meshes in the first, as lower_step then run_one make them):
    DTensor's cached output specs of the first world would name its
    destroyed groups, so fake_world clears DTensor's caches."""
    import torch.distributed as dist
    monkeypatch.setenv("REPRO_FORCE_MESH", "4,2")
    shapes = dict(dryrun.INPUT_SHAPES)
    shapes["tiny"] = InputShape("tiny", 256, 8, "train")
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(dryrun, "get_config", lambda n: get_config(
        n).reduced(layers=1, d_model=256))
    for arch, meshes in (("yi-9b", 2), ("granite-3-2b", 1)):
        for _ in range(meshes):
            lowered, _ = dryrun.lower_step(arch, "tiny")
        lowered.run()
        dist.destroy_process_group()


def test_dryrun_flops_are_a_device_share(no_group):
    """A DTensor matmul is counted at its local share: [64, 128] split 8
    ways on rows times a replicated [128, 128] is 2*8*128*128 a device;
    replicated, the whole product on every device."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    dryrun.fake_world(8)
    mesh = init_device_mesh("cpu", (8,), mesh_dim_names=("data",))
    a = distribute_tensor(torch.ones(64, 128), mesh, [Shard(0)],
                          src_data_rank=None)
    b = distribute_tensor(torch.ones(128, 128), mesh, [Replicate()],
                          src_data_rank=None)
    fc = dryrun.flop_counter()
    with fc:
        a @ b
    assert fc.get_total_flops() == 2 * 8 * 128 * 128
    fc = dryrun.flop_counter()
    with fc:
        a.redistribute(mesh, [Replicate()]) @ b
    assert fc.get_total_flops() == 2 * 64 * 128 * 128


def test_dryrun_cli_writes_a_record(tmp_path, monkeypatch, no_group):
    """The CLI (JAX's flags) writes <arch>__<shape>__<mesh>.json."""
    import json
    monkeypatch.setenv("REPRO_FORCE_MESH", "2,2")
    shapes = dict(dryrun.INPUT_SHAPES)
    shapes["tiny"] = InputShape("tiny", 128, 4, "train")
    monkeypatch.setattr(dryrun, "INPUT_SHAPES", shapes)
    monkeypatch.setattr(dryrun, "get_config", lambda n: get_config(
        n).reduced(layers=1, d_model=128))
    dryrun.main(["--arch", "granite-3-2b", "--shape", "tiny",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "granite-3-2b__tiny__2x2.json").read_text())
    assert rec["status"] == "ok" and rec["mode"] == "train"
    assert rec["collectives"]["counts"]["all-gather"] > 0


# -- a 1x1 mesh and the constraints off a mesh ----------------------------------

def test_one_by_one_mesh_is_the_unsharded_step_bit_for_bit(no_group):
    """Reduced granite under the training runtime (flash_vjp under
    local_map, remat, chunked loss): loss and every new parameter."""
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(
        layers=2, d_model=256), dtype="float32")
    cfg, rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])
    rt = dataclasses.replace(rt, q_chunk=32, kv_chunk=32, loss_chunk=32)
    gen = torch.Generator().manual_seed(3)
    params = T.init_params(gen, cfg, device="cpu")
    masks = {k: v for k, v in flatten_with_path(params)}
    masks = unflatten(params, [(torch.rand(w.shape, generator=gen) > 0.3)
                               .to(torch.uint8) for w in masks.values()])
    tok = torch.randint(0, cfg.vocab_size, (8, 65), generator=gen)
    loss_eq, params_eq, l1, l0 = shards.one_by_one(
        cfg, rt, params, masks, {"tokens": tok[:, :-1],
                                 "labels": tok[:, 1:]}, "cpu")
    assert loss_eq and params_eq, (l1, l0)


def test_constrain_is_the_identity_off_a_mesh(no_group):
    x = torch.randn(4, 8, 16)
    assert rules.active_mesh() is None
    assert rules.constrain(x, "batch", None, "model") is x
    assert rules.constrain_batch_model(x, d_threshold=1) is x
    assert rules.unshard_batch({"w": x})["w"] is x
    assert rules.hold_grad(x) is x
    dryrun.fake_world(1)
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    with rules.set_mesh(mesh):
        assert rules.active_mesh() is mesh
        assert rules.constrain(x, "batch", None, "model") is x
    assert rules.active_mesh() is None


def test_constrain_places_a_dtensor_like_jax(no_group):
    """Divisibility-guarded, each axis used once, batch over the batch
    axes: the placements JAX's with_sharding_constraint would get."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    dryrun.fake_world(8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    x = distribute_tensor(torch.zeros(8, 6, 4096), mesh,
                          [Replicate(), Replicate()], src_data_rank=None)
    with rules.set_mesh(mesh):
        assert tuple(rules.constrain_batch_model(x).placements) == \
            (Shard(0), Shard(2))
        assert tuple(rules.constrain(x, "batch", "model", "model")
                     .placements) == (Shard(0), Shard(1))
        y = distribute_tensor(torch.zeros(6, 3, 16), mesh,
                              [Replicate(), Replicate()], src_data_rank=None)
        assert tuple(rules.constrain(y, "batch", "model", "model")
                     .placements) == (Replicate(), Shard(2))
