"""Sharded LM train-step cases shared by the port's CPU tests
(tests/test_torch_lm_sharding.py) and card tests (tests/test_torch_cuda.py):
the functions each rank runs under `repro_torch.launch.mesh.spawn_shards`
(module level, so they pickle by reference into the spawned ranks), and
the one-rank 1x1-mesh check. Imports no JAX.

A case is (name, config, runtime, numpy params, numpy masks, numpy batch,
microbatches):
every rank builds the same tensors from the numpy trees, runs the port's
masked-FedSGD step on DTensors placed by the partition rules over a mesh of
the group's ranks, and rank 0 also runs the unsharded step and returns
both results as numpy."""
import numpy as np
import torch

from repro_torch.convert import lm_params_from_numpy
from repro_torch.launch import steps
from repro_torch.sharding import rules
from repro_torch.tree import leaves


def _np(t) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def sharded_step(cfg, rt, params, masks, batch, mesh, microbatches=1):
    """(loss, new params as full tensors, new params' placements, the
    parameters' placements) of one sharded step over `mesh`."""
    pol = rules.make_policy(cfg, mesh, "train")
    ps = rules.param_specs(cfg, pol, params)
    dp, dm = rules.distribute(params, ps, mesh), rules.distribute(masks, ps,
                                                                  mesh)
    db = rules.distribute(batch, {k: rules.batch_spec(v.shape[0], pol,
                                                      rank=v.ndim)
                                  for k, v in batch.items()}, mesh)
    with rules.set_mesh(mesh):
        loss, new = steps.make_train_step(cfg, rt,
                                          microbatches=microbatches)(
            dp, dm, db)
        full = [w.full_tensor() for w in leaves(new)]
    return (loss.full_tensor(), full, [tuple(w.placements) for w in
                                      leaves(new)],
            [tuple(w.placements) for w in leaves(dp)])


def step_cases(group, cases, mesh_shape=(4, 2)):
    """Every case sharded over a (data, model) mesh of `mesh_shape` on the
    group's ranks (gloo, CPU); rank 0 returns {name: result}, the others
    None."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    out = {}
    for name, cfg, rt, np_params, np_masks, np_batch, mb in cases:
        params = lm_params_from_numpy(np_params)
        masks = lm_params_from_numpy(np_masks)
        batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
        loss, full, new_pl, old_pl = sharded_step(cfg, rt, params, masks,
                                                  batch, mesh, mb)
        if group.rank == 0:
            l0, n0 = steps.make_train_step(cfg, rt, microbatches=mb)(
                params, masks, batch)
            out[name] = {"loss": float(loss), "new": [_np(w) for w in full],
                         "loss_unsharded": float(l0),
                         "new_unsharded": [_np(w) for w in leaves(n0)],
                         "placements_kept": new_pl == old_pl}
    return out if group.rank == 0 else None


def _prefill(cfg, rt, params, tokens, cache):
    """The prompt's last-token logits (a one-entry list) and the cache."""
    logits, cache = steps.make_prefill_step(cfg, rt)(
        params, {"tokens": tokens}, cache)
    return [logits], cache


def serve_cases(group, cases, mesh_shape=(4, 2)):
    """Prefill and decode steps sharded over a (data, model) mesh of
    `mesh_shape` on the group's ranks (gloo, CPU): parameters by the
    serving rules, the cache by `cache_specs` (its sequence on the model
    axis), prompt and tokens by `batch_spec`. A case is (name, config,
    prefill runtime, decode runtime, numpy params, prompt [B, S], decode
    tokens [n, B, 1], cache length). Rank 0 returns {name: (sharded
    logits, unsharded logits, sharded cache leaves, unsharded cache
    leaves)}, the others None."""
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.models import transformer as T
    mesh = init_device_mesh("cpu", mesh_shape,
                            mesh_dim_names=("data", "model"))
    out = {}
    for name, cfg, rt_p, rt_d, np_params, prompt, new, cache_len in cases:
        params = lm_params_from_numpy(np_params)
        prompt = torch.from_numpy(prompt)
        new = [torch.from_numpy(t) for t in new]
        b = prompt.shape[0]
        pol = rules.make_policy(cfg, mesh, "serve")
        dp = rules.distribute(params, rules.param_specs(cfg, pol, params),
                              mesh)
        cache = T.init_cache(cfg, b, cache_len, device="cpu")
        dc = rules.distribute(cache, rules.cache_specs(cfg, pol, cache, b),
                              mesh)

        def rows(t):
            return rules.distribute({"t": t}, {"t": rules.batch_spec(
                b, pol, rank=t.ndim)}, mesh)["t"]

        with rules.set_mesh(mesh):
            logits, dc = _prefill(cfg, rt_p, dp, rows(prompt), dc)
            more, dc = _serve_decode(cfg, rt_d, dp, dc, [rows(t) for t in
                                                        new],
                                     prompt.shape[1])
            logits = [x.full_tensor() for x in logits + more]
            cache_full = [x.full_tensor() for x in leaves(dc)]
        if group.rank == 0:
            l0, cache = _prefill(cfg, rt_p, params, prompt, cache)
            m0, c0 = _serve_decode(cfg, rt_d, params, cache, new,
                                   prompt.shape[1])
            out[name] = ([_np(x) for x in logits],
                         [_np(x) for x in l0 + m0],
                         [_np(x) for x in cache_full],
                         [_np(x) for x in leaves(c0)])
    return out if group.rank == 0 else None


def _serve_decode(cfg, rt, params, cache, steps_tokens, pos: int):
    """Decode steps from `pos` on: (the list of logits, the cache)."""
    decode = steps.make_serve_step(cfg, rt)
    out = []
    for i, tok in enumerate(steps_tokens):
        logits, cache = decode(params, cache, tok, pos + i)
        out.append(logits)
    return out, cache


def run_cases(group, train, serve):
    """`step_cases` and `serve_cases` in one launch of the ranks."""
    return step_cases(group, train), serve_cases(group, serve)


def one_by_one(cfg, rt, params, masks, batch, device_type: str):
    """The sharded step on a 1x1 mesh (a fake world of one rank) against
    the unsharded step on the same tensors, under deterministic
    algorithms (torch's index backward on the embedding otherwise sums in
    a varying order): (loss equal, every new parameter equal, sharded
    loss, unsharded loss). The caller destroys the process group."""
    from repro_torch.launch.dryrun import fake_world
    from torch.distributed.device_mesh import init_device_mesh
    fake_world(1)
    mesh = init_device_mesh(device_type, (1, 1),
                            mesh_dim_names=("data", "model"))
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        l0, n0 = steps.make_train_step(cfg, rt, microbatches=1)(
            params, masks, batch)
        l1, full, _, _ = sharded_step(cfg, rt, params, masks, batch, mesh)
    finally:
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
    return (torch.equal(l0, l1), all(torch.equal(a, b) for a, b in
                                     zip(leaves(n0), full)),
            float(l1), float(l0))
