"""Block-engine cases shared by the port's CPU and card tests: an mlp-edge
engine, a client store and the operands of one block for each kind of
round body, with each round's `round_step` arguments beside them. Imports
no JAX."""
import numpy as np
import torch

from repro_torch.core import ClientData, make_aggregator
from repro_torch.models import cnn

LANES = 128

BLOCK_BODIES = ("shared", "multi", "ragged", "noisy", "faulted", "poisoned",
                "coord_median")


def block_case(dev, body, n_rounds=4, seed=0):
    """An mlp-edge engine on `dev`, a store of six clients (one smaller than
    the batch) and the operands of a block of `n_rounds` rounds of 3 or 4
    clients (bucket 4) for one body kind, with each round's round_step
    arguments beside them."""
    from repro_torch.core import ParamPack, RoundEngine
    from repro_torch.core.client_store import ClientStore
    rng = np.random.default_rng(seed)
    sizes = [40, 30, 6 if body == "ragged" else 25, 35, 28, 33]
    clients = [ClientData(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int32))
               for n in sizes]
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(seed),
                               device=dev)
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    pack = ParamPack.build(params)
    eng = RoundEngine(loss, pack, eta=0.1, weighted_loss_fn=loss.weighted,
                      max_clients=6, device=dev,
                      aggregator=(make_aggregator("coord_median")
                                  if body == "coord_median" else None))
    store = ClientStore.build(clients, device=dev)
    batch, c_max = 8, 4
    counts = np.asarray([4, 3, 4, 3][:n_rounds] * (n_rounds // 4 or 1))
    counts = counts[:n_rounds]
    cids = np.empty((n_rounds, c_max), np.int32)
    idxs = np.empty((n_rounds, c_max, batch), np.int32)
    sw = np.ones((n_rounds, c_max, batch), np.float32)
    for k in range(n_rounds):
        sel = rng.choice(6, counts[k], replace=False)
        if body == "ragged":
            sel[0] = 2
        cids[k, :counts[k]] = sel
        for j, c in enumerate(sel):
            m = min(batch, sizes[c])
            idxs[k, j, :m] = rng.choice(sizes[c], m, replace=sizes[c] < batch)
            idxs[k, j, m:] = idxs[k, j, m - 1]
            sw[k, j, m:] = 0.0
        cids[k, counts[k]:] = cids[k, counts[k] - 1]
        idxs[k, counts[k]:] = idxs[k, counts[k] - 1]
        sw[k, counts[k]:] = sw[k, counts[k] - 1]
    if body in ("shared", "ragged", "noisy", "coord_median"):
        lams = np.repeat(rng.uniform(0.0, 0.5, (n_rounds, 1)), c_max, 1)
    else:
        lams = rng.uniform(0.05, 0.6, (n_rounds, c_max))
    kw = {}
    if body == "ragged":
        kw["sample_weights"] = sw
    if body == "noisy":
        kw["noises"] = (1e-3 * rng.normal(size=(n_rounds, pack.rows, LANES))
                        * pack.valid_mask()).astype(np.float32)
    if body in ("faulted", "poisoned", "coord_median"):
        kw["upload_weights"] = (rng.random((n_rounds, c_max)) > 0.25
                                ).astype(np.float32)
        kw["corrupt"] = [None if k % 2 else
                         np.where(rng.random(c_max) < 0.3, np.nan,
                                  1.0).astype(np.float32)
                         for k in range(n_rounds)]
    if body in ("poisoned", "coord_median"):
        kw["poisons"] = [None if k == 1 else
                         (rng.normal(size=(c_max, pack.rows, LANES))
                          * pack.valid_mask()).astype(np.float32)
                         for k in range(n_rounds)]
    return eng, store, params, (cids, idxs, lams, counts), kw


def round_args(store, ops_, kw, k):
    """round_step's arguments for round k of a block case."""
    cids, idxs, lams, counts = ops_
    n = int(counts[k])
    xs, ys = store.gather(cids[k, :n], idxs[k, :n])
    out = dict(lams=lams[k, :n])
    if "sample_weights" in kw:
        out["sample_weights"] = kw["sample_weights"][k, :n]
    if "noises" in kw:
        out["noise"] = kw["noises"][k]
    if "upload_weights" in kw:
        out["upload_weights"] = kw["upload_weights"][k, :n]
    if kw.get("corrupt") is not None and kw["corrupt"][k] is not None:
        out["corrupt"] = kw["corrupt"][k][:n]
    if kw.get("poisons") is not None and kw["poisons"][k] is not None:
        out["poison"] = kw["poisons"][k][:n]
    return xs, ys, out


# the local-update schemes of the block cases: FedAvg at E = 3 (no power of
# two, where the JAX package pads steps), FedProx with ragged clients,
# FedDyn under dropped and NaN uploads with per-client lambda
LOCAL_BODIES = {"fedavg": dict(steps=3), "fedprox": dict(steps=3, mu=0.05),
                "feddyn": dict(steps=2, alpha=0.1)}


def local_block_case(dev, name, n_rounds=4, seed=0):
    """An mlp-edge engine running local scheme `name` on `dev`, a store of
    six clients (client 2 smaller than the batch) and the operands of a
    block of `n_rounds` rounds of 3 or 4 clients with [K, C, E, B] indices
    (`round_args` gives each round's arguments; FedDyn's state and client
    ids are the caller's)."""
    from repro_torch.core import ParamPack, RoundEngine
    from repro_torch.core.client_store import ClientStore
    from repro_torch.core.local import make_local_scheme
    ls = make_local_scheme(name, **LOCAL_BODIES[name])
    rng = np.random.default_rng(seed)
    sizes = [40, 30, 6, 35, 28, 33]
    clients = [ClientData(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int32))
               for n in sizes]
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(seed),
                               device=dev)
    loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
    pack = ParamPack.build(params)
    eng = RoundEngine(loss, pack, eta=0.1, weighted_loss_fn=loss.weighted,
                      max_clients=6, local_scheme=ls, device=dev)
    store = ClientStore.build(clients, device=dev)
    batch, c_max, e = 8, 4, ls.steps
    counts = np.asarray([4, 3, 4, 3] * (n_rounds // 4 + 1))[:n_rounds]
    cids = np.empty((n_rounds, c_max), np.int32)
    idxs = np.empty((n_rounds, c_max, e, batch), np.int32)
    sw = np.ones((n_rounds, c_max, e, batch), np.float32)
    for k in range(n_rounds):
        sel = rng.choice(6, counts[k], replace=False)
        if name == "fedprox":
            sel[0] = 2 if 2 not in sel[1:] else sel[0]
        cids[k, :counts[k]] = sel
        for j, c in enumerate(sel):
            m = min(batch, sizes[c])
            for t in range(e):
                idxs[k, j, t, :m] = rng.choice(sizes[c], m,
                                               replace=sizes[c] < batch)
                idxs[k, j, t, m:] = idxs[k, j, t, m - 1]
                sw[k, j, t, m:] = 0.0
        cids[k, counts[k]:] = cids[k, counts[k] - 1]
        idxs[k, counts[k]:] = idxs[k, counts[k] - 1]
        sw[k, counts[k]:] = sw[k, counts[k] - 1]
    if name == "fedavg":
        lams = np.repeat(rng.uniform(0.0, 0.5, (n_rounds, 1)), c_max, 1)
    else:
        lams = rng.uniform(0.05, 0.6, (n_rounds, c_max))
    kw = {}
    if (sw == 0).any():
        kw["sample_weights"] = sw
    if name == "feddyn":
        kw["upload_weights"] = (rng.random((n_rounds, c_max)) > 0.25
                                ).astype(np.float32)
        kw["corrupt"] = [None if k % 2 else
                         np.where(rng.random(c_max) < 0.3, np.nan,
                                  1.0).astype(np.float32)
                         for k in range(n_rounds)]
    return eng, store, params, (cids, idxs, lams, counts), kw
