"""Sharded-client-axis cases shared by the port's CPU tests
(tests/test_torch_sharding.py) and card tests (tests/test_torch_cuda.py):
the environments, and the functions each rank runs under
`repro_torch.launch.mesh.spawn_shards` (module level, so they pickle by
reference into the spawned ranks). Imports no JAX.

Every rank function returns plain numpy / Python values. Cases that hold
a sharded run against an unsharded one run the unsharded baseline on one
rank only (`_mine`), spreading the baselines over the ranks."""
import hashlib

import numpy as np
import torch

from repro_torch import convert
from repro_torch.core import (ClientData, FederatedTrainer, ParamPack,
                              RoundEngine, ScaledMalicious, CorruptUpload,
                              make_aggregator)
from repro_torch.core.client_store import ClientStore
from repro_torch.core.local import make_local_scheme
from repro_torch.core.optimizer_ao import Schedule
from repro_torch.core.round_engine import replay_shard_mean
from repro_torch.data import make_dataset, partition_by_dirichlet
from repro_torch.models import cnn
from repro_torch.wireless import ChannelModel, SystemParams

HETERO_SIZES = (60, 30, 20, 10, 7, 3)
HETERO_ROUNDS = 6
# (name, aggregator and its kwargs, fault model)
ROBUST = (("mean", None, "corrupt"),
          ("coord_median", ("coord_median", {}), "scaled"),
          ("trimmed_mean", ("trimmed_mean", {"beta": 0.3}), "scaled"))
LOCAL = (("feddyn", dict(steps=2, alpha=0.1)), ("fedavg", dict(steps=3)))
LOCAL_ROUNDS = 4


def lenet_params(seed: int) -> dict:
    """LeNet weights as numpy arrays (the port's init, from a torch
    generator): both packages start from them."""
    p = cnn.lenet_init(torch.Generator().manual_seed(seed), device="cpu")
    return {k: t.numpy() for k, t in p.items()}


def to_params(np_params: dict, dev) -> dict:
    return {k: t.to(dev) for k, t in
            convert.params_from_numpy(np_params).items()}


def first_env():
    """The JAX package's test_sharded_engine_first_round setting: three
    Dirichlet clients of synthetic-mnist and one batch of 8 each."""
    ds = make_dataset("synthetic-mnist", n_train=300, n_test=100, seed=1)
    parts = partition_by_dirichlet(ds.y_train, 3, sigma=1.0,
                                   rng=np.random.default_rng(1))
    clients = [ClientData(ds.x_train[i], ds.y_train[i]) for i in parts]
    rng = np.random.default_rng(0)
    xs, ys = [], []
    for c in clients:
        idx = rng.choice(len(c), size=8, replace=len(c) < 8)
        xs.append(c.x[idx])
        ys.append(c.y[idx])
    return np.stack(xs), np.stack(ys)


def hetero_env(sizes=HETERO_SIZES, seed=0):
    """Clients of the given (heterogeneous) sample counts."""
    ds = make_dataset("synthetic-mnist", n_train=sum(sizes), n_test=60,
                      seed=seed)
    off = np.cumsum([0] + list(sizes))
    return [ClientData(ds.x_train[a:b], ds.y_train[a:b])
            for a, b in zip(off, off[1:])]


def varying_selection(n: int, rounds: int, seed: int = 3,
                      min_sel: int = 2) -> np.ndarray:
    """The JAX package's varying-selection schedule matrix [S, N]."""
    rng = np.random.default_rng(seed)
    a = np.zeros((rounds, n))
    for s in range(rounds):
        sel = rng.choice(n, size=rng.integers(min_sel, n + 1), replace=False)
        a[s, sel] = 1.0
    return a


def make_schedule(a, lam) -> Schedule:
    a = np.asarray(a, float)
    lam = np.broadcast_to(np.asarray(lam, float), a.shape).copy()
    lam[a == 0] = 0.0
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def fault_model(kind: str | None):
    if kind == "corrupt":
        return CorruptUpload(rate=0.25, mode="nan", seed=4)
    if kind == "scaled":
        return ScaledMalicious(rate=0.3, scale=10.0, seed=1)
    return None


class BlockDigests:
    """Callback: a digest of (w, v) after every block, to hold the ranks'
    replicated state identical."""

    def __init__(self):
        self.digests = []

    def on_round_end(self, m, trainer):
        pass

    def on_eval(self, m, trainer):
        pass

    def on_checkpoint(self, m, trainer):
        pass

    def on_block_end(self, start, n_rounds, trainer):
        self.digests.append(wv_digest(trainer._w, trainer._v))


def wv_digest(w, v) -> str:
    h = hashlib.sha256()
    for t in (w, v):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def run_hetero(np_params, dev, *, shards=None, rpd=1, aggregator=None,
               faults=None, local=None, rounds=HETERO_ROUNDS, lam=0.3):
    """The hetero trainer over `rounds` rounds of varying selection.
    Returns (trainer, history, block digests)."""
    clients = hetero_env()
    loss = cnn.make_loss_fn(cnn.lenet_apply)
    n = len(clients)
    tr = FederatedTrainer(
        loss, to_params(np_params, dev), clients, eta=0.1, batch_size=16,
        seed=0, backend="packed", shards=shards, rounds_per_dispatch=rpd,
        device=dev, aggregator=(make_aggregator(aggregator[0],
                                                **aggregator[1])
                                if aggregator else None),
        fault_model=fault_model(faults),
        local_scheme=(make_local_scheme(local[0], **local[1])
                      if local else None))
    a = varying_selection(n, rounds)
    ch = ChannelModel(n)
    dig = BlockDigests()
    hist = tr.run(make_schedule(a, lam), SystemParams.table1(n), ch.uplink,
                  ch.downlink, callbacks=(dig,))
    return tr, hist, dig.digests


def trainer_result(tr, hist, digests=()) -> dict:
    out = {"losses": np.asarray([m.train_loss for m in hist]),
           "n_quarantined": np.asarray([m.n_quarantined for m in hist]),
           "n_agg": np.asarray([m.n_agg_adjusted for m in hist]),
           "w": tr._w.detach().cpu().numpy().copy(),
           "v": tr._v.detach().cpu().numpy().copy(),
           "params": {k: t.detach().cpu().numpy().copy()
                      for k, t in tr.params.items()},
           "digests": list(digests)}
    if tr.engine is not None:
        out.update(collectives=tr.engine.collectives,
                   graphs_captured=tr.engine.graphs_captured,
                   graph_replays=tr.engine.graph_replays,
                   gather_seconds=tr.engine.gather_seconds)
    if tr._h is not None:
        out["h"] = tr._h.detach().cpu().numpy().copy()
    return out


def _mine(group, i: int) -> bool:
    """Whether this rank runs unsharded baseline i."""
    return i % group.world == group.rank


def multi_v(w, pack) -> torch.Tensor:
    """The per-client round's broadcast gradient, drawn from numpy as the
    JAX reference draws it."""
    rng = np.random.default_rng(6)
    v = (1e-2 * rng.normal(size=tuple(w.shape))).astype(np.float32) \
        * pack.valid_mask()
    return torch.as_tensor(v, device=w.device)


def first_round_case(group, np_params, dev="cpu") -> dict:
    """The JAX package's first-round setting: a shared-lambda round from
    (w, 0) and a per-client-lambda round from (w, `multi_v`), sharded (the
    group's size, resolved) and on one rank: outputs, and the host's replay
    of the shared round's gathered partials."""
    xs, ys = first_env()
    params = to_params(np_params, dev)
    loss = cnn.make_loss_fn(cnn.lenet_apply)
    pack = ParamPack.build(params)
    engn = RoundEngine(loss, pack, eta=0.1, device=dev)
    eng1 = RoundEngine(loss, pack, eta=0.1, device=dev, shards=1)
    w, v = engn.init_buffers(params)
    out = {"xs": xs, "ys": ys, "shards": engn.shards,
           "buckets": sorted(engn.buckets_used)}
    for label, eng in (("n", engn), ("1", eng1)):
        o = eng.round_step(w, v, xs, ys, np.full(3, 0.2))
        if label == "n":
            out["replay_v"] = replay_shard_mean(
                eng.last_gathered, w.numel(),
                np.float32(1.0 / 3)).view(w.shape).numpy()
        m = eng.round_step(w, multi_v(w, pack), xs, ys,
                           np.asarray([0.0, 0.2, 0.5]))
        for tag, r in (("shared", o), ("multi", m)):
            for name, t in zip(("w", "v", "losses", "thr"), r[:4]):
                out[f"{tag}_{name}_{label}"] = t.detach().cpu().numpy()
    out["collectives"] = engn.collectives
    out["buckets"] = sorted(engn.buckets_used)
    return out


def tail_inputs(rows: int, seed: int = 7):
    """A mean / robust tail's inputs on the LeNet pack's rows: 8 clients'
    uploads over five decades of magnitude, one of them NaN, weights with
    two padding clients, (w, v), 1/6 and the losses."""
    rng = np.random.default_rng(seed)
    scale = 10.0 ** rng.uniform(-4, 1, size=(8, rows, 128))
    grads = (rng.normal(size=(8, rows, 128)) * scale).astype(np.float32)
    grads[5, 3, 7] = np.nan
    cw = np.asarray([1, 1, 1, 0, 1, 1, 1, 0], np.float32)
    w = rng.normal(size=(rows, 128)).astype(np.float32)
    v = (1e-2 * rng.normal(size=(rows, 128))).astype(np.float32)
    losses = rng.uniform(1, 3, size=8).astype(np.float32)
    return grads, cw, w, v, np.float32(1.0 / 6), losses


def tail_case(group, np_params, dev="cpu") -> dict:
    """The sharded tails alone on `tail_inputs`: each rank's row from its
    two clients, the collective, the replicated tail; mean and
    coord_median."""
    params = to_params(np_params, dev)
    loss = cnn.make_loss_fn(cnn.lenet_apply)
    pack = ParamPack.build(params)
    grads, cw, w, v, inv, losses = tail_inputs(pack.rows)
    t = {k: torch.as_tensor(a, device=dev) for k, a in
         dict(grads=grads, cw=cw, w=w, v=v, losses=losses).items()}
    out = {}
    for name, agg in (("mean", None), ("coord_median", "coord_median")):
        eng = RoundEngine(loss, pack, eta=0.1, device=dev,
                          aggregator=make_aggregator(agg) if agg else None)
        lo, hi = eng._bounds(8)
        send = eng._shard_row(t["losses"][lo:hi], t["grads"][lo:hi], None,
                              t["cw"], 8)
        recv = torch.empty((eng.shards, send.numel()), device=dev)
        eng._exchange(send, recv)
        w2, g, lo_all, step, n_ok, ast = eng._shard_tail(
            t["w"], t["v"], recv, 8, t["cw"], inv)
        out[name] = dict(w=w2.cpu().numpy(), v=g.cpu().numpy(),
                         losses=lo_all.cpu().numpy(), n_ok=int(n_ok),
                         ast=int(ast))
    return out


def hetero_case(group, np_params, dev="cpu") -> dict:
    """The hetero trainer sharded per round and in blocks of 4."""
    out = {}
    for rpd in (1, 4):
        tr, hist, dig = run_hetero(np_params, dev, rpd=rpd)
        out[f"rpd{rpd}"] = trainer_result(tr, hist, dig)
        out[f"rpd{rpd}"]["n_block_dispatches"] = tr.n_block_dispatches
        out[f"rpd{rpd}"]["n_batch_uploads"] = tr.n_batch_uploads
    return out


def robust_case(group, np_params, dev="cpu", rpd=1) -> dict:
    """Mean (NaN uploads quarantined), coord_median and trimmed_mean
    (30 % scaled attackers) sharded, and each unsharded on one rank."""
    out = {}
    for i, (name, agg, faults) in enumerate(ROBUST):
        tr, hist, dig = run_hetero(np_params, dev, rpd=rpd, aggregator=agg,
                                   faults=faults)
        out[name] = trainer_result(tr, hist, dig)
        if _mine(group, i):
            tr, hist, _ = run_hetero(np_params, dev, rpd=rpd, shards=1,
                                     aggregator=agg, faults=faults)
            out[name + "_1"] = trainer_result(tr, hist)
    return out


def local_case(group, np_params, dev="cpu", rpd=1) -> dict:
    """FedDyn and FedAvg E = 3 sharded, and each unsharded on one rank."""
    out = {}
    for i, (name, kw) in enumerate(LOCAL):
        tr, hist, dig = run_hetero(np_params, dev, rpd=rpd,
                                   local=(name, kw), rounds=LOCAL_ROUNDS)
        out[name] = trainer_result(tr, hist, dig)
        if _mine(group, i + len(ROBUST)):
            tr, hist, _ = run_hetero(np_params, dev, rpd=rpd, shards=1,
                                     local=(name, kw), rounds=LOCAL_ROUNDS)
            out[name + "_1"] = trainer_result(tr, hist)
    return out


class CohortRows:
    """Callback: after each streamed block, whether this rank's cohort rows
    are its sub-cohort's clients' rows (and only those), and its bytes."""

    def __init__(self, clients):
        self.clients = clients
        self.blocks = []

    def on_round_end(self, m, trainer):
        pass

    def on_eval(self, m, trainer):
        pass

    def on_checkpoint(self, m, trainer):
        pass

    def on_block_end(self, start, n_rounds, trainer):
        cs = trainer._cohorts
        cohort = next(iter(cs._live.values()))
        ids = cohort.ids_by_shard[trainer.rank]
        rows = cohort.x[cohort.base:cohort.base + len(ids)].cpu().numpy()
        ok = True
        for k, cid in enumerate(ids):
            c = self.clients[int(cid)]
            n = len(c.y)
            ok &= bool(np.array_equal(rows[k, :n], np.asarray(c.x)))
            ok &= bool((rows[k, n:] == 0).all())
        self.blocks.append(dict(
            start=int(start), ids=[int(i) for i in ids], rows_ok=ok,
            sharded=bool(cohort.sharded), nbytes=int(cohort.nbytes),
            local_nbytes=int(cohort.local_nbytes),
            per=int(cohort.per),
            digest=wv_digest(trainer._w, trainer._v)))


def fleet_spec(mode: str, shards, population=24, rounds=6, rpd=2):
    import repro_torch.api as api
    return api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-fleet", n_clients=population,
                          n_train=24 * population, n_test=64, seed=5),
        model=api.ModelSpec(name="mlp-edge", kwargs={"hidden": 16}),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="random_k", rounds=rounds, batch=8,
                              ao={"k": 5, "lam": 0.3, "seed": 1}),
        run=api.RunSpec(seed=2, eval_every=3, stop_on_budget=False,
                        client_store=mode, shards=shards,
                        rounds_per_dispatch=rpd))


def fleet_case(group, dev="cpu", population=24, rounds=6, rpd=2) -> dict:
    """The fleet spec streamed with sharded cohorts and replicated, both
    sharded over the group, through the experiment API."""
    import repro_torch.api as api
    out = {}
    for mode in ("streamed", "replicated"):
        run = api.Experiment(fleet_spec(mode, None, population, rounds,
                                        rpd)).build(device=dev)
        cb = CohortRows(run.env.clients)
        res = run.run(callbacks=(cb,) if mode == "streamed" else ())
        tr = run.trainer
        out[mode] = dict(
            history=[(m.round, repr(m.train_loss), repr(m.test_accuracy))
                     for m in res.history],
            w=tr._w.cpu().numpy().copy(), v=tr._v.cpu().numpy().copy(),
            blocks=cb.blocks, shards=tr.engine.shards,
            collectives=tr.engine.collectives,
            streaming=tr.streaming,
            fleet={k: v for k, v in tr.fleet_counters.items()
                   if k != "prefetch_stall_s"})
        if mode == "replicated":
            store = tr._ensure_store()
            out["store_nbytes"] = store.nbytes
    return out


def store_case(group, dev="cpu") -> dict:
    """launch.mesh.replicate over a ClientStore's buffers: a rank's
    perturbed copy becomes rank 0's (each rank builds the same store from
    the same clients, so the trainer never needs it)."""
    from repro_torch.launch.mesh import replicate
    clients = hetero_env()
    store = ClientStore.build(clients, device=dev)
    ref = store.x.clone()
    if group.rank:
        store.x.add_(1.0)
    replicate((store.x, store.y), group)
    return {"equal": bool(torch.equal(store.x, ref))}


def cpu_cases(group, np_first, np_hetero) -> dict:
    """Every CPU case in one spawn (a spawn costs the ranks' start-up)."""
    torch.manual_seed(0)
    return {"first": first_round_case(group, np_first),
            "tail": tail_case(group, np_first),
            "hetero": hetero_case(group, np_hetero),
            "robust": robust_case(group, np_hetero),
            "local": local_case(group, np_hetero),
            "fleet": fleet_case(group),
            "store": store_case(group)}


# -- the card: ranks sharing one CUDA device ---------------------------------------

CARD_BODIES = ("multi", "coord_median")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card_cases(group) -> dict:
    """For the block cases' per-client-lambda mean body and coord_median
    body (tests/_torch_blocks.py) on a CUDA device shared by the ranks:
    round 0 sharded against one rank (the mean path against the host's
    replay of its gathered partials too), then two blocks of 4 rounds
    through the capture-split graphs against 8 sharded round_steps, with
    the kernels' launch counts of both."""
    from _torch_blocks import block_case, round_args
    from repro_torch.kernels import _build
    from repro_torch.kernels import pruning_mask as pm
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = group.device
    if dev.type == "cuda":
        _build.load()                   # built by the parent: no nvcc here
    out = {}
    for body in CARD_BODIES:
        eng1, store, params, ops_, kw = block_case(dev, body, seed=7)
        loss = cnn.make_loss_fn(cnn.mlp_edge_apply)
        eng = RoundEngine(loss, eng1.pack, eta=0.1,
                          weighted_loss_fn=loss.weighted, max_clients=6,
                          device=dev, aggregator=eng1.aggregator,
                          shards=group.world)
        w0, v0 = eng.init_buffers(params)
        xs, ys, args = round_args(store, ops_, kw, 0)
        lams = args.pop("lams")
        one = eng1.round_step(w0, v0, xs, ys, lams, **args)
        got = eng.round_step(w0, v0, xs, ys, lams, **args)
        r = {"round_w_bitwise": bool(torch.equal(
                 got[0].view(torch.int32), one[0].view(torch.int32))),
             "round_v_bitwise": bool(torch.equal(
                 got[1].view(torch.int32), one[1].view(torch.int32))),
             "round_losses_bitwise": bool(torch.equal(got[2], one[2])),
             "round_w_max_err": float((got[0] - one[0]).abs().max()),
             "round_w_scale": float(one[0].abs().max())}
        if eng1.aggregator is None and "upload_weights" not in args:
            n = int(ops_[3][0])
            rep = replay_shard_mean(eng.last_gathered, w0.numel(),
                                    np.float32(1.0 / n)).view(w0.shape)
            r["replay_bitwise"] = bool(torch.equal(
                rep.view(torch.int32), got[1].cpu().view(torch.int32)))
        # two blocks of 4 against 8 sharded round_steps
        pm.reset_launches()
        w, v = w0, v0
        ref = []
        for _rep in range(2):
            for k in range(4):
                xs, ys, args = round_args(store, ops_, kw, k)
                lams = args.pop("lams")
                w, v, losses, thr, _ = eng.round_step(w, v, xs, ys, lams,
                                                      **args)
                ref.append((losses.cpu(), thr.cpu().reshape(-1)))
        _sync(dev)
        eager = dict(pm.LAUNCHES)
        pm.reset_launches()
        c0 = eng.collectives
        wb, vb = w0, v0
        blk = []
        for _rep in range(2):
            wb, vb, losses, thrs = eng.block_step(wb, vb, store, *ops_, **kw)
            for k in range(4):
                blk.append((losses[k].cpu(), thrs[k].cpu().reshape(-1)))
        _sync(dev)
        ok = all(torch.equal(a[0][:b[0].numel()].view(torch.int32),
                             b[0].view(torch.int32))
                 and torch.equal(a[1][:b[1].numel()].view(torch.int32),
                                 b[1].view(torch.int32))
                 for a, b in zip(blk, ref))
        r.update(block_rounds_bitwise=ok,
                 block_w_bitwise=bool(torch.equal(wb.view(torch.int32),
                                                  w.view(torch.int32))),
                 block_v_equal=bool(torch.equal(vb, v)),
                 block_collectives=eng.collectives - c0,
                 launches_eager=eager, launches_blocked=dict(pm.LAUNCHES),
                 graphs_captured=eng.graphs_captured,
                 graph_replays=eng.graph_replays,
                 digest=wv_digest(wb, vb))
        out[body] = r
    return out


def sweep_cells_via_api(group, sweep: dict, out_dir: str) -> None:
    """Each cell of a sweep matrix run on its own through the API on every
    rank (its spec's run.shards ranks: this group); rank 0 writes each
    RunResult as <out_dir>/<cell name>.jsonl, the sweep sink's layout."""
    import os
    from repro_torch.api import Experiment, SweepSpec
    for cell in SweepSpec.from_dict(sweep).expand():
        res = Experiment(cell.spec).run(device=group.device)
        if group.rank == 0:
            res.to_jsonl(os.path.join(out_dir, f"{cell.name}.jsonl"))
