"""The JAX package's sharded runs that tests/test_torch_sharding.py holds
the port against, in a process of its own: JAX's client axis is sharded
over a mesh of forced host devices, which must be set before JAX starts.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/_jax_shards_reference.py IN.npz OUT.npz

IN holds the initial weights (``first/<leaf>``, ``hetero/<leaf>``) and
the tails' inputs (``tail/<name>``); OUT gets every case's outputs under
``<case>/<name>``. The cases mirror tests/_torch_shards.py's.

JAX's sharded MEAN path does not hold on JAX 0.9: inside its
``shard_map`` body every client's gradient comes out as the sum of all the
shards' client gradients, padding clients included (its own
test_sharded_engine_first_round_matches_single_device fails under the
forced-4-device leg). Its gather paths (the robust reducers, FedDyn) and
its psum tail hold. So the mean-path trainer cases run JAX unsharded
(``shards=1``: what JAX's sharded run is documented to equal), the gather
paths run sharded, and the first round and the tails run both ways."""
import sys

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from repro.core import ClientData, FederatedTrainer, ParamPack, RoundEngine
from repro.core.aggregators import make_aggregator
from repro.core.faults import ScaledMalicious
from repro.core.local import make_local_scheme
from repro.core.optimizer_ao import Schedule
from repro.data import make_dataset, partition_by_dirichlet
from repro.models import lenet_apply, make_loss_fn
from repro.wireless import ChannelModel, SystemParams

HETERO_SIZES = (60, 30, 20, 10, 7, 3)
HETERO_ROUNDS = 6
LOCAL = (("feddyn", dict(steps=2, alpha=0.1)), ("fedavg", dict(steps=3)))
LOCAL_ROUNDS = 4


def params_of(inp, prefix):
    return {k.split("/", 1)[1]: jnp.asarray(inp[k]) for k in inp.files
            if k.startswith(prefix + "/")}


def make_schedule(a, lam):
    a = np.asarray(a, float)
    lam = np.broadcast_to(np.asarray(lam, float), a.shape).copy()
    lam[a == 0] = 0.0
    return Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                    freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                    delay=0.0, feasible=True)


def varying_selection(n, rounds, seed=3, min_sel=2):
    rng = np.random.default_rng(seed)
    a = np.zeros((rounds, n))
    for s in range(rounds):
        sel = rng.choice(n, size=rng.integers(min_sel, n + 1), replace=False)
        a[s, sel] = 1.0
    return a


def multi_v(w, pack):
    """The per-client round's broadcast gradient (both packages draw it
    from numpy, so both rounds start from the same bits)."""
    rng = np.random.default_rng(6)
    return jnp.asarray((1e-2 * rng.normal(size=w.shape)).astype(np.float32)
                       * pack.valid_mask())


def first_case(params, out):
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
    xs, ys = np.stack(xs), np.stack(ys)
    pack = ParamPack.build(params)
    out["first/xs"], out["first/ys"] = xs, ys
    for label, shards in (("n", None), ("1", 1)):
        eng = RoundEngine(make_loss_fn(lenet_apply), pack, eta=0.1,
                          shards=shards)
        assert (eng.mesh is not None and eng.shards == 4) or shards == 1
        w, v = eng.init_buffers(params)
        o = eng.round_step(w, v, jnp.asarray(xs), jnp.asarray(ys),
                           np.full(3, 0.2))
        m = eng.round_step(w, multi_v(w, pack), jnp.asarray(xs),
                           jnp.asarray(ys), np.asarray([0.0, 0.2, 0.5]))
        for tag, r in (("shared", o), ("multi", m)):
            for name, a in zip(("w", "v", "losses", "thr"), r[:4]):
                out[f"first/{tag}_{name}_{label}"] = np.asarray(a)
        out[f"first/buckets_{label}"] = np.asarray(sorted(eng.buckets_used))


def tail_case(params, inp, out):
    pack = ParamPack.build(params)
    grads, cw, w, v, losses = (jnp.asarray(inp[f"tail/{k}"]) for k in
                               ("grads", "cw", "w", "v", "losses"))
    inv = np.float32(inp["tail/inv"])
    for name, agg in (("mean", None), ("coord_median", "coord_median")):
        eng = RoundEngine(make_loss_fn(lenet_apply), pack, eta=0.1,
                          aggregator=make_aggregator(agg) if agg else None)
        robust = agg is not None
        partial = eng._robust_partial if robust else eng._guarded_partial

        def body(l_, g_, c_):
            return partial(l_, g_, c_, None)

        def run(losses, grads, cw, w, v):
            lo, a, b = shard_map(
                body, mesh=eng.mesh, in_specs=(P("data"),) * 3,
                out_specs=(P("data"), P(), P()),
                check_rep=not robust)(losses, grads, cw)
            if robust:
                w2, g, step, n_ok, ast = eng._robust_tail(w, v, a, b, None)
            else:
                w2, g, step, n_ok = eng._guarded_tail(w, v, a, b, inv, None)
                ast = jnp.int32(0)
            return w2, g, lo, n_ok, ast

        w2, g, lo, n_ok, ast = jax.jit(run)(losses, grads, cw, w, v)
        for k, a in (("w", w2), ("v", g), ("losses", lo), ("n_ok", n_ok),
                     ("ast", ast)):
            out[f"tail/{name}_{k}"] = np.asarray(a)


def hetero_env(seed=0):
    ds = make_dataset("synthetic-mnist", n_train=sum(HETERO_SIZES),
                      n_test=60, seed=seed)
    off = np.cumsum([0] + list(HETERO_SIZES))
    return [ClientData(ds.x_train[a:b], ds.y_train[a:b])
            for a, b in zip(off, off[1:])]


def run_trainer(params, label, out, *, shards=None, local=None,
                aggregator=None, faults=False, rounds=HETERO_ROUNDS):
    clients = hetero_env()
    n = len(clients)
    tr = FederatedTrainer(make_loss_fn(lenet_apply), params, clients,
                          eta=0.1, batch_size=16, seed=0, backend="packed",
                          shards=shards,
                          local_scheme=(make_local_scheme(local[0],
                                                          **local[1])
                                        if local else None),
                          aggregator=(make_aggregator(aggregator)
                                      if aggregator else None),
                          fault_model=(ScaledMalicious(rate=0.3, scale=10.0,
                                                       seed=1)
                                       if faults else None))
    assert shards == 1 or tr.engine.shards == 4
    ch = ChannelModel(n)
    hist = tr.run(make_schedule(varying_selection(n, rounds), 0.3),
                  SystemParams.table1(n), ch.uplink, ch.downlink)
    out[f"{label}/losses"] = np.asarray([m.train_loss for m in hist])
    out[f"{label}/w"] = np.asarray(tr._w)
    out[f"{label}/v"] = np.asarray(tr._v)
    if tr._h is not None:
        out[f"{label}/h"] = np.asarray(tr._h)


def main(inp_path, out_path):
    assert len(jax.devices()) == 4, jax.devices()
    inp = np.load(inp_path)
    out = {}
    first = params_of(inp, "first")
    hetero = params_of(inp, "hetero")
    first_case(first, out)
    tail_case(first, inp, out)
    run_trainer(hetero, "hetero", out, shards=1)
    run_trainer(hetero, "coord_median", out, aggregator="coord_median",
                faults=True)
    run_trainer(hetero, "feddyn", out, local=LOCAL[0], rounds=LOCAL_ROUNDS)
    run_trainer(hetero, "fedavg", out, shards=1, local=LOCAL[1],
                rounds=LOCAL_ROUNDS)
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
