"""The port's hand-written CUDA kernels on the card.

The tests marked `cuda` need a CUDA card with `nvcc` beside it (the kernels
build for sm_90a at first use) and skip on a host without one; the others
check, without touching a card, what the CUDA path refuses. The file imports
neither JAX nor the JAX package, so it runs where only PyTorch is installed:

    python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held bit for bit to its plain PyTorch version on the same
device, at the LeNet slice's packed shape (R = 1024) with 1, 3 and 8
clients (the rank sort, the unweighted aggregate and the masked update at
C in {1, 3, 8, 10, 16, 33}, past the sort's 32-client register network;
the one-launch histogram and the shared-threshold mask also at R = 256 and
65,536, over the histogram's worst cases and the threshold's edges, with
the histogram's trace showing one kernel a call and calls on two streams
at once agreeing; the aggregate tail on subnormal input; the weighted
aggregate at every C from 1 to 33 under zero-weight clients holding NaN at
the front, in the middle, at the end and everywhere and under non-unit and
subnormal weights, also at R = 256 and 65,536, and on products that round
up to FLT_MIN; the masked update with keep-masks, masks of other values
and NaN and inf in w at R = 256, 1024 and 65,536; both one kernel a call),
and a few rounds of the trainer run through the kernels with the packed
backend equal to the reference backend, under the mean and under a robust
reducer with an attack. The LM stack's kernels (flash attention, decode
attention, the SSD chunk) are held to their plain versions within the
JAX package's kernel tolerances (fp32 2e-5, bf16 2e-2) at the served
models' head dims (64, 128, 256 with gemma2's softcap) and SSD widths
(mamba2's, hymba's N 16, padded P and N, a ragged chunk, a sequence's
chunks as batch rows of one launch; two SSD calls agree bit for bit),
with windows,
lengths that are no multiple of the flash kernels' tiles (64 rows at D
256; 128 query rows and 128 keys at D 64 and 128), Sq != Skv, and decode
positions at the split-KV
kernel's chunk edges, all at 0 or past the cache, over caches split in 8
or more chunks; two decode calls in a row agree bit for bit (the ticket
counters reset); and the serving engine runs a reduced model through the
flash kernel. The training path's attention backward is held to its plain
version at the same head dims, with windows, caps, GQA and ragged tiles
(a rerun bit for bit); kernel 8 asked for the rows' log-sum-exp gives the
same o bit for bit, reruns bit for bit, and runs the kernel of its head
dim (the device trace); and a reduced model's loss gradient through both
kernels matches the naive path's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_blocks import (BLOCK_BODIES, LOCAL_BODIES, block_case,  # noqa: E402
                           local_block_case, round_args)
from repro_torch.core import (ClientData, FederatedTrainer,  # noqa: E402
                              ScaledMalicious, make_aggregator)
from repro_torch.core import round_engine as tre  # noqa: E402
from repro_torch.core.optimizer_ao import Schedule  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import pruning_mask as pm  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.wireless import ChannelModel, SystemParams  # noqa: E402


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


LANES = 128


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build with nvcc for sm_90a")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bits(t):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_bitwise(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(_bits(a), _bits(b))


# A device trace taken in a fresh process. torch.profiler's CUDA trace of a
# few short kernels comes back whole in a new process, and empty or short
# in one that has opened many profiler windows of other lengths
# (scripts/trace_window_probe.py on the H100: none of 250 windows empty at
# first, up to 46 of 50 after 250 windows of mixed lengths), whatever host
# time the window holds at its edges; the tests that read a trace take it
# in a child that opens no other window.
_TRACE_CHILD = """
import importlib, json, sys
import torch
from torch.profiler import ProfilerActivity, profile
target, path, calls = sys.argv[1], sys.argv[2], int(sys.argv[3])
mod, name = target.split(":")
fn = getattr(importlib.import_module(mod), name)
args, kw = torch.load(path)
args = [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]
fn(*args, **kw)
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CUDA]) as prof:
    for _ in range(calls):
        fn(*args, **kw)
    torch.cuda.synchronize()
print(json.dumps([(ev.key, ev.count) for ev in prof.key_averages()
                  if str(getattr(ev, "device_type", "")).endswith("CUDA")]))
"""


def _fresh_trace(target: str, args, kw, calls: int, tmp_path):
    """(name, count) of each CUDA kernel in torch.profiler's trace of
    `calls` calls of `target` ("module:function") on `args` / `kw`, after
    one untimed call, taken in a fresh Python process (the tensors go there
    on the CPU through a file and back to the card, strides kept)."""
    import json
    import os
    import subprocess
    import sys
    path = tmp_path / "trace_inputs.pt"
    torch.save(([a.cpu() if isinstance(a, torch.Tensor) else a
                 for a in args], kw), path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(root, "src"), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", _TRACE_CHILD, target,
                          str(path), str(calls)], capture_output=True,
                         text=True, env=env, timeout=600, check=True)
    return [tuple(x) for x in json.loads(out.stdout.strip().splitlines()[-1])]


def _inputs(dev, n_clients, rows=1024, seed=0):
    rng = np.random.default_rng(seed)
    shape = (rows, LANES)
    w = rng.normal(size=shape).astype(np.float32)
    v = (1e-2 * rng.normal(size=shape)).astype(np.float32)
    v.reshape(-1)[::11] = 0.0                       # q exactly 0
    v.reshape(-1)[3::17] = np.float32(3e-20)        # q subnormal: flushed
    pr = np.ones(shape, np.float32)
    pr.reshape(-1)[-3 * LANES - 17:] = 0.0          # padding tail
    grads = rng.normal(size=(n_clients,) + shape).astype(np.float32)
    cw = np.ones(n_clients, np.float32)
    if n_clients > 1:                               # padding client: NaN
        cw[-1] = 0.0
        grads[-1] = np.nan
    t = {k: torch.from_numpy(a).to(dev) for k, a in
         dict(w=w, v=v, pr=pr, grads=grads, cw=cw).items()}
    q = pm.importance(t["w"], t["v"])
    picks = torch.from_numpy(rng.choice(q.numel(), n_clients)).to(dev)
    thr = q.reshape(-1)[picks].contiguous()
    thr[0] = float(np.nextafter(np.float32(0), np.float32(1)))  # round 0
    t.update(q=q, thr=thr, inv=torch.tensor(np.float32(1.0 / cw.sum()),
                                            device=dev),
             eta=torch.tensor(np.float32(0.1), device=dev))
    return t


@pytest.mark.cuda
@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_kernels_match_plain_versions(dev, n_clients):
    t = _inputs(dev, n_clients, seed=n_clients)
    pm.reset_launches()
    for a, b in zip(pm.importance_mask_batched(t["w"], t["v"], t["pr"],
                                               t["thr"]),
                    pm.importance_masks_plain(t["w"], t["v"], t["pr"],
                                              t["thr"])):
        assert_bitwise(a, b)
    kq, km = pm.importance_mask_2d(t["w"], t["v"], t["pr"], t["thr"][0])
    pq, pms = pm.importance_masks_plain(t["w"], t["v"], t["pr"], t["thr"][0])
    assert_bitwise(kq, pq)
    assert_bitwise(km, pms[0])
    assert bool((km == 1).all())        # nextafter(0) keeps every coordinate
    assert_bitwise(pm.exponent_histogram(t["q"], t["pr"]),
                   pm.exponent_histogram_plain(t["q"], t["pr"]))
    args = (t["w"], t["grads"], t["cw"], t["inv"], t["eta"])
    outs = pm.fedsgd_aggregate_weighted(*args)
    for a, b in zip(outs, pm.fedsgd_aggregate_weighted_plain(*args)):
        assert_bitwise(a, b)
        assert bool(torch.isfinite(a).all())
    torch.cuda.synchronize()
    assert pm.LAUNCHES == {"importance_mask_2d": 1,
                           "importance_mask_batched": 1,
                           "fedsgd_aggregate_weighted": 1,
                           "exponent_histogram": 1, "fedsgd_aggregate": 0,
                           "client_rank_sort": 0, "masked_update_2d": 0,
                           "flash_attention": 0, "flash_attention_bwd": 0,
                           "decode_attention": 0, "ssd_chunk": 0}


def _rank_stack(dev, n_clients, rows=1024, seed=0):
    """[C, rows, 128] with ties, +-0.0 and +-inf on valid clients and NaN on
    zero-weight ones."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(n_clients, rows, LANES)).astype(np.float32)
    tie = rng.random(g.shape) < 0.3
    pool = np.asarray([-1.5, -0.0, 0.0, 0.25, 3.0, np.inf, -np.inf],
                      np.float32)
    g[tie] = rng.choice(pool, size=int(tie.sum()))
    cw = np.ones(n_clients, np.float32)
    if n_clients > 2:
        cw[[1, -1]] = 0.0
        g[1] = np.nan
    return torch.from_numpy(g).to(dev), torch.from_numpy(cw).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clients", [1, 3, 8, 10, 16, 33])
def test_new_kernels_match_plain_versions(dev, n_clients):
    g, cw = _rank_stack(dev, n_clients, seed=n_clients)
    w = torch.randn(1024, LANES, generator=torch.Generator().manual_seed(1)
                    ).to(dev)
    mask = (g[0] > 0).float()
    pm.reset_launches()
    assert_bitwise(pm.client_rank_sort(g, cw),
                   pm.client_rank_sort_plain(g, cw))
    finite = torch.nan_to_num(g, nan=0.5, posinf=2.0, neginf=-2.0)
    for a, b in zip(pm.fedsgd_aggregate(w, finite, 0.1),
                    pm.fedsgd_aggregate_plain(w, finite, 0.1)):
        assert_bitwise(a, b)
    assert_bitwise(pm.masked_update_2d(w, finite[0], mask, 0.05),
                   pm.masked_update_plain(w, finite[0], mask, 0.05))
    torch.cuda.synchronize()
    assert pm.LAUNCHES["client_rank_sort"] == 1
    assert pm.LAUNCHES["fedsgd_aggregate"] == 1
    assert pm.LAUNCHES["masked_update_2d"] == 1


@pytest.mark.cuda
def test_robust_trainer_rounds_through_the_rank_sort(dev):
    """Three rounds of mlp-edge on the card under a scaled-malicious attack
    with the coordinate-wise median: the rank sort launches once a round,
    the weighted aggregate never, and packed equals reference."""
    rng = np.random.default_rng(5)
    clients = [ClientData(rng.normal(size=(40, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, 40).astype(np.int32))
               for _ in range(5)]
    a = np.ones((3, 5))
    sched = Schedule(a=a, lam=np.full((3, 5), 0.3), power=0.3 * a,
                     freq=3e8 * a, theta=0.0, energy=0.0, delay=0.0,
                     feasible=True)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(5), device="cpu")
    ch = ChannelModel(5)
    out = {}
    for backend in ("packed", "reference"):
        pm.reset_launches()
        tr = FederatedTrainer(
            cnn.make_loss_fn(cnn.mlp_edge_apply), params, clients, eta=0.1,
            batch_size=16, seed=0, backend=backend,
            fault_model=ScaledMalicious(rate=0.4, scale=10.0, seed=1),
            aggregator=make_aggregator("coord_median"))
        hist = tr.run(sched, SystemParams.table1(5), ch.uplink, ch.downlink)
        out[backend] = (tr, hist, dict(pm.LAUNCHES))
    (tp, hp, lp), (tr_, hr, _) = out["packed"], out["reference"]
    assert lp["client_rank_sort"] == 3
    assert lp["fedsgd_aggregate_weighted"] == 0
    assert [m.train_loss for m in hp] == [m.train_loss for m in hr]
    assert tp.agg_counters == tr_.agg_counters == {"n_excluded": 12}
    for k in tp.params:
        assert_bitwise(tp.params[k], tr_.params[k])


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    t = _inputs(dev, 3)
    with pytest.raises(ValueError, match="float32"):
        pm.exponent_histogram(t["q"].double(), t["pr"])
    with pytest.raises(ValueError, match="shape"):
        pm.importance_mask_batched(t["w"], t["v"][:256], t["pr"], t["thr"])
    with pytest.raises(ValueError, match="contiguous"):
        pm.importance_mask_2d(t["w"].t(), t["v"], t["pr"], t["thr"][0])
    with pytest.raises(ValueError, match="on cuda"):
        pm.fedsgd_aggregate_weighted(t["w"], t["grads"], t["cw"].cpu(),
                                     t["inv"], t["eta"])
    with pytest.raises(ValueError, match="on cuda"):
        pm.client_rank_sort(t["grads"], t["cw"].cpu())
    with pytest.raises(ValueError, match="shape"):
        pm.masked_update_2d(t["w"], t["v"][:256], t["pr"], 0.1)
    # the bf16 flash kernel loads 16 bytes a thread: rows of 68 bf16
    # (136 bytes) are refused, 72 (144 bytes) taken
    from repro_torch.kernels import flash_attention as fa
    for width, ok in ((68, False), (72, True)):
        q = torch.zeros((1, 2, 128, width), dtype=torch.bfloat16,
                        device=dev)[..., :64]
        if ok:
            fa.flash_attention(q, q, q)
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fa.flash_attention(q, q, q)
    # the plain version is for CPU tensors only
    with pytest.raises(ValueError, match="'torch'"):
        ops.packed_importance_masks(t["w"], t["v"], t["pr"], t["thr"],
                                    impl="torch")


def test_packed_backend_on_cuda_needs_a_weighted_loss():
    """Without a per-sample-weighted loss a ragged round could not stack,
    and on CUDA the packed backend never leaves the kernels for the
    host-threshold reference loop: the trainer refuses at construction,
    before it touches the card."""
    rng = np.random.default_rng(4)
    clients = [ClientData(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int32))
               for n in (40, 9)]
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(4), device="cpu")
    plain = cnn.make_loss_fn(cnn.mlp_edge_apply)

    def loss(p, x, y):                  # no .weighted companion
        return plain(p, x, y)

    with pytest.raises(ValueError, match="weighted loss"):
        FederatedTrainer(loss, params, clients, eta=0.1, batch_size=16,
                         backend="packed", device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("coarse", ["bisect", "histogram"])
def test_threshold_matches_cpu(dev, coarse):
    rng = np.random.default_rng(11)
    q = (1e-18 * rng.random(4096)).astype(np.float32)
    q[::7] = 0.0
    pr = np.ones(4096, np.float32)
    pr[:50] = 0.0
    q, pr = (torch.from_numpy(a.reshape(32, LANES)) for a in (q, pr))
    n_valid = int(pr.sum())
    ks = torch.tensor([0, 1, n_valid // 3, n_valid, n_valid + 7])
    want = tre.kth_smallest_threshold(q, pr, ks, coarse="bisect")
    got = tre.kth_smallest_threshold(q.to(dev), pr.to(dev), ks.to(dev),
                                     coarse=coarse)
    assert_bitwise(got, want)


@pytest.mark.cuda
def test_trainer_rounds_through_the_kernels(dev):
    """Four rounds of mlp-edge on the card, shared and per-client lambda:
    every kernel launches, and packed equals reference."""
    rng = np.random.default_rng(3)
    clients = [ClientData(rng.normal(size=(40, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, 40).astype(np.int32))
               for _ in range(4)]
    a = np.ones((4, 4))
    lam = np.full((4, 4), 0.4)
    lam[1] = [0.1, 0.3, 0.5, 0.7]
    sched = Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                     freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                     delay=0.0, feasible=True)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(3), device="cpu")
    ch = ChannelModel(4)
    out = {}
    for backend in ("packed", "reference"):
        pm.reset_launches()
        tr = FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                              clients, eta=0.1, batch_size=16, seed=0,
                              backend=backend)
        assert tr.device.type == "cuda"
        hist = tr.run(sched, SystemParams.table1(4), ch.uplink, ch.downlink)
        out[backend] = (tr, hist, dict(pm.LAUNCHES))
    launches = out["packed"][2]
    assert launches["exponent_histogram"] == 4
    assert launches["fedsgd_aggregate_weighted"] == 4
    assert launches["importance_mask_batched"] == 1
    assert launches["importance_mask_2d"] == 3
    assert set(out["reference"][2].values()) == {0}
    (tp, hp, _), (tr_, hr, _) = out["packed"], out["reference"]
    assert [m.train_loss for m in hp] == [m.train_loss for m in hr]
    for k in tp.params:
        assert_bitwise(tp.params[k], tr_.params[k])
        assert torch.equal(tp.global_grad[k], tr_.global_grad[k])


# -- kernels 4 and 2 (one-launch histogram, shared-threshold mask) ----------

SHAPE_ROWS = [256, 1024, 65536]
HIST_CASES = ["random", "zero", "one_bin", "nothing_prunable"]


def _hist_inputs(dev, rows, case, seed=0):
    """q and prunable [rows, 128]: the importance of random w and v (round
    > 0), all zero (round 0: every q in bin 0), all in one non-zero bin
    (1.5: byte 127), or nothing prunable (an empty histogram)."""
    gen = torch.Generator().manual_seed(seed)
    shape = (rows, LANES)
    pr = (torch.rand(shape, generator=gen) < 0.9).float()
    if case == "random":
        q = pm.importance(torch.randn(shape, generator=gen),
                          1e-2 * torch.randn(shape, generator=gen))
        q.reshape(-1)[::13] = -1.0               # a set sign bit: dropped
    elif case == "one_bin":
        q = torch.full(shape, 1.5)
    else:
        q = torch.zeros(shape)
    if case == "nothing_prunable":
        pr.zero_()
    return q.to(dev), pr.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("case", HIST_CASES)
@pytest.mark.parametrize("rows", SHAPE_ROWS)
def test_exponent_histogram_kernel_matches_plain(dev, rows, case):
    """Bin for bin, ten calls in a row (the ticket resets after each). At
    R = 65,536 each thread of the wrapper's grid takes several vectors."""
    q, pr = _hist_inputs(dev, rows, case, seed=rows)
    want = pm.exponent_histogram_plain(q, pr)
    assert int(want.sum()) == (0 if case == "nothing_prunable"
                               else int(((pr > 0) & (q >= 0)).sum()))
    for _ in range(10):
        assert_bitwise(pm.exponent_histogram(q, pr), want)


@pytest.mark.cuda
def test_exponent_histogram_alternating_sizes(dev):
    """Calls alternating between R = 256 and 65,536: the grid changes, and
    the one accumulator and ticket, left at 0 by each call, serve both."""
    small = _hist_inputs(dev, 256, "random", seed=1)
    large = _hist_inputs(dev, 65536, "random", seed=2)
    want = [pm.exponent_histogram_plain(*x) for x in (small, large)]
    for i in range(10):
        assert_bitwise(pm.exponent_histogram(*(small, large)[i % 2]),
                       want[i % 2])


@pytest.mark.cuda
def test_exponent_histogram_on_two_streams(dev):
    """Calls queued on two streams at once, with no order between them:
    each stream has its own accumulator and ticket, so both give the plain
    histogram on every call."""
    a = _hist_inputs(dev, 65536, "random", seed=3)
    b = _hist_inputs(dev, 65536, "zero", seed=4)
    want = [pm.exponent_histogram_plain(*x) for x in (a, b)]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    got = []
    for _ in range(5):
        got.append((0, pm.exponent_histogram(*a)))
        with torch.cuda.stream(side):
            got.append((1, pm.exponent_histogram(*b)))
    torch.cuda.synchronize(dev)
    for which, h in got:
        assert_bitwise(h, want[which])


@pytest.mark.cuda
def test_exponent_histogram_is_one_kernel_a_call(dev, tmp_path):
    """A torch.profiler trace of histogram calls (taken in a fresh
    process, `_fresh_trace`) holds the ticket kernel and nothing else: no
    fill of the output, no second pass. (The profiler may drop events, so
    the count is at most one a call.)"""
    q, pr = _hist_inputs(dev, 1024, "random")
    calls = 20
    kernels = _fresh_trace("repro_torch.kernels.pruning_mask:"
                           "exponent_histogram", (q, pr), {}, calls,
                           tmp_path)
    assert kernels, "the trace shows no device kernel"
    assert all("exponent_histogram_ticket_kernel" in k for k, _ in kernels), \
        kernels
    assert 1 <= sum(n for _, n in kernels) <= calls


@pytest.mark.cuda
@pytest.mark.parametrize("thr_case", ["-inf", "nextafter0", "nan", "middle"])
@pytest.mark.parametrize("rows", SHAPE_ROWS)
def test_importance_mask_2d_kernel_matches_plain(dev, rows, thr_case):
    """Bit for bit at a threshold of -inf (keep all), nextafter(0) (a
    subnormal that daz makes 0), NaN (k beyond the valid count: prune every
    prunable coordinate) and the middle k."""
    gen = torch.Generator().manual_seed(rows)
    shape = (rows, LANES)
    w = torch.randn(shape, generator=gen)
    v = 1e-2 * torch.randn(shape, generator=gen)
    v.reshape(-1)[::11] = 0.0
    v.reshape(-1)[3::17] = 3e-20                 # q subnormal: flushed
    pr = (torch.rand(shape, generator=gen) < 0.9).float()
    w, v, pr = w.to(dev), v.to(dev), pr.to(dev)
    q = pm.importance(w, v)
    thr = {"-inf": torch.tensor(-np.inf),
           "nextafter0": torch.tensor(np.nextafter(np.float32(0),
                                                   np.float32(1))),
           "nan": torch.tensor(np.nan),
           "middle": tre.kth_smallest_threshold(
               q, pr, int(pr.sum()) // 2).cpu()}[thr_case]
    thr = thr.float().to(dev)
    pq, pms = pm.importance_masks_plain(w, v, pr, thr)
    kq, km = pm.importance_mask_2d(w, v, pr, thr)
    assert_bitwise(kq, pq)
    assert_bitwise(km, pms[0])
    if thr_case in ("-inf", "nextafter0"):
        assert bool((km == 1).all())
    if thr_case == "nan":
        assert bool((km == (pr == 0).float()).all())


def _tiny_stack(rng, c, rows=1024):
    """[c, rows, 128] gradients of scale 1e-39 (subnormal) with normal rows
    and rows straddling FLT_MIN."""
    flt_min = np.finfo(np.float32).tiny
    g = (1e-39 * rng.normal(size=(c, rows, LANES))).astype(np.float32)
    g[:, :8] = rng.normal(size=(c, 8, LANES))
    g[:, 8:24] = flt_min * rng.uniform(-3, 3, size=(c, 16, LANES))
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("n_clients", [1, 3, 8])
def test_aggregate_tail_kernels_flush_subnormals(dev, n_clients):
    """Kernels 3, 5 and 7 against their plain versions on subnormal
    gradients and weights: every sum, difference and product flushed as
    XLA flushes it (a zero-weight client holds NaN)."""
    rng = np.random.default_rng(40 + n_clients)
    flt_min = np.finfo(np.float32).tiny
    w = rng.normal(size=(1024, LANES)).astype(np.float32)
    w[24:32] = 1e-39 * rng.normal(size=(8, LANES))
    w[32:40] = flt_min * rng.uniform(-2, 2, size=(8, LANES))
    g = _tiny_stack(rng, n_clients)
    cw = np.ones(n_clients, np.float32)
    if n_clients > 1:
        cw[-1] = 0.0
        g[-1] = np.nan
    w, g, cw = (torch.from_numpy(x).to(dev) for x in (w, g, cw))
    inv = torch.tensor(np.float32(1.0 / float(cw.sum())), device=dev)
    eta = torch.tensor(np.float32(0.15), device=dev)
    for a, b in zip(pm.fedsgd_aggregate_weighted(w, g, cw, inv, eta),
                    pm.fedsgd_aggregate_weighted_plain(w, g, cw, inv, eta)):
        assert_bitwise(a, b)
    g = torch.from_numpy(_tiny_stack(rng, n_clients)).to(dev)
    for a, b in zip(pm.fedsgd_aggregate(w, g, 0.15),
                    pm.fedsgd_aggregate_plain(w, g, 0.15)):
        assert_bitwise(a, b)
    m = torch.from_numpy(rng.random((1024, LANES)) < 0.7).float().to(dev)
    assert_bitwise(pm.masked_update_2d(w, g[0], m, 0.02),
                   pm.masked_update_plain(w, g[0], m, 0.02))


# -- kernels 3 and 7 (weighted aggregate, masked update) ----------------------

FLT_MIN = float(np.finfo(np.float32).tiny)
AGG_PATTERNS = ["live", "front", "middle", "end", "everywhere", "nonunit"]


def _client_weights(c, pattern, rng):
    """0/1 weights with zero-weight clients at the front, in the middle, at
    the end or everywhere; or scales in [0.2, 1.9] with a weight of 1.0
    and a subnormal one (compared as 0: its client is dead)."""
    cw = np.ones(c, np.float32)
    if pattern == "nonunit":
        cw = rng.uniform(0.2, 1.9, size=c).astype(np.float32)
        cw[c // 2] = 1.0
        cw[-1] = np.float32(3e-39) if c > 1 else cw[-1]
    elif pattern != "live":
        cw[{"front": [0], "middle": [c // 2], "end": [c - 1],
            "everywhere": list(range(c))}[pattern]] = 0.0
    return cw


def _check_weighted(dev, w, grads, cw_np, eta=0.1):
    """Kernel 3 against its plain version, bit for bit, dead clients
    holding NaN, inv = 1/(sum of live weights) (0 with none live)."""
    dead = torch.as_tensor(cw_np < FLT_MIN, device=dev)
    grads = torch.where(dead[:, None, None],
                        torch.full_like(grads, float("nan")), grads)
    n_live = float(cw_np[cw_np >= FLT_MIN].sum())
    inv = torch.tensor(np.float32(1.0 / n_live if n_live else 0.0),
                       device=dev)
    eta = torch.tensor(np.float32(eta), device=dev)
    cw = torch.from_numpy(cw_np).to(dev)
    outs = pm.fedsgd_aggregate_weighted(w, grads, cw, inv, eta)
    for a, b in zip(outs, pm.fedsgd_aggregate_weighted_plain(w, grads, cw,
                                                             inv, eta)):
        assert_bitwise(a, b)
        assert bool(torch.isfinite(a).all())
    return outs


@pytest.mark.cuda
@pytest.mark.parametrize("n_clients", range(1, 34))
def test_weighted_aggregate_kernel_every_client_count(dev, n_clients):
    """Every instantiation (C = 1..32) and the any-count path (33), under
    every weight pattern, at R = 1024."""
    rng = np.random.default_rng(n_clients)
    gen = torch.Generator(device=dev).manual_seed(n_clients)
    w = torch.randn((1024, LANES), generator=gen, device=dev)
    grads = torch.randn((n_clients, 1024, LANES), generator=gen, device=dev)
    for pattern in AGG_PATTERNS:
        outs = _check_weighted(dev, w, grads,
                               _client_weights(n_clients, pattern, rng))
        if pattern == "everywhere":
            assert bool((outs[1] == 0).all()) and bool((outs[2] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [256, 65536])
@pytest.mark.parametrize("n_clients", [1, 8, 10, 32, 33])
def test_weighted_aggregate_kernel_at_other_sizes(dev, n_clients, rows):
    """R = 256 (one vector a thread, fewer blocks than SMs) and 65,536
    (several vectors a thread)."""
    rng = np.random.default_rng(rows + n_clients)
    gen = torch.Generator(device=dev).manual_seed(rows + n_clients)
    w = torch.randn((rows, LANES), generator=gen, device=dev)
    grads = torch.randn((n_clients, rows, LANES), generator=gen, device=dev)
    for pattern in ("live", "front", "nonunit"):
        _check_weighted(dev, w, grads, _client_weights(n_clients, pattern,
                                                       rng))


def _round_up_to_flt_min(factor):
    """128 normal values whose exact product with `factor` lies just below
    FLT_MIN and rounds to FLT_MIN in fp32: XLA flushes those more than
    2^-151 below it."""
    f = np.float32(factor)
    x0 = np.float32(FLT_MIN / np.float64(f))
    xs = np.asarray([np.float32(x0 + k * np.spacing(x0))
                     for k in range(-256, 257)], np.float32)
    found = xs[(xs >= FLT_MIN) & (xs.astype(np.float64) * np.float64(f)
                                  < FLT_MIN) & (xs * f == FLT_MIN)]
    assert found.size, f"no value rounds up to FLT_MIN at factor {f}"
    return np.resize(found, LANES)


@pytest.mark.cuda
@pytest.mark.parametrize("n_clients,pattern", [
    (3, "live"), (8, "end"), (12, "front"), (13, "end"), (32, "middle"),
    (33, "nonunit")])
def test_weighted_aggregate_kernel_flushes_like_the_plain_version(
        dev, n_clients, pattern):
    """Subnormal gradients and weights, sums straddling FLT_MIN, and row 40
    of the first live client holding values whose product with inv rounds
    up to FLT_MIN (the edge test of mul_ftz)."""
    rng = np.random.default_rng(70 + n_clients)
    cw = _client_weights(n_clients, pattern, rng)
    w = rng.normal(size=(1024, LANES)).astype(np.float32)
    w[24:32] = 1e-39 * rng.normal(size=(8, LANES))
    w[32:40] = FLT_MIN * rng.uniform(-2, 2, size=(8, LANES))
    g = _tiny_stack(rng, n_clients)
    live = np.flatnonzero(cw >= FLT_MIN)
    inv = np.float32(1.0 / float(cw[live].sum()))    # as _check_weighted's
    g[:, 40] = 0.0
    g[live[0], 40] = _round_up_to_flt_min(inv)
    _check_weighted(dev, torch.from_numpy(w).to(dev),
                    torch.from_numpy(g).to(dev), cw, eta=0.15)


MASK_KINDS = ["keep", "scaled", "subnormal"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MASK_KINDS)
@pytest.mark.parametrize("rows", [256, 1024, 65536])
def test_masked_update_kernel_matches_plain(dev, rows, kind):
    """Kernel 7 bit for bit: keep-masks, masks of other values (scales, an
    overflow), and a mask of subnormals and signed zeros; w with NaN and
    inf, subnormal rows and rows at FLT_MIN's scale, eta*g rounding up to
    FLT_MIN."""
    rng = np.random.default_rng(rows + MASK_KINDS.index(kind))
    shape = (rows, LANES)
    w = rng.normal(size=shape).astype(np.float32)
    w[5] = 1e-39 * rng.normal(size=LANES)
    w[6] = FLT_MIN * rng.uniform(-2, 2, size=LANES)
    w[7, :6] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf]
    g = rng.normal(size=shape).astype(np.float32)
    g[8] = 1e-39 * rng.normal(size=LANES)
    g[9] = 2.0 * FLT_MIN * rng.uniform(1.0, 2.0, size=LANES)
    g[10] = _round_up_to_flt_min(0.02)
    m = (rng.random(shape) < 0.6).astype(np.float32)
    if kind == "scaled":
        m = rng.choice(np.asarray([0.5, -1.0, 3.0, 1e30, 0.0, 1.0],
                                  np.float32), size=shape)
    elif kind == "subnormal":
        m = rng.choice(np.asarray([-0.0, 0.0, 1.0, 3e-39, -1e-39],
                                  np.float32), size=shape)
    m[7, :6] = [0.0, 0.0, -0.0, 1.0, 1.0, 1.0]
    w, g, m = (torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
               for x in (w, g, m))
    out = pm.masked_update_2d(w, g, m, 0.02)
    assert_bitwise(out, pm.masked_update_plain(w, g, m, 0.02))
    assert bool(torch.isnan(out[7, :3]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["weighted_aggregate", "masked_update"])
def test_tail_kernel_is_one_kernel_a_call(dev, which, tmp_path):
    """A torch.profiler trace of kernel 3's (or 7's) calls (taken in a
    fresh process, `_fresh_trace`) holds that kernel and nothing else: no
    fill, no copy, no second pass. (The profiler may drop events, so the
    count is at most one a call.)"""
    t = _inputs(dev, 8)
    symbol, fn, args = {
        "weighted_aggregate": ("fedsgd_aggregate_weighted_kernel",
                               "fedsgd_aggregate_weighted",
                               (t["w"], t["grads"], t["cw"], t["inv"],
                                t["eta"])),
        "masked_update": ("masked_update_kernel", "masked_update_2d",
                          (t["w"], t["grads"][0], t["pr"], 0.1))}[which]
    calls = 20
    kernels = _fresh_trace(f"repro_torch.kernels.pruning_mask:{fn}", args,
                           {}, calls, tmp_path)
    assert kernels, "the trace shows no device kernel"
    assert all(symbol in k for k, _ in kernels), kernels
    assert 1 <= sum(n for _, n in kernels) <= calls


# -- the LM stack's kernels ---------------------------------------------------

LM_TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
          torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


def _assert_close(a, b, dtype):
    assert a.shape == b.shape and a.dtype == b.dtype
    torch.testing.assert_close(a.float(), b.float(), **LM_TOL[dtype])


def _normal(rng, shape, dev, dtype, scale=1.0):
    return torch.from_numpy((scale * rng.normal(size=shape)).astype(
        np.float32)).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (1, 256, 32, 8, 64, True, 0, 0.0),        # granite prefill
    (2, 384, 8, 2, 128, False, 0, 0.0),       # qwen-like head dim, GQA 4
    (1, 512, 4, 2, 64, True, 100, 0.0),       # sliding window, skipped tiles
    (1, 256, 16, 8, 256, True, 0, 50.0),      # gemma2 global layer
    (1, 384, 16, 8, 256, True, 128, 50.0),    # gemma2 local layer
    # lengths that are no multiple of the 64-row query / key tiles
    (1, 96, 8, 2, 64, True, 0, 0.0),
    (1, 200, 8, 2, 64, True, 0, 0.0),
    (2, 200, 4, 2, 64, False, 0, 0.0),        # ragged last key tile alone
    (1, 320, 4, 1, 64, True, 40, 0.0),        # window edge inside a tile
    (1, 256, 16, 4, 128, True, 0, 0.0),       # D 128, GQA 4, causal
    (1, 1024, 16, 8, 256, True, 256, 50.0),   # gemma2 local at 1024 tokens
    # grids large enough for two warpgroups a block sharing K / V tiles
    (1, 1024, 32, 8, 64, True, 0, 0.0),       # granite's 1024 bucket
    (2, 1000, 16, 4, 64, True, 0, 0.0),       # ragged
    (2, 1024, 16, 4, 128, True, 0, 0.0),
    (1, 1024, 25, 5, 64, True, 256, 0.0),     # hymba's heads: g = 5, window
    # hymba's exact-length prefills: ragged, under its window and a band
    (1, 999, 25, 5, 64, True, 1024, 0.0),
    (1, 777, 25, 5, 64, True, 256, 0.0),
    (1, 512, 48, 8, 128, True, 0, 0.0),       # mixtral's heads: g = 6
    (1, 2048, 8, 2, 64, True, 128, 0.0),      # a band across many tiles
    # whisper's decoder heads, g = 1 (one warpgroup): a 256 bucket, a
    # ragged prompt and its training layer's length
    (1, 256, 12, 12, 64, True, 0, 0.0),
    (1, 439, 12, 12, 64, True, 0, 0.0),
    (2, 4096, 12, 12, 64, True, 0, 0.0),
    # llama-vision's self layers, g = 8, D 128: its 1024 bucket
    (1, 1024, 64, 8, 128, True, 0, 0.0),
    # granite on 16 model ranks: 2 query heads on one repeated KV head
    (4, 1024, 2, 1, 64, True, 0, 0.0),
    # arctic's served bucket, g = 7 at D 128 (one warpgroup a block), and
    # qwen's heads, g = 8 over two KV heads
    (1, 1024, 56, 8, 128, True, 0, 0.0),
    (2, 1024, 16, 2, 128, True, 0, 0.0),
    # the edges of the warp-specialised kernel's 128-row query units and
    # 128-key tiles at D 64 and 128, over g = 1, 5, 6, 7, 8: a row short of
    # a tile, one tile, a row past it, ragged lengths, a window edge inside
    # a key tile, causal False over a ragged last tile, a cap
    (1, 127, 8, 2, 64, True, 0, 0.0),
    (1, 128, 8, 1, 128, True, 0, 0.0),
    (2, 129, 5, 1, 64, True, 0, 0.0),
    (1, 129, 6, 1, 128, False, 0, 0.0),
    (1, 439, 7, 1, 128, True, 0, 0.0),
    (1, 439, 8, 1, 64, False, 0, 0.0),
    (1, 1000, 8, 8, 128, True, 0, 0.0),
    (1, 1000, 5, 1, 128, True, 300, 0.0),
    (1, 640, 6, 1, 64, True, 200, 0.0),
    (1, 384, 7, 1, 64, True, 0, 30.0),
    (2, 1000, 6, 1, 128, False, 0, 30.0),
    # a training shape at B = 1: mixtral's heads over 4,096 tokens
    (1, 4096, 48, 8, 128, True, 0, 0.0),
])
def test_flash_attention_kernel_matches_plain(dev, dtype, b, s, hq, hkv, d,
                                              causal, window, cap):
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(d + s)
    q = _normal(rng, (b, s, hq, d), dev, dtype)
    k = _normal(rng, (b, s, hkv, d), dev, dtype)
    v = _normal(rng, (b, s, hkv, d), dev, dtype)
    kw = dict(causal=causal, window=window, cap=cap)
    plain = fa.flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), **kw).transpose(1, 2)
    pm.reset_launches()
    out = ops.flash_attention(q, k, v, **kw)       # model layout, by strides
    assert pm.LAUNCHES["flash_attention"] == 1
    torch.cuda.synchronize()
    _assert_close(out, plain, dtype)
    assert out.transpose(1, 2).is_contiguous() or out.is_contiguous()
    kl = fa.flash_attention(q.transpose(1, 2).contiguous(),
                            k.transpose(1, 2).contiguous(),
                            v.transpose(1, 2).contiguous(), **kw)
    _assert_close(kl.transpose(1, 2), plain, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,skv,causal,window", [
    (300, 439, False, 0),       # more keys than queries, ragged both
    (439, 129, False, 0),       # fewer keys: units past the last key tile
    (640, 1000, True, 0),       # causal: keys past the last query unused
    (1000, 800, True, 256),     # rows past the keys see a window's band
])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_kernel_cross_lengths(dev, d, sq, skv, causal,
                                              window):
    """bf16 kernel 8 at D 64 and 128 with Sq != Skv (the kernel masks on
    absolute positions, kpos <= qpos and kpos > qpos - window, as the plain
    version does), o and lse against the plain versions."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(sq + skv + d)
    q = _normal(rng, (2, 6, sq, d), dev, torch.bfloat16)
    k, v = (_normal(rng, (2, 2, skv, d), dev, torch.bfloat16)
            for _ in range(2))
    kw = dict(causal=causal, window=window, cap=0.0)
    o, lse = fa.flash_attention(q, k, v, lse=True, **kw)
    torch.cuda.synchronize()
    _assert_close(o, fa.flash_attention_plain(q, k, v, **kw), torch.bfloat16)
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     q.reshape(2, 2, 3, sq, d).float(), k.float())
    s = s / np.sqrt(d)
    qpos = torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    keep = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        keep &= kpos <= qpos
    if window:
        keep &= kpos > qpos - window
    want = torch.logsumexp(torch.where(keep, s, fa.NEG_INF), dim=-1)
    _assert_close(lse, want.reshape(2, 6, sq), torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_rerun_is_bitwise(dev, d):
    """No atomics, a fixed order of units: two bf16 forward calls on the
    same inputs give the same o and lse bits."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(d)
    q, k, v = (_normal(rng, (2, 1000, h, d), dev,
                       torch.bfloat16).transpose(1, 2) for h in (8, 2, 2))
    kw = dict(causal=True, window=300, cap=30.0)
    first = fa.flash_attention(q, k, v, lse=True, **kw)
    second = fa.flash_attention(q, k, v, lse=True, **kw)
    for a, b in zip(first, second):
        assert_bitwise(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bf16_runs_its_head_dims_kernel(dev, d, tmp_path):
    """A torch.profiler trace of bf16 forward calls (in a fresh process,
    `_fresh_trace`) holds only the kernel BF16_KERNELS names for the head
    dim: the warp-specialised TMA kernel at D 64 and 128, the cp.async
    wgmma kernel at D 256; never the CUDA-core kernel. (The profiler may
    drop events, so the kernel is asked to show at least once in 10
    calls.)"""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(d)
    args = [_normal(rng, (1, 512, h, d), dev, torch.bfloat16).transpose(1, 2)
            for h in (8, 2, 2)]
    names = [key for key, _ in _fresh_trace(
        "repro_torch.kernels.flash_attention:flash_attention", args,
        dict(causal=True, lse=True), 10, tmp_path)]
    assert names, "the trace shows no device kernel"
    assert all(f"{fa.BF16_KERNELS[d]}<" in n for n in names), names


BWD_CASES = [
    (1, 256, 32, 8, 64, True, 0, 0.0),        # granite's heads
    (2, 384, 8, 2, 128, False, 0, 0.0),       # D 128, GQA 4, no mask
    (1, 512, 4, 2, 64, True, 100, 0.0),       # window: skipped tiles
    (1, 256, 16, 8, 256, True, 0, 50.0),      # gemma2 global layer
    (1, 384, 16, 8, 256, True, 128, 50.0),    # gemma2 local layer
    (1, 200, 8, 2, 64, True, 0, 0.0),         # ragged query / key tiles
    (2, 200, 4, 2, 64, False, 0, 0.0),
    (1, 320, 4, 1, 64, True, 40, 0.0),        # window edge inside a tile
    (1, 256, 16, 4, 128, True, 0, 0.0),
    (2, 256, 4, 4, 64, True, 0, 30.0),        # g = 1 with a cap
    # D 128, g = 3 (one query head a dq block), window, cap, and a last key
    # block whose second warpgroup holds no key
    (1, 320, 6, 2, 128, True, 64, 30.0),
    # granite's heads over 1,024 tokens: many ring stages, 4 query heads a
    # kv tile, two warpgroups a block in both passes
    (2, 2048, 32, 8, 64, True, 0, 0.0),
    (1, 1024, 25, 5, 64, True, 256, 0.0),     # hymba's heads: g = 5, window
    (1, 512, 48, 8, 128, True, 0, 0.0),       # mixtral's heads: g = 6
    (1, 2048, 8, 2, 64, True, 128, 0.0),      # a band across many tiles
    (2, 1024, 12, 12, 64, True, 0, 0.0),      # whisper's heads: g = 1
    (1, 1024, 64, 8, 128, True, 0, 0.0),      # llama-vision's: g = 8
    (4, 1024, 2, 1, 64, True, 0, 0.0),        # granite a model rank: g = 2
    (1, 1024, 56, 8, 128, True, 0, 0.0),      # arctic's heads: g = 7
    (2, 1024, 16, 2, 128, True, 0, 0.0),      # qwen's: g = 8 on 2 KV heads
    # gemma2's heads at D 256 over grids that fill the split-D blocks: 32
    # key blocks a kv head, a window of 256 across many tiles at batch 2,
    # and a ragged length (the last query and key tiles part empty)
    (1, 2048, 16, 8, 256, True, 0, 50.0),
    (2, 1024, 16, 8, 256, True, 256, 50.0),
    (1, 1000, 16, 8, 256, True, 0, 50.0),
    # D 256 without a cap, and without a mask over ragged tiles: the
    # uncapped scores and the non-causal tile bounds of the split-D kernels
    (1, 1000, 16, 8, 256, True, 0, 0.0),
    (2, 320, 16, 8, 256, False, 0, 0.0),
]


def _bwd_inputs(dev, dtype, b, s, hq, hkv, d, causal, window, cap):
    """q, k, v, dO in the model layout [B,S,H,D] as kernel-layout views,
    and the forward kernel's (o, lse) on them."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(7 * d + s)
    q, k, v, do = (_normal(rng, (b, s, h, d), dev, dtype).transpose(1, 2)
                   for h in (hq, hkv, hkv, hq))
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                cap=cap, lse=True)
    return q, k, v, o, do, lse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain(dev, dtype, b, s, hq, hkv,
                                                  d, causal, window, cap):
    """dq, dk, dv of the backward kernel against its plain version (the
    blocked scan of flash_vjp) on the same (q, k, v, o, dO, lse), the
    forward's o and lse from kernel 8 (its lse against the plain scan's
    too), within the kernel tolerances."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    kw = dict(causal=causal, window=window, cap=cap)
    q, k, v, o, do, lse = _bwd_inputs(dev, dtype, b, s, hq, hkv, d, **kw)
    _, lse_plain = fa.flash_attention_lse_plain(q, k, v, **kw)
    _assert_close(lse, lse_plain, dtype)
    pm.reset_launches()
    grads = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert pm.LAUNCHES["flash_attention_bwd"] == 1
    torch.cuda.synchronize()
    for got, want, like in zip(grads, fab.flash_attention_bwd_plain(
            q, k, v, o, do, lse, **kw), (q, k, v)):
        assert got.stride() == like.stride()     # the model layout kept
        assert bool(torch.isfinite(got).all())
        _assert_close(got, want, dtype)


def _scaled_err(got, want) -> float:
    """max |got - want| over max |want|: the error at the output's own
    scale."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (4, 1024, 32, 8, 64, True, 0, 0.0),       # granite's heads
    (2, 2048, 16, 8, 128, True, 0, 0.0),      # D 128, two warpgroups
    (2, 384, 8, 2, 128, True, 128, 50.0),     # D 128, window, cap
    (1, 200, 8, 2, 64, False, 0, 0.0),        # ragged, no mask
    (4, 4096, 12, 12, 64, True, 0, 0.0),      # whisper's train layer, g = 1
    (1, 1024, 64, 8, 128, True, 0, 0.0),      # llama-vision's heads, g = 8
    (16, 4096, 2, 1, 64, True, 0, 0.0),       # rank 0's of granite, 16x16
    (1, 2048, 16, 8, 256, True, 0, 50.0),     # gemma2, D split in halves
    (2, 1024, 16, 8, 256, True, 256, 50.0),   # gemma2 under a window
    (1, 1000, 16, 8, 256, True, 0, 50.0),     # gemma2, ragged tiles
    (1, 1000, 16, 8, 256, True, 0, 0.0),      # D 256 without a cap
    (2, 320, 16, 8, 256, False, 0, 0.0),      # D 256, no mask, ragged
])
def test_flash_attention_bwd_bf16_at_each_outputs_scale(dev, b, s, hq, hkv,
                                                        d, causal, window,
                                                        cap):
    """The bf16 (wgmma) backward's dq, dk and dv each within 2e-2 of its
    own peak against the plain version, as phase 14 of chip_smoke.py holds
    them; the kernel fed dO one position late (a planted fault) must break
    that limit in each of the three."""
    from repro_torch.kernels import flash_attention_bwd as fab
    kw = dict(causal=causal, window=window, cap=cap)
    q, k, v, o, do, lse = _bwd_inputs(dev, torch.bfloat16, b, s, hq, hkv, d,
                                      **kw)
    want = fab.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    got = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    late = fab.flash_attention_bwd(q, k, v, o, do.roll(1, dims=2), lse, **kw)
    torch.cuda.synchronize()
    sound = [_scaled_err(x, w) for x, w in zip(got, want)]
    fault = [_scaled_err(x, w) for x, w in zip(late, want)]
    assert max(sound) <= 2e-2 < min(fault), (sound, fault)


@pytest.mark.cuda
def test_flash_attention_bwd_rejects_unaligned_bf16_rows(dev):
    """The bf16 backward loads 16 bytes a thread: rows of 68 bf16 (136
    bytes) are refused, 72 (144 bytes) taken; no fallback."""
    from repro_torch.kernels import flash_attention_bwd as fab
    lse = torch.zeros((1, 2, 128), dtype=torch.float32, device=dev)
    for width, ok in ((68, False), (72, True)):
        x = torch.zeros((1, 2, 128, width), dtype=torch.bfloat16,
                        device=dev)[..., :64]
        if ok:
            fab.flash_attention_bwd(x, x, x, x, x, lse)
        else:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fab.flash_attention_bwd(x, x, x, x, x, lse)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_attention_bwd_bf16_runs_the_wgmma_kernels(dev, d,
                                                        tmp_path):
    """A torch.profiler trace of bf16 backward calls at D 64, 128 and 256
    (taken in a fresh process, `_fresh_trace`) holds the tensor-core kernels of that head dim (dk/dv and dq on wgmma;
    at D 256 the kernels that split D across two warpgroups) beside the
    delta pass, no CUDA-core backward kernel and nothing else. (The
    profiler may drop events, so each kernel is asked to show at least
    once in 10 calls.)"""
    from repro_torch.kernels import flash_attention_bwd as fab
    kw = dict(causal=True, window=0, cap=0.0)
    args = _bwd_inputs(dev, torch.bfloat16, 1, 512, 8, 2, d, **kw)
    names = [key for key, _ in _fresh_trace(
        "repro_torch.kernels.flash_attention_bwd:flash_attention_bwd", args,
        kw, 10, tmp_path)]
    assert names, "the trace shows no device kernel"
    assert all("flash_bwd_" in n for n in names), names
    for kern in fab.WGMMA_KERNELS[d]:
        assert any(kern in n for n in names), (kern, names)
    assert not any(kern in n for kern in fab.CORE_KERNELS
                   for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_rerun_is_bitwise(dev, dtype, d):
    """No atomics: two calls on the same inputs give the same bits."""
    from repro_torch.kernels import flash_attention_bwd as fab
    kw = dict(causal=True, window=40, cap=30.0)
    q, k, v, o, do, lse = _bwd_inputs(dev, dtype, 2, 320, 8, 2, d, **kw)
    first = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    second = fab.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    for a, b in zip(first, second):
        assert_bitwise(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s,hq,hkv,d,window,cap", [
    (1024, 32, 8, 64, 0, 0.0), (384, 16, 8, 256, 128, 50.0),
    (200, 8, 2, 128, 0, 0.0), (1000, 25, 5, 64, 256, 0.0),
    (1024, 64, 8, 128, 0, 0.0)])
def test_flash_attention_lse_leaves_o_unchanged(dev, dtype, s, hq, hkv, d,
                                                window, cap):
    """Kernel 8 asked for lse gives o bit for bit as without it (the
    serving path passes none)."""
    from repro_torch.kernels import flash_attention as fa
    rng = np.random.default_rng(s)
    q, k, v = (_normal(rng, (1, s, h, d), dev, dtype).transpose(1, 2)
               for h in (hq, hkv, hkv))
    kw = dict(causal=True, window=window, cap=cap)
    o, lse = fa.flash_attention(q, k, v, lse=True, **kw)
    assert_bitwise(o, fa.flash_attention(q, k, v, **kw))
    assert lse.shape == (1, hq, s) and lse.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-9b", "hymba-1.5b",
                                  "mixtral-8x22b", "whisper-small",
                                  "llama-3.2-vision-90b", "qwen2.5-3b",
                                  "yi-9b", "arctic-480b"])
def test_flash_vjp_training_gradient_through_the_kernels(dev, arch):
    """loss_fn's gradient on a reduced model in fp32 under the train
    runtime (flash_vjp: kernel 8 with lse, the backward kernel; remat)
    against the naive path's autograd on the card, and each kernel
    launched as the layers and remat predict. Whisper and llama-vision
    take their memory input (random; llama-vision's gates opened to 0.7):
    the encoder's and the cross layers' attention stay on the naive path,
    so only the decoder's self-attention layers launch the kernels.
    Qwen's q/k/v biases are drawn non-zero (both packages initialise them
    to 0)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.launch.train import add_extra
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.tree import leaves
    cfg = get_config(arch).reduced()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    if cfg.family == "vlm":
        params["blocks"]["cross"]["gate"].fill_(0.7)
    gen = torch.Generator(device=dev).manual_seed(1)
    attn = params["blocks"].get("attn", {})
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name].copy_(torch.randn(attn[name].shape, generator=gen,
                                         device=dev))
    assert ("bq" in attn) == cfg.qkv_bias
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(2, 257)),
                           device=dev)
    extra = add_extra({}, rng, cfg, 2, dev) or None
    self_layers = cfg.num_layers
    if cfg.family == "vlm":
        self_layers -= cfg.num_layers // cfg.cross_attn_every

    def grads(rt):
        return leaves(value_and_grad(lambda p: T.loss_fn(
            p, toks[:, :-1], toks[:, 1:], cfg, rt, extra), params)[1])

    pm.reset_launches()
    got = grads(Runtime(attn_impl="flash_vjp", q_chunk=64, kv_chunk=64,
                        loss_chunk=64, remat=True))
    assert pm.LAUNCHES["flash_attention"] == 2 * self_layers
    assert pm.LAUNCHES["flash_attention_bwd"] == self_layers
    want = grads(Runtime(attn_impl="naive"))
    num = sum(float((a - b).double().square().sum()) for a, b in
              zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    assert (num / den) ** 0.5 < 1e-5


@pytest.mark.cuda
def test_dense_init_holds_one_fp32_draw(dev):
    """dense_init draws fp32 and scales it in place: over the call the
    card holds the fp32 draw and the bf16 result, no second fp32 copy (an
    arctic-480b expert leaf draws 17.8 GB), and the bits are those of the
    draw times the scale, cast."""
    from repro_torch.models.layers import dense_init
    shape, fan_in = (8, 1024, 1024), 1024
    n = int(np.prod(shape))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w = dense_init(torch.Generator(device=dev).manual_seed(0), fan_in, shape,
                   dev, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= n * (4 + 2)
    draw = torch.randn(shape, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    assert_bitwise(w, (draw * (1.0 / np.sqrt(fan_in))).to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("experts", [8, 128])
def test_moe_apply_on_the_card_equals_the_cpu_and_reruns_bitwise(dev,
                                                                experts):
    """moe_apply on a reduced mixtral in fp32 with 8 experts and with
    arctic's 128, at the default capacity factor (drops): the same experts
    and buckets as on the CPU, y within 1e-5, and on the card the output,
    the aux and every gradient bit for bit on a rerun (deterministic
    algorithms on: the dispatch's gathers have a sorted backward)."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("mixtral-8x22b").reduced(),
                              num_experts=experts)
    p = moe.moe_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(4, 256, cfg.d_model)).astype(np.float32))
    y_cpu, aux_cpu = moe.moe_apply(x, p, cfg)
    logits = x.reshape(-1, cfg.d_model) @ p["router"]
    pd = {k: v.to(dev).requires_grad_() for k, v in p.items()}
    xd = x.to(dev).requires_grad_()
    _, idx_d, _ = moe.route_topk(xd.detach().reshape(-1, cfg.d_model)
                                 @ pd["router"].detach(), 2)
    assert torch.equal(idx_d.cpu(), moe.route_topk(logits, 2)[1])
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = []
        for _ in range(2):
            y, aux = moe.moe_apply(xd, pd, cfg)
            loss = y.square().sum() + aux
            runs.append([y, aux, *torch.autograd.grad(
                loss, [xd] + [pd[k] for k in sorted(pd)])])
    finally:
        torch.use_deterministic_algorithms(prev)
    for a, b in zip(*runs):
        assert_bitwise(a.detach(), b.detach())
    torch.testing.assert_close(runs[0][0].detach().cpu(), y_cpu, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(runs[0][1].detach().cpu(), aux_cpu, rtol=1e-6,
                               atol=0)


def _decode_positions(case, b, skv, hkv):
    """Positions of a decode case: ragged (0, 1, mid, full, past the end),
    a chunk boundary of the split-KV kernel with one before and one after
    it, every row at 0, or a long cache (NS >= 8) at ragged positions."""
    from repro_torch.kernels import decode_attention as da
    chunk = da.split_chunk(skv, b * hkv)
    return {"ragged": [0, 1, 517, skv, skv + 9],
            "chunk edges": [chunk - 1, chunk, chunk + 1, 2 * chunk, skv],
            "all zero": [0] * b,
            "long cache": [0, 3 * chunk + 5, skv // 2, skv - 1, skv]}[case]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 64), (16, 2, 128),
                                      (16, 8, 256), (4, 4, 64)])
@pytest.mark.parametrize("case,skv", [("ragged", 1024), ("chunk edges", 1024),
                                      ("all zero", 1024),
                                      ("long cache", 4096)])
def test_decode_attention_kernel_matches_plain(dev, dtype, hq, hkv, d, case,
                                               skv):
    """Ragged positions, positions at the split-KV kernel's chunk edges,
    all rows at 0, and a cache split in 8 or more chunks, on a layer slice
    of a stacked [L, B, S, Hkv, D] cache, read in place."""
    from repro_torch.kernels import decode_attention as da
    rng = np.random.default_rng(hq + d)
    b = 5
    assert skv // da.split_chunk(skv, b * hkv) >= (8 if case == "long cache"
                                                   else 2)
    cache_k = _normal(rng, (2, b, skv, hkv, d), dev, dtype)
    cache_v = _normal(rng, (2, b, skv, hkv, d), dev, dtype)
    q = _normal(rng, (b, 1, hq, d), dev, dtype)
    pos_list = _decode_positions(case, b, skv, hkv)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    pm.reset_launches()
    out = ops.decode_attention(q, cache_k[1], cache_v[1], pos)
    assert pm.LAUNCHES["decode_attention"] == 1
    plain = da.decode_attention_plain(q.transpose(1, 2), cache_k[1],
                                      cache_v[1], pos).transpose(1, 2)
    torch.cuda.synchronize()
    _assert_close(out, plain, dtype)
    for r, p in enumerate(pos_list):
        if p == 0:                                # zero, as the TPU kernel
            assert bool((out[r] == 0).all())
    r = max(range(b), key=lambda i: 0 < pos_list[i] <= skv)
    one = ops.decode_attention(q[r:r + 1], cache_k[1, r:r + 1],
                               cache_v[1, r:r + 1], pos_list[r])
    _assert_close(one, out[r:r + 1], dtype)
    if pos_list[r] == 0:
        return
    from repro_torch.models.attention import decode_attention as model_dec
    _assert_close(model_dec(q[r:r + 1], cache_k[1, r:r + 1],
                            cache_v[1, r:r + 1], pos_list[r]), one, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_repeats_bit_for_bit(dev, dtype):
    """Two calls in a row give the same bits: the last block of each row
    resets its ticket counter, and the merge reads the partials in split
    order whichever block finished last."""
    rng = np.random.default_rng(7)
    b, skv, hq, hkv, d = 8, 2048, 32, 8, 64
    k = _normal(rng, (b, skv, hkv, d), dev, dtype)
    v = _normal(rng, (b, skv, hkv, d), dev, dtype)
    q = _normal(rng, (b, 1, hq, d), dev, dtype)
    pos = torch.tensor([0, 1, 255, 256, 257, 1000, 2047, 2048],
                       dtype=torch.int32, device=dev)
    outs = [ops.decode_attention(q, k, v, pos) for _ in range(3)]
    torch.cuda.synchronize()
    assert_bitwise(outs[0], outs[1])
    assert_bitwise(outs[0], outs[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,q,h,p,n,alog_hi", [(1, 128, 24, 64, 128, 16.0),
                                              (2, 64, 4, 32, 16, 4.0)])
def test_ssd_chunk_kernel_matches_plain(dev, dtype, b, q, h, p, n, alog_hi):
    from repro_torch.kernels import ssd_chunk as sc
    rng = np.random.default_rng(q + n)
    x = _normal(rng, (b, q, h, p), dev, dtype, 0.3)
    bb = _normal(rng, (b, q, n), dev, dtype, 0.3)
    cc = _normal(rng, (b, q, n), dev, dtype, 0.3)
    dt = torch.nn.functional.softplus(_normal(rng, (b, q, h), dev,
                                              torch.float32))
    a_log = torch.log(torch.linspace(1.0, alog_hi, h, device=dev))
    pm.reset_launches()
    outs = sc.ssd_chunk(x, bb, cc, dt, a_log)
    assert pm.LAUNCHES["ssd_chunk"] == 1
    plain = sc.ssd_chunk_plain(x, bb, cc, dt, a_log)
    torch.cuda.synchronize()
    _assert_close(outs[0], plain[0], dtype)
    for a, c in zip(outs[1:], plain[1:]):
        _assert_close(a, c, torch.float32 if dtype == torch.float32
                      else torch.bfloat16)


@pytest.mark.cuda
def test_ssd_chunked_pallas_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(3)
    b, s, h, p, n = 2, 256, 4, 64, 32
    x = _normal(rng, (b, s, h, p), dev, torch.float32, 0.3)
    bb = _normal(rng, (b, s, n), dev, torch.float32, 0.3)
    cc = _normal(rng, (b, s, n), dev, torch.float32, 0.3)
    dt = torch.nn.functional.softplus(_normal(rng, (b, s, h), dev,
                                              torch.float32))
    a_log = torch.log(torch.linspace(1.0, 4.0, h, device=dev))
    pm.reset_launches()
    y, fin = ops.ssd_chunked_pallas(x, bb, cc, dt, a_log, chunk=64)
    assert pm.LAUNCHES["ssd_chunk"] == 1        # every chunk in one call
    yc, fc = ops.ssd_chunked_pallas(*(t.cpu() for t in (x, bb, cc, dt,
                                                        a_log)), chunk=64)
    torch.testing.assert_close(y.cpu(), yc, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(fin.cpu(), fc, rtol=2e-4, atol=2e-4)


def _ssd_bf16_inputs(dev, b, q, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = _normal(rng, (b, q, h, p), dev, torch.bfloat16, 0.3)
    bb = _normal(rng, (b, q, n), dev, torch.bfloat16, 0.3)
    cc = _normal(rng, (b, q, n), dev, torch.bfloat16, 0.3)
    dt = torch.nn.functional.softplus(_normal(rng, (b, q, h), dev,
                                              torch.float32))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    return x, bb, cc, dt, a_log


@pytest.mark.cuda
@pytest.mark.parametrize("b,q,h,p,n", [
    (1, 128, 24, 64, 128),    # mamba2's chunk
    (1, 128, 4, 64, 16),      # hymba's N 16
    (2, 64, 4, 32, 16),       # P and N padded to one 64-column panel
    (1, 100, 4, 64, 128),     # a ragged chunk: Q = s < chunk
    (4, 128, 24, 64, 128),    # 512 tokens of mamba2 as B·nc batch rows
    (1, 256, 4, 64, 128),     # four warpgroups
])
def test_ssd_chunk_wgmma_kernel_matches_plain(dev, b, q, h, p, n):
    """The bf16 tensor-core kernel against the plain version on the same
    bf16 inputs, the bf16 kernel tolerance on y, the fp32 state and the
    decay."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _ssd_bf16_inputs(dev, b, q, h, p, n, seed=q + n + p)
    pm.reset_launches()
    outs = sc.ssd_chunk(*args)
    assert pm.LAUNCHES["ssd_chunk"] == 1
    plain = sc.ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    for got, want in zip(outs, plain):
        _assert_close(got, want, torch.bfloat16)


@pytest.mark.cuda
def test_ssd_chunk_wgmma_kernel_repeats_bit_for_bit(dev):
    """No atomics: two calls on the same inputs give the same bits."""
    from repro_torch.kernels import ssd_chunk as sc
    args = _ssd_bf16_inputs(dev, 4, 128, 24, 64, 128, seed=5)
    first, second = sc.ssd_chunk(*args), sc.ssd_chunk(*args)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert_bitwise(a, b)


@pytest.mark.cuda
def test_bf16_ssd_entry_is_one_launch_on_the_models_views(dev):
    """ops.ssd_chunked_pallas on bf16 views cut the way mamba2's layer cuts
    them (x, B, C split from one [B,S,d_inner+2N] tensor): one kernel
    launch for 4 chunks, within bf16 of the CPU's run of the same call."""
    rng = np.random.default_rng(9)
    bsz, s, h, p, n = 1, 512, 24, 64, 128
    xbc = _normal(rng, (bsz, s, h * p + 2 * n), dev, torch.bfloat16, 0.3)
    xi, bb, cc = torch.split(xbc, [h * p, n, n], dim=-1)
    x = xi.reshape(bsz, s, h, p)
    dt = torch.nn.functional.softplus(_normal(rng, (bsz, s, h), dev,
                                              torch.float32))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=dev))
    pm.reset_launches()
    y, fin = ops.ssd_chunked_pallas(x, bb, cc, dt, a_log, chunk=128)
    assert pm.LAUNCHES["ssd_chunk"] == 1
    yc, fc = ops.ssd_chunked_pallas(*(t.cpu() for t in (x, bb, cc, dt,
                                                        a_log)), chunk=128)
    _assert_close(y.cpu(), yc, torch.bfloat16)
    _assert_close(fin.cpu(), fc, torch.bfloat16)


@pytest.mark.cuda
def test_serving_engine_runs_through_the_flash_kernel(dev):
    """A reduced granite served on the card: every prefill longer than 128
    tokens goes through the kernel, once per layer, and the engine's tokens
    equal a sequential generation over the same padded prefill."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.serving import ServingEngine
    cfg = get_config("granite-3-2b").reduced()
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    rt = Runtime(attn_impl="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (150, 300, 140, 260, 200)]
    eng = ServingEngine(params, cfg, max_batch=2, max_seq=512, rt=rt,
                        prompt_buckets=(256, 384), device=dev)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=6)
    pm.reset_launches()
    done = eng.run_to_completion()
    assert pm.LAUNCHES["flash_attention"] == cfg.num_layers * len(prompts)
    assert len(done) == len(prompts)
    by_uid = {st.request.uid: st.generated for st in done}
    for uid in (0, 3):
        cache = T.init_cache(cfg, 1, 512, device=dev)
        pr = prompts[uid]
        padded = torch.as_tensor(eng.prefill_tokens(pr), device=dev).long()
        T.prefill(params, padded[None], cache, cfg, rt)
        tok, pos, out = int(pr[-1]), len(pr) - 1, []
        for _ in range(6):
            lg, _ = T.decode_step(params, torch.tensor([[tok]], device=dev),
                                  cache, pos, cfg, rt)
            tok = int(lg[0].argmax())
            out.append(tok)
            pos += 1
        assert by_uid[uid] == out


@pytest.mark.cuda
def test_whisper_engine_at_full_width_equals_sequential(dev):
    """whisper-small at full width (d 768, 12 heads of 64, its 51,865-word
    tied head) and 2 of its 12 decoder and encoder layers, in bf16, one
    shared encoder input [1, 1500, 768]: every prefill past 128 tokens
    goes through kernel 8 (g = 1) once a decoder layer, the engine's
    tokens equal a sequential generation over the same padded prefill
    (the first request of each bucket and one in a reused slot), and
    another encoder input changes the prefill's logits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.blocks import Runtime
    from repro_torch.serving import ServingEngine
    cfg = dataclasses.replace(get_config("whisper-small"), num_layers=2,
                              encoder_layers=2)
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    rt = Runtime(attn_impl="cuda")
    rng = np.random.default_rng(0)

    def memory():
        return {"encoder_input": torch.as_tensor(rng.normal(
            size=(1, cfg.encoder_tokens, cfg.d_model)), device=dev).to(
                torch.bfloat16)}

    extra = memory()
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in (150, 300, 140, 260, 200)]
    eng = ServingEngine(params, cfg, max_batch=2, max_seq=512, rt=rt,
                        prompt_buckets=(256, 384), extra=extra, device=dev)
    for pr in prompts:
        eng.submit(pr, max_new_tokens=6)
    pm.reset_launches()
    done = eng.run_to_completion()
    assert pm.LAUNCHES["flash_attention"] == cfg.num_layers * len(prompts)
    assert len(done) == len(prompts)
    by_uid = {st.request.uid: st.generated for st in done}
    for uid in (0, 1, 2):
        cache = T.init_cache(cfg, 1, 512, device=dev)
        pr = prompts[uid]
        padded = torch.as_tensor(eng.prefill_tokens(pr), device=dev).long()
        first, _ = T.prefill(params, padded[None], cache, cfg, rt, extra)
        tok, pos, out = int(pr[-1]), len(pr) - 1, []
        for _ in range(6):
            lg, _ = T.decode_step(params, torch.tensor([[tok]], device=dev),
                                  cache, pos, cfg, rt)
            tok = int(lg[0].argmax())
            out.append(tok)
            pos += 1
        assert by_uid[uid] == out
    other, _ = T.prefill(params, padded[None],
                         T.init_cache(cfg, 1, 512, device=dev), cfg, rt,
                         memory())
    assert float((other - first).abs().max()) > 1e-2


# -- multi-round blocks on CUDA graphs -----------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("body", BLOCK_BODIES)
def test_graph_block_step_equals_eager_round_steps(dev, body):
    """Two blocks of 4 rounds through the captured graphs (the second all
    replays) against 8 eager round_step calls: parameters, v, losses,
    thresholds, survivor and reducer counts bit for bit, and the kernels'
    launch counts equal."""
    eng, store, params, ops_, kw = block_case(dev, body, seed=7)
    w0, v0 = eng.init_buffers(params)
    pm.reset_launches()
    w, v = w0, v0
    ref = []
    for _rep in range(2):
        for k in range(4):
            xs, ys, args = round_args(store, ops_, kw, k)
            lams = args.pop("lams")
            w, v, losses, thr, _ = eng.round_step(w, v, xs, ys, lams, **args)
            ref.append((losses, thr, eng.last_n_ok, eng.last_agg_stat))
    torch.cuda.synchronize()
    eager_launches = dict(pm.LAUNCHES)
    pm.reset_launches()
    wb, vb = w0, v0
    got = []
    for _rep in range(2):
        wb, vb, losses, thrs = eng.block_step(wb, vb, store, *ops_, **kw)
        for k in range(4):
            got.append((losses[k], thrs[k], eng.last_n_ok[k],
                        eng.last_agg_stat[k]))
    torch.cuda.synchronize()
    assert dict(pm.LAUNCHES) == eager_launches
    assert eng.graphs_captured >= 1 and eng.graph_replays >= 4
    assert eng.graphs_captured + eng.graph_replays == 8
    assert_bitwise(wb, w)
    assert torch.equal(vb, v)
    for k, (a, b) in enumerate(zip(got, ref)):
        n = int(ops_[3][k % 4])
        assert_bitwise(a[0][:n], b[0])
        assert_bitwise(a[1].reshape(-1)[:b[1].numel()], b[1].reshape(-1))
        assert int(a[2]) == int(b[2])
        assert int(a[3]) == int(b[3])


@pytest.mark.cuda
def test_graphs_captured_bounded_by_body_keys(dev):
    """A trainer on the card over 24 rounds of varying selection size, block
    length and lambda (32-round blocks, eval every 5 rounds): the blocked
    run equals the per-round run bit for bit, uploads no batch, and
    captures one graph a distinct round body, whatever the rounds."""
    rng = np.random.default_rng(3)
    sizes = [40, 30, 7, 25, 33, 28]
    clients = [ClientData(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int32))
               for n in sizes]
    n_rounds, n = 24, len(sizes)
    a = np.zeros((n_rounds, n))
    for s in range(n_rounds):
        a[s, rng.choice(n, rng.integers(1, n + 1), replace=False)] = 1.0
    lam = np.where(rng.random((n_rounds, 1)) < 0.5,
                   np.round(rng.uniform(0.1, 0.5, (n_rounds, 1)), 2),
                   rng.uniform(0.1, 0.5, (n_rounds, n)))
    lam = np.broadcast_to(lam, a.shape).copy()
    sched = Schedule(a=a, lam=lam, power=0.3 * np.ones_like(a),
                     freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                     delay=0.0, feasible=True)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(3), device="cpu")
    ch = ChannelModel(n)
    out = {}
    for rpd in ("auto", 1):
        tr = FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                              clients, eta=0.1, batch_size=16, seed=0,
                              rounds_per_dispatch=rpd)
        hist = tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink,
                      eval_fn=lambda p: (0.0, 0.0), eval_every=5)
        out[rpd] = (tr, hist)
    (tb, hb), (t1, h1) = out["auto"], out[1]
    assert tb.rounds_per_dispatch == 32 and tb.n_batch_uploads == 0
    assert tb.n_block_dispatches > 1
    assert [m.train_loss for m in hb] == [m.train_loss for m in h1]
    for k in tb.params:
        assert_bitwise(tb.params[k], t1.params[k])
    eng = tb.engine
    # (bucket, shared lambda), times ragged blocks or not (client 2 holds
    # fewer samples than the batch)
    keys = {(tb.engine.bucket_size(int(a[s].sum())),
             len(set(np.floor(lam[s][a[s] > 0] * tb.pack.n_prunable)
                     .astype(int))) == 1) for s in range(n_rounds)}
    assert eng.graphs_captured == len(eng._graphs) <= 2 * len(keys)
    assert eng.graphs_captured + eng.graph_replays == n_rounds


@pytest.mark.cuda
def test_rank_sort_kernel_takes_a_subnormal_weight_as_zero(dev):
    """Kernel 6 flushes each client's weight before the > 0 test, as XLA
    compares it: a weight of 3e-39 sorts its client last, like weight 0,
    at C = 5 (the register network) and C = 33 (the generic kernel)."""
    for n_clients in (5, 33):
        g, cw = _rank_stack(dev, n_clients, seed=n_clients)
        cw = torch.ones_like(cw)
        cw[2] = 3e-39
        out = pm.client_rank_sort(g, cw)
        assert_bitwise(out, pm.client_rank_sort_plain(g, cw))
        cw0 = cw.clone()
        cw0[2] = 0.0
        assert_bitwise(out, pm.client_rank_sort_plain(g, cw0))


# -- the paper's CIFAR-10 path: local schemes and ResNet on the card ------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", list(LOCAL_BODIES))
def test_graph_local_block_step_equals_eager_round_steps(dev, name):
    """Two blocks of 4 rounds of a local scheme through the captured graphs
    (the second all replays) against 8 eager round_step calls: parameters,
    v, losses, thresholds, survivor counts and FedDyn's state bit for bit,
    and the kernels' launch counts equal."""
    eng, store, params, ops_, kw = local_block_case(dev, name, seed=7)
    cids, _, _, counts = ops_
    dyn = name == "feddyn"
    w0, v0 = eng.init_buffers(params)
    h_e = torch.zeros((6,) + tuple(w0.shape), device=dev) if dyn else None
    h_b = torch.zeros_like(h_e) if dyn else None
    pm.reset_launches()
    w, v = w0, v0
    ref = []
    for _rep in range(2):
        for k in range(4):
            xs, ys, args = round_args(store, ops_, kw, k)
            lams = args.pop("lams")
            if dyn:
                args.update(h=h_e, client_ids=cids[k, :int(counts[k])])
            w, v, losses, thr, _ = eng.round_step(w, v, xs, ys, lams, **args)
            ref.append((losses, thr, eng.last_n_ok))
    torch.cuda.synchronize()
    eager_launches = dict(pm.LAUNCHES)
    pm.reset_launches()
    wb, vb = w0, v0
    got = []
    for _rep in range(2):
        wb, vb, losses, thrs = eng.block_step(wb, vb, store, *ops_, h=h_b,
                                              **kw)
        for k in range(4):
            got.append((losses[k], thrs[k], eng.last_n_ok[k]))
    torch.cuda.synchronize()
    assert dict(pm.LAUNCHES) == eager_launches
    assert eng.graphs_captured >= 1 and eng.graph_replays >= 4
    assert eng.graphs_captured + eng.graph_replays == 8
    assert_bitwise(wb, w)
    assert torch.equal(vb, v)
    if dyn:
        assert_bitwise(h_b, h_e)
        assert float(h_b.abs().sum()) > 0
    for k, (a, b) in enumerate(zip(got, ref)):
        n = int(counts[k % 4])
        assert_bitwise(a[0][:n], b[0])
        assert_bitwise(a[1].reshape(-1)[:b[1].numel()], b[1].reshape(-1))
        assert int(a[2]) == int(b[2])


def _resnet_grads(dev, params, x, y):
    """ResNet's loss and packed gradient through the round engine."""
    from repro_torch.core import ParamPack, RoundEngine
    loss = cnn.make_loss_fn(cnn.resnet_apply)
    pack = ParamPack.build(params)
    eng = RoundEngine(loss, pack, eta=0.1, weighted_loss_fn=loss.weighted,
                      device=dev)
    sw = torch.ones(x.shape[0], device=dev)
    return eng._value_and_grad(pack.pack(params), x, y, sw)


def _leaf_grads(params, x, y, scope=True):
    """ResNet's loss and its gradient leaves, concatenated in flatten
    order, with or without the exact_fp32 scope."""
    import contextlib
    from repro_torch.device import exact_fp32
    from repro_torch.tree import leaves, unflatten
    ps = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    with (exact_fp32() if scope else contextlib.nullcontext()):
        loss = cnn.make_loss_fn(cnn.resnet_apply)(unflatten(params, ps), x,
                                                  y)
        g = torch.autograd.grad(loss, ps)
    return loss.detach(), torch.cat([t.reshape(-1) for t in g])


def _tf32_on():
    """Switch TF32 on for cuDNN convolutions globally; returns the undo."""
    conv = torch.backends.cudnn.conv
    prev = conv.fp32_precision
    conv.fp32_precision = "tf32"
    return lambda: setattr(conv, "fp32_precision", prev)


@pytest.mark.cuda
def test_resnet_gradients_ignore_the_callers_cudnn_flags(dev):
    """ResNet-20's loss and packed gradient on a CIFAR-shaped batch of 32:
    the same bits with TF32 and cuDNN's benchmark mode switched on
    globally as with the defaults (the engine's exact_fp32 scope), and the
    same bits as the leaf gradients the reference backend takes. Against
    an fp64 reference on the CPU the gradient is within 1e-3 relative L2
    (fp32 on cuDNN's deterministic algorithms; the same call without the
    scope under global TF32, the planted fault, misses it)."""
    from repro_torch.tree import tree_map
    params = cnn.resnet_init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(32, 32, 32, 3)).astype(np.float32))
    y = torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32))
    on_card = tree_map(lambda t: t.to(dev), params)
    xd, yd = x.to(dev), y.to(dev)
    l0, g0 = _resnet_grads(dev, on_card, xd, yd)
    flags = (torch.backends.cudnn.benchmark,
             torch.backends.cudnn.deterministic)
    undo = _tf32_on()
    try:
        torch.backends.cudnn.benchmark = True
        torch.backends.cudnn.deterministic = False
        l1, g1 = _resnet_grads(dev, on_card, xd, yd)
        _, g_tf32 = _leaf_grads(on_card, xd, yd, scope=False)
    finally:
        undo()
        (torch.backends.cudnn.benchmark,
         torch.backends.cudnn.deterministic) = flags
    assert_bitwise(l1, l0)
    assert_bitwise(g1, g0)
    _, g_leaf = _leaf_grads(on_card, xd, yd)
    n = g_leaf.numel()
    assert_bitwise(g0.reshape(-1)[:n], g_leaf)
    _, g64 = _leaf_grads(tree_map(lambda t: t.double(), params), x.double(),
                         y)

    def rel(g):
        return float((g.double().cpu() - g64).norm() / g64.norm())
    assert rel(g_leaf) < 1e-3
    assert rel(g_tf32) > 1e-3


@pytest.mark.cuda
def test_feddyn_restore_into_a_captured_trainer_then_replay(dev, tmp_path):
    """A blocked FedDyn trainer on the card runs 8 rounds with checkpoints
    after rounds 0 and 4; restoring round 4's checkpoint into the same
    trainer (its graphs captured, h written in place) and running rounds
    5-7 again replays the captured graphs to the uninterrupted run's
    parameters and FedDyn state, bit for bit."""
    from repro_torch.api.callbacks import (CheckpointCallback,
                                           restore_trainer_state)
    from repro_torch.core.local import make_local_scheme
    rng = np.random.default_rng(5)
    sizes = [40, 30, 25, 35, 28, 33]
    clients = [ClientData(rng.normal(size=(n, 28, 28, 1)).astype(np.float32),
                          rng.integers(0, 10, n).astype(np.int32))
               for n in sizes]
    n = len(sizes)
    a = (rng.random((8, n)) < 0.7).astype(np.float64)
    a[:, 0] = 1.0
    sched = Schedule(a=a, lam=0.3 * a, power=0.3 * np.ones_like(a),
                     freq=3e8 * np.ones_like(a), theta=0.0, energy=0.0,
                     delay=0.0, feasible=True)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(5), device="cpu")
    tr = FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                          clients, eta=0.1, batch_size=16, seed=0,
                          local_scheme=make_local_scheme("feddyn", steps=2,
                                                         alpha=0.1))
    ch = ChannelModel(n)
    ckpt = CheckpointCallback(str(tmp_path), 4)
    tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink,
           callbacks=[ckpt])
    want_w = tr.pack.pack(tr.params).clone()
    want_h = tr._h.clone()
    h_tensor, captured = tr._h, tr.engine.graphs_captured
    assert tr.n_block_dispatches >= 2 and tr.engine.graph_replays >= 1
    restore_trainer_state(ckpt.manager, tr, step=4)
    assert tr._h is h_tensor and not torch.equal(tr._h, want_h)
    replays = tr.engine.graph_replays
    tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink,
           start_round=5)
    assert tr.engine.graphs_captured == captured
    assert tr.engine.graph_replays == replays + 3
    assert_bitwise(tr.pack.pack(tr.params), want_w)
    assert_bitwise(tr._h, want_h)


# -- cohort streaming and the sweep's threads on the card ------------------------

class _SlowRoster:
    """A fleet roster whose clients take `delay` seconds each to generate:
    a cohort's prefetch is then still packing while the block before it
    runs (and captures its graphs)."""

    def __init__(self, roster, delay):
        self.roster, self.delay = roster, delay
        self.counts = roster.counts

    def __len__(self):
        return len(self.roster)

    def __getitem__(self, cid):
        import time
        time.sleep(self.delay)
        return self.roster[cid]

    def store_nbytes(self):
        return self.roster.store_nbytes()


def _fleet_trainer(clients, sched_a, mode, **kw):
    n = len(clients)
    params = cnn.mlp_edge_init(torch.Generator().manual_seed(4), device="cpu",
                               hidden=32)
    tr = FederatedTrainer(cnn.make_loss_fn(cnn.mlp_edge_apply), params,
                          clients, eta=0.1, batch_size=8, seed=0,
                          client_store=mode, **kw)
    sched = Schedule(a=sched_a, lam=0.3 * sched_a,
                     power=0.3 * np.ones_like(sched_a),
                     freq=3e8 * np.ones_like(sched_a), theta=0.0, energy=0.0,
                     delay=0.0, feasible=True)
    ch = ChannelModel(n)
    hist = tr.run(sched, SystemParams.table1(n), ch.uplink, ch.downlink)
    return tr, hist


@pytest.mark.cuda
def test_prefetch_in_flight_while_a_new_body_is_captured(dev):
    """Blocks of 4 rounds over a 48-client roster with a new client bucket
    in each block (so each block captures a new round body) while the next
    cohort is still being packed by its prefetch thread: the capture
    holds, the streamed run equals the replicated run bit for bit, and it
    captures exactly as many graphs, whatever the number of cohorts."""
    from repro_torch.data import make_fleet
    roster = make_fleet(population=48, n_train=48 * 20, n_test=16,
                        seed=2).roster
    rng = np.random.default_rng(1)
    a = np.zeros((16, 48))
    for s in range(16):
        k = (1, 3, 6, 12)[(s // 4) % 4]
        a[s, rng.choice(48, k, replace=False)] = 1.0
    ts, hs = _fleet_trainer(_SlowRoster(roster, 0.01), a, "streamed",
                            rounds_per_dispatch=4)
    tr, hr = _fleet_trainer(roster, a, "replicated", rounds_per_dispatch=4)
    assert ts.streaming and ts.fleet_counters["n_cohort_swaps"] == 4
    assert [m.train_loss for m in hs] == [m.train_loss for m in hr]
    for k in tr.params:
        assert_bitwise(ts.params[k], tr.params[k])
    assert ts.engine.graphs_captured == tr.engine.graphs_captured == 4
    assert ts.engine.graph_replays == tr.engine.graph_replays == 12


@pytest.mark.cuda
def test_a_slot_is_not_rewritten_while_a_replay_reads_it(dev):
    """Cohort 0 sits in slot 0; a read of slot 0 is queued behind a ~50 ms
    delay kernel on the compute stream, then cohorts 1 and 2 are acquired
    (2 goes to slot 0 again). The copy of cohort 2 waits for that read: the
    read sees cohort 0's rows, and afterwards slot 0 holds cohort 2's."""
    from repro_torch.core import CohortStore
    from repro_torch.data import make_fleet
    roster = make_fleet(population=30, n_train=600, n_test=8, seed=3).roster
    plans = [(0, np.asarray([[0, 1, 2, 3]], np.int32), np.asarray([4])),
             (1, np.asarray([[4, 5, 6, 7]], np.int32), np.asarray([4])),
             (2, np.asarray([[8, 9, 10, 11]], np.int32), np.asarray([4]))]
    store = CohortStore(roster, max_clients=30, device=dev)
    store.schedule(plans)
    c0 = store.acquire(0)
    rows0 = torch.as_tensor(c0.remap(plans[0][1])[0], device=dev).long()
    want0 = np.stack([roster[i].x[:10] for i in range(4)])
    torch.cuda._sleep(int(1e8))               # the queued replay's delay
    seen = c0.x[rows0, :10].clone()           # ... and its read of slot 0
    store.acquire(1)
    c2 = store.acquire(2)
    assert c2.slot == c0.slot == 0
    torch.cuda.synchronize()
    np.testing.assert_array_equal(seen.cpu().numpy(), want0)
    rows2 = torch.as_tensor(c2.remap(plans[2][1])[0], device=dev).long()
    np.testing.assert_array_equal(
        c2.x[rows2, :10].cpu().numpy(),
        np.stack([roster[i].x[:10] for i in range(8, 12)]))
    store.close()


@pytest.mark.cuda
def test_exact_fp32_from_two_threads_keeps_resnet_gradient_bits(dev):
    """Two threads take ResNet-20's gradient through the engine (each
    inside exact_fp32) while a third enters and leaves the scope in a
    loop, under global TF32 and cuDNN benchmarking: every gradient is the
    single-threaded one, bit for bit."""
    import threading
    from repro_torch.device import exact_fp32
    from repro_torch.tree import tree_map
    params = cnn.resnet_init(torch.Generator().manual_seed(0), device="cpu")
    on_card = tree_map(lambda t: t.to(dev), params)
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(32, 32, 32, 3)).astype(np.float32),
                        device=dev)
    y = torch.as_tensor(rng.integers(0, 10, 32).astype(np.int32), device=dev)
    _, g_ref = _resnet_grads(dev, on_card, x, y)
    undo = _tf32_on()
    bench = torch.backends.cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    stop = threading.Event()
    bad = []

    def toggler():
        while not stop.is_set():
            with exact_fp32():
                pass

    def grads():
        for _ in range(6):
            _, g = _resnet_grads(dev, on_card, x, y)
            if not torch.equal(_bits(g), _bits(g_ref)):
                bad.append(int((_bits(g) != _bits(g_ref)).sum()))

    try:
        ts = [threading.Thread(target=f) for f in (toggler, grads, grads)]
        for t in ts:
            t.start()
        for t in ts[1:]:
            t.join()
        stop.set()
        ts[0].join()
    finally:
        undo()
        torch.backends.cudnn.benchmark = bench
    assert bad == []


@pytest.mark.cuda
def test_launch_counts_stay_exact_under_two_sweep_workers(dev):
    """Four blocked cells on two sweep workers: each thread captures its own
    round bodies while the other launches, and the wrappers' counts add up
    to one histogram, one aggregate and one mask a round over all cells,
    as with one worker; the per-run records are byte-identical."""
    import glob
    import os
    import tempfile
    from repro_torch import api
    base = api.ExperimentSpec(
        data=api.DataSpec(dataset="synthetic-mnist", n_clients=6, sigma=5.0,
                          n_train=600, n_test=60, seed=0),
        model=api.ModelSpec(name="mlp-edge"),
        wireless=api.WirelessSpec(e0=1e6, t0=1e6, seed=0),
        scheme=api.SchemeSpec(name="random_k", rounds=12, eta=0.1, batch=8,
                              ao={"k": 3, "lam": 0.3, "seed": 1}),
        run=api.RunSpec(seed=0, eval_every=4, stop_on_budget=False))
    sw = api.SweepSpec(base=base, seeds=[0, 1, 2, 3])
    out = {}
    for workers in (1, 2):
        d = tempfile.mkdtemp()
        pm.reset_launches()
        res = api.run_sweep(sw, sink=api.JsonlDirSink(d), workers=workers)
        assert res.errors == []
        out[workers] = (dict(pm.LAUNCHES), {
            os.path.basename(p): open(p, "rb").read()
            for p in glob.glob(os.path.join(d, "0*.jsonl"))})
    n_rounds = 4 * 12
    for workers, (counts, _) in out.items():
        assert counts["exponent_histogram"] == n_rounds, workers
        assert counts["fedsgd_aggregate_weighted"] == n_rounds, workers
        assert counts["importance_mask_2d"] + \
            counts["importance_mask_batched"] == n_rounds, workers
    assert out[1][1] == out[2][1] and len(out[1][1]) == 4


# -- the sharded client axis: two gloo ranks sharing the card -------------------

@pytest.fixture(scope="module")
def card_shards():
    """Each rank's results of tests/_torch_shards.py `card_cases`, from
    one spawn of two gloo ranks on the card (the parent builds the kernels
    first: the ranks must not race nvcc)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels build with nvcc for sm_90a")
    import _torch_shards
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import spawn_shards
    _build.load()
    return spawn_shards(_torch_shards.card_cases, 2, device="cuda:0",
                        timeout_s=600, threads=None)


@pytest.mark.cuda
def test_sharded_mean_round_on_two_ranks_is_the_replay_of_its_partials(
        card_shards):
    """A per-client-lambda round at 2 ranks: v is the host's shard-order
    replay of the gathered partials bit for bit, the losses are one rank's,
    w within 1e-6 of one rank's."""
    for r in card_shards:
        m = r["multi"]
        assert m["replay_bitwise"] and m["round_losses_bitwise"]
        assert m["round_w_max_err"] <= 1e-6 * m["round_w_scale"]


@pytest.mark.cuda
def test_sharded_robust_round_on_two_ranks_equals_one_rank(card_shards):
    for r in card_shards:
        m = r["coord_median"]
        assert m["round_w_bitwise"] and m["round_v_bitwise"]
        assert m["round_losses_bitwise"]


@pytest.mark.cuda
@pytest.mark.parametrize("body", ["multi", "coord_median"])
def test_sharded_capture_split_block_equals_its_rounds(card_shards, body):
    """Two blocks of 4 rounds, each round two graphs around the host's
    gather, against 8 sharded round_steps: bit for bit, one collective a
    round, the same kernel launches; both ranks end on the same (w, v)."""
    for r in card_shards:
        m = r[body]
        assert m["block_rounds_bitwise"] and m["block_w_bitwise"]
        assert m["block_v_equal"]
        assert m["block_collectives"] == 8
        assert m["launches_blocked"] == m["launches_eager"]
        assert m["launches_blocked"]["exponent_histogram"] == 8
        assert m["graphs_captured"] >= 2 and m["graphs_captured"] % 2 == 0
        assert m["graphs_captured"] + m["graph_replays"] == 16
    assert card_shards[0][body]["digest"] == card_shards[1][body]["digest"]


# -- the LM's sharded train step (sharding/rules.py on DTensor) -------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_lm_step_on_a_one_by_one_mesh_is_the_unsharded_step(dev, dtype):
    """Reduced granite (2 layers, d_model 256, heads of 64) under the
    training runtime on the card: the step on DTensors over a 1 x 1 mesh
    (a fake world of one rank; attention through local_map into kernel 8
    and the backward) equals the unsharded step bit for bit, and each
    step launches both kernels as many times (kernel 8 twice a layer,
    remat)."""
    import dataclasses

    import torch.distributed as dist

    import _torch_lm_shards as shards
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.kernels.counters import LAUNCHES, reset_launches
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config("granite-3-2b").reduced(
        layers=2, d_model=256), dtype=dtype)
    cfg, rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])
    rt = dataclasses.replace(rt, q_chunk=64, kv_chunk=64, loss_chunk=64)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    masks = tree_map(lambda w: (torch.rand(w.shape, generator=gen,
                                           device=dev) > 0.3).to(
        torch.uint8), params)
    tok = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen,
                        device=dev, dtype=torch.int32)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    reset_launches()
    try:
        loss_eq, params_eq, l1, l0 = shards.one_by_one(
            cfg, rt, params, masks, batch, "cuda")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert loss_eq and params_eq, (l1, l0)
    assert LAUNCHES["flash_attention"] == 2 * 2 * cfg.num_layers
    assert LAUNCHES["flash_attention_bwd"] == 2 * cfg.num_layers


# -- the train step that holds only its state (launch/steps.py) -------------------

@pytest.mark.cuda
def test_train_step_holds_only_its_state(dev):
    """granite-3-2b at full width, 2 of its 40 layers, bf16, 2 x 4,096
    tokens in 2 microbatches under specialize's train runtime (kernel 8
    with lse and the backward): the step equals the straightforward
    reference step (tests/_torch_train_step_reference.py) bit for bit,
    and its peak allocation above what the caller holds (weights, masks,
    batch) stays under the step's state, the masked copy (2 bytes a
    parameter) and the fp32 accumulator (4), plus an activation
    allowance: the peak of a forward-only run of one microbatch with its
    graph kept and remat off (every activation the backward could hold
    at once; under remat it holds a layer's at a time, which leaves room
    for the gradients autograd still sums). The reference, which holds
    the whole gradient tree beside its accumulator, peaks above that
    bound (PERF.md has the measured peaks)."""
    import dataclasses
    import json

    import _torch_train_step_reference as reference
    from repro_torch.configs import get_config
    from repro_torch.configs.registry import INPUT_SHAPES
    from repro_torch.launch import steps
    from repro_torch.models import transformer as T
    from repro_torch.tree import leaves, tree_map
    cfg = dataclasses.replace(get_config("granite-3-2b"), num_layers=2)
    cfg, rt = steps.specialize(cfg, INPUT_SHAPES["train_4k"])
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    masks = tree_map(lambda w: (torch.rand(w.shape, generator=gen,
                                           device=dev) > 0.3).to(
        torch.uint8), params)
    tok = torch.randint(0, cfg.vocab_size, (2, 4097), generator=gen,
                        device=dev)
    batch = {"tokens": tok[:, :-1].contiguous(),
             "labels": tok[:, 1:].contiguous()}
    n = sum(w.numel() for w in leaves(params))

    def peak_of(fn):
        torch.cuda.synchronize()
        floor = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - floor

    with torch.no_grad():
        req = tree_map(lambda w, m: (w * m.to(w.dtype)).requires_grad_(),
                       params, masks)
    loss, fwd = peak_of(lambda: T.loss_fn(
        req, batch["tokens"][:1], batch["labels"][:1], cfg,
        dataclasses.replace(rt, remat=False)))
    del loss, req
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, step_peak = peak_of(lambda: steps.make_train_step(
            cfg, rt, microbatches=2)(params, masks, batch))
        want, ref_peak = peak_of(lambda: reference.make_train_step(
            cfg, rt, microbatches=2)(params, masks, batch))
    finally:
        torch.use_deterministic_algorithms(False)
    state = n * (2 + 4)
    allowance = fwd
    print(json.dumps({"train_step_memory": "granite-3-2b 2 layers, 2 x 4096, "
                      "2 microbatches", "params": n,
                      "state_gib": state / 2**30,
                      "forward_only_gib": fwd / 2**30,
                      "step_peak_gib": step_peak / 2**30,
                      "reference_peak_gib": ref_peak / 2**30}))
    assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
    for a, b in zip(leaves(got[1]), leaves(want[1])):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert step_peak <= state + allowance < ref_peak, (
        step_peak, state, allowance, ref_peak)


def _sec5_records():
    """scripts/sec5_records.py: the Sec. V matrix, records and comparison."""
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts"))
    import sec5_records
    return sec5_records


@pytest.mark.cuda
def test_sec5_distributions_match_jax(dev):
    """The paper's Sec. V comparison on the card: benchmarks/common.py's six
    SCHEMES x run.seed 0-7 at examples/feel_paper_reproduction.py's settings
    through the port's sweep service (32-round blocks on CUDA graphs, one
    pooled trainer), each run from the port's own initial weights. Every
    scheme's schedule as run (selected ids, per-client lambda, delay and
    energy a round, rounds completed, the budgets spent) equals JAX's bit
    for bit, and each scheme's mean final accuracy and mean train loss over
    the last 10 rounds lie within 3 standard errors of JAX's 8 seeds:
    |m_port - m_jax| <= 3 sqrt(s_port^2 / 8 + s_jax^2 / 8). JAX's numbers
    come from tests/torch_fixtures/sec5_jax.json
    (scripts/make_sec5_jax_reference.py, on the CPU); one seed's outcome
    is a draw (tests/test_torch_paper_sec5.py), so only the distributions
    are compared."""
    import json
    import repro_torch.api as api
    sec5 = _sec5_records()
    reference = sec5.load_reference()
    res = api.run_sweep(sec5.sec5_sweep(api, sec5.SEEDS), device=dev)
    assert not res.errors, res.errors
    port = sec5.collect(res.cells, res.results)
    cmp = sec5.compare(port, reference)
    print("\n" + "\n".join(sec5.table(cmp["port"], cmp["jax"],
                                      cmp["checks"])))
    print(json.dumps({"sec5_distributions": cmp["checks"],
                      "port": cmp["port"], "jax": cmp["jax"]}))
    assert not cmp["schedule_problems"], cmp["schedule_problems"]
    outside = {name: {stat: r for stat, r in c.items()
                      if r["ok"] is not True}
               for name, c in cmp["checks"].items()}
    assert not any(outside.values()), outside


@pytest.mark.cuda
def test_sec5_trajectory_is_chaotic_on_the_card(dev):
    """The Sec. V chaos on the card (tests/test_torch_paper_sec5.py pins it
    on the CPU): fixed_selection's schedule cut to rounds 0-20, 21-round
    blocks on CUDA graphs, from seed 0's weights and from them times
    (1 + 2^-22). Until a keep-mask flips at a near-tie the two runs differ
    by float noise (1.13e-6 relative at most over rounds 0-4 on an H100);
    the flip moves the train loss ~1e-3."""
    import dataclasses
    import json
    import repro_torch.api as api
    sec5 = _sec5_records()
    spec = sec5.spec_from_config(api, sec5.ExpConfig(), "fixed_selection",
                                 eval_every=sec5.EVAL_EVERY)
    spec = dataclasses.replace(spec, run=dataclasses.replace(
        spec.run, evaluate=False))
    n = 21
    runs = []
    for scale in (1.0, float(np.float32(1 + 2 ** -22))):
        run = api.Experiment(spec).build(device=dev)
        s = run.schedule
        run.schedule = dataclasses.replace(s, a=s.a[:n], lam=s.lam[:n],
                                           power=s.power[:n],
                                           freq=s.freq[:n])
        w = run.env.init_fn(torch.Generator().manual_seed(0), device=dev)
        run.trainer.reset({k: v * torch.tensor(scale, device=dev)
                           for k, v in w.items()}, 0)
        runs.append(run.run().history)
    d = [abs(a.train_loss - b.train_loss) / abs(b.train_loss)
         for a, b in zip(*runs)]
    print(json.dumps({"sec5_chaos_train_loss_rel_diff": d}))
    assert len(d) == n
    assert max(d[:5]) <= 1e-5, d[:5]
    assert d[20] > 1e-4, d
