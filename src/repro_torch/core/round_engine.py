"""Packed round engine (paper Sec. II-A, eqs. 2-7).

The port of ``repro/core/round_engine.py``. One
``round_step`` runs a whole round on the device over the packed
``[R, 128]`` parameter buffer (core/packing.py):

  1. importance Q = (w * v)^2 (eq. 4), denormals zero;
  2. the global pruning threshold — the k-th smallest prunable importance,
     k = floor(lambda * M_prunable) — by bisection over fp32 bit patterns
     (`kth_smallest_threshold`), on the device;
  3. the keep-masks from one importance+mask kernel: one shared mask when
     every selected client has the same k, else one mask per client;
  4. per-client mini-batch gradients on the pruned model (eq. 5), taken by
     autograd with respect to the packed buffer, masked on the device; or,
     with a local-update scheme (core/local.py), each client's E local
     steps from its pruned start, uploading the sum of its step
     directions (FedAvg, FedProx's proximal term, FedDyn's correction
     state, `_local_client`);
  5. the fault operands (per-client factors `cf`, additive poison), the
     non-finite quarantine, then the fused weighted aggregate + FedSGD step
     kernel (eqs. 6-7) — or, with a robust `aggregator`, its reducer (the
     rank-sort kernel for the median and the trimmed mean) and the same
     update tail with inv = 1; with channel noise the server steps with
     mean + noise. The aggregate is the next round's v;
  6. FedDyn only: the per-client state h [N, R, 128] of every client whose
     upload survived moves by -alpha*(u_E - u0), in place (`h_scatter`).

The client axis is padded to the JAX package's bucket size (`bucket_capacity`);
padding clients replicate the last real batch and carry weight 0, so they
never touch the update. Ragged clients ride per-sample 0/1 weights through
the weighted loss. Only the integers k and the scalar 1/C come from the
host, with the fault and noise operands; nothing in the round syncs the
device.

``block_step`` runs K rounds from one upload of the block's schedule
operands, gathering every batch on the device from a `ClientStore`
(core/client_store.py): the port of the JAX package's ``lax.scan`` block.
On CUDA each distinct round body (client bucket, shared or per-client
lambda, batch length, sample weights, the noise / fault / poison operands)
is captured once as a CUDA graph and replayed once a round; the first round
of a body runs eagerly as its real round and serves as the capture's
warm-up. On the CPU the same body runs eagerly. Either way each round is
exactly the body ``round_step`` runs, so a block is bit for bit K
``round_step`` calls.

On the CPU the kernels' plain versions run and the engine reproduces the
reference trainer value for value; on CUDA the kernels are bit-identical to
the plain versions, so the same holds there.

Sharded client axis (``shards`` > 1, the JAX package's ``shard_map`` over
the mesh's ``data`` axis). One process is one shard (launch/mesh.py): every
rank holds (w, v) replicated and computes the threshold and the shared mask
itself; client position j of the bucketed axis (``bucket_capacity`` with
``shards``: a multiple of the shard count) belongs to rank ``j // (C_b /
shards)``, which runs that client's update (the per-client masks from its
local thresholds, kernel 1). The ranks meet in exactly one collective a
round, an all-gather (`collectives` counts them):

  * the mean path gathers each rank's [R*L + 2 + C_b/S] row: its weighted
    partial gradient sum, its (weighted, surviving) client counts and its
    losses. Every rank then sums the partials in shard order with the
    flushing add (XLA:CPU's psum order, so the sum is the JAX package's
    bit for bit), renormalizes over the survivors and steps (`_shard_tail`);
  * the robust path gathers the post-fault uploads and their quarantine
    weights; the reducer runs on the full stack on every rank;
  * FedDyn gathers the raw uploads and state deltas; the whole tail (faults,
    quarantine, aggregate, step, state scatter) runs on every rank.

The robust and FedDyn rounds are bit for bit the unsharded ones (the same
ops on the same stack); the mean path reassociates only the cross-shard sum.
On CUDA a sharded round body is two captured graphs, before and after the
collective: the host copies the rank's row out, gathers and copies the rows
in between their replays, so this path syncs the host once a round where
the JAX package's stays on the device.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.packing import LANES, ParamPack
from repro_torch.device import CAPTURE_LOCK, exact_fp32, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.counters import capturing, count_launch
from repro_torch.tree import tree_map


def kth_smallest_threshold(q: torch.Tensor, prunable: torch.Tensor, k, *,
                           coarse: str | None = None) -> torch.Tensor:
    """Threshold such that exactly k prunable entries are strictly below it.

    The k-th smallest prunable importance nudged one ulp up (`nextafter`),
    matching `pruning.global_threshold` bit for bit. `k` may be a scalar or
    a [C] vector of per-client counts. Importance is non-negative, so value
    order is the int32 order of the bit patterns and the k-th smallest is
    found by bisection with one masked count per step (no sort).

    `coarse="histogram"` prepends a 256-bin histogram of the exponent byte
    (the exponent_histogram kernel on CUDA) whose cumulative counts pin
    bits 30..23, leaving a 23-step mantissa bisection; `"bisect"` is the
    plain 31-step search. None picks "histogram" for CUDA tensors and
    "bisect" for CPU tensors, as the JAX package picks per backend. Both
    modes are exact. k > 0 beyond the valid count saturates to NaN, k <= 0
    gives -inf.
    """
    if coarse is None:
        coarse = "histogram" if q.is_cuda else "bisect"
    if coarse not in ("histogram", "bisect"):
        raise ValueError(f"unknown coarse mode {coarse!r}")
    bits = q.reshape(-1).contiguous().view(torch.int32)
    valid = prunable.reshape(-1) > 0
    k = torch.as_tensor(k, dtype=torch.int32, device=q.device)

    if coarse == "histogram":
        hist = ops.packed_exponent_histogram(q, prunable)
        cum = torch.cumsum(hist, 0)
        # k beyond the valid count would give bin 256 and overflow the shift;
        # the clamp degrades it to the same answer the plain bisection gives
        top = torch.searchsorted(cum, k.long(), right=False)
        top = torch.clamp(top, max=255).to(torch.int32)
        lo = top << 23
        hi = lo | ((1 << 23) - 1)
        steps = 23
    else:
        lo = torch.zeros(k.shape, dtype=torch.int32, device=q.device)
        hi = torch.full(k.shape, 2**31 - 1, dtype=torch.int32,
                        device=q.device)
        steps = 31
    for _ in range(steps):
        mid = lo + (hi - lo) // 2    # (lo+hi)//2 overflows int32 for q >= 2.0
        below = valid & (bits <= mid[..., None])
        ge = below.sum(dim=-1) >= k
        lo, hi = torch.where(ge, lo, mid + 1), torch.where(ge, mid, hi)
    kth = lo.view(torch.float32)
    inf = torch.full_like(kth, float("inf"))
    nxt = torch.nextafter(kth, inf)
    # k beyond the valid count ends on a NaN bit pattern; XLA's nextafter
    # returns the canonical quiet NaN for it, and so does the port
    nxt = torch.where(torch.isnan(nxt), torch.full_like(nxt, float("nan")),
                      nxt)
    return torch.where(k > 0, nxt, -inf)


def h_scatter(h: torch.Tensor, cid: torch.Tensor, upd: torch.Tensor) -> None:
    """h[cid[c]] += upd[c] for each c in order, in place, each add flushed
    as XLA's scatter-add is on the CPU: FedDyn's state update. A repeated
    id (the round's padding clients repeat the last real one, adding +0.0)
    adds to the row its earlier entries left, as the sequential scatter
    does. Gathers the rows, updates them and writes them back with
    `index_copy_` (repeated ids then write equal rows): deterministic with
    no atomics and no host sync, so a CUDA graph can capture it."""
    rows = h.index_select(0, cid)
    same = cid[:, None] == cid[None, :]
    for c in range(cid.shape[0]):
        new = ops.flush_add(rows[c], upd[c])
        rows = torch.where(same[c][:, None, None], new, rows)
    h.index_copy_(0, cid, rows)


def bucket_capacity(n_clients: int, *, shards: int = 1, bucket: bool = True,
                    max_clients: int | None = None) -> int:
    """Padded client-axis size for a round selecting `n_clients`: the JAX
    package's formula, shards * next_pow2(ceil(n / shards)), the per-shard
    bucket capped at ceil(max_clients / shards) (padding clients cost real
    gradient FLOPs, so full participation never pads past the population).
    `bucket=False` pads to a multiple of the shard count only."""
    per = -(-int(n_clients) // shards)
    if bucket:
        p2 = 1 << (per - 1).bit_length()
        if max_clients is not None:
            p2 = min(p2, max(per, -(-int(max_clients) // shards)))
        per = p2
    return per * shards


def resolve_shards(shards: int | None) -> int:
    """Shard count of the client axis: the explicit argument, then the
    REPRO_ROUND_SHARDS environment variable, then the world size of an
    initialised default process group, else 1. The engine raises when the
    count is above 1 and no process group of that size is there."""
    if shards is not None:
        return max(1, int(shards))
    env = os.environ.get("REPRO_ROUND_SHARDS")
    if env:
        return max(1, int(env))
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def shard_order_sum(recv: torch.Tensor, rl: int):
    """The sharded mean path's reduction of its gathered rows recv [S, n]:
    the partial sums recv[:, :rl] added in shard order with the flushing
    add (the order of the JAX package's psum on XLA:CPU), and the
    (weighted, surviving) counts recv[:, rl:rl + 2] summed. Returns (sum
    [rl], counts [2])."""
    gsum, cnt = recv[0, :rl], recv[0, rl:rl + 2]
    for s in range(1, recv.shape[0]):
        gsum = ops.flush_add(gsum, recv[s, :rl])
        cnt = cnt + recv[s, rl:rl + 2]
    return gsum, cnt


def replay_shard_mean(recv: torch.Tensor, rl: int, inv) -> torch.Tensor:
    """The host's replay of a sharded mean-path round's broadcast gradient
    (v') from the rows its collective gathered (`RoundEngine.last_gathered`):
    `shard_order_sum` on the CPU, then the mean, with the host's `inv` when
    every weighted client survived and 1/survivors otherwise. A reference
    for checks of the engine; the engine does not call it."""
    gsum, cnt = shard_order_sum(recv.detach().cpu(), rl)
    n_w, n_ok = cnt[0], cnt[1]
    inv_eff = (torch.as_tensor(inv, dtype=torch.float32)
               if bool(n_ok == n_w) else 1.0 / torch.clamp(n_ok, min=1.0))
    return ops.flush_mul(gsum, inv_eff)


class RoundEngine:
    """Packed-buffer round (pruning -> client updates -> aggregate) on one
    device.

    loss_fn(params, x, y) -> scalar is differentiated through `pack.unpack`,
    so gradients live on the packed buffer. weighted_loss_fn(params, x, y,
    sample_weights) carries ragged clients; without it sample weights are
    ignored. `aggregator` (core/aggregators.py) replaces the weighted mean
    with a robust reducer; None keeps the mean path. `local_scheme`
    (core/local.LocalScheme) makes each client run E local steps; None is
    the single-gradient FedSGD body. The kernels are the CUDA ones on a
    CUDA device and their plain versions on the CPU (kernels/ops.py,
    impl="auto"); device=None means CUDA. `shards` (`resolve_shards`) > 1
    shards the client axis over `group` (a launch.mesh.ShardGroup; None:
    `launch.mesh.current_group()`), which must have that many ranks.
    """

    def __init__(self, loss_fn: Callable, pack: ParamPack, *, eta: float,
                 weighted_loss_fn: Callable | None = None,
                 max_clients: int | None = None, aggregator=None,
                 local_scheme=None, device=None, shards: int | None = None,
                 group=None):
        self.pack = pack
        self.eta = float(eta)
        self.max_clients = int(max_clients) if max_clients else None
        self.aggregator = aggregator
        self.local_scheme = local_scheme
        self.device = resolve_device(device)
        self.shards = resolve_shards(shards)
        self.group = None
        if self.shards > 1:
            if group is None:
                from repro_torch.launch.mesh import current_group
                group = current_group(self.device)
            if group is None or group.world != self.shards:
                raise ValueError(
                    f"shards={self.shards} needs a process group of "
                    f"{self.shards} ranks (launch.mesh.init_shards or "
                    "spawn_shards); "
                    + ("none is initialised" if group is None
                       else f"this one has {group.world}"))
            self.group = group
        # the rank's client positions [lo, hi) of a bucket: see _bounds
        self.rank = 0 if self.group is None else self.group.rank
        # collectives issued (one a sharded round); host seconds in the
        # collectives themselves, and in the copies out before them (which
        # wait for the device's work of the round so far)
        self.collectives = 0
        self.gather_seconds = 0.0
        self.sync_seconds = 0.0
        # the rows of the most recent sharded round's collective
        self.last_gathered = None
        self.prunable = torch.as_tensor(pack.prunable_mask(),
                                        device=self.device)
        self._eta = torch.tensor(np.float32(eta), device=self.device)
        self._zero_stat = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self.buckets_used: set[int] = set()
        # block lengths run by block_step (the pow2 ladder of the trainer)
        self.k_buckets_used: set[int] = set()
        # CUDA graphs of the block's round bodies, by body key (see
        # _BlockLayout); the store tensors they gather from (a ClientStore's,
        # or a cohort store's two slots) are baked into them
        self._graphs: dict[tuple, _RoundGraph] = {}
        self._graph_src: tuple | None = None
        self._graph_h = None
        self._graph_wv: tuple[torch.Tensor, torch.Tensor] | None = None
        self._capture_stream = None
        # CUDA graphs captured and replayed (a sharded body is two graphs,
        # both replayed each round)
        self.graphs_captured = 0
        self.graph_replays = 0
        # host seconds spent in _capture (the eager round and the capture)
        self.capture_seconds = 0.0
        # device constants by (bucket, selected count) / sample-weight shape
        self._cw_cache: dict[tuple, torch.Tensor] = {}
        self._sw_cache: dict[tuple, torch.Tensor] = {}
        # survivor count of the most recent round (lazy device int32)
        self.last_n_ok = None
        # the robust reducer's count of the most recent round (clients
        # trimmed / clipped / excluded; 0 on the mean path), lazy int32
        self.last_agg_stat = None
        # FedDyn: the state tensor the most recent dispatch updated in place
        self.last_h = None
        if weighted_loss_fn is not None:
            def packed_loss(wp, x, y, sw):
                return weighted_loss_fn(pack.unpack(wp), x, y, sw)
        else:
            def packed_loss(wp, x, y, sw):
                return loss_fn(pack.unpack(wp), x, y)
        self._packed_loss = packed_loss

    # -- round bodies -------------------------------------------------------

    def _value_and_grad(self, wp, x, y, sw):
        wp = wp.detach().requires_grad_(True)
        with torch.enable_grad(), exact_fp32():
            loss = self._packed_loss(wp, x, y, sw)
            (g,) = torch.autograd.grad(loss, wp)
        return loss.detach(), g

    def _grads(self, start, xs, ys, sw):
        """The FedSGD client axis: client c's masked gradient at its pruned
        start, `start(c)` -> (pruned buffer, mask [R, L]) (the shared mask,
        or w * masks[c] formed inside its own step). Returns (losses [C],
        masked grads [C, R, L])."""
        losses, grads = [], []
        for c in range(xs.shape[0]):
            u0, mask = start(c)
            loss, g = self._value_and_grad(u0, xs[c], ys[c], sw[c])
            losses.append(loss)
            grads.append(g * mask)
        return torch.stack(losses), torch.stack(grads)

    def _local_client(self, u0, mask, xs, ys, sw, hm=None):
        """One client's E local steps (xs [E, B, ...]) from its pruned start
        u0 = w * mask: each step takes the masked gradient at the current
        iterate, adds the scheme's regularizer (FedProx / FedDyn,
        `ops.packed_local_delta`; hm is FedDyn's masked state row),
        accumulates the direction into the upload and steps u <- u -
        eta*d, every op flushed as XLA flushes it. The upload starts from
        zeros, so it is 0 + d_0 + ..., as the JAX package's (the first add
        turns a -0.0 into +0.0). Returns (loss at step 0, upload, FedDyn's
        state delta alpha*(u_E - u0) or None). The JAX package pads E to a
        power of two with steps that are exact no-ops; running exactly E
        steps gives its bits."""
        ls = self.local_scheme
        u, acc, loss0 = u0, torch.zeros_like(u0), None
        for t in range(xs.shape[0]):
            loss, g = self._value_and_grad(u, xs[t], ys[t], sw[t])
            g = g * mask
            d = (g if ls.name == "fedavg" else
                 ops.packed_local_delta(g, u, u0, ls.coeff, hm=hm))
            acc = ops.flush_add(acc, d)
            u = ops.flush_sub(u, ops.flush_mul(self.eta, d))
            if t == 0:
                loss0 = loss
        hd = (ops.flush_mul(ls.alpha, ops.flush_sub(u, u0)) if ls.stateful
              else None)
        return loss0, acc, hd

    def _locals(self, start, xs, ys, sw, hms=None):
        """The local-step client axis (xs [C, E, B, ...]), `start` as in
        `_grads`; hms the selected clients' masked FedDyn state [C, R, L]
        or None. Returns (losses [C], uploads [C, R, L], state deltas
        [C, R, L] or None)."""
        out = [self._local_client(*start(c), xs[c], ys[c], sw[c],
                                  None if hms is None else hms[c])
               for c in range(xs.shape[0])]
        losses, ups, hds = zip(*out)
        return (torch.stack(losses), torch.stack(ups),
                None if hds[0] is None else torch.stack(hds))

    def _client_axis(self, start, masks, xs, ys, sw, h, cid):
        """Client updates of one round: the FedSGD gradients, or the local
        steps with FedDyn's state rows h[cid] (masked by `masks`, one mask
        or [C] of them) when h is given. Returns (losses, uploads, state
        deltas or None)."""
        if self.local_scheme is None:
            return (*self._grads(start, xs, ys, sw), None)
        hms = None if h is None else h.index_select(0, cid) * masks
        return self._locals(start, xs, ys, sw, hms)

    def _aggregate_update(self, w, v, grads, cw, inv, noise=None, cf=None,
                          poison=None):
        """Faults, quarantine, aggregate and FedSGD step.

        `cf` ([C] per-client factors, 1.0 = clean) scales each client's
        masked gradient, then `poison` ([C, R, L], zero = clean) is added —
        the corrupt-upload and byzantine axes (core/faults.py). The
        always-on non-finite guard zeroes the weight of any client that went
        non-finite and renormalizes over the survivors. A robust aggregator
        then reduces the stack with those weights and its survivor-normalized
        (and flushed) aggregate takes the update tail unscaled (inv=None:
        the reference's * 1.0 is exact, and XLA drops it); the mean
        path takes the weighted aggregate kernel, or, with channel `noise`
        ([R, L], zero on padding lanes), the plain weighted sum and the tail
        that rounds inv*gsum before adding the noise. When no client
        survives, (w, v) are carried unchanged. The factor and the poison
        are flushed as XLA flushes them (subnormal inputs and results are
        zeros of their sign), like the rest of the tail.
        Returns (w', v', step, n_ok, agg_stat, cw_eff), as the JAX
        package's: the quarantine's weights decide whose FedDyn state
        moves."""
        if cf is not None:
            grads = ops.flush_mul(grads, cf[:, None, None])
        if poison is not None:
            grads = ops.flush_add(grads, poison)
        cw_eff, inv_eff, n_ok, alive = ops.packed_client_quarantine(
            grads, cw, inv)
        if self.aggregator is not None:
            ghat, ast = self.aggregator.reduce(grads, cw_eff)
            w2, g, step = ops.packed_apply_mean_update(
                w, ghat, None, self._eta, noise=noise)
        elif noise is None:
            ast = self._zero_stat
            w2, g, step = ops.packed_fedsgd_update_weighted(
                w, grads, cw_eff, inv_eff, self._eta)
        else:
            ast = self._zero_stat
            gsum = ops.packed_weighted_grad_sum(grads, cw_eff)
            w2, g, step = ops.packed_apply_mean_update(
                w, gsum, inv_eff, self._eta, noise=noise)
        w2 = torch.where(alive, w2, w)
        g = torch.where(alive, g, v)
        return w2, g, step, n_ok, ast, cw_eff

    def _tail(self, w, v, ups, hds, cw, inv, h, cid, faults):
        """The aggregate and step, then FedDyn's state: h[cid] -= hd for
        every client whose upload survived the quarantine (a subnormal
        weight is dead, as XLA compares it flushed); the others, padding
        clients included, add exact +0.0."""
        w2, g, step, n_ok, ast, cw_eff = self._aggregate_update(
            w, v, ups, cw, inv, **faults)
        if hds is not None:
            live = ops.flush(cw_eff)[:, None, None] > 0.0
            h_scatter(h, cid, torch.where(live, -hds, 0.0))
        return w2, g, step, n_ok, ast

    def _round_shared(self, w, v, xs, ys, sw, cw, inv, k, h=None, cid=None,
                      **faults):
        """One shared-lambda round; `faults` are _aggregate_update's
        noise / cf / poison, (h, cid) FedDyn's state and the ids of its
        rows."""
        q = ops.importance(w, v)
        thr = kth_smallest_threshold(q, self.prunable, k)
        _, mask = ops.packed_importance_mask(w, v, self.prunable, thr)
        pruned = w * mask
        losses, ups, hds = self._client_axis(lambda c: (pruned, mask), mask,
                                             xs, ys, sw, h, cid)
        w2, g, step, n_ok, ast = self._tail(w, v, ups, hds, cw, inv, h, cid,
                                            faults)
        return w2, g, losses, thr, step, n_ok, ast

    def _round_multi(self, w, v, xs, ys, sw, cw, inv, ks, h=None, cid=None,
                     **faults):
        """One per-client-lambda round."""
        q = ops.importance(w, v)
        thr = kth_smallest_threshold(q, self.prunable, ks)      # [C]
        _, masks = ops.packed_importance_masks(w, v, self.prunable, thr)
        losses, ups, hds = self._client_axis(
            lambda c: (w * masks[c], masks[c]), masks, xs, ys, sw, h, cid)
        w2, g, step, n_ok, ast = self._tail(w, v, ups, hds, cw, inv, h, cid,
                                            faults)
        return w2, g, losses, thr, step, n_ok, ast

    # -- sharded bodies: the client axis over the ranks ---------------------

    def _bounds(self, c_b: int) -> tuple[int, int]:
        """This rank's client positions [lo, hi) of a bucket of c_b."""
        per = c_b // self.shards
        return self.rank * per, (self.rank + 1) * per

    def _shard_part(self, w, v, xs, ys, sw, cw, k, shared: bool, c_b: int,
                    h=None, cid=None, cf=None, poison=None):
        """The rank's half of a sharded round, up to its collective: the
        threshold (replicated; [C_b] per-client thresholds when not
        `shared`), the rank's client updates on its batches (xs, ys, sw:
        its C_b/S positions only) and the row it sends, flat fp32:

          * mean path: its weighted partial sum of the post-fault uploads
            (the quarantine's weights: a non-finite upload weighs 0), its
            (weighted, surviving) client counts, its losses;
          * robust path: its post-fault uploads, their quarantine weights,
            its losses;
          * FedDyn (h given): its raw uploads and state deltas, its losses.

        cw, cf, poison and cid are the whole bucket's (the rank slices
        them). Returns (thresholds, row)."""
        lo, hi = self._bounds(c_b)
        q = ops.importance(w, v)
        thr = kth_smallest_threshold(q, self.prunable, k)
        if shared:
            _, mask = ops.packed_importance_mask(w, v, self.prunable, thr)
            pruned = w * mask
            masks, start = mask, (lambda c: (pruned, mask))
        else:
            # the rank's masks from its local thresholds: one launch of the
            # batched kernel over the replicated (w, v)
            _, masks = ops.packed_importance_masks(w, v, self.prunable,
                                                   thr[lo:hi])
            start = (lambda c: (w * masks[c], masks[c]))
        losses, ups, hds = self._client_axis(
            start, masks, xs, ys, sw, h, None if cid is None else cid[lo:hi])
        return thr, self._shard_row(losses, ups, hds, cw, c_b, cf, poison)

    def _shard_row(self, losses, ups, hds, cw, c_b: int, cf=None,
                   poison=None) -> torch.Tensor:
        """The row `_shard_part` sends, from the rank's losses, uploads and
        FedDyn state deltas (or None) and the bucket's cw / cf / poison."""
        lo, hi = self._bounds(c_b)
        if hds is not None:
            parts = (ups, hds)
        else:
            if cf is not None:
                ups = ops.flush_mul(ups, cf[lo:hi, None, None])
            if poison is not None:
                ups = ops.flush_add(ups, poison[lo:hi])
            fin = torch.isfinite(ups).flatten(1).all(dim=1)
            cwl = cw[lo:hi].float()
            cwe = cwl * fin.float()
            if self.aggregator is None:
                parts = (ops.packed_weighted_grad_sum(ups, cwe),
                         torch.stack([cwl.sum(), cwe.sum()]))
            else:
                parts = (ups, cwe)
        return torch.cat([p.reshape(-1) for p in parts]
                         + [losses.reshape(-1).float()])

    def _exchange(self, send: torch.Tensor, recv: torch.Tensor) -> None:
        """The round's one collective: every rank's row into recv [S, n]."""
        self.group.all_gather_into(send, recv)
        self.collectives += 1
        self.gather_seconds += self.group.last_gather_s
        self.sync_seconds += self.group.last_copy_s
        self.last_gathered = recv

    def _shard_tail(self, w, v, recv, c_b: int, cw, inv, h=None, cid=None,
                    noise=None, cf=None, poison=None):
        """The replicated half of a sharded round, from the gathered rows
        recv [S, n]: the mean path sums the partials in shard order with
        the flushing add, renormalizes the mean over the surviving count
        (the host `inv` passes through when every weighted client
        survived) and steps; the robust path reduces the full stack and
        steps with inv = 1; FedDyn runs `_tail` on the full stacks. No
        survivor: (w, v) carried. Returns (w', v', losses [C_b], step,
        n_ok, agg_stat)."""
        per = c_b // self.shards
        rows, lanes = w.shape
        rl = w.numel()
        losses = recv[:, recv.shape[1] - per:].reshape(c_b)
        if h is not None:
            ups = recv[:, :per * rl].reshape(c_b, rows, lanes)
            hds = recv[:, per * rl:2 * per * rl].reshape(c_b, rows, lanes)
            w2, g, step, n_ok, ast = self._tail(
                w, v, ups, hds, cw, inv, h, cid,
                dict(noise=noise, cf=cf, poison=poison))
            return w2, g, losses, step, n_ok, ast
        if self.aggregator is not None:
            grads = recv[:, :per * rl].reshape(c_b, rows, lanes)
            cwe = recv[:, per * rl:per * rl + per].reshape(c_b)
            ghat, ast = self.aggregator.reduce(grads, cwe)
            n_ok = cwe.sum()
            w2, g, step = ops.packed_apply_mean_update(w, ghat, None,
                                                       self._eta, noise=noise)
        else:
            gsum, cnt = shard_order_sum(recv, rl)
            n_w, n_ok = cnt[0], cnt[1]
            inv_t = torch.as_tensor(inv, dtype=torch.float32,
                                    device=w.device)
            inv_eff = torch.where(
                n_ok == n_w, inv_t,
                torch.where(n_ok > 0.0, 1.0 / torch.clamp(n_ok, min=1.0),
                            torch.zeros_like(n_ok)))
            w2, g, step = ops.packed_apply_mean_update(
                w, gsum.view(rows, lanes), inv_eff, self._eta, noise=noise)
            ast = self._zero_stat
        alive = n_ok > 0.0
        w2 = torch.where(alive, w2, w)
        g = torch.where(alive, g, v)
        return w2, g, losses, step, n_ok.int(), ast

    def _round_sharded(self, w, v, xs, ys, sw, cw, inv, k, shared: bool,
                       h=None, cid=None, noise=None, cf=None, poison=None):
        """One sharded round from the whole bucket's padded operands (xs,
        ys, sw [C_b, ...]: the rank uses its positions): `_shard_part`, the
        collective, `_shard_tail`. Returns `_round_shared`'s outputs."""
        c_b = int(cw.shape[0])
        lo, hi = self._bounds(c_b)
        thr, send = self._shard_part(w, v, xs[lo:hi], ys[lo:hi], sw[lo:hi],
                                     cw, k, shared, c_b, h=h, cid=cid,
                                     cf=cf, poison=poison)
        recv = torch.empty((self.shards, send.numel()), dtype=send.dtype,
                           device=send.device)
        self._exchange(send, recv)
        w2, g, losses, step, n_ok, ast = self._shard_tail(
            w, v, recv, c_b, cw, inv, h=h, cid=cid, noise=noise, cf=cf,
            poison=poison)
        return w2, g, losses, thr, step, n_ok, ast

    # -- public API ---------------------------------------------------------

    def bucket_size(self, n_clients: int) -> int:
        return bucket_capacity(n_clients, shards=self.shards,
                               max_clients=self.max_clients)

    def init_buffers(self, params) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.pack.pack(tree_map(lambda t: t.to(self.device), params))
        return w, torch.zeros_like(w)

    @torch.no_grad()
    def round_step(self, w, v, xs, ys, lams, sample_weights=None,
                   noise=None, upload_weights=None, corrupt=None,
                   poison=None, h=None, client_ids=None):
        """One full round. xs: [C, B, ...], ys: [C, B] (tensors or arrays),
        lams: [C] host-side pruning ratios of the selected clients;
        sample_weights: optional [C, B] 0/1 per-sample weights (ragged
        clients padded to B). With a local scheme the batches carry a step
        axis after the client axis: xs [C, E, B, ...], ys and
        sample_weights [C, E, B], E = local_scheme.steps. FedDyn also takes
        `h`, its [N, R, L] state (updated in place: `last_h` is h), and
        `client_ids`, the [C] ids of the selected clients' rows.

        The scenario operands, all host arrays: `noise` [R, L] aggregation
        channel noise (zero on padding lanes) added to the aggregate before
        the update; `upload_weights` [C] 0/1 — 0 marks an upload that never
        arrived (the client rides the padding path, and the host mean scalar
        renormalizes over the survivors); `corrupt` [C] gradient factors
        (1.0 clean, NaN poisoned); `poison` [C, R, L] additive upload
        poison (zeros for clean clients).

        Returns (w', v', losses [C], threshold, step), all device tensors;
        nothing is synced to the host (`last_n_ok` and `last_agg_stat` hold
        the round's lazy survivor count and reducer count)."""
        lams = np.atleast_1d(np.asarray(lams, np.float64))
        if np.any((lams < 0.0) | (lams >= 1.0)):
            raise ValueError(f"lambda must be in [0,1), got {lams}")
        n_clients = int(xs.shape[0])
        if lams.shape[0] != n_clients:
            raise ValueError(
                f"{lams.shape[0]} lambdas for {n_clients} client batches")
        ks = np.floor(lams * self.pack.n_prunable).astype(np.int32)
        dev = self.device
        xs = torch.as_tensor(xs, device=dev)
        ys = torch.as_tensor(ys, device=dev)
        ls = self.local_scheme
        if ls is not None and (xs.ndim < 3 or int(xs.shape[1]) != ls.steps):
            raise ValueError(f"expected {ls.steps} local-step batches per "
                             f"client ([C, E, B, ...]), got {tuple(xs.shape)}")

        # pad the client axis to the bucket; padding clients replicate the
        # last real batch and carry weight 0, so they never touch the update
        c_b = self.bucket_size(n_clients)
        self.buckets_used.add(c_b)
        pad = c_b - n_clients
        if sample_weights is None:
            key = (c_b,) + tuple(int(s) for s in ys.shape[1:])
            sw = self._sw_cache.get(key)
            if sw is None:
                sw = self._sw_cache[key] = torch.ones(key, device=dev)
        else:
            sw = torch.as_tensor(np.asarray(sample_weights, np.float32),
                                 device=dev)
        if pad:
            def tile(a):
                return torch.cat([a, a[-1:].expand((pad,) + a.shape[1:])])
            xs, ys = tile(xs), tile(ys)
            if sample_weights is not None:
                sw = tile(sw)
        if upload_weights is None:
            cw = self._cw_cache.get((c_b, n_clients))
            if cw is None:
                cw_host = np.zeros(c_b, np.float32)
                cw_host[:n_clients] = 1.0
                cw = self._cw_cache[(c_b, n_clients)] = torch.as_tensor(
                    cw_host, device=dev)
            # 1/C on host, like the reference server_step's 1/len(grads)
            inv = np.float32(1.0 / n_clients)
        else:
            # the fault draw rides the padding clients' 0/1 weight operand;
            # the mean renormalizes over the survivors exactly as the
            # reference server_step's 1/len(surviving grads) does
            uw = np.asarray(upload_weights, np.float32)
            if uw.shape != (n_clients,):
                raise ValueError(
                    f"upload_weights shape {uw.shape} != ({n_clients},)")
            cw_host = np.zeros(c_b, np.float32)
            cw_host[:n_clients] = uw
            cw = torch.as_tensor(cw_host, device=dev)
            surv = float(np.asarray(uw, np.float64).sum())
            inv = np.float32(1.0 / surv) if surv > 0 else np.float32(0.0)
        faults = {}
        if poison is not None:
            po = np.asarray(poison, np.float32)
            if po.shape[0] != n_clients:
                raise ValueError(
                    f"poison leading dim {po.shape[0]} != {n_clients}")
            if pad:
                # padding clients stay clean: the additive identity is 0
                po = np.concatenate(
                    [po, np.zeros((pad,) + po.shape[1:], np.float32)])
            faults["poison"] = torch.as_tensor(po, device=dev)
        if corrupt is not None or poison is not None:
            cf_host = np.ones(c_b, np.float32)   # padding clients clean
            if corrupt is not None:
                cf_host[:n_clients] = np.asarray(corrupt, np.float32)
            faults["cf"] = torch.as_tensor(cf_host, device=dev)
        if noise is not None:
            faults["noise"] = torch.as_tensor(np.asarray(noise, np.float32),
                                              device=dev)
        if self._dyn(h):
            if client_ids is None:
                raise ValueError("feddyn round_step requires the selected "
                                 "client_ids")
            cid = np.asarray(client_ids, np.int64)
            if cid.shape != (n_clients,):
                raise ValueError(f"client_ids shape {cid.shape} != "
                                 f"({n_clients},)")
            # padding clients repeat the last real id and add exact +0.0
            cid = np.concatenate([cid, np.full(pad, cid[-1], np.int64)])
            faults.update(h=h, cid=torch.as_tensor(cid, device=dev))
            self.last_h = h

        shared = bool(np.all(ks == ks[0]))
        if shared:
            k = int(ks[0])
        else:
            ks_b = np.concatenate(
                [ks, np.full(pad, ks[-1], np.int32)]) if pad else ks
            k = torch.as_tensor(ks_b, device=dev)
        if self.group is not None:
            out = self._round_sharded(w, v, xs, ys, sw, cw, inv, k, shared,
                                      **faults)
        elif shared:
            out = self._round_shared(w, v, xs, ys, sw, cw, inv, k, **faults)
        else:
            out = self._round_multi(w, v, xs, ys, sw, cw, inv, k, **faults)
        w2, g, losses, thr, step, n_ok, ast = out
        self.last_n_ok = n_ok
        self.last_agg_stat = ast
        if pad:
            losses = losses[:n_clients]
            if thr.ndim:                      # per-client thresholds
                thr = thr[:n_clients]
        return w2, g, losses, thr, step

    def _dyn(self, h) -> bool:
        """Whether a dispatch carries FedDyn's state: the scheme needs it,
        and no other takes it."""
        ls = self.local_scheme
        stateful = ls is not None and ls.stateful
        if stateful and h is None:
            raise ValueError("feddyn needs its per-client state h")
        if h is not None and not stateful:
            raise ValueError("h= is FedDyn's per-client state; this engine's "
                             f"local scheme {ls!r} carries none")
        return stateful

    # -- multi-round blocks -------------------------------------------------

    def _ones_sw(self, shape) -> torch.Tensor:
        """The all-ones sample weights round_step takes for a round without
        ragged clients (one device constant a shape)."""
        sw = self._sw_cache.get(shape)
        if sw is None:
            sw = self._sw_cache[shape] = torch.ones(shape, device=self.device)
        return sw

    def _row_operands(self, lay: "_BlockLayout", row, cf_on: bool) -> dict:
        """A block round's per-bucket operands from its operand row
        (`_BlockLayout`): ids, upload weights, the host's 1/n, the k (one,
        or one a client) and the fault factors (or None)."""
        rowf = row.view(torch.float32)
        o, c_b = lay.offsets, lay.c_b
        return dict(cid=row[o["cid"]:o["cid"] + c_b].long(),
                    cw=rowf[o["cw"]:o["cw"] + c_b], inv=rowf[o["inv"]],
                    k=row[o["k"]] if lay.shared else row[o["k"]:o["k"] + c_b],
                    cf=rowf[o["cf"]:o["cf"] + c_b] if cf_on else None)

    def _row_batches(self, lay: "_BlockLayout", store, row, cid, lo: int,
                     hi: int):
        """The batches (xs, ys, sw) of client positions [lo, hi) of a block
        round, gathered from the store by the row's ids `cid` and sample
        indices (a replicated store by global ids, a sharded cohort by the
        rank's own row ids: the same slice of the row either way)."""
        o, shape = lay.offsets, lay.batch_shape
        ix = row[o["ix"]:o["k"]].view(shape)[lo:hi].long()
        cidx = cid[lo:hi].view((hi - lo,) + (1,) * (len(shape) - 1))
        sw = (row.view(torch.float32)[o["sw"]:o["sw"] + int(np.prod(shape))]
              .view(shape)[lo:hi] if lay.has_sw
              else self._ones_sw((hi - lo,) + shape[1:]))
        return store.x[cidx, ix], store.y[cidx, ix], sw

    def _put_round(self, lay: "_BlockLayout", w, v, out, w2, g, losses,
                   n_ok, ast) -> None:
        """A block round's results: (w', g) into (w, v), the losses and the
        survivor and reducer counts into `out`."""
        w.copy_(w2)
        v.copy_(g)
        out.view(torch.float32)[:lay.c_b].copy_(losses)
        out[-2].copy_(n_ok)
        out[-1].copy_(ast)

    def _block_round(self, lay: "_BlockLayout", store, w, v, row, noise,
                     poison, cf_on: bool, out, h=None) -> None:
        """One round of a block from its operand row: gathers the batches
        from the store, runs the `round_step` body on (w, v) (and FedDyn's
        h, in place), writes (w', g) back into (w, v) and the round's
        losses, thresholds, survivor and reducer counts into `out`. Every
        operand is a device tensor, so a CUDA graph can capture the whole
        round."""
        f = self._row_operands(lay, row, cf_on)
        xs, ys, sw = self._row_batches(lay, store, row, f["cid"], 0, lay.c_b)
        body = self._round_shared if lay.shared else self._round_multi
        w2, g, losses, thr, _, n_ok, ast = body(
            w, v, xs, ys, sw, f["cw"], f["inv"], f["k"], h=h,
            cid=None if h is None else f["cid"], noise=noise, cf=f["cf"],
            poison=poison)
        out.view(torch.float32)[lay.c_b:lay.c_b + lay.n_k].copy_(
            thr.reshape(-1))
        self._put_round(lay, w, v, out, w2, g, losses, n_ok, ast)

    def _block_part(self, lay: "_BlockLayout", store, w, v, row, poison,
                    cf_on: bool, out, h=None) -> torch.Tensor:
        """A sharded block round up to its collective: gathers the rank's
        positions' batches from the store, runs `_shard_part`, writes the
        thresholds into `out` and returns the row to send."""
        c_b = lay.c_b
        lo, hi = self._bounds(c_b)
        f = self._row_operands(lay, row, cf_on)
        xs, ys, sw = self._row_batches(lay, store, row, f["cid"], lo, hi)
        thr, send = self._shard_part(
            w, v, xs, ys, sw, f["cw"], f["k"], lay.shared, c_b, h=h,
            cid=None if h is None else f["cid"], cf=f["cf"], poison=poison)
        out.view(torch.float32)[c_b:c_b + lay.n_k].copy_(thr.reshape(-1))
        return send

    def _block_tail(self, lay: "_BlockLayout", w, v, row, noise, poison,
                    cf_on: bool, out, recv, h=None) -> None:
        """A sharded block round after its collective: `_shard_tail` on
        the gathered rows, then `_put_round`."""
        f = self._row_operands(lay, row, cf_on)
        w2, g, losses, _, n_ok, ast = self._shard_tail(
            w, v, recv, lay.c_b, f["cw"], f["inv"], h=h, cid=f["cid"],
            noise=noise, cf=f["cf"], poison=poison)
        self._put_round(lay, w, v, out, w2, g, losses, n_ok, ast)

    def _block_sharded_round(self, lay, store, w, v, row, noise, poison,
                             cf_on: bool, out, h) -> None:
        """One eager sharded block round: part, collective, tail."""
        part = self._block_part(lay, store, w, v, row, poison, cf_on, out, h)
        recv = torch.empty((self.shards, part.numel()), dtype=part.dtype,
                           device=part.device)
        self._exchange(part, recv)
        self._block_tail(lay, w, v, row, noise, poison, cf_on, out, recv, h)

    def _capture(self, key, lay, store, w, v, row, noise, poison,
                 cf_on, h) -> "_RoundGraph":
        """Run one round eagerly as its real round on the capture stream,
        then capture the same body as a CUDA graph over static buffers.
        The eager round is the capture's warm-up (autograd, cuBLAS and the
        histogram's per-stream state are set up on that stream), so no
        extra round runs and (w, v) advance once. A failed capture raises:
        on CUDA a block never runs its rounds eagerly beyond this one. The
        wrappers' launch counts of the captured body are kept with the
        graph and added at every replay; capturing launches nothing.

        Other threads (sweep workers) may run meanwhile: the capture is in
        "thread_local" mode, so their allocations and syncs do not break
        it, and the whole call holds `device.CAPTURE_LOCK`, so no other
        thread captures or copies on a side stream at the same time (the
        capture stream comes from torch's pool and may be another
        engine's too). The capture's launch counts are this thread's only
        (`counters.capturing`)."""
        from repro_torch.kernels import _build
        _build.load()                    # never nvcc inside a capture
        with CAPTURE_LOCK:
            t0 = time.perf_counter()
            if self._capture_stream is None:
                self._capture_stream = torch.cuda.Stream(self.device)
            s = self._capture_stream
            rg = _RoundGraph(
                row=row.clone(),
                noise=None if noise is None else noise.clone(),
                poison=None if poison is None else poison.clone(),
                out=torch.empty(lay.out_width, dtype=torch.int32,
                                device=self.device))
            cur = torch.cuda.current_stream(self.device)
            s.wait_stream(cur)
            if self.group is not None:
                self._capture_sharded(rg, lay, store, w, v, cf_on, h, s)
            else:
                with torch.cuda.stream(s):
                    self._block_round(lay, store, w, v, rg.row, rg.noise,
                                      rg.poison, cf_on, rg.out, h)
                graph = torch.cuda.CUDAGraph()
                with capturing() as launches:
                    with torch.cuda.graph(graph, stream=s,
                                          capture_error_mode="thread_local"):
                        self._block_round(lay, store, w, v, rg.row,
                                          rg.noise, rg.poison, cf_on, rg.out,
                                          h)
                rg.launches = launches
                rg.graph = graph
                self.graphs_captured += 1
            cur.wait_stream(s)
            self._graphs[key] = rg
            self.capture_seconds += time.perf_counter() - t0
            return rg

    def _capture_sharded(self, rg: "_RoundGraph", lay, store, w, v,
                         cf_on: bool, h, s) -> None:
        """`_capture` of a sharded body: the eager round (part, collective,
        tail) on the capture stream, then two graphs, the part up to the
        collective (it writes the static send row) and the tail after it
        (it reads the static gathered rows); a collective cannot sit inside
        a graph, so the host gathers between their replays."""
        with torch.cuda.stream(s):
            part = self._block_part(lay, store, w, v, rg.row, rg.poison,
                                    cf_on, rg.out, h)
            rg.send = torch.empty_like(part)
            rg.recv = torch.empty((self.shards, part.numel()),
                                  dtype=part.dtype, device=part.device)
            rg.send.copy_(part)
            self._exchange(rg.send, rg.recv)
            self._block_tail(lay, w, v, rg.row, rg.noise, rg.poison, cf_on,
                             rg.out, rg.recv, h)
        pre, post = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with capturing() as launches:
            with torch.cuda.graph(pre, stream=s,
                                  capture_error_mode="thread_local"):
                rg.send.copy_(self._block_part(lay, store, w, v, rg.row,
                                               rg.poison, cf_on, rg.out, h))
            with torch.cuda.graph(post, stream=s,
                                  capture_error_mode="thread_local"):
                self._block_tail(lay, w, v, rg.row, rg.noise, rg.poison,
                                 cf_on, rg.out, rg.recv, h)
        rg.launches = launches
        rg.graph, rg.post = pre, post
        self.graphs_captured += 2

    @torch.no_grad()
    def block_step(self, w, v, store, cids, idxs, lams, counts,
                   sample_weights=None, noises=None, upload_weights=None,
                   corrupt=None, poisons=None, h=None):
        """K rounds from one upload of the block's operands.

        store : ClientStore, the device-resident [C_all, N_max, ...] data,
            or a streamed `Cohort` (core/cohort_store.py) with cids remapped
            to its device rows.
        cids  : [K, C] int, selected client ids a round in selected order;
            a round with fewer than C clients is right-padded by repeating
            its last real id (the per-round path's padding clients).
        idxs  : [K, C, B] int, host-drawn sample indices into each client's
            store rows (the trainer draws them with `_sample_batch`'s RNG
            calls, so the batches are the per-round path's); [K, C, E, B]
            with a local scheme of E steps.
        lams  : [K, C] float, pruning ratios, padded like cids.
        counts: [K] int, the real selected count of each round.
        sample_weights : [K, C, B] 0/1 weights or None.
        noises : [K, R, L] packed aggregation noise a round, or None.
        upload_weights : [K, C] 0/1 fault weights (0 = the upload never
            arrived), or None.
        corrupt : [K, C] gradient factors (1.0 = clean), or None; or a
            sequence of K entries, each a [C] array or None for a round
            that carries no factor (round_step's `corrupt=None`).
        poisons : [K, C, R, L] additive upload poison, or None; or a
            sequence of K entries, each [C, R, L] or None.
        h : FedDyn's [N, R, L] per-client state (required with FedDyn),
            updated in place round after round (a CUDA graph captures this
            tensor: pass the same one to every block).

        Every round is exactly the body `round_step` runs with the same
        operands, so the block equals K `round_step` calls bit for bit. The
        schedule operands go to the device in one upload a block; the
        batches are gathered there (no batch data crosses, and nothing
        syncs). On CUDA each round replays the CUDA graph of its body (one
        graph a body key, `graphs_captured`; the first round of a key runs
        eagerly as its real round and is captured); on the CPU the body
        runs eagerly.

        Returns (w', v', losses [K, C_b], thresholds [K] or [K, C_b]), all
        device tensors; `losses[k, counts[k]:]` belong to padding clients.
        `last_n_ok` and `last_agg_stat` hold the [K] survivor and reducer
        counts. The client axis buckets as in `round_step`, and every round
        of a block must share one bucket; K is not padded."""
        dyn = self._dyn(h)
        if getattr(store, "sharded", False):
            if self.group is None:
                raise ValueError("a data-sharded cohort store needs an "
                                 "engine sharded over the same ranks")
            if dyn:
                raise ValueError(
                    "feddyn over a data-sharded cohort store is not "
                    "supported: run with shards=1 (streamed cohorts stay "
                    "available) or client_store='replicated'")
        lams = np.asarray(lams, np.float64)
        if np.any((lams < 0.0) | (lams >= 1.0)):
            raise ValueError(f"lambda must be in [0,1), got {lams}")
        idxs = np.asarray(idxs, np.int32)
        ls = self.local_scheme
        if ls is None and idxs.ndim != 3:
            raise ValueError(
                f"expected [K, C, B] indices, got shape {idxs.shape}")
        if ls is not None and (idxs.ndim != 4 or idxs.shape[2] != ls.steps):
            raise ValueError(f"expected [K, C, {ls.steps}, B] local-step "
                             f"indices, got shape {idxs.shape}")
        n_rounds, c_max, batch = idxs.shape[0], idxs.shape[1], idxs.shape[-1]
        counts = np.asarray(counts, np.int64)
        cids = np.asarray(cids)
        if counts.shape != (n_rounds,) or cids.shape != (n_rounds, c_max) \
                or lams.shape != (n_rounds, c_max):
            raise ValueError("inconsistent block array shapes")
        if int(counts.max()) > c_max or int(counts.min()) < 1:
            raise ValueError(f"counts {counts} outside [1, {c_max}]")
        ks = np.floor(lams * self.pack.n_prunable).astype(np.int32)
        c_b = self.bucket_size(int(counts.max()))
        if self.bucket_size(int(counts.min())) != c_b:
            raise ValueError(
                "rounds in one block must share a client-axis bucket "
                f"(got counts {counts} -> buckets "
                f"{sorted({self.bucket_size(int(c)) for c in counts})})")
        self.buckets_used.add(c_b)
        self.k_buckets_used.add(n_rounds)
        pad = c_b - c_max

        def pad_cols(a):
            return np.concatenate(
                [a, np.repeat(a[:, -1:], pad, axis=1)], axis=1) if pad else a

        def pad_ones(a):
            # padding clients carry weight 0; their factors stay clean
            return np.concatenate(
                [a, np.ones((n_rounds, pad), np.float32)],
                axis=1) if pad else a

        rows, lanes = self.pack.rows, LANES
        cf, cf_on = _per_round(corrupt, n_rounds, (c_max,), 1.0, "corrupt")
        po, po_on = _per_round(poisons, n_rounds, (c_max, rows, lanes), 0.0,
                               "poisons")
        faulted = (upload_weights is not None or cf_on.any()
                   or po_on.any())
        col = np.arange(c_max)[None, :]
        live = (col < counts[:, None]).astype(np.float32)
        if faulted:
            uw = (np.ones((n_rounds, c_max), np.float32)
                  if upload_weights is None
                  else np.asarray(upload_weights, np.float32))
            if uw.shape != (n_rounds, c_max):
                raise ValueError("fault operand shapes must be [K, C]")
            # the float64 1/n -> float32 cast of round_step
            surv = (uw.astype(np.float64) * live).sum(1)
            inv = np.where(surv > 0, 1.0 / np.maximum(surv, 1.0), 0.0)
            cw = live * uw
        else:
            inv = 1.0 / counts
            cw = live
        shared = bool((ks == ks[:, :1]).all())
        lay = _BlockLayout(c_b=c_b, batch=int(batch), shared=shared,
                           has_sw=sample_weights is not None, has_cf=faulted,
                           steps=0 if ls is None else ls.steps, dyn=dyn)
        sw = (None if sample_weights is None
              else pad_cols(np.asarray(sample_weights, np.float32)))
        if pad:
            cw = np.concatenate([cw, np.zeros((n_rounds, pad), np.float32)],
                                axis=1)
            if po is not None:
                po = np.concatenate(
                    [po, np.zeros((n_rounds, pad, rows, lanes), np.float32)],
                    axis=1)
        if faulted and cf is None:
            # upload weights alone (dropouts): the factor words are clean
            cf = np.ones((n_rounds, c_max), np.float32)
        # one upload: the operand rows, then the noise and poison stacks
        parts = [lay.pack(pad_cols(cids.astype(np.int32)), pad_cols(idxs),
                          pad_cols(ks)[:, :lay.n_k], cw, inv, sw,
                          pad_ones(cf) if faulted else None)]
        if noises is not None:
            noises = np.asarray(noises, np.float32)
            if noises.shape != (n_rounds, rows, lanes):
                raise ValueError(f"noises shape {noises.shape} != "
                                 f"({n_rounds}, {rows}, {lanes})")
            parts.append(noises)
        if po is not None:
            parts.append(po)
        dev_parts = _upload(parts, self.device)
        row_stack = dev_parts[0]
        noise_stack = dev_parts[1] if noises is not None else None
        po_stack = dev_parts[-1] if po is not None else None
        out = torch.empty((n_rounds, lay.out_width), dtype=torch.int32,
                          device=self.device)

        def operands(k):
            # round_step scales by the factors whenever a round carries
            # factors or poison (ones when only poison came)
            return (row_stack[k],
                    None if noise_stack is None else noise_stack[k],
                    po_stack[k] if po_on[k] else None,
                    bool(cf_on[k] or po_on[k]))

        if dyn:
            self.last_h = h
        if self.device.type == "cuda":
            src = self._graph_src
            if (src is None or src[0] is not store.x
                    or src[1] is not store.y or self._graph_h is not h):
                # the graphs gather from the tensors they were captured
                # with and update the FedDyn state they were captured with;
                # a cohort store's cohorts share its two slots, so a swap
                # keeps them
                self._graphs.clear()
                self._graph_src, self._graph_h = (store.x, store.y), h
            if self._graph_wv is None:
                self._graph_wv = (torch.empty_like(w), torch.empty_like(v))
            ws, vs = self._graph_wv
            ws.copy_(w)
            vs.copy_(v)
            for k in range(n_rounds):
                row, noise, poison, cf_k = operands(k)
                key = (lay, cf_k, poison is not None, noise is not None,
                       self.shards)
                rg = self._graphs.get(key)
                if rg is None:
                    rg = self._capture(key, lay, store, ws, vs, row, noise,
                                       poison, cf_k, h)
                else:
                    rg.row.copy_(row)
                    if noise is not None:
                        rg.noise.copy_(noise)
                    if poison is not None:
                        rg.poison.copy_(poison)
                    rg.graph.replay()
                    self.graph_replays += 1
                    if rg.post is not None:
                        self._exchange(rg.send, rg.recv)
                        rg.post.replay()
                        self.graph_replays += 1
                    for name, n in rg.launches.items():
                        count_launch(name, n)
                out[k].copy_(rg.out)
            w2, v2 = ws.clone(), vs.clone()
        else:
            w2, v2 = w.clone(), v.clone()
            body = (self._block_round if self.group is None
                    else self._block_sharded_round)
            for k in range(n_rounds):
                row, noise, poison, cf_k = operands(k)
                body(lay, store, w2, v2, row, noise, poison, cf_k, out[k], h)
        outf = out.view(torch.float32)
        losses = outf[:, :c_b]
        thrs = outf[:, c_b:c_b + lay.n_k]
        self.last_n_ok = out[:, -2]
        self.last_agg_stat = out[:, -1]
        return w2, v2, losses, thrs[:, 0] if shared else thrs


@dataclasses.dataclass(frozen=True)
class _BlockLayout:
    """The int32 words of one round's operand row in a block: client ids
    [C_b], sample indices [C_b*B] ([C_b*E*B] with E local steps), k (one,
    shared lambda) or ks [C_b], the client weights [C_b] and 1/n (fp32
    bits), then the sample weights (shaped as the indices) and the
    corruption factors [C_b] when the block has them. The output row:
    losses [C_b] and thresholds [n_k] (fp32 bits), the survivor count and
    the reducer count. `steps` (0 for the FedSGD body) and `dyn` (FedDyn's
    state) also key the round body's graph."""

    c_b: int
    batch: int
    shared: bool
    has_sw: bool
    has_cf: bool
    steps: int = 0
    dyn: bool = False

    @property
    def n_k(self) -> int:
        return 1 if self.shared else self.c_b

    @property
    def batch_shape(self) -> tuple[int, ...]:
        """The shape of a round's indices and sample weights."""
        return ((self.c_b, self.steps, self.batch) if self.steps
                else (self.c_b, self.batch))

    @property
    def offsets(self) -> dict[str, int]:
        n_ix = int(np.prod(self.batch_shape))
        sizes = [("cid", self.c_b), ("ix", n_ix),
                 ("k", self.n_k), ("cw", self.c_b), ("inv", 1)]
        if self.has_sw:
            sizes.append(("sw", n_ix))
        if self.has_cf:
            sizes.append(("cf", self.c_b))
        out, at = {}, 0
        for name, n in sizes:
            out[name] = at
            at += n
        out["end"] = at
        return out

    @property
    def out_width(self) -> int:
        return self.c_b + self.n_k + 2

    def pack(self, cids, idxs, ks, cw, inv, sw, cf) -> np.ndarray:
        """[K, width] int32 rows from the padded host operands."""
        n = cids.shape[0]
        o = self.offsets
        rows = np.empty((n, o["end"]), np.int32)
        rows[:, o["cid"]:o["ix"]] = cids
        rows[:, o["ix"]:o["k"]] = idxs.reshape(n, -1)
        rows[:, o["k"]:o["cw"]] = ks
        f = rows.view(np.float32)
        f[:, o["cw"]:o["inv"]] = cw
        f[:, o["inv"]] = np.asarray(inv, np.float64).astype(np.float32)
        if self.has_sw:
            f[:, o["sw"]:o["sw"] + o["k"] - o["ix"]] = sw.reshape(n, -1)
        if self.has_cf:
            f[:, o["cf"]:o["cf"] + self.c_b] = cf
        return rows


class _RoundGraph:
    """A captured round body with its static operand buffers: the operand
    row, the round's noise and poison, and the output row; `launches` are
    the kernel launches of one replay (of both graphs of a sharded
    body)."""

    def __init__(self, row, noise, poison, out):
        self.row, self.noise, self.poison, self.out = row, noise, poison, out
        self.graph = None
        # a sharded body's second graph (after the collective) and the
        # static rows it sends and receives
        self.post = self.send = self.recv = None
        self.launches: dict[str, int] = {}


def _per_round(op, n_rounds: int, shape, fill: float, name: str):
    """A per-round block operand as ([K, *shape] float32 or None, [K]
    bool): an array applies to every round; a sequence may hold None for
    the rounds that carry no such operand (they get `fill`)."""
    if op is None:
        return None, np.zeros(n_rounds, bool)
    if not isinstance(op, (list, tuple)):
        arr = np.asarray(op, np.float32)
        if arr.shape != (n_rounds,) + tuple(shape):
            raise ValueError(f"{name} shape {arr.shape} != "
                             f"{(n_rounds,) + tuple(shape)}")
        return arr, np.ones(n_rounds, bool)
    if len(op) != n_rounds:
        raise ValueError(f"{name}: {len(op)} entries for {n_rounds} rounds")
    on = np.asarray([e is not None for e in op], bool)
    arr = np.full((n_rounds,) + tuple(shape), fill, np.float32)
    for k, e in enumerate(op):
        if e is not None:
            e = np.asarray(e, np.float32)
            if e.shape != tuple(shape):
                raise ValueError(f"{name}[{k}] shape {e.shape} != {shape}")
            arr[k] = e
    return arr, on


def _upload(parts, device) -> list[torch.Tensor]:
    """Host arrays of 4-byte words to the device in one copy (from pinned
    memory on CUDA, without waiting for the host), returned as device
    views of the arrays' shapes and dtypes."""
    flat = [np.ascontiguousarray(p).reshape(-1).view(np.int32)
            for p in parts]
    total = sum(f.size for f in flat)
    if device.type == "cuda":
        host = torch.empty(total, dtype=torch.int32, pin_memory=True)
    else:
        host = torch.empty(total, dtype=torch.int32)
    hv = host.numpy()
    at = 0
    for f in flat:
        hv[at:at + f.size] = f
        at += f.size
    dev = (host.to(device, non_blocking=True) if device.type == "cuda"
           else host)
    out, at = [], 0
    for p, f in zip(parts, flat):
        t = dev[at:at + f.size]
        if np.asarray(p).dtype == np.float32:
            t = t.view(torch.float32)
        out.append(t.view(np.asarray(p).shape))
        at += f.size
    return out
