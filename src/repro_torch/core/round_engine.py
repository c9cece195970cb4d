"""Single-device packed round engine (paper Sec. II-A, eqs. 2-7).

The port of ``repro/core/round_engine.py`` (its single-device, one-round-
per-dispatch paths). One ``round_step`` runs a whole FedSGD round on the
device over the packed ``[R, 128]`` parameter buffer (core/packing.py):

  1. importance Q = (w * v)^2 (eq. 4), denormals zero;
  2. the global pruning threshold — the k-th smallest prunable importance,
     k = floor(lambda * M_prunable) — by bisection over fp32 bit patterns
     (`kth_smallest_threshold`), on the device;
  3. the keep-masks from one importance+mask kernel: one shared mask when
     every selected client has the same k, else one mask per client;
  4. per-client mini-batch gradients on the pruned model (eq. 5), taken by
     autograd with respect to the packed buffer, masked on the device;
  5. the fault operands (per-client factors `cf`, additive poison), the
     non-finite quarantine, then the fused weighted aggregate + FedSGD step
     kernel (eqs. 6-7) — or, with a robust `aggregator`, its reducer (the
     rank-sort kernel for the median and the trimmed mean) and the same
     update tail with inv = 1; with channel noise the server steps with
     mean + noise. The aggregate is the next round's v.

The client axis is padded to the JAX package's bucket size (`bucket_capacity`);
padding clients replicate the last real batch and carry weight 0, so they
never touch the update. Ragged clients ride per-sample 0/1 weights through
the weighted loss. Only the integers k and the scalar 1/C come from the
host, with the fault and noise operands; nothing in the round syncs the
device.

On the CPU the kernels' plain versions run and the engine reproduces the
reference trainer value for value; on CUDA the kernels are bit-identical to
the plain versions, so the same holds there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.packing import ParamPack
from repro_torch.device import resolve_device
from repro_torch.kernels import ops


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


def bucket_capacity(n_clients: int, *, max_clients: int | None = None) -> int:
    """Padded client-axis size for a round selecting `n_clients` on one
    device: next_pow2(n), capped at the population (padding clients cost
    real gradient FLOPs, so full participation never pads past it)."""
    p2 = 1 << (int(n_clients) - 1).bit_length()
    if max_clients is not None:
        p2 = min(p2, max(int(n_clients), int(max_clients)))
    return p2


class RoundEngine:
    """Packed-buffer FedSGD round (pruning -> gradients -> aggregate) on one
    device.

    loss_fn(params, x, y) -> scalar is differentiated through `pack.unpack`,
    so gradients live on the packed buffer. weighted_loss_fn(params, x, y,
    sample_weights) carries ragged clients; without it sample weights are
    ignored. `aggregator` (core/aggregators.py) replaces the weighted mean
    with a robust reducer; None keeps the mean path. The kernels are the
    CUDA ones on a CUDA device and their plain versions on the CPU
    (kernels/ops.py, impl="auto"); device=None means CUDA.
    """

    def __init__(self, loss_fn: Callable, pack: ParamPack, *, eta: float,
                 weighted_loss_fn: Callable | None = None,
                 max_clients: int | None = None, aggregator=None,
                 device=None):
        self.pack = pack
        self.eta = float(eta)
        self.max_clients = int(max_clients) if max_clients else None
        self.aggregator = aggregator
        self.device = resolve_device(device)
        self.prunable = torch.as_tensor(pack.prunable_mask(),
                                        device=self.device)
        self._eta = torch.tensor(np.float32(eta), device=self.device)
        self._zero_stat = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self.buckets_used: set[int] = set()
        # device constants by (bucket, selected count) / sample-weight shape
        self._cw_cache: dict[tuple, torch.Tensor] = {}
        self._sw_cache: dict[tuple, torch.Tensor] = {}
        # survivor count of the most recent round (lazy device int32)
        self.last_n_ok = None
        # the robust reducer's count of the most recent round (clients
        # trimmed / clipped / excluded; 0 on the mean path), lazy int32
        self.last_agg_stat = None
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
        with torch.enable_grad():
            loss = self._packed_loss(wp, x, y, sw)
            (g,) = torch.autograd.grad(loss, wp)
        return loss.detach(), g

    def _grads_shared(self, pruned, mask, xs, ys, sw):
        """Every client sees the same pruned buffer and mask [R, L].
        Returns (losses [C], masked grads [C, R, L])."""
        losses, grads = [], []
        for c in range(xs.shape[0]):
            loss, g = self._value_and_grad(pruned, xs[c], ys[c], sw[c])
            losses.append(loss)
            grads.append(g * mask)
        return torch.stack(losses), torch.stack(grads)

    def _grads_multi(self, w, masks, xs, ys, sw):
        """Per-client masks [C, R, L]: each client's pruned buffer
        w * masks[c] is formed inside its own step."""
        losses, grads = [], []
        for c in range(xs.shape[0]):
            loss, g = self._value_and_grad(w * masks[c], xs[c], ys[c], sw[c])
            losses.append(loss)
            grads.append(g * masks[c])
        return torch.stack(losses), torch.stack(grads)

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
        Returns (w', v', step, n_ok, agg_stat)."""
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
        return w2, g, step, n_ok, ast

    def _round_shared(self, w, v, xs, ys, sw, cw, inv, k, **faults):
        """One shared-lambda round; `faults` are _aggregate_update's
        noise / cf / poison."""
        q = ops.importance(w, v)
        thr = kth_smallest_threshold(q, self.prunable, k)
        _, mask = ops.packed_importance_mask(w, v, self.prunable, thr)
        pruned = w * mask
        losses, grads = self._grads_shared(pruned, mask, xs, ys, sw)
        w2, g, step, n_ok, ast = self._aggregate_update(w, v, grads, cw, inv,
                                                        **faults)
        return w2, g, losses, thr, step, n_ok, ast

    def _round_multi(self, w, v, xs, ys, sw, cw, inv, ks, **faults):
        """One per-client-lambda round."""
        q = ops.importance(w, v)
        thr = kth_smallest_threshold(q, self.prunable, ks)      # [C]
        _, masks = ops.packed_importance_masks(w, v, self.prunable, thr)
        losses, grads = self._grads_multi(w, masks, xs, ys, sw)
        w2, g, step, n_ok, ast = self._aggregate_update(w, v, grads, cw, inv,
                                                        **faults)
        return w2, g, losses, thr, step, n_ok, ast

    # -- public API ---------------------------------------------------------

    def bucket_size(self, n_clients: int) -> int:
        return bucket_capacity(n_clients, max_clients=self.max_clients)

    def init_buffers(self, params) -> tuple[torch.Tensor, torch.Tensor]:
        w = self.pack.pack({k: t.to(self.device) for k, t in params.items()})
        return w, torch.zeros_like(w)

    @torch.no_grad()
    def round_step(self, w, v, xs, ys, lams, sample_weights=None,
                   noise=None, upload_weights=None, corrupt=None,
                   poison=None):
        """One full round. xs: [C, B, ...], ys: [C, B] (tensors or arrays),
        lams: [C] host-side pruning ratios of the selected clients;
        sample_weights: optional [C, B] 0/1 per-sample weights (ragged
        clients padded to B).

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

        if np.all(ks == ks[0]):
            out = self._round_shared(w, v, xs, ys, sw, cw, inv, int(ks[0]),
                                     **faults)
        else:
            ks_b = np.concatenate(
                [ks, np.full(pad, ks[-1], np.int32)]) if pad else ks
            out = self._round_multi(w, v, xs, ys, sw, cw, inv,
                                    torch.as_tensor(ks_b, device=dev),
                                    **faults)
        w2, g, losses, thr, step, n_ok, ast = out
        self.last_n_ok = n_ok
        self.last_agg_stat = ast
        if pad:
            losses = losses[:n_clients]
            if thr.ndim:                      # per-client thresholds
                thr = thr[:n_clients]
        return w2, g, losses, thr, step
