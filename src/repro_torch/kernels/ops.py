"""Entry points of the port's kernels: the packed-buffer ones of the round
engine (core/packing.py layout) and the LM stack's attention and SSD ones.

Each entry point calls its wrapper (kernels/pruning_mask.py,
flash_attention.py, decode_attention.py, ssd_chunk.py), which launches the
hand-written Hopper kernel on CUDA tensors and runs the plain PyTorch
version on CPU tensors (bit-identical for the round's kernels, within a
stated tolerance for attention and SSD). ``impl`` mirrors
``repro/kernels/ops.py`` and only checks that choice:

  * "auto"  — whatever the tensors' device gives;
  * "cuda"  — the kernel; raises on a CPU tensor;
  * "torch" — the plain version; raises on a CUDA tensor.

The quarantine, the weighted sum, the mean-update tail and the robust
reducers around the rank sort are plain torch, as the JAX package computes
them outside any Pallas kernel; eager torch rounds every op on its own, so
the FedSGD step's ``eta * g`` is never FMA-contracted with the subtraction
(the fence ``repro/kernels/ops._rounded_product`` builds inside a jitted
graph is implicit here).

Denormals: XLA:CPU (and the TPU) treat subnormal inputs as zero and flush
a tiny result (below FLT_MIN after rounding) to a zero of its sign. The
aggregate tail and the reducers' own arithmetic on gradient values (the
median's ``(lo + hi) * 0.5``, the trimmed mean's sum and scale, the
clipping factors, the means' scale) state the same flush
(``flush_add`` / ``flush_mul``); tests/test_torch_flush.py and
tests/test_torch_aggregators.py pin it against the JAX package.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import pruning_mask as _pm
from repro_torch.kernels import ssd_chunk as _sc

LANES = _pm.LANES
FLT_MIN = _pm.FLT_MIN
INT32_MAX = _pm.INT32_MAX

# q = (w*v)^2 with denormals zero: the round engine's threshold input
importance = _pm.importance
# sums, differences and products on gradient values, flushed as XLA does
flush, flush_add, flush_sub, flush_mul = (_pm.flush, _pm.flush_add,
                                          _pm.flush_sub, _pm.flush_mul)


def _check_impl(impl: str, t: torch.Tensor) -> None:
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl != "auto" and impl != ("cuda" if t.is_cuda else "torch"):
        raise ValueError(f"impl={impl!r} does not run on {t.device} tensors "
                         "('cuda' needs CUDA tensors, 'torch' CPU tensors)")


def packed_importance_mask(w, v, prunable, threshold, *, impl="auto"):
    """Shared-threshold path: (importance fp32, mask fp32), both [R, 128];
    protected/padding coordinates (prunable == 0) are always kept."""
    _check_impl(impl, w)
    return _pm.importance_mask_2d(w, v, prunable, threshold)


def packed_importance_masks(w, v, prunable, thresholds, *, impl="auto"):
    """Per-client-threshold path: (importance [R,128], masks [C,R,128])."""
    _check_impl(impl, w)
    return _pm.importance_mask_batched(w, v, prunable, thresholds)


def packed_exponent_histogram(q, prunable, *, impl="auto"):
    """256-bin histogram of fp32 exponent bytes over valid coordinates —
    the coarse first pass of ``kth_smallest_threshold(coarse="histogram")``."""
    _check_impl(impl, q)
    return _pm.exponent_histogram(q, prunable)


def packed_fedsgd_update_weighted(w, grads, cweights, inv, eta, *,
                                  impl="auto"):
    """Weighted eqs. (6)-(7): g = (sum_c cw[c]*grads[c]) * inv, w' = w -
    eta*g, returning (w', g, step). inv and eta are fp32 scalar tensors on
    w's device (inv from the quarantine, never synced to the host)."""
    _check_impl(impl, w)
    return _pm.fedsgd_aggregate_weighted(w, grads, cweights, inv, eta)


def packed_fedsgd_update(w, grads, eta, *, impl="auto"):
    """Unweighted eqs. (6)-(7): average the stacked masked gradients
    [C,R,128] and take the FedSGD step, returning (w', mean_grad, step).
    Not used by the round engine (which always aggregates with weights);
    with all-ones weights and inv = float32(1/C) the weighted entry point
    gives the same bits."""
    _check_impl(impl, w)
    return _pm.fedsgd_aggregate(w, grads, eta)


def packed_masked_update(w, g, mask, eta, *, impl="auto"):
    """(w - eta*g) * mask on one packed buffer, one launch for the whole
    model: the packed form of the per-leaf `masked_update`, for
    pruned-checkpoint workflows (the round engine never masks w). Each op is
    rounded on its own, as the JAX package's eager
    ``ref.masked_update_ref``; its jitted ``ops.packed_masked_update``
    contracts w - eta*g into an FMA and can differ by the rounding of
    eta*g."""
    _check_impl(impl, w)
    return _pm.masked_update_2d(w, g, mask, eta)


def _to_tiles(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Any tensor -> ([rows, 128] zero-padded fp32 tiles, element count)."""
    flat = x.reshape(-1).float()
    n = flat.shape[0]
    pad = (-n) % LANES
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    return flat.reshape(-1, LANES).contiguous(), n


def _from_tiles(t: torch.Tensor, n: int, shape, dtype) -> torch.Tensor:
    return t.reshape(-1)[:n].reshape(shape).to(dtype)


def masked_update(w, g, mask, eta, *, impl="auto"):
    """(w - eta*g) * mask for one tensor of any shape (per-leaf form of
    `packed_masked_update`): flattened, zero-padded to whole 128-lane rows,
    one kernel launch, and cut back to w's shape and dtype."""
    _check_impl(impl, w)
    wt, n = _to_tiles(w)
    gt, _ = _to_tiles(g)
    mt, _ = _to_tiles(mask)
    return _from_tiles(_pm.masked_update_2d(wt, gt, mt, eta), n, w.shape,
                       w.dtype)


# the plain tail pieces, as the JAX package's ops names them
packed_weighted_grad_sum = _pm.weighted_grad_sum
packed_apply_mean_update = _pm.apply_mean_update


def packed_local_delta(g, u, u0, coeff, hm=None):
    """A local step's update direction for FedProx / FedDyn: d = g +
    coeff*(u - u0) [- hm], hm FedDyn's masked correction state. Plain
    torch, as the JAX package computes it outside any Pallas kernel: every
    op rounded on its own (the product before the add, which the JAX
    package's fence forces inside jit) and flushed as XLA flushes it, so it
    is bit for bit the jitted ``ops.packed_local_delta`` on the CPU,
    subnormal input included. `coeff` is a host scalar."""
    d = flush_add(g, flush_mul(coeff, flush_sub(u, u0)))
    if hm is not None:
        d = flush_sub(d, hm)
    return d


def packed_client_quarantine(grads, cweights, inv):
    """Always-on non-finite upload guard over the stacked masked gradients
    [C, R, 128]: returns (cw_eff, inv_eff, n_ok, alive), all on the device.

    cw_eff zeroes non-finite clients; inv_eff passes the host `inv` through
    when nobody was quarantined and renormalizes to 1/n_ok otherwise (0
    when nobody survives); n_ok is the int32 survivor count; alive is False
    when no client survives (the caller then keeps (w, v) unchanged)."""
    cw = cweights.float()
    fin = torch.isfinite(grads).flatten(1).all(dim=1)
    cw_eff = cw * fin.float()
    n_w = cw.sum()
    n_ok = cw_eff.sum()
    inv_t = torch.as_tensor(inv, dtype=torch.float32, device=grads.device)
    inv_eff = torch.where(
        n_ok == n_w, inv_t,
        torch.where(n_ok > 0.0, 1.0 / torch.clamp(n_ok, min=1.0),
                    torch.zeros_like(n_ok)))
    return cw_eff, inv_eff, n_ok.int(), n_ok > 0.0


# -- robust aggregation ---------------------------------------------------------

def packed_client_rank_sort(grads, cweights, *, impl="auto"):
    """Per-coordinate rank sort along the client axis of a [C, R, 128]
    stack; zero-weight (padding / quarantined) clients sort last, so every
    rank < n_valid holds a real value. The client_rank_sort kernel on CUDA,
    its stable-sort plain version on the CPU."""
    _check_impl(impl, grads)
    return _pm.client_rank_sort(grads, cweights)


def _at_rank(sorted_vals: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """sorted_vals[rank] for a device int scalar rank (no host sync)."""
    return sorted_vals.index_select(0, rank.reshape(1).long())[0]


def _sorted_median(sorted_vals, nn):
    """Midpoint of ranks (nn-1)//2 and nn//2 of a rank-sorted stack: the
    median over the nn valid lanes, with the flush of every input and of the
    sum and the halving."""
    lo = _at_rank(sorted_vals, (nn - 1) // 2)
    hi = _at_rank(sorted_vals, nn // 2)
    return flush_mul(flush_add(lo, hi), 0.5)


def packed_robust_aggregate(grads, cweights, *, kind, impl="auto",
                            beta=0.1, tau=None, f=1, m=None):
    """Weight-aware Byzantine-robust reduction of a packed gradient stack:
    the port of ``repro/kernels/ops.py::packed_robust_aggregate``.

    grads: [C, R, 128] stacked per-client masked gradients; cweights: [C]
    effective validity weights (0 marks padding, dropped and quarantined
    clients: `packed_client_quarantine`'s cw_eff). Returns ``(ghat,
    stat)``: the survivor-normalized robust aggregate [R, 128] fp32 (the
    caller applies it with inv = 1.0) and an int32 diagnostic count
    (clients trimmed / clipped / excluded; 0 when nobody is valid).
    Zero-weight lanes never influence an output bit, so the result is
    invariant to the bucket capacity C. Nothing here syncs the host.

    Kinds: "coord_median" and "trimmed_mean" sort through the
    client_rank_sort kernel; "norm_clip" (min(1, tau/||g_c||), tau None or
    <= 0: the median valid norm) and "multi_krum" (keep the m, default
    n-f, clients with the smallest sums of their n-f-2 nearest squared
    distances; one Gram matmul) are plain torch, as in the JAX package.
    The norms and the Gram matrix reduce in torch's order, not XLA's."""
    g = grads.float()
    cw = cweights.float()
    dev = g.device
    # XLA compares the flushed weight: a subnormal one is dead
    valid = _pm.flush(cw) > 0.0
    n = valid.int().sum()
    nn = torch.clamp(n, min=1)
    c_b = g.shape[0]
    if kind == "coord_median":
        sv = packed_client_rank_sort(g, cw, impl=impl)
        ghat = _sorted_median(sv, nn)
        # clients outside the (one- or two-element) median window
        stat = torch.clamp(n - 2 + (n & 1), min=0)
    elif kind == "trimmed_mean":
        if not 0.0 <= beta < 0.5:
            raise ValueError(f"trimmed_mean beta must be in [0, 0.5), "
                             f"got {beta}")
        sv = packed_client_rank_sort(g, cw, impl=impl)
        t = torch.floor(_pm.f32_scalar(beta, g) * nn.float()).int()
        keep = torch.clamp(nn - 2 * t, min=1)
        acc = torch.zeros(g.shape[1:], dtype=torch.float32, device=dev)
        for c in range(c_b):                 # rank order
            acc = torch.where((c >= t) & (c < nn - t),
                              flush_add(acc, sv[c]), acc)
        ghat = flush_mul(acc, 1.0 / keep.float())
        stat = torch.minimum(2 * t, n)
    elif kind == "norm_clip":
        gm = g.reshape(c_b, -1)
        norms = torch.sqrt((gm * gm).sum(dim=1))
        if tau is None or float(tau) <= 0.0:
            key = torch.where(valid, _pm.order_keys(norms),
                              torch.full_like(n, INT32_MAX))
            idx = torch.sort(key, stable=True).indices
            tau_t = _sorted_median(norms[idx], nn)
        else:
            tau_t = _pm.f32_scalar(tau, g)
        # a quarantined client's NaN norm fails both compares: factor 1.0,
        # and its weight is already 0 in the sum
        clipped = valid & (norms > tau_t)
        factor = torch.where(norms > tau_t, tau_t / norms,
                             torch.ones_like(norms))
        gsum = packed_weighted_grad_sum(
            flush_mul(g, factor[:, None, None]), cw)
        ghat = flush_mul(gsum, 1.0 / nn.float())
        stat = clipped.int().sum()
    elif kind == "multi_krum":
        if int(f) < 0:
            raise ValueError(f"multi_krum f must be >= 0, got {f}")
        if m is not None and int(m) < 1:
            raise ValueError(f"multi_krum m must be >= 1, got {m}")
        gm = g.reshape(c_b, -1)
        gram = gm @ gm.T                     # one matmul: all pairwise inners
        sq = torch.diagonal(gram)
        # 2*gram is exact, so no contraction can perturb the expression
        d2 = sq[:, None] + sq[None, :] - 2.0 * gram
        inf = torch.full_like(d2, float("inf"))
        eye = torch.eye(c_b, dtype=torch.bool, device=dev)
        pair_ok = valid[:, None] & valid[None, :] & ~eye
        sd = torch.sort(torch.where(pair_ok, d2, inf), dim=1).values
        # each valid row has n-1 finite entries and k_nb <= n-2, so no +inf
        # sentinel reaches a valid client's score
        k_nb = torch.clamp(n - int(f) - 2, min=1, max=max(c_b - 1, 1))
        score = torch.zeros(c_b, dtype=torch.float32, device=dev)
        for j in range(c_b):                 # rank order
            score = torch.where(j < k_nb, score + sd[:, j], score)
        score = torch.where(valid, score, inf[0])
        # valid clients first even on tied +inf scores (the sentinel is
        # strictly above the +inf key), stable on remaining ties
        skey = torch.where(valid, _pm.order_keys(score),
                           torch.full_like(n, INT32_MAX))
        m_sel = n - int(f) if m is None else torch.full_like(n, int(m))
        m_sel = torch.minimum(torch.clamp(m_sel, min=1), nn)
        order = torch.sort(skey, stable=True).indices
        rank_ok = (torch.arange(c_b, device=dev) < m_sel).float()
        sel = torch.zeros(c_b, dtype=torch.float32, device=dev).scatter(
            0, order, rank_ok)
        gsum = packed_weighted_grad_sum(g, sel * cw)
        ghat = flush_mul(gsum, 1.0 / m_sel.float())
        stat = torch.clamp(n - m_sel, min=0)
    else:
        raise ValueError(f"unknown robust aggregate kind {kind!r}")
    return ghat, stat.int()


# -- the LM stack: attention and SSD ------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, impl="auto"):
    """Flash attention in model layout: q [B,S,Hq,D], k/v [B,S,Hkv,D] ->
    [B,S,Hq,D]. The kernel reads the transposed views in place. Any
    sequence length: the CUDA kernel masks its ragged last tiles, so the
    exact-length prefills of the ssm and hybrid families reach it (the TPU
    kernel wants a multiple of min(128, S))."""
    _check_impl(impl, q)
    o = _fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            cap=cap)
    return o.transpose(1, 2)


def decode_attention(q, k, v, pos, *, block_k=512, impl="auto"):
    """Flash-decoding in model layout: q [B,1,Hq,D], cache k/v
    [B,S,Hkv,D] read in place, pos the valid cache length (an int, or an
    int tensor [B] for rows at different positions). Returns [B,1,Hq,D];
    0 for a row at pos = 0, as the TPU kernel."""
    _check_impl(impl, q)
    return _da.decode_attention(q.transpose(1, 2), k, v, pos,
                                block_k=block_k).transpose(1, 2)


def ssd_chunked_pallas(x, b, c, dt, a_log, *, chunk=128, impl="auto"):
    """The SSD scan with one ssd_chunk call over every chunk and the
    inter-chunk recurrence on the host: the counterpart of the JAX
    package's ``ops.ssd_chunked_pallas`` (no D-skip, zero initial state).

    x [B,S,H,P], b/c [B,S,N], dt [B,S,H] -> (y [B,S,H,P] in x's type,
    final state [B,H,P,N] fp32). The chunks go to the kernel as the batch
    rows of one call ([B,S,...] -> [B·nc,Q,...] by reshape, a view of the
    model's split and conv outputs); the intra-chunk step does not depend
    on the carried state, so this computes what JAX's scan of one kernel
    call per chunk computes. The state is carried chunk by chunk in order
    (the kernel's [N, P] chunk state swapped to [P, N]); the inter-chunk
    term of every chunk then reads the state entering it in one batched
    product, and is added to y_intra, which is in x's type as there."""
    _check_impl(impl, x)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} must divide chunk {q}")
    nc = s // q
    y_intra, st_contrib, dec = _sc.ssd_chunk(
        x.reshape(bsz * nc, q, h, p), b.reshape(bsz * nc, q, n),
        c.reshape(bsz * nc, q, n), dt.reshape(bsz * nc, q, h), a_log)
    st_contrib = st_contrib.view(bsz, nc, h, n, p).transpose(-1, -2)
    dec = dec.view(bsz, nc, h, 1, 1)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    entering = []                      # the state entering each chunk
    for ci in range(nc):
        entering.append(state)
        state = state * dec[:, ci] + st_contrib[:, ci]
    # inter-chunk term: y_inter[s] = C_s . state * exp(acum_s)
    a = -torch.exp(a_log.float())
    acum = torch.cumsum(dt.reshape(bsz, nc, q, h).float() * a, dim=2)
    y_inter = torch.einsum("bcqn,bchpn->bcqhp",
                           c.reshape(bsz, nc, q, n).float(),
                           torch.stack(entering, dim=1))
    y_inter = y_inter * torch.exp(acum)[..., None]
    y = y_intra.float().view(bsz, nc, q, h, p) + y_inter
    return y.reshape(bsz, s, h, p).to(x.dtype), state
