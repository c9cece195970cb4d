"""Mixture-of-Experts: top-k router and capacity-bucketed expert compute
(the port of ``repro/models/moe.py``).

Dispatch is grouped, as in the JAX package: the T tokens are split into G
groups and each group routes into its own [E, C] capacity buckets, so every
gather is batched over the group axis. Tokens past an expert's capacity are
dropped (they get no output from that expert), and the router adds the
load-balance auxiliary loss E * sum(me * ce).

The buckets are built without a scatter: a stable sort of the group's
(token, choice) entries by expert, `searchsorted` for each expert's first
entry and count, then gathers. Duplicate-index writes never happen, so the
forward is deterministic on every device; the backward of the two gathers
is torch's index backward (sorted, deterministic under
``torch.use_deterministic_algorithms``).

One property of the JAX dispatch is kept on purpose. There, the dropped
entries of an overflowing expert are clipped onto its last slot, C - 1, and
write the padding id there after its kept token did (XLA:CPU applies
duplicate scatter updates in order). The last kept token of every expert
whose count exceeds C therefore gets 0 from that expert, although its
combine weight still counts it as kept. Here slot C - 1 of every such
expert is marked as padding explicitly: the port computes the reference's
function, deterministically on every device (ROADMAP.md section 3,
"Properties of the reference").

The JAX package's sharding constraints are no-ops on one device and are
dropped (sharding is ROADMAP.md section 1, item 8). The expert products
are einsums, as the JAX package computes them outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init


def moe_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    """The fp32 router [D, E] and the experts' SwiGLU weights [E, D, F],
    [E, D, F], [E, F, D] (a leading [L] when stacked)."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    lead = (stacked,) if stacked else ()
    return {
        "router": dense_init(gen, d, (*lead, d, e), device, torch.float32),
        "w_gate": dense_init(gen, d, (*lead, e, d, f), device, dtype),
        "w_up": dense_init(gen, d, (*lead, e, d, f), device, dtype),
        "w_down": dense_init(gen, f, (*lead, e, f, d), device, dtype),
    }


def _top_k(probs: torch.Tensor, k: int):
    """The k largest entries of each row, largest first, ties to the lower
    index (jax.lax.top_k's order; torch.topk promises none): k passes of
    argmax, which returns the first maximum."""
    cols = torch.arange(probs.shape[-1], device=probs.device)
    rest = probs
    vals, idx = [], []
    for _ in range(k):
        i = rest.argmax(dim=-1, keepdim=True)
        vals.append(torch.gather(probs, -1, i))
        idx.append(i)
        rest = torch.where(cols == i, float("-inf"), rest)
    return torch.cat(vals, dim=-1), torch.cat(idx, dim=-1)


def route_topk(logits: torch.Tensor, top_k: int):
    """logits [T, E] -> (weights [T, k] renormalised, experts [T, k],
    the load-balance aux E * sum(me * ce)), the softmax in fp32."""
    probs = torch.softmax(logits.float(), dim=-1)
    w, idx = _top_k(probs, top_k)
    w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1e-9)
    e = logits.shape[-1]
    me = probs.mean(dim=0)
    ce = F.one_hot(idx.reshape(-1), e).sum(dim=0).float() / idx.numel()
    return w, idx, e * torch.sum(me * ce)


def pick_groups(t: int, *, target: int = 64) -> int:
    """The largest group count <= target that divides t."""
    g = min(target, t)
    while g > 1 and t % g:
        g -= 1
    return g


def _group_dispatch(idx_g: torch.Tensor, w_g: torch.Tensor, cap: int,
                    e: int):
    """Buckets of every group at once. idx_g, w_g [G, Tg, k] -> bucket_tok
    [G, E, C] (token ids, Tg = padding), comb_idx [G, Tg*k] (into the
    flattened [E*C] buckets), comb_w [G, Tg*k] (0 for a dropped entry)."""
    g, tg, k = idx_g.shape
    n = tg * k
    dev = idx_g.device
    flat_e = idx_g.reshape(g, n)
    flat_t = torch.arange(tg, device=dev).repeat_interleave(k)
    se, order = torch.sort(flat_e, dim=-1, stable=True)
    st = flat_t[order]                                      # [G, n]
    experts = torch.arange(e, device=dev).expand(g, e).contiguous()
    starts = torch.searchsorted(se, experts)                # [G, E]
    counts = torch.searchsorted(se, experts, right=True) - starts
    # the entry's slot in its expert's bucket, in the original entry order
    slot_sorted = torch.arange(n, device=dev) - torch.gather(starts, 1, se)
    slot = torch.gather(slot_sorted, 1, torch.argsort(order, dim=-1))
    # bucket (e, c) holds the expert's c-th entry; slot C-1 of an expert
    # that overflows holds padding (the reference's last scatter write)
    c = torch.arange(cap, device=dev)
    live = (c < counts[..., None]) & ~((c == cap - 1)
                                       & (counts[..., None] > cap))
    src = torch.clamp(starts[..., None] + c, max=n - 1).reshape(g, e * cap)
    bucket_tok = torch.where(live, torch.gather(st, 1, src).reshape(
        g, e, cap), tg)
    comb_idx = flat_e * cap + torch.clamp(slot, max=cap - 1)
    comb_w = w_g.reshape(g, n) * (slot < cap).float()
    return bucket_tok, comb_idx, comb_w


def moe_apply(x: torch.Tensor, p: dict, cfg, groups: int | None = None):
    """x [B, S, D] -> (y [B, S, D], aux loss scalar)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"]
    w, idx, aux = route_topk(logits, k)

    g = pick_groups(t) if groups is None else groups
    tg = t // g
    cap = max(int(math.ceil(tg * k / e * cfg.moe_capacity_factor)), k)
    bucket_tok, comb_idx, comb_w = _group_dispatch(
        idx.reshape(g, tg, k), w.reshape(g, tg, k), cap, e)

    # gather into [G, E, C, D]; row Tg of each group is the zero padding
    xpad = torch.cat([xt.reshape(g, tg, d),
                      torch.zeros((g, 1, d), dtype=x.dtype, device=x.device)],
                     dim=1)
    rows = torch.arange(g, device=x.device)[:, None]
    xe = xpad[rows, bucket_tok.reshape(g, e * cap)].reshape(g, e, cap, d)
    gg = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    uu = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    h = F.silu(gg.float()).to(x.dtype) * uu
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"])

    # combine by gather (the inverse permutation), batched over groups
    contrib = ye.reshape(g, e * cap, d)[rows, comb_idx]     # [G, Tg*k, D]
    contrib = contrib * comb_w[..., None].to(ye.dtype)
    y = contrib.reshape(g, tg, k, d).sum(dim=2)
    return y.reshape(b, s, d), aux
