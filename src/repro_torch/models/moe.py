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

The JAX package's sharding constraints sit where it puts them
(`rules.constrain`: the identity off a mesh). On a mesh the ops DTensor
has no sharding strategy for (the dispatch's sort and searchsorted, the
row gathers) run on each rank's groups under ``local_map``. The expert
products are einsums, as the JAX package computes them outside any Pallas
kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.sharding.rules import active_mesh, batch_rows, constrain


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


def _gather_rows(xg: torch.Tensor, bucket_tok: torch.Tensor) -> torch.Tensor:
    """xg [G, Tg, D], bucket_tok [G, E, C] -> xe [G, E, C, D]; the id Tg
    reads a zero row (the padding)."""
    g, _, d = xg.shape
    e, cap = bucket_tok.shape[1:]
    xpad = torch.cat([xg, torch.zeros((g, 1, d), dtype=xg.dtype,
                                      device=xg.device)], dim=1)
    rows = torch.arange(g, device=xg.device)[:, None]
    return xpad[rows, bucket_tok.reshape(g, e * cap)].reshape(g, e, cap, d)


def _combine_rows(ye: torch.Tensor, comb_idx: torch.Tensor) -> torch.Tensor:
    """ye [G, E, C, D], comb_idx [G, n] -> [G, n, D] (the inverse
    permutation, a gather)."""
    g, e, cap, d = ye.shape
    rows = torch.arange(g, device=ye.device)[:, None]
    return ye.reshape(g, e * cap, d)[rows, comb_idx]


def _local(fn, out, ins, grads=None):
    """local_map over the active mesh (the ops DTensor has no sharding
    strategy for: sort, searchsorted and the duplicate-free index gathers
    of the dispatch)."""
    from torch.distributed.tensor.experimental import local_map
    return local_map(fn, out_placements=out, in_placements=ins,
                     in_grad_placements=grads, device_mesh=active_mesh())


def _expert_down(h, w_down):
    """ye = einsum("gecf,efd->gecd", h, w_down) on each rank's shards:
    h is first placed on the model axis as w_down is there (its experts
    where w_down splits E, its F where w_down splits F, as the serve rules
    do, else whole), and the local products are the output's shards (a
    partial sum over the model axis when F is split). DTensor's own einsum
    views a permuted local shard that its recorded strides do not match
    when the groups are split (mixtral's decode)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    names = w_down.device_mesh.mesh_dim_names
    i = names.index("model")
    wp = w_down.placements[i]
    want, out = {Shard(0): (Shard(1), Shard(1)),
                 Shard(1): (Shard(3), Partial())}.get(
        wp, (Replicate(), Replicate()))
    hp = list(h.placements)
    hp[i] = want
    h = h.redistribute(h.device_mesh, hp)
    op = list(hp)
    op[i] = out
    wpl = list(w_down.placements)
    # each rank's groups add their own share to w_down's gradient: a
    # partial sum over the batch axes the groups are split on
    wgrad = [Partial() if p == Shard(0) and n != "model" else q
             for n, p, q in zip(names, hp, wpl)]
    return _local(lambda a, b: torch.einsum("gecf,efd->gecd", a, b), op,
                  (hp, wpl), (hp, wgrad))(h, w_down)


def moe_apply(x: torch.Tensor, p: dict, cfg, groups: int | None = None):
    """x [B, S, D] -> (y [B, S, D], aux loss scalar). On a mesh the
    dispatch and the row gathers run on each rank's groups under
    ``local_map`` (DTensor has no strategy for sort, searchsorted or
    index gathers), the expert products as DTensor einsums; the
    constraints are the JAX package's."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    logits = xt.float() @ p["router"]
    w, idx, aux = route_topk(logits, k)

    g = pick_groups(t) if groups is None else groups
    tg = t // g
    cap = max(int(math.ceil(tg * k / e * cfg.moe_capacity_factor)), k)
    xg = constrain(xt.reshape(g, tg, d), "batch", None, None)
    idx_g, w_g = idx.reshape(g, tg, k), w.reshape(g, tg, k)
    sharded = isinstance(xg, DTensor)
    if sharded:
        pl = batch_rows(xg)
        mesh = active_mesh()
        xg, idx_g, w_g = (v.redistribute(mesh, pl) for v in (xg, idx_g, w_g))
        bucket_tok, comb_idx, comb_w = _local(
            lambda i, ww: _group_dispatch(i, ww, cap, e), (pl, pl, pl),
            (pl, pl))(idx_g, w_g)
    else:
        bucket_tok, comb_idx, comb_w = _group_dispatch(idx_g, w_g, cap, e)
    bucket_tok = constrain(bucket_tok, "batch", "model", None)

    # gather into [G, E, C, D]; row Tg of each group is the zero padding
    if sharded:
        from torch.distributed.tensor import Partial
        bpl = list(bucket_tok.placements)
        # experts split over the model axis: each rank's rows reach only its
        # experts, so the gradient of xg is a partial sum there
        xe = _local(_gather_rows, bpl, (pl, bpl),
                    (batch_rows(xg, model=Partial())
                     if bpl != pl else pl, bpl))(xg, bucket_tok)
    else:
        xe = _gather_rows(xg, bucket_tok)
    xe = constrain(xe, "batch", "model", None, None)
    gg = torch.einsum("gecd,edf->gecf", xe, p["w_gate"])
    uu = torch.einsum("gecd,edf->gecf", xe, p["w_up"])
    gg = constrain(gg, "batch", "model", None, "model")
    uu = constrain(uu, "batch", "model", None, "model")
    h = F.silu(gg.float()).to(x.dtype) * uu
    ye = _expert_down(h, p["w_down"]) if sharded else \
        torch.einsum("gecf,efd->gecd", h, p["w_down"])
    ye = constrain(ye, "batch", "model", None, None)

    # combine by gather (the inverse permutation), batched over groups
    if sharded:
        ye = ye.redistribute(mesh, pl)     # every expert's rows, a gather
        contrib = _local(_combine_rows, pl, (pl, pl))(ye, comb_idx)
    else:
        contrib = _combine_rows(ye, comb_idx)               # [G, Tg*k, D]
    contrib = constrain(contrib, "batch", None, None)
    contrib = contrib * comb_w[..., None].to(ye.dtype)
    y = contrib.reshape(g, tg, k, d).sum(dim=2)
    y = constrain(y, "batch", None, None)
    return y.reshape(b, s, d), aux
