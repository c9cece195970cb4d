"""Attention: GQA, causal/bidirectional, sliding window, softcap, KV cache
(the port of ``repro/models/attention.py``).

Execution paths of `attend` (selected by `impl`):
  * "naive":   materialises the [Sq, Skv] scores — short sequences;
  * "chunked": online softmax over KV chunks (a Python loop in place of
               ``lax.scan``); a sliding window reads one banded KV slice
               per q chunk, so the work scales with S * (window + chunk);
  * "chunked_skip": the causal chunked path over the lower-triangle chunk
               pairs only;
  * "cuda":    the hand-written flash-attention kernel
               (``kernels/flash_attention.py``), the counterpart of the JAX
               package's "pallas"; its plain PyTorch version on CPU tensors;
  * "flash_vjp": the training path (``models/flash_vjp.py``): attention
               whose backward recomputes p from (q, k, v, o, lse); on CUDA
               tensors kernel 8 with lse and the hand-written backward.

All functions take q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] with Hq a multiple of
Hkv (GQA) and return [B,Sq,Hq,D]. Cache positions (`pos`) are Python ints.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.models.layers import dense_init, softcap
from repro_torch.sharding.rules import hold_grad

NEG_INF = -2.0**30  # large but finite: no NaN for fully masked rows

IMPLS = ("naive", "chunked", "chunked_skip", "cuda", "flash_vjp")


# -- parameters ---------------------------------------------------------------

def attention_params(gen, cfg, *, stacked: int = 0, cross: bool = False,
                     device=None) -> dict:
    lead = (stacked,) if stacked else ()
    dtype = getattr(torch, cfg.dtype)
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim
    p = {
        "wq": dense_init(gen, d, (*lead, d, qd), device, dtype),
        "wk": dense_init(gen, d, (*lead, d, kvd), device, dtype),
        "wv": dense_init(gen, d, (*lead, d, kvd), device, dtype),
        "wo": dense_init(gen, qd, (*lead, qd, d), device, dtype),
    }
    if cfg.qkv_bias and not cross:
        dev = p["wq"].device
        p["bq"] = torch.zeros((*lead, qd), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((*lead, kvd), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((*lead, kvd), dtype=dtype, device=dev)
    return p


def project_qkv(x, p, cfg, kv_x=None):
    """x -> q [B,S,Hq,D], k/v [B,Skv,Hkv,D]."""
    kv_src = x if kv_x is None else kv_x
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    b = x.shape[0]
    q = _split_heads(q, b, cfg.num_heads, cfg.head_dim)
    k = _split_heads(k, b, cfg.num_kv_heads, cfg.head_dim)
    v = _split_heads(v, b, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _whole_heads(t, h: int | None = None):
    """t [B, S, H, ...] with dim 2 (the heads, or the flat H*Dh) whole on
    the model axis: a DTensor that splits it there is gathered, only when
    H does not divide the axis if `h` is given; any other tensor as it
    is."""
    if not isinstance(t, DTensor) or "model" not in \
            t.device_mesh.mesh_dim_names:
        return t
    i = t.device_mesh.mesh_dim_names.index("model")
    if t.placements[i] != Shard(2) or (
            h is not None and h % t.device_mesh.shape[i] == 0):
        return t
    pl = list(t.placements)
    pl[i] = Replicate()
    return t.redistribute(t.device_mesh, pl)


def _split_heads(t, b: int, h: int, dh: int):
    """[B, S, H*Dh] -> [B, S, H, Dh]. A DTensor whose flat head dim is
    sharded on the model axis where H does not divide it (granite's 8 KV
    heads on 16 ranks: half a head each) is gathered on that axis first."""
    return _whole_heads(t, h).reshape(b, -1, h, dh)


def output_proj(o, p):
    b, s = o.shape[:2]
    return hold_grad(o.reshape(b, s, -1)) @ p["wo"]


# -- naive reference ----------------------------------------------------------

def naive_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    cap: float = 0.0, q_offset: int = 0, kv_len=None):
    """Materialised-scores attention. q_offset: absolute position of q[0];
    kv_len: number of valid cache entries."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, d)
    # scaled in place, and no mask where none applies (cross-attention to a
    # memory): the same values with one [B, H, S, T] fp32 buffer fewer in
    # the forward and in the backward
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qr.float(),
                          k.float()).div_(math.sqrt(d))
    scores = softcap(scores, cap)
    if causal or window or kv_len is not None:
        qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        if kv_len is not None:
            mask &= kpos < kv_len
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


# -- chunked (flash-style) attention ------------------------------------------

def _online_block(qc, kc, vc, m, l, acc, mask, cap, scale):
    """One online-softmax update. qc [B,C,Hkv,G,D]; kc/vc [B,Ck,Hkv,D]."""
    s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(), kc.float()) * scale
    s = softcap(s, cap)
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p,
                                                   vc.float())
    return m_new, l_new, acc_new


def _state0(b, hkv, g, c, d, device, lead=()):
    m = torch.full((*lead, b, hkv, g, c), NEG_INF, dtype=torch.float32,
                   device=device)
    l = torch.zeros((*lead, b, hkv, g, c), dtype=torch.float32, device=device)
    acc = torch.zeros((*lead, b, hkv, g, c, d), dtype=torch.float32,
                      device=device)
    return m, l, acc


def _finish(acc, l):
    """acc / max(l, 1e-20): [B,Hkv,G,C,D] -> [B,C,Hkv,G,D]."""
    o = acc / torch.clamp(l[..., None], min=1e-20)
    return o.permute(0, 3, 1, 2, 4)


def chunked_attention(q, k, v, *, causal: bool = True, window: int = 0,
                      cap: float = 0.0, q_chunk: int = 512,
                      kv_chunk: int = 512):
    """Online-softmax attention with O(chunk^2) live scores. window > 0
    reads one contiguous KV slice of length window + q_chunk per q chunk."""
    if window and not causal:
        raise ValueError("sliding windows are causal by definition")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / np.sqrt(d)
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide chunks "
                         f"({q_chunk},{kv_chunk})")
    dev = q.device
    outs = []
    for qi in range(sq // q_chunk):
        q_start = qi * q_chunk
        qc = q[:, q_start:q_start + q_chunk].reshape(b, q_chunk, hkv, g, d)
        qpos = q_start + torch.arange(q_chunk, device=dev)[:, None]
        m, l, acc = _state0(b, hkv, g, q_chunk, d, dev)
        if window:
            band = min(window + q_chunk, skv)
            start = min(max(q_start + q_chunk - band, 0), skv - band)
            kpos = start + torch.arange(band, device=dev)[None, :]
            mask = (kpos > qpos - window) & (kpos <= qpos)
            m, l, acc = _online_block(qc, k[:, start:start + band],
                                      v[:, start:start + band], m, l, acc,
                                      mask, cap, scale)
        else:
            for ki in range(skv // kv_chunk):
                kpos = ki * kv_chunk + torch.arange(kv_chunk,
                                                    device=dev)[None, :]
                mask = (kpos <= qpos) if causal else torch.ones(
                    (q_chunk, kv_chunk), dtype=torch.bool, device=dev)
                sl = slice(ki * kv_chunk, (ki + 1) * kv_chunk)
                m, l, acc = _online_block(qc, k[:, sl], v[:, sl], m, l, acc,
                                          mask, cap, scale)
        outs.append(_finish(acc, l))
    return torch.cat(outs, dim=1).reshape(b, sq, hq, d).to(q.dtype)


def chunked_attention_causal_skip(q, k, v, *, cap: float = 0.0,
                                  q_chunk: int = 512, kv_chunk: int = 512):
    """Causal chunked attention over the lower-triangle chunk pairs only
    (ki <= qi), in the JAX package's pair order."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if sq != skv:
        raise ValueError("triangle skip assumes self-attention (sq == skv)")
    g = hq // hkv
    scale = 1.0 / np.sqrt(d)
    c = min(q_chunk, kv_chunk, sq)
    if sq % c:
        raise ValueError(f"seq {sq} must divide chunk {c}")
    n = sq // c
    dev = q.device
    m, l, acc = _state0(b, hkv, g, c, d, dev, lead=(n,))
    for qi, ki in zip(*np.tril_indices(n)):
        qi, ki = int(qi), int(ki)
        qc = q[:, qi * c:(qi + 1) * c].reshape(b, c, hkv, g, d)
        qpos = qi * c + torch.arange(c, device=dev)[:, None]
        kpos = ki * c + torch.arange(c, device=dev)[None, :]
        sl = slice(ki * c, (ki + 1) * c)
        m[qi], l[qi], acc[qi] = _online_block(qc, k[:, sl], v[:, sl], m[qi],
                                              l[qi], acc[qi], kpos <= qpos,
                                              cap, scale)
    o = torch.cat([_finish(acc[i], l[i]) for i in range(n)], dim=1)
    return o.reshape(b, sq, hq, d).to(q.dtype)


# -- decode (one token) against a KV cache ------------------------------------

def decode_attention(q, cache_k, cache_v, pos: int, *, window: int = 0,
                     cap: float = 0.0, k_scale=None, v_scale=None):
    """q [B,1,Hq,D]; cache [B,Smax,Hkv,D]; pos: count of valid entries (the
    new token's k/v already written at pos-1). With a window only the last
    `window` entries are read."""
    if window:
        smax = cache_k.shape[1]
        w = min(window, smax)
        start = min(max(pos - w, 0), smax - w)
        kpos = start + torch.arange(w, device=q.device)
        valid = (kpos < pos) & (kpos >= pos - w)
        return _decode_core(q, cache_k[:, start:start + w],
                            cache_v[:, start:start + w], valid, cap)
    kpos = torch.arange(cache_k.shape[1], device=q.device)
    return _decode_core(q, cache_k, cache_v, kpos < pos, cap,
                        k_scale=k_scale, v_scale=v_scale)


def ring_slots(pos: int, window: int, device=None) -> torch.Tensor:
    """Absolute position held by each ring slot when the write head is at
    `pos`: slot i holds the largest p <= pos with p % window == i; negative
    entries are slots not filled yet."""
    i = torch.arange(window, device=device)
    head = pos % window
    return pos - ((head - i) % window)


def decode_attention_ring(q, cache_k, cache_v, pos: int, *, cap: float = 0.0):
    """Decode against a ring-buffer window cache [B, W, Hkv, D] whose slot
    pos % W holds the token at `pos`."""
    valid = ring_slots(pos, cache_k.shape[1], device=q.device) >= 0
    return _decode_core(q, cache_k, cache_v, valid, cap)


def fill_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """The last `window` entries of k [B,S,...] in ring order (slot
    p % window holds position p); left-padded with zeros when S < window."""
    if isinstance(k, DTensor):
        # torch.roll has no DTensor strategy in every release the port runs
        # on; the sequence dim is whole on every rank, so each rank rolls
        # its own shard
        from torch.distributed.tensor.experimental import local_map
        pl = list(k.placements)
        return local_map(lambda t: fill_ring(t, window), out_placements=pl,
                         in_placements=(pl,), device_mesh=k.device_mesh)(k)
    s = k.shape[1]
    if s >= window:
        tail = k[:, s - window:]
    else:
        pad = torch.zeros((k.shape[0], window - s, *k.shape[2:]),
                          dtype=k.dtype, device=k.device)
        tail = torch.cat([pad, k], dim=1)
    return torch.roll(tail, s % window, dims=1)


def _decode_core(q, k, v, valid, cap, *, k_scale=None, v_scale=None):
    """k/v may be int8 with per-(B,S,H) fp32 scales (quantised cache). On
    a mesh the one token's query heads are gathered whole (the cache is
    split on its sequence, not its heads), so the scores come out split on
    the cache positions."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qr = _whole_heads(q).reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qr.float(), k.float()) / math.sqrt(d)
    if k_scale is not None:                  # [B, S, Hkv] -> [B, Hkv, 1, S]
        s = s * k_scale.transpose(1, 2)[:, :, None, :]
    s = softcap(s, cap)
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    if v_scale is not None:
        w = w * v_scale.transpose(1, 2)[:, :, None, :]
    o = torch.einsum("bhgk,bkhd->bhgd", w, v.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., H, D] -> (int8 values, fp32 scale over D)."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


# -- dispatch -----------------------------------------------------------------

def attend(q, k, v, *, impl: str = "chunked", causal: bool = True,
           window: int = 0, cap: float = 0.0, q_chunk: int = 512,
           kv_chunk: int = 512):
    """The JAX package's dispatch, with its short-sequence rule: any Sq <=
    max(q_chunk, 128) // 4 (128 at the default q_chunk) takes the naive
    path, whatever `impl` asks for."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; options {IMPLS}")
    if isinstance(q, DTensor):
        return _attend_local(q, k, v, impl=impl, causal=causal,
                             window=window, cap=cap, q_chunk=q_chunk,
                             kv_chunk=kv_chunk)
    if impl == "naive" or q.shape[1] <= max(q_chunk, 128) // 4:
        return naive_attention(q, k, v, causal=causal, window=window, cap=cap)
    if impl == "cuda":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, causal=causal, window=window,
                                    cap=cap)
    if impl == "flash_vjp":
        from repro_torch.models.flash_vjp import chunked_attention_vjp
        return chunked_attention_vjp(q, k, v, causal=causal, window=window,
                                     cap=cap, q_chunk=q_chunk,
                                     kv_chunk=kv_chunk)
    if impl == "chunked_skip" and causal and not window \
            and q.shape[1] == k.shape[1]:
        return chunked_attention_causal_skip(q, k, v, cap=cap,
                                             q_chunk=q_chunk,
                                             kv_chunk=kv_chunk)
    return chunked_attention(q, k, v, causal=causal, window=window, cap=cap,
                             q_chunk=q_chunk, kv_chunk=kv_chunk)


def _attend_local(q, k, v, **kw):
    """`attend` on DTensors: every path (the kernels on CUDA) runs on each
    rank's local shards under ``local_map``, batch over the batch axes
    and heads over the model axis as `rules.head_layout` places them (KV
    heads repeated where the model axis has more ranks than KV heads)."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding.rules import head_layout
    mesh = q.device_mesh
    pl, rep = head_layout(mesh, q.shape[0], q.shape[2], k.shape[2])
    q = q.redistribute(mesh, pl)
    if rep > 1:
        whole = [Replicate() if n == "model" else p
                 for n, p in zip(mesh.mesh_dim_names, pl)]
        k, v = (t.redistribute(mesh, whole).repeat_interleave(rep, dim=2)
                for t in (k, v))
    k, v = (t.redistribute(mesh, pl) for t in (k, v))
    pl = list(pl)      # one output: a list, not a tuple of outputs
    fn = local_map(lambda a, b, c: attend(a, b, c, **kw), out_placements=pl,
                   in_placements=(pl, pl, pl), device_mesh=mesh)
    return fn(q, k, v)
