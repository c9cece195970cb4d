"""Per-family transformer blocks (the port of ``repro/models/blocks.py``).

Every block function has the signature

    y, cache = block(x, params, cfg, rt, *, kind=0, cache=None, pos=None)

where `cache` is this block's cache dict for serving ({"k", "v"} of shape
[B, Smax, Hkv, Dh], or the SSM state) and `pos` a Python int, the number
of valid cache entries. The JAX package returns updated copies of its
immutable caches; here the cache tensors are written IN PLACE (prefill
writes the fresh K/V or state, decode writes one position) and the same
dict is returned, so a caller holding a view of a larger cache (the
serving engine's slot rows) sees the update.

Ported: the dense block (llama / granite / qwen / gemma2), the MoE block
(mixtral / arctic), the SSM block (mamba2), the hybrid block (hymba), the
encoder block (whisper) and the cross-attention decoder block (whisper's
decoder layer, llama-vision's gated cross layer).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, gated_mlp,
                                       gated_mlp_params, layer_norm, mlp,
                                       mlp_params, rms_norm)


@dataclasses.dataclass(frozen=True)
class Runtime:
    """Execution knobs (not architecture): attention impl and chunking.

    attn_impl: "naive" | "chunked" | "chunked_skip" | "cuda" (the
    flash-attention kernel; the JAX package's "pallas") | "flash_vjp" (the
    training path: models/flash_vjp.py, on the card kernel 8 forward and
    the hand-written backward). loss_chunk: the sequence chunk of
    transformer.loss_fn; remat: activation checkpointing of every layer."""

    attn_impl: str = "chunked"
    q_chunk: int = 512
    kv_chunk: int = 512
    loss_chunk: int = 512       # vocab CE sequence chunking
    remat: bool = False         # activation checkpointing over layers
    swa_only: bool = False      # gemma2's long-context variant


# -- attention sub-block ------------------------------------------------------

def _write(cache: torch.Tensor, start: int, x: torch.Tensor) -> None:
    """cache[:, start:start + S] = x (in place), cast to the cache's type.
    A DTensor cache (on a mesh, its sequence split on the model axis by
    sharding/rules.cache_specs) is written on each rank's own slots: x is
    gathered to the cache's batch rows, whole in its other dims, and each
    rank copies the positions that fall in its slice (DTensor's setitem
    would slice the split sequence dim of a gathered copy)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(cache, DTensor):
        cache[:, start:start + x.shape[1]] = x.to(cache.dtype)
        return
    mesh, pl = cache.device_mesh, cache.placements
    xl = x.redistribute(mesh, [p if p == Shard(0) else Replicate()
                               for p in pl]).to_local()
    off, n = 0, cache.shape[1]
    for k, p in enumerate(pl):
        if p == Shard(1):                   # major first, as rules place it
            n //= mesh.size(k)
            off += mesh.get_coordinate()[k] * n
    lo, hi = max(start, off), min(start + x.shape[1], off + n)
    if lo < hi:
        cache.to_local()[:, lo - off:hi - off] = \
            xl[:, lo - start:hi - start].to(cache.dtype)


def attn_apply(x, p, cfg, rt: Runtime, *, window: int, cache=None, pos=None,
               kv_x=None, causal=True, positions=None, impl=None):
    """Returns (attn_out [B,S,D], cache). Decode (S == 1 with a cache)
    writes this token's K/V at `pos` (a ring slot for windowed layers,
    int8 with scales for a quantised cache) and attends to pos + 1
    entries; prefill writes the prompt's K/V from position 0."""
    b, s, _ = x.shape
    q, k, v = attn.project_qkv(x, p, cfg, kv_x=kv_x)
    decode = cache is not None and s == 1
    if positions is None:
        if decode:
            positions = torch.full((b, 1), pos, dtype=torch.int32,
                                   device=x.device)
        else:
            positions = torch.arange(q.shape[1], device=x.device).expand(
                b, q.shape[1])
    if cfg.rope_theta and kv_x is None:      # no RoPE on cross-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    quant = cache is not None and "k_scale" in cache
    if decode:
        if window:
            slot = pos % cache["k"].shape[1]
            _write(cache["k"], slot, k)
            _write(cache["v"], slot, v)
            o = attn.decode_attention_ring(q, cache["k"], cache["v"], pos,
                                           cap=cfg.attn_softcap)
        elif quant:
            for name, t in (("k", k), ("v", v)):
                t8, ts = attn.quantize_kv(t)
                _write(cache[name], pos, t8)
                _write(cache[name + "_scale"], pos, ts)
            o = attn.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                      cap=cfg.attn_softcap,
                                      k_scale=cache["k_scale"],
                                      v_scale=cache["v_scale"])
        else:
            _write(cache["k"], pos, k)
            _write(cache["v"], pos, v)
            o = attn.decode_attention(q, cache["k"], cache["v"], pos + 1,
                                      cap=cfg.attn_softcap)
    else:
        if cache is not None:                # prefill: persist K/V
            if window:
                w = cache["k"].shape[1]
                cache["k"].copy_(attn.fill_ring(k.to(cache["k"].dtype), w))
                cache["v"].copy_(attn.fill_ring(v.to(cache["v"].dtype), w))
            elif quant:
                for name, t in (("k", k), ("v", v)):
                    t8, ts = attn.quantize_kv(t)
                    _write(cache[name], 0, t8)
                    _write(cache[name + "_scale"], 0, ts)
            else:
                _write(cache["k"], 0, k)
                _write(cache["v"], 0, v)
        o = attn.attend(q, k, v, impl=impl or rt.attn_impl, causal=causal,
                        window=window, cap=cfg.attn_softcap,
                        q_chunk=rt.q_chunk, kv_chunk=rt.kv_chunk)
    return attn.output_proj(o, p), cache


def layer_window(cfg, rt: Runtime, kind: int) -> int:
    """Effective sliding window of a layer. kind: 0 = local, 1 = global."""
    if cfg.local_global:
        if kind == 0:
            return cfg.sliding_window or 4096
        return (cfg.sliding_window or 4096) if rt.swa_only else 0
    return cfg.sliding_window


# -- dense block (llama / yi / qwen / granite / gemma2) -----------------------

def _norms(names, lead, cfg, device) -> dict:
    """fp32 zeros [*lead, D] for each norm scale named."""
    return {nm: torch.zeros((*lead, cfg.d_model), dtype=torch.float32,
                            device=device) for nm in names}


def dense_block_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    lead = (stacked,) if stacked else ()
    p = {
        "attn": attn.attention_params(gen, cfg, stacked=stacked,
                                      device=device),
        "mlp": gated_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                getattr(torch, cfg.dtype), stacked=stacked,
                                device=device),
    }
    names = ["norm_attn", "norm_mlp"]
    if cfg.attn_softcap or cfg.local_global:   # gemma2-style post-norms
        names += ["postnorm_attn", "postnorm_mlp"]
    p.update(_norms(names, lead, cfg, p["attn"]["wq"].device))
    return p


def dense_block(x, p, cfg, rt, *, kind=0, cache=None, pos=None):
    h, cache = attn_apply(rms_norm(x, p["norm_attn"], cfg.norm_eps),
                          p["attn"], cfg, rt,
                          window=layer_window(cfg, rt, kind),
                          cache=cache, pos=pos)
    if "postnorm_attn" in p:
        h = rms_norm(h, p["postnorm_attn"], cfg.norm_eps)
    x = x + h
    h = gated_mlp(rms_norm(x, p["norm_mlp"], cfg.norm_eps), p["mlp"])
    if "postnorm_mlp" in p:
        h = rms_norm(h, p["postnorm_mlp"], cfg.norm_eps)
    return x + h, cache


# -- MoE block (mixtral / arctic) ---------------------------------------------

def moe_block_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    lead = (stacked,) if stacked else ()
    dtype = getattr(torch, cfg.dtype)
    p = {"attn": attn.attention_params(gen, cfg, stacked=stacked,
                                       device=device),
         "moe": moe_lib.moe_params(gen, cfg, stacked=stacked, device=device)}
    if cfg.dense_residual_ff:           # arctic's parallel dense MLP
        p["dense_mlp"] = gated_mlp_params(gen, cfg.d_model,
                                          cfg.dense_residual_ff, dtype,
                                          stacked=stacked, device=device)
    p.update(_norms(("norm_attn", "norm_ffn"), lead, cfg,
                    p["attn"]["wq"].device))
    return p


def moe_block(x, p, cfg, rt, *, kind=0, cache=None, pos=None):
    """Returns (y, (cache, aux)): the router's load-balance loss rides
    with the cache, as in the JAX package."""
    h, cache = attn_apply(rms_norm(x, p["norm_attn"], cfg.norm_eps),
                          p["attn"], cfg, rt, window=cfg.sliding_window,
                          cache=cache, pos=pos)
    x = x + h
    hin = rms_norm(x, p["norm_ffn"], cfg.norm_eps)
    y, aux = moe_lib.moe_apply(hin, p["moe"], cfg)
    if "dense_mlp" in p:
        y = y + gated_mlp(hin, p["dense_mlp"])
    return x + y, (cache, aux)


# -- SSM block (mamba2): mixer only, no MLP -----------------------------------

def ssm_block_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    lead = (stacked,) if stacked else ()
    mixer = ssm_lib.ssm_params(gen, cfg, stacked=stacked, device=device)
    return {"mixer": mixer,
            "norm": torch.zeros((*lead, cfg.d_model), dtype=torch.float32,
                                device=mixer["in_proj"].device)}


def ssm_block(x, p, cfg, rt, *, kind=0, cache=None, pos=None):
    y, cache = ssm_lib.ssm_block(rms_norm(x, p["norm"], cfg.norm_eps),
                                 p["mixer"], cfg, cache=cache)
    return x + y, cache


# -- hybrid block (hymba): parallel attention and SSM heads, fused by mean ----

def hybrid_block_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    lead = (stacked,) if stacked else ()
    p = {"attn": attn.attention_params(gen, cfg, stacked=stacked,
                                       device=device),
         "mixer": ssm_lib.ssm_params(gen, cfg, stacked=stacked,
                                     device=device),
         "mlp": gated_mlp_params(gen, cfg.d_model, cfg.d_ff,
                                 getattr(torch, cfg.dtype), stacked=stacked,
                                 device=device)}
    p.update(_norms(("norm_in", "norm_mlp"), lead, cfg,
                    p["attn"]["wq"].device))
    return p


def hybrid_block(x, p, cfg, rt, *, kind=0, cache=None, pos=None):
    """Attention on the ring window and the SSM mixer read one norm of x
    and are fused as x + (ya + ys) / 2, then the gated MLP. cache:
    {"attn": ring K/V, "ssm": {"ssm", "conv"}}, written in place."""
    h = rms_norm(x, p["norm_in"], cfg.norm_eps)
    ya, _ = attn_apply(h, p["attn"], cfg, rt, window=cfg.sliding_window,
                       cache=None if cache is None else cache["attn"],
                       pos=pos)
    ys, _ = ssm_lib.ssm_block(h, p["mixer"], cfg,
                              cache=None if cache is None else cache["ssm"])
    x = x + 0.5 * (ya + ys)
    x = x + gated_mlp(rms_norm(x, p["norm_mlp"], cfg.norm_eps), p["mlp"])
    return x, cache


# -- encoder block (whisper's encoder: bidirectional, LayerNorm, GELU MLP) ----

def _layer_norms(names, lead, cfg, device) -> dict:
    """fp32 LayerNorm scales (ones) and biases (zeros) [*lead, D], as
    name_s / name_b for each name."""
    out = {}
    for nm in names:
        out[nm + "_s"] = torch.ones((*lead, cfg.d_model),
                                    dtype=torch.float32, device=device)
        out[nm + "_b"] = torch.zeros((*lead, cfg.d_model),
                                     dtype=torch.float32, device=device)
    return out


def encoder_block_params(gen, cfg, *, stacked: int = 0, device=None) -> dict:
    lead = (stacked,) if stacked else ()
    p = {"attn": attn.attention_params(gen, cfg, stacked=stacked,
                                       device=device),
         "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff,
                           getattr(torch, cfg.dtype), stacked=stacked,
                           device=device)}
    p.update(_layer_norms(("ln1", "ln2"), lead, cfg,
                          p["attn"]["wq"].device))
    return p


def encoder_block(x, p, cfg, rt):
    """Pre-LN bidirectional self-attention over the encoder frames, on the
    naive path (1,500 frames are short and not chunk-aligned), then the
    GELU MLP."""
    h, _ = attn_apply(layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps),
                      p["attn"], cfg, rt, window=0, causal=False,
                      impl="naive")
    x = x + h
    return x + mlp(layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps),
                   p["mlp"])


# -- cross-attention decoder block (whisper's decoder, llama-vision) ----------

def cross_block_params(gen, cfg, *, stacked: int = 0, self_attn: bool = True,
                       use_layernorm: bool = True, device=None) -> dict:
    """Cross-attention to a memory (no biases), a GELU MLP with LayerNorms
    (whisper) or a gated MLP with RMSNorms (llama-vision), the fp32 tanh
    gate (0: closed), and with self_attn a causal self-attention. The
    three norms exist whether or not the self-attention does, as in the
    JAX package's tree."""
    lead = (stacked,) if stacked else ()
    dtype = getattr(torch, cfg.dtype)
    p = {"cross": attn.attention_params(gen, cfg, stacked=stacked,
                                        cross=True, device=device)}
    dev = p["cross"]["wq"].device
    p["mlp"] = (mlp_params if use_layernorm else gated_mlp_params)(
        gen, cfg.d_model, cfg.d_ff, dtype, stacked=stacked, device=dev)
    p["gate"] = torch.zeros(lead, dtype=torch.float32, device=dev)
    if self_attn:
        p["self"] = attn.attention_params(gen, cfg, stacked=stacked,
                                          device=dev)
    names = ("ln_self", "ln_cross", "ln_mlp")
    p.update(_layer_norms(names, lead, cfg, dev) if use_layernorm
             else _norms(names, lead, cfg, dev))
    return p


def _norm(x, p, name, cfg):
    """LayerNorm where the block holds name_s / name_b, else RMSNorm."""
    if name + "_s" in p:
        return layer_norm(x, p[name + "_s"], p[name + "_b"], cfg.norm_eps)
    return rms_norm(x, p[name], cfg.norm_eps)


def cross_block(x, p, cfg, rt, *, enc, cache=None, pos=None, gated=False):
    """The optional self-attention (its {"k", "v"} cache written in place,
    as attn_apply does), then cross-attention to `enc` [B, T, D] on the
    naive path (the memory is short and not chunk-aligned); with `gated`
    the result is scaled by tanh(gate) in h's type. The cross K/V are
    recomputed from `enc` at every call, decode included: the cache holds
    none, as in the JAX package. Then the MLP the block holds (GELU with
    its w_in, else gated), which the JAX package's `use_gelu_mlp` names
    but does not decide."""
    if "self" in p:
        h, _ = attn_apply(_norm(x, p, "ln_self", cfg), p["self"], cfg, rt,
                          window=cfg.sliding_window, cache=cache, pos=pos)
        x = x + h
    h, _ = attn_apply(_norm(x, p, "ln_cross", cfg), p["cross"], cfg, rt,
                      window=0, kv_x=enc, causal=False, impl="naive")
    if gated:
        h = h * torch.tanh(p["gate"].to(h.dtype))
    x = x + h
    hin = _norm(x, p, "ln_mlp", cfg)
    return x + (mlp(hin, p["mlp"]) if "w_in" in p["mlp"]
                else gated_mlp(hin, p["mlp"])), cache
