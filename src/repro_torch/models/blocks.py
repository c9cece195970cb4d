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
(mixtral / arctic), the SSM block (mamba2) and the hybrid block (hymba). The
encoder and cross-attention blocks raise NotImplementedError naming their
ROADMAP item.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import (apply_rope, gated_mlp,
                                       gated_mlp_params, rms_norm)


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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md "
                              f"section 1, item {item}")


# -- attention sub-block ------------------------------------------------------

def _write(cache: torch.Tensor, start: int, x: torch.Tensor) -> None:
    """cache[:, start:start + S] = x (in place), cast to the cache's type."""
    cache[:, start:start + x.shape[1]] = x.to(cache.dtype)


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


# -- families not ported yet --------------------------------------------------

def encoder_block(*args, **kwargs):
    _not_ported("the encoder block (whisper)", "7.4, audio/vlm")


def cross_block(*args, **kwargs):
    _not_ported("the cross-attention block (whisper, llama-vision)",
                "7.4, audio/vlm")
