"""The language model: embed -> layer stack -> norm -> LM head (the port of
``repro/models/transformer.py`` for serving).

Public API:
    init_params(gen, cfg, device=None)            -> params dict
    init_cache(cfg, batch, max_seq, device=None)  -> serving cache dict
    forward(params, tokens, cfg, rt)              -> logits [B,S,V]
    prefill(params, tokens, cache, cfg, rt)       -> (last-token logits, cache)
    decode_step(params, token, cache, pos, cfg, rt) -> (logits [B,V], cache)

Stacked layer weights keep their [L, ...] shape and a Python loop over
layers takes the place of ``lax.scan``. Caches are written in place
(models/blocks.py). Ported families: dense (plain and gemma2's
local/global alternation) and ssm; the others raise NotImplementedError
naming their ROADMAP item. Training (`loss_fn`) is not ported yet. The
JAX package's `constrain_batch_model` is a no-op on one device and is
dropped (sharding is ROADMAP item 8). Entry points run on CUDA unless
given device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.blocks import Runtime
from repro_torch.models.layers import embed_init, rms_norm, softcap

# family -> its ROADMAP.md section 1 item
_NOT_PORTED = {"moe": "7.3, MoE", "hybrid": "7.2, hybrid",
               "audio": "7.4, audio/vlm", "vlm": "7.4, audio/vlm"}


def _check_family(cfg) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md section 1, item {_NOT_PORTED[cfg.family]}")
    if cfg.family not in ("dense", "ssm"):
        raise ValueError(f"unknown family {cfg.family}")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree, i: int):
    """Layer i of a stacked dict (views, so in-place writes reach it)."""
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# -- parameters and caches ----------------------------------------------------

def init_params(gen: torch.Generator, cfg, *, device=None) -> dict:
    """Random parameters in the JAX package's tree layout, drawn from
    `gen` on its own device (a generator on the card draws a full-width
    model there) and placed on `device` (None: CUDA)."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg)
    p = {"embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                             device),
         "final_norm": torch.zeros((cfg.d_model,), dtype=torch.float32,
                                   device=device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                  device)
    if cfg.family == "dense" and cfg.local_global:
        half = cfg.num_layers // 2
        p["blocks"] = {
            "local": B.dense_block_params(gen, cfg, stacked=half,
                                          device=device),
            "global": B.dense_block_params(gen, cfg, stacked=half,
                                           device=device)}
    elif cfg.family == "dense":
        p["blocks"] = B.dense_block_params(gen, cfg, stacked=cfg.num_layers,
                                           device=device)
    else:
        p["blocks"] = B.ssm_block_params(gen, cfg, stacked=cfg.num_layers,
                                         device=device)
    return p


def _kv_cache(cfg, batch, max_seq, dtype, device, lead=(), quant=False):
    shape = (*lead, batch, max_seq, cfg.num_kv_heads)
    if quant:   # int8 values + per-(B, S, H) fp32 scales
        return {"k": torch.zeros((*shape, cfg.head_dim), dtype=torch.int8,
                                 device=device),
                "v": torch.zeros((*shape, cfg.head_dim), dtype=torch.int8,
                                 device=device),
                "k_scale": torch.zeros(shape, dtype=torch.float32,
                                       device=device),
                "v_scale": torch.zeros(shape, dtype=torch.float32,
                                       device=device)}
    return {"k": torch.zeros((*shape, cfg.head_dim), dtype=dtype,
                             device=device),
            "v": torch.zeros((*shape, cfg.head_dim), dtype=dtype,
                             device=device)}


def init_cache(cfg, batch: int, max_seq: int, *, swa_only: bool = False,
               kv_quant: bool = False, device=None) -> dict:
    """Serving cache. Sliding-window layers keep ring buffers of `window`
    slots (attention.ring_slots); full layers keep max_seq slots (int8 with
    kv_quant, full-attention layers only). `swa_only` must match
    Runtime.swa_only."""
    _check_family(cfg)
    device = resolve_device(device)
    dtype = _dtype(cfg)

    def eff(w):
        return min(max_seq, w) if w else max_seq

    if cfg.family == "dense" and cfg.local_global:
        half = cfg.num_layers // 2
        w = cfg.sliding_window or 4096
        glob = eff(w) if swa_only else max_seq
        return {"local": _kv_cache(cfg, batch, eff(w), dtype, device,
                                   (half,)),
                "global": _kv_cache(cfg, batch, glob, dtype, device, (half,),
                                    quant=kv_quant and not swa_only)}
    if cfg.family == "dense":
        return _kv_cache(cfg, batch, eff(cfg.sliding_window), dtype, device,
                         (cfg.num_layers,),
                         quant=kv_quant and not cfg.sliding_window)
    per = ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
    return {k: v.expand(cfg.num_layers, *v.shape).clone()
            for k, v in per.items()}


# -- the layer stack ----------------------------------------------------------

def _run_stack(x, params, cfg, rt, *, cache=None, pos=None):
    """Run every layer; returns (hidden, cache)."""
    blocks = params["blocks"]
    if cfg.family == "dense" and cfg.local_global:
        for i in range(cfg.num_layers // 2):
            for kind, name in ((0, "local"), (1, "global")):
                c = None if cache is None else _layer(cache[name], i)
                x, _ = B.dense_block(x, _layer(blocks[name], i), cfg, rt,
                                     kind=kind, cache=c, pos=pos)
        return x, cache
    block_fn = B.dense_block if cfg.family == "dense" else B.ssm_block
    for i in range(cfg.num_layers):
        c = None if cache is None else _layer(cache, i)
        x, _ = block_fn(x, _layer(blocks, i), cfg, rt, cache=c, pos=pos)
    return x, cache


def _embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # scale in the residual dtype, as the JAX package does
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _logits(params, h, cfg):
    """h @ head in the model's type, then fp32 and the final softcap."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return softcap((h @ head).float(), cfg.final_softcap)


def forward(params, tokens, cfg, rt: Runtime = Runtime()):
    """Full-sequence logits [B, S, V] (small vocabs / tests)."""
    _check_family(cfg)
    x, _ = _run_stack(_embed_tokens(params, tokens, cfg), params, cfg, rt)
    return _logits(params, rms_norm(x, params["final_norm"], cfg.norm_eps),
                   cfg)


def prefill(params, tokens, cache, cfg, rt: Runtime = Runtime()):
    """Process the prompt, fill the cache in place, return (last-token
    logits [B, V], cache)."""
    _check_family(cfg)
    x, cache = _run_stack(_embed_tokens(params, tokens, cfg), params, cfg,
                          rt, cache=cache)
    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def decode_step(params, token, cache, pos: int, cfg,
                rt: Runtime = Runtime()):
    """One serving step: token [B, 1] at position `pos` -> (logits [B, V],
    cache written in place)."""
    _check_family(cfg)
    x, cache = _run_stack(_embed_tokens(params, token, cfg), params, cfg, rt,
                          cache=cache, pos=pos)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache
