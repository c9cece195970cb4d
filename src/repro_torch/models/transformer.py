"""The language model: embed -> layer stack -> norm -> LM head (the port of
``repro/models/transformer.py``).

Public API:
    init_params(gen, cfg, device=None)            -> params dict
    param_count(cfg)                              -> number of parameters
    active_param_count(cfg)                       -> parameters a token uses
    init_cache(cfg, batch, max_seq, device=None)  -> serving cache dict
    forward(params, tokens, cfg, rt)              -> logits [B,S,V]
    loss_fn(params, tokens, labels, cfg, rt)      -> scalar CE (chunked)
    prefill(params, tokens, cache, cfg, rt)       -> (last-token logits, cache)
    decode_step(params, token, cache, pos, cfg, rt) -> (logits [B,V], cache)

Stacked layer weights keep their [L, ...] shape and a Python loop over
layers takes the place of ``lax.scan``; with ``rt.remat`` each layer (a
local/global pair for gemma2) runs under ``torch.utils.checkpoint``, as
the JAX package wraps its scan bodies in ``jax.checkpoint``. Caches are
written in place (models/blocks.py). Ported families: dense (plain and
gemma2's local/global alternation), moe, ssm and hybrid; audio and vlm
raise NotImplementedError naming their ROADMAP item. The JAX package's
`constrain_batch_model` is a no-op on one device and is dropped (sharding
is ROADMAP item 8). Entry points run on CUDA unless given device="cpu".
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.blocks import Runtime
from repro_torch.models.layers import embed_init, rms_norm, softcap
from repro_torch.tree import flatten_with_path

# family -> its ROADMAP.md section 1 item
_NOT_PORTED = {"audio": "7.4, audio/vlm", "vlm": "7.4, audio/vlm"}
_BLOCKS = {"dense": (B.dense_block_params, B.dense_block),
           "moe": (B.moe_block_params, B.moe_block),
           "ssm": (B.ssm_block_params, B.ssm_block),
           "hybrid": (B.hybrid_block_params, B.hybrid_block)}


def _check_family(cfg) -> None:
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet: "
            f"ROADMAP.md section 1, item {_NOT_PORTED[cfg.family]}")
    if cfg.family not in _BLOCKS:
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
    else:
        p["blocks"] = _BLOCKS[cfg.family][0](gen, cfg,
                                             stacked=cfg.num_layers,
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
    if cfg.family in ("dense", "moe"):
        return _kv_cache(cfg, batch, eff(cfg.sliding_window), dtype, device,
                         (cfg.num_layers,),
                         quant=kv_quant and not cfg.sliding_window)
    per = ssm_lib.init_ssm_cache(cfg, batch, dtype, device)
    ssm = {k: v.expand(cfg.num_layers, *v.shape).clone()
           for k, v in per.items()}
    if cfg.family == "ssm":
        return ssm
    return {"attn": _kv_cache(cfg, batch, eff(cfg.sliding_window), dtype,
                              device, (cfg.num_layers,)),
            "ssm": ssm}


def param_count(cfg) -> int:
    """Number of parameters, from the shapes alone (a tree on the meta
    device: nothing is allocated or drawn)."""
    _check_family(cfg)
    meta = init_params(torch.Generator(), cfg, device="meta")
    return sum(leaf.numel() for _, leaf in flatten_with_path(meta))


def active_param_count(cfg) -> int:
    """MoE: the parameters a token touches (its top-k experts, not all);
    the parameter count for the other families."""
    total = param_count(cfg)
    if not cfg.num_experts:
        return total
    meta = init_params(torch.Generator(), cfg, device="meta")
    expert = sum(leaf.numel() for path, leaf in flatten_with_path(meta)
                 if "moe" in path and any(
                     s in path for s in ("w_gate", "w_up", "w_down")))
    inactive = expert * (1 - cfg.experts_per_token / cfg.num_experts)
    return int(total - inactive)


# -- the layer stack ----------------------------------------------------------

def _maybe_remat(fn, rt):
    """fn(x) (the next hidden state, with a MoE layer's aux beside it)
    under activation checkpointing when rt.remat: only the layer's input
    is kept, its inside is recomputed in the backward."""
    if not rt.remat:
        return fn
    return lambda x: checkpoint(fn, x, use_reentrant=False)


def _run_stack(x, params, cfg, rt, *, cache=None, pos=None):
    """Run every layer; returns (hidden, cache, aux), aux the MoE layers'
    load-balance losses summed (0 for the other families). Without a
    cache (training and `forward`) each layer body goes through
    `_maybe_remat`, which recomputes a MoE layer's routing in the
    backward from the same input."""
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "dense" and cfg.local_global:
        for i in range(cfg.num_layers // 2):
            if cache is None:
                def pair(h, i=i):
                    for kind, name in ((0, "local"), (1, "global")):
                        h, _ = B.dense_block(h, _layer(blocks[name], i), cfg,
                                             rt, kind=kind)
                    return h
                x = _maybe_remat(pair, rt)(x)
                continue
            for kind, name in ((0, "local"), (1, "global")):
                x, _ = B.dense_block(x, _layer(blocks[name], i), cfg, rt,
                                     kind=kind, cache=_layer(cache[name], i),
                                     pos=pos)
        return x, cache, aux
    block_fn = _BLOCKS[cfg.family][1]
    moe = cfg.family == "moe"      # its block returns (y, (cache, aux))

    def body(h, i, layer_cache=None):
        h, out = block_fn(h, _layer(blocks, i), cfg, rt, cache=layer_cache,
                          pos=pos)
        return h, (out[1] if moe else aux)

    auxs = []
    for i in range(cfg.num_layers):
        if cache is None:
            x, a = _maybe_remat(lambda h, i=i: body(h, i), rt)(x)
        else:
            x, a = body(x, i, _layer(cache, i))
        auxs.append(a)
    return x, cache, torch.stack(auxs).sum() if moe else aux


def _embed_tokens(params, tokens, cfg):
    x = params["embed"][tokens]
    if cfg.embed_scale:
        # scale in the residual dtype, as the JAX package does
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    return x


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, h, cfg):
    """h @ head in the model's type, then fp32 and the final softcap."""
    return softcap((h @ _head(params, cfg)).float(), cfg.final_softcap)


def forward(params, tokens, cfg, rt: Runtime = Runtime()):
    """Full-sequence logits [B, S, V] (small vocabs / tests)."""
    _check_family(cfg)
    x, _, _ = _run_stack(_embed_tokens(params, tokens, cfg), params, cfg,
                         rt)
    return _logits(params, rms_norm(x, params["final_norm"], cfg.norm_eps),
                   cfg)


def loss_fn(params, tokens, labels, cfg, rt: Runtime = Runtime(),
            extra: dict | None = None, *, aux_weight: float = 0.01):
    """Mean next-token CE over B x S, computed in sequence chunks of
    rt.loss_chunk (all of S when it does not divide S), each chunk's
    logits recomputed in the backward (a checkpoint), so the [B,S,V]
    logits are never held. Adds aux_weight times the MoE layers' summed
    load-balance loss (0 for the other families). `extra` is the JAX
    signature's: the ported families take no extra input."""
    _check_family(cfg)
    x, _, aux = _run_stack(_embed_tokens(params, tokens, cfg), params, cfg,
                           rt)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = _head(params, cfg)
    bsz, s, _ = h.shape
    c = min(rt.loss_chunk, s)
    if s % c:
        c = s      # fallback: no chunking on ragged seqs (smoke sizes)

    def chunk_ce(hh, ll):
        logits = softcap((hh @ head).float(), cfg.final_softcap)
        gold = torch.gather(logits, -1, ll[..., None].long())[..., 0]
        return (torch.logsumexp(logits, dim=-1) - gold).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(chunk_ce, h[:, sl], labels[:, sl],
                                   use_reentrant=False)
    return total / (bsz * s) + aux_weight * aux


def prefill(params, tokens, cache, cfg, rt: Runtime = Runtime()):
    """Process the prompt, fill the cache in place, return (last-token
    logits [B, V], cache)."""
    _check_family(cfg)
    x, cache, _ = _run_stack(_embed_tokens(params, tokens, cfg), params,
                             cfg, rt, cache=cache)
    h = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache


def decode_step(params, token, cache, pos: int, cfg,
                rt: Runtime = Runtime()):
    """One serving step: token [B, 1] at position `pos` -> (logits [B, V],
    cache written in place)."""
    _check_family(cfg)
    x, cache, _ = _run_stack(_embed_tokens(params, token, cfg), params, cfg,
                             rt, cache=cache, pos=pos)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return _logits(params, h, cfg)[:, 0], cache
