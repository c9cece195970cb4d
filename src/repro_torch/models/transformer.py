"""The language model: embed -> layer stack -> norm -> LM head (the port of
``repro/models/transformer.py``).

Public API:
    init_params(gen, cfg, device=None)            -> params dict
    param_count(cfg)                              -> number of parameters
    active_param_count(cfg)                       -> parameters a token uses
    init_cache(cfg, batch, max_seq, device=None)  -> serving cache dict
    forward(params, tokens, cfg, rt, extra)       -> logits [B,S,V]
    loss_fn(params, tokens, labels, cfg, rt, extra) -> scalar CE (chunked)
    prefill(params, tokens, cache, cfg, rt, extra) -> (last logits, cache)
    decode_step(params, token, cache, pos, cfg, rt) -> (logits [B,V], cache)

`extra` is the cross-attention memory's input: {"encoder_input": [B, T,
D]} (audio: whisper's stub frame embeddings, run through the encoder) or
{"vision_embeddings": [B, N, D]} (vlm: stub patch embeddings, projected by
`vision_proj`); the other families take none. `prefill` writes the memory
into the cache ("enc_out" / "vision"), and `decode_step` reads it there.

Stacked layer weights keep their [L, ...] shape and a Python loop over
layers takes the place of ``lax.scan``; with ``rt.remat`` each layer (a
local/global pair for gemma2) runs under ``torch.utils.checkpoint``, as
the JAX package wraps its scan bodies in ``jax.checkpoint`` (the vlm: a
group of k-1 self layers and its cross layer; whisper's encoder: each
layer). Caches are written in place (models/blocks.py). Families: dense
(plain and gemma2's local/global alternation), moe, ssm, hybrid, audio
(whisper: encoder, learned positions, cross-attention decoder) and vlm
(llama-vision: self layers stacked [n_groups, k-1, ...], one gated cross
layer a group). Entry points run on CUDA unless given device="cpu".

The same functions run sharded: given DTensor parameters placed by
sharding/rules.py and called under `rules.set_mesh`, each layer gathers
its weights' FSDP shards (`_weights`), the residual stream is constrained
where the JAX package constrains it (`constrain_batch_model` at each layer
input, after the embedding and the final norm, in the loss chunks), and
attention and the other ops DTensor has no strategy for run on each
rank's local shards under ``local_map``. Off a mesh every hook is the
identity, so an unsharded run keeps its bits.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.blocks import Runtime
from repro_torch.models.layers import (embed_init, layer_norm, rms_norm,
                                       softcap)
from repro_torch.sharding.rules import (batch_rows, constrain_batch_model,
                                        unshard_batch)
from repro_torch.tree import flatten_with_path

_BLOCKS = {"dense": (B.dense_block_params, B.dense_block),
           "moe": (B.moe_block_params, B.moe_block),
           "ssm": (B.ssm_block_params, B.ssm_block),
           "hybrid": (B.hybrid_block_params, B.hybrid_block)}


# the cache leaf that holds each cross-attention family's memory
_MEMORY = {"audio": "enc_out", "vlm": "vision"}
_FAMILIES = (*_BLOCKS, *_MEMORY)


def _check_family(cfg) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree, *i: int):
    """Layer i of a stacked dict (views, so in-place writes reach it); two
    indices (group, layer) for the vlm's [n_groups, k-1, ...] stack."""
    return {k: (_layer(v, *i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def _weights(tree, *i: int):
    """Layer i's weights, their FSDP shards gathered on a mesh (ZeRO-3:
    inside the layer's checkpoint, so the backward gathers them again)."""
    return unshard_batch(_layer(tree, *i))


def _groups(cfg) -> tuple[int, int]:
    """The vlm's (n_groups, k_every): k_every - 1 self layers and one
    cross layer a group."""
    return cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every


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
    elif cfg.family == "audio":
        d = cfg.d_model
        p["pos_embed"] = embed_init(gen, (cfg.max_seq, d), dtype, device)
        p["enc_pos_embed"] = embed_init(gen, (cfg.encoder_tokens, d), dtype,
                                        device)
        p["enc_blocks"] = B.encoder_block_params(
            gen, cfg, stacked=cfg.encoder_layers, device=device)
        p["enc_final_s"] = torch.ones((d,), dtype=torch.float32,
                                      device=device)
        p["enc_final_b"] = torch.zeros((d,), dtype=torch.float32,
                                       device=device)
        p["blocks"] = B.cross_block_params(gen, cfg, stacked=cfg.num_layers,
                                           self_attn=True,
                                           use_layernorm=True, device=device)
        p["final_b"] = torch.zeros((d,), dtype=torch.float32, device=device)
    elif cfg.family == "vlm":
        n_groups, k_every = _groups(cfg)
        self_p = B.dense_block_params(gen, cfg,
                                      stacked=n_groups * (k_every - 1),
                                      device=device)
        p["blocks"] = {
            "self": _regroup(self_p, n_groups, k_every - 1),
            "cross": B.cross_block_params(gen, cfg, stacked=n_groups,
                                          self_attn=False,
                                          use_layernorm=False,
                                          device=device)}
        p["vision_proj"] = embed_init(gen, (cfg.d_model, cfg.d_model), dtype,
                                      device)
    else:
        p["blocks"] = _BLOCKS[cfg.family][0](gen, cfg,
                                             stacked=cfg.num_layers,
                                             device=device)
    return p


def _regroup(tree, n_groups: int, per: int) -> dict:
    """[n_groups * per, ...] leaves as [n_groups, per, ...] (views)."""
    return {k: _regroup(v, n_groups, per) if isinstance(v, dict)
            else v.reshape(n_groups, per, *v.shape[1:])
            for k, v in tree.items()}


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
    if cfg.family in _MEMORY:
        # the decoder's self-attention K/V and the cross-attention memory
        # (encoder output [B, T, D] / projected vision tokens [B, N, D])
        if cfg.family == "audio":
            lead, n = (cfg.num_layers,), cfg.encoder_tokens
        else:
            n_groups, k_every = _groups(cfg)
            lead, n = (n_groups, k_every - 1), cfg.vision_tokens
        c = _kv_cache(cfg, batch, max_seq, dtype, device, lead)
        c[_MEMORY[cfg.family]] = torch.zeros((batch, n, cfg.d_model),
                                             dtype=dtype, device=device)
        return c
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


def _run_stack(x, params, cfg, rt, *, cache=None, pos=None, enc=None):
    """Run every layer; returns (hidden, cache, aux), aux the MoE layers'
    load-balance losses summed (0 for the other families). Without a
    cache (training and `forward`) each layer body goes through
    `_maybe_remat`, which recomputes a MoE layer's routing in the
    backward from the same input. `enc` is the cross-attention memory of
    the audio and vlm families."""
    blocks = params["blocks"]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # the audio and vlm caches hold the memory beside the layers' K/V
    kv = None if cache is None or cfg.family not in _MEMORY else \
        {"k": cache["k"], "v": cache["v"]}
    if cfg.family == "audio":
        for i in range(cfg.num_layers):
            if cache is None:
                x = _maybe_remat(lambda h, i=i: B.cross_block(
                    h, _weights(blocks, i), cfg, rt, enc=enc)[0], rt)(x)
            else:
                x, _ = B.cross_block(constrain_batch_model(x),
                                     _weights(blocks, i), cfg, rt, enc=enc,
                                     cache=_layer(kv, i), pos=pos)
        return x, cache, aux
    if cfg.family == "vlm":
        n_groups, k_every = _groups(cfg)

        def group(h, g):
            h = constrain_batch_model(h)
            for j in range(k_every - 1):
                h, _ = B.dense_block(
                    h, _weights(blocks["self"], g, j), cfg, rt,
                    cache=None if kv is None else _layer(kv, g, j),
                    pos=pos)
            return B.cross_block(h, _weights(blocks["cross"], g), cfg, rt,
                                 enc=enc, gated=True)[0]

        for g in range(n_groups):
            x = group(x, g) if cache is not None else \
                _maybe_remat(lambda h, g=g: group(h, g), rt)(x)
        return x, cache, aux
    if cfg.family == "dense" and cfg.local_global:
        for i in range(cfg.num_layers // 2):
            if cache is None:
                def pair(h, i=i):
                    h = constrain_batch_model(h)
                    for kind, name in ((0, "local"), (1, "global")):
                        h, _ = B.dense_block(h, _weights(blocks[name], i),
                                             cfg, rt, kind=kind)
                    return h
                x = _maybe_remat(pair, rt)(x)
                continue
            x = constrain_batch_model(x)
            for kind, name in ((0, "local"), (1, "global")):
                x, _ = B.dense_block(x, _weights(blocks[name], i), cfg, rt,
                                     kind=kind, cache=_layer(cache[name], i),
                                     pos=pos)
        return x, cache, aux
    block_fn = _BLOCKS[cfg.family][1]
    moe = cfg.family == "moe"      # its block returns (y, (cache, aux))

    def body(h, i, layer_cache=None):
        h, out = block_fn(constrain_batch_model(h), _weights(blocks, i), cfg,
                          rt, cache=layer_cache, pos=pos)
        return h, (out[1] if moe else aux)

    auxs = []
    for i in range(cfg.num_layers):
        if cache is None:
            x, a = _maybe_remat(lambda h, i=i: body(h, i), rt)(x)
        else:
            x, a = body(x, i, _layer(cache, i))
        auxs.append(a)
    return x, cache, torch.stack(auxs).sum() if moe else aux


def _encode(params, enc_input, cfg, rt):
    """Whisper's encoder over stub frame embeddings [B, T, D]: learned
    positions, the encoder layers (each under `_maybe_remat`), a final
    LayerNorm."""
    x = enc_input + params["enc_pos_embed"][None, :enc_input.shape[1]]
    for i in range(cfg.encoder_layers):
        x = _maybe_remat(lambda h, i=i: B.encoder_block(
            constrain_batch_model(h), _weights(params["enc_blocks"], i), cfg,
            rt), rt)(x)
    return layer_norm(x, params["enc_final_s"], params["enc_final_b"],
                      cfg.norm_eps)


def _gather_embed(embed, tokens):
    """embed[tokens]. On a mesh the lookup runs on each rank's tokens under
    ``local_map``, on the table with its vocab whole (gathered where the
    rules split it) and its feature dim as the rules place it on the
    model axis: the backward's index_put has no working sharding strategy
    in every torch release the port runs on (2.11 rejects its placements)."""
    if not isinstance(embed, DTensor):
        return embed[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = embed.device_mesh
    names = mesh.mesh_dim_names
    epl = [Shard(1) if n == "model" and p == Shard(1) else Replicate()
           for n, p in zip(names, embed.placements)]
    tpl = batch_rows(tokens)
    embed = embed.redistribute(mesh, epl)
    tokens = tokens.redistribute(mesh, tpl)
    out = [Shard(2) if p == Shard(1) else q for p, q in zip(epl, tpl)]
    # each rank's tokens add their rows to the table's gradient: a partial
    # sum over the batch axes the tokens are split on
    egrad = [Partial() if q == Shard(0) else p for p, q in zip(epl, tpl)]
    return local_map(lambda e, t: e[t], out_placements=out,
                     in_placements=(epl, tpl),
                     in_grad_placements=(egrad, tpl),
                     device_mesh=mesh)(embed, tokens)


def _embed_tokens(params, tokens, cfg, *, pos0: int = 0):
    x = _gather_embed(params["embed"], tokens)
    if cfg.embed_scale:
        # scale in the residual dtype, as the JAX package does
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype,
                             device=x.device)
    if cfg.family == "audio":
        # learned positions pos0 .. pos0 + S - 1; the start clamped into
        # the table as jax.lax.dynamic_slice_in_dim clamps it
        s, n = tokens.shape[1], params["pos_embed"].shape[0]
        start = min(max(pos0, 0), n - s)
        x = x + params["pos_embed"][None, start:start + s]
    return x


def _final_hidden(x, params, cfg):
    if cfg.family == "audio":
        return layer_norm(x, 1.0 + params["final_norm"], params["final_b"],
                          cfg.norm_eps)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def _extra_enc(params, cfg, rt, extra, cache=None):
    """The cross-attention memory: the encoder's output (audio) or the
    projected vision tokens (vlm), from `extra`, or from the cache when a
    cache is given without `extra` (decode); None for the other
    families."""
    if cfg.family not in _MEMORY:
        return None
    if cache is not None and extra is None:
        return cache[_MEMORY[cfg.family]]
    if cfg.family == "audio":
        return _encode(params, extra["encoder_input"], cfg, rt)
    return extra["vision_embeddings"] @ params["vision_proj"]


def _head(params, cfg):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _logits(params, h, cfg):
    """h @ head in the model's type, then fp32 and the final softcap."""
    return softcap((h @ _head(params, cfg)).float(), cfg.final_softcap)


def forward(params, tokens, cfg, rt: Runtime = Runtime(),
            extra: dict | None = None):
    """Full-sequence logits [B, S, V] (small vocabs / tests)."""
    _check_family(cfg)
    enc = _extra_enc(params, cfg, rt, extra)
    x = constrain_batch_model(_embed_tokens(params, tokens, cfg))
    x, _, _ = _run_stack(x, params, cfg, rt, enc=enc)
    return _logits(params, _final_hidden(x, params, cfg), cfg)


def ce_sum(logits, labels):
    """sum over rows of logsumexp(logits) - logits[label], logits [B, c, V]
    fp32. Logits whose vocab is sharded on the model axis (the JAX
    package's placement of a loss chunk's logits, d_threshold=1) stay
    sharded: each rank takes the logsumexp and the gold logit of its
    vocab slice under ``local_map`` (DTensor's gather has no strategy
    over a sharded dim), the slices' logsumexps are gathered (one value
    a row and rank) and combined by one more logsumexp, and the gold
    logit is a partial sum over the model axis. On a model axis of one
    rank that is the unsharded computation bit for bit: the logsumexp of
    one value is the value, its gradient the incoming one."""
    if isinstance(logits, DTensor) and "model" in \
            logits.device_mesh.mesh_dim_names:
        model = logits.device_mesh.mesh_dim_names.index("model")
        if logits.placements[model] == Shard(2):
            return _vocab_parallel_ce(logits, labels)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (torch.logsumexp(logits, dim=-1) - gold).sum()


def _vocab_parallel_ce(logits, labels):
    """ce_sum on logits whose vocab is Shard(2) on the model axis."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    rows = batch_rows(logits)
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    labels = labels.redistribute(mesh, rows)
    vocab = [Shard(2) if n == "model" else p for n, p in zip(names, rows)]
    part = [Partial() if n == "model" else p for n, p in zip(names, rows)]

    def local(lg, lb):
        n = lg.shape[-1]
        idx = lb.long() - mesh.get_local_rank("model") * n
        inside = (idx >= 0) & (idx < n)
        gold = torch.gather(lg, -1, idx.clamp(0, n - 1)[..., None])[..., 0]
        return (torch.logsumexp(lg, dim=-1, keepdim=True),
                torch.where(inside, gold, torch.zeros_like(gold)))

    lse, gold = local_map(local, out_placements=(vocab, part),
                          in_placements=(vocab, rows),
                          device_mesh=mesh)(logits, labels)
    lse = torch.logsumexp(lse.redistribute(mesh, rows), dim=-1)
    return (lse - gold.redistribute(mesh, rows)).sum()


def loss_fn(params, tokens, labels, cfg, rt: Runtime = Runtime(),
            extra: dict | None = None, *, aux_weight: float = 0.01):
    """Mean next-token CE over B x S, computed in sequence chunks of
    rt.loss_chunk (all of S when it does not divide S), each chunk's
    logits recomputed in the backward (a checkpoint), so the [B,S,V]
    logits are never held. Adds aux_weight times the MoE layers' summed
    load-balance loss (0 for the other families). `extra`: the audio and
    vlm families' memory input (module docstring)."""
    _check_family(cfg)
    enc = _extra_enc(params, cfg, rt, extra)
    x = constrain_batch_model(_embed_tokens(params, tokens, cfg))
    x, _, aux = _run_stack(x, params, cfg, rt, enc=enc)
    h = constrain_batch_model(_final_hidden(x, params, cfg))
    head = _head(params, cfg)
    bsz, s, _ = h.shape
    c = min(rt.loss_chunk, s)
    if s % c:
        c = s      # fallback: no chunking on ragged seqs (smoke sizes)

    def chunk_ce(hh, ll):
        hh = constrain_batch_model(hh)
        logits = constrain_batch_model((hh @ head).float(), d_threshold=1)
        return ce_sum(softcap(logits, cfg.final_softcap), ll)

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        total = total + checkpoint(chunk_ce, h[:, sl], labels[:, sl],
                                   use_reentrant=False)
    return total / (bsz * s) + aux_weight * aux


def prefill(params, tokens, cache, cfg, rt: Runtime = Runtime(),
            extra: dict | None = None):
    """Process the prompt, fill the cache in place, return (last-token
    logits [B, V], cache). The audio and vlm families take their memory
    from `extra` and write it into the cache for the decode steps."""
    _check_family(cfg)
    enc = _extra_enc(params, cfg, rt, extra)
    if enc is not None and extra is not None:
        cache[_MEMORY[cfg.family]].copy_(enc)
    x, cache, _ = _run_stack(_embed_tokens(params, tokens, cfg), params,
                             cfg, rt, cache=cache, enc=enc)
    h = _final_hidden(x[:, -1:], params, cfg)
    return _logits(params, h, cfg)[:, 0], cache


def decode_step(params, token, cache, pos: int, cfg,
                rt: Runtime = Runtime()):
    """One serving step: token [B, 1] at position `pos` -> (logits [B, V],
    cache written in place)."""
    _check_family(cfg)
    enc = _extra_enc(params, cfg, rt, None, cache=cache)
    x, cache, _ = _run_stack(_embed_tokens(params, token, cfg, pos0=pos),
                             params, cfg, rt, cache=cache, pos=pos, enc=enc)
    h = _final_hidden(x, params, cfg)
    return _logits(params, h, cfg)[:, 0], cache
