"""Step functions for every input shape (the port of
``repro/launch/steps.py``): the masked-FedSGD train step, prefill and
serve.

`make_train_step` realizes the paper's parameter-efficient FedSGD on one
card: the pruning masks ride with the parameters, gradients are masked
before the update (the pruned-gradient upload, DESIGN.md §3) and the
server SGD update (eq. 7) is applied, w - eta (g m), so pruned
coordinates never move. The JAX package's abstract input specs
(`batch_specs`, `input_specs`) serve its multi-device dry-run and come
with sharding (ROADMAP.md section 1, item 8).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import InputShape
from repro_torch.models import transformer as T
from repro_torch.models.blocks import Runtime
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

PyTree = Any


def specialize(cfg: ModelConfig,
               shape: InputShape) -> tuple[ModelConfig, Runtime]:
    """Adapt config + runtime to an input shape (DESIGN.md §5): training
    takes flash_vjp (O(S) attention backward memory) with remat, prefill
    the causal triangle-skip scan."""
    impl = {"train": "flash_vjp", "prefill": "chunked_skip",
            "decode": "chunked"}[shape.kind]
    rt = Runtime(attn_impl=impl, q_chunk=512, kv_chunk=512,
                 loss_chunk=256, remat=(shape.kind == "train"))
    if shape.name == "long_500k" and cfg.local_global:
        rt = dataclasses.replace(rt, swa_only=True)
    if cfg.family == "audio" and shape.seq_len > cfg.max_seq:
        cfg = dataclasses.replace(cfg, max_seq=shape.seq_len)
    return cfg, rt


def train_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation factor: bounds activation memory for the
    widest archs (d_model >= 6144: mixtral, llama-vision-90b, arctic;
    arctic additionally needs x8 for its 128 experts' dispatch buffers)."""
    if cfg.num_experts >= 64:
        return 8
    return 4 if cfg.d_model >= 6144 else 1


def structured_slice(params: PyTree,
                     lam: float) -> tuple[PyTree, ModelConfig | None]:
    """Structured (width) pruning: drop the trailing lam fraction of every
    FFN hidden dimension by slicing the weights (views), leaves chosen by
    the same path substrings as the JAX package (w_gate / w_up: last dim;
    w_down: second to last). Returns (sliced params, None); the config is
    unchanged because the FFN width is read from the weights."""
    if lam <= 0:
        return params, None

    def slc(path, w):
        if any(k in path for k in ("w_gate", "w_up")) and w.ndim >= 2:
            return w.narrow(-1, 0, max(1, int(w.shape[-1] * (1 - lam))))
        if "w_down" in path and w.ndim >= 2:
            return w.narrow(-2, 0, max(1, int(w.shape[-2] * (1 - lam))))
        return w

    return unflatten(params, [slc(p, w) for p, w in
                              flatten_with_path(params)]), None


def value_and_grad(loss_of, params: PyTree):
    """(detached loss, gradient tree) of the scalar loss_of(params), by
    autograd with respect to every leaf of params; a leaf the loss does
    not read gets zeros, as jax.grad gives it (the gate of whisper's
    ungated cross layers, llama-vision's cross layers' ln_self)."""
    req = [w.detach().requires_grad_() for w in leaves(params)]
    loss = loss_of(unflatten(params, req))
    return loss.detach(), unflatten(params, list(torch.autograd.grad(
        loss, req, allow_unused=True, materialize_grads=True)))


def make_train_step(cfg: ModelConfig, rt: Runtime, *, eta: float = 1e-2,
                    microbatches: int | None = None,
                    structured_lambda: float = 0.0):
    """(params, masks, batch) -> (loss, new_params): the masked-FedSGD step.

    batch: {"tokens", "labels"} [B, S] integer tensors, and the audio or
    vlm family's memory input ("encoder_input" / "vision_embeddings"
    [B, T, D], transformer.forward's `extra`). With microbatches > 1
    every entry of the batch is cut into that many slices (a loop in
    place of ``lax.scan``), dividing activation memory; gradients
    accumulate in fp32 (bf16 above 100e9 parameters). structured_lambda
    > 0 also width-prunes the FFNs (structured_slice). Returns new
    tensors; the inputs are left as they are."""
    mb = train_microbatches(cfg) if microbatches is None else microbatches
    # >= 100B params: bf16 gradient accumulation (an fp32 accumulator is
    # 7.5 GB/device for arctic-480b at the JAX package's FSDP sharding)
    acc_dtype = torch.bfloat16 if T.param_count(cfg) > 100e9 \
        else torch.float32

    def masked_loss(p, masks, tokens, labels, extra):
        pm = tree_map(lambda w, m: w * m.to(w.dtype), p, masks)
        if structured_lambda > 0:
            pm, _ = structured_slice(pm, structured_lambda)
        return T.loss_fn(pm, tokens, labels, cfg, rt, extra or None)

    def loss_and_grad(params, masks, tokens, labels, extra):
        return value_and_grad(
            lambda p: masked_loss(p, masks, tokens, labels, extra), params)

    def train_step(params, masks, batch):
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        if mb == 1:
            loss, grads = loss_and_grad(params, masks, batch["tokens"],
                                        batch["labels"], extra)
        else:
            parts = {k: v.chunk(mb) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=acc_dtype, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(mb):
                li, gi = loss_and_grad(
                    params, masks, parts["tokens"][i], parts["labels"][i],
                    {k: parts[k][i] for k in extra})
                grads = tree_map(lambda a, g: a + g.to(a.dtype), grads, gi)
                loss = loss + li
            grads = tree_map(lambda g: g / mb, grads)
            loss = loss / mb
        # pruned coordinates neither upload nor update (eq. 5-7)
        with torch.no_grad():
            new_params = tree_map(
                lambda w, g, m: w - eta * (g * m.to(g.dtype)).to(w.dtype),
                params, grads, masks)
        return loss, new_params

    return train_step


def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    def prefill_step(params, batch, cache):
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        return T.prefill(params, batch["tokens"], cache, cfg, rt, extra)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rt: Runtime):
    def serve_step(params, cache, token, pos):
        return T.decode_step(params, token, cache, pos, cfg, rt)

    return serve_step
