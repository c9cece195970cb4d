"""Training launcher: the masked-FedSGD train step on an LM (the port of
``repro/launch/train.py``, same flags plus --device).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --full --steps 20 --batch 4 --seq 128 [--ckpt-dir D]
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --device cpu --steps 2          # reduced config on the CPU

Random weights from a torch.Generator seeded with 0 (drawn on the card);
masks at --lam from Taylor importance (eq. 4) of one warm-up gradient on
a random batch (numpy seed 0); then --steps steps on document-packed
batches (data/lm_pipeline.py; --data random for numpy draws), the audio
and vlm families' memory input drawn beside each batch as the JAX launcher
draws it (`add_extra`, JAX's `_add_extra`), a
checkpoint every 10 steps and at the end with --ckpt-dir. Attention as the
JAX launcher picks it: naive up to 512 tokens, chunked beyond. Runs on
CUDA unless given --device cpu; step times are the host clock around a
step that ends in reading its loss.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_configs
from repro_torch.core import pruning
from repro_torch.device import resolve_device
from repro_torch.launch.steps import loss_and_leaf_grads, make_train_step
from repro_torch.models import transformer as T
from repro_torch.models.blocks import Runtime
from repro_torch.tree import leaves, unflatten


def packed_batch(it, cfg, batch, device) -> dict:
    """Document-packed batch from the deterministic LM pipeline, with the
    memory input of a fresh numpy seed 0, as the JAX launcher's."""
    pb = next(it)
    out = {"tokens": torch.as_tensor(pb.tokens, device=device).long(),
           "labels": torch.as_tensor(pb.labels, device=device).long()}
    return add_extra(out, np.random.default_rng(0), cfg, batch, device)


def add_extra(out, rng, cfg, batch, device) -> dict:
    """The audio family's encoder input, the vlm's vision embeddings:
    standard normal [batch, T, D] from `rng` in the model's type."""
    name, n = {"audio": ("encoder_input", cfg.encoder_tokens),
               "vlm": ("vision_embeddings", cfg.vision_tokens)}.get(
                   cfg.family, (None, 0))
    if name:
        out[name] = torch.as_tensor(
            rng.normal(size=(batch, n, cfg.d_model)), device=device).to(
                getattr(torch, cfg.dtype))
    return out


def synthetic_batch(rng, cfg, batch, seq, device) -> dict:
    tokens = rng.integers(0, cfg.vocab_size, size=(batch, seq + 1))
    out = {"tokens": torch.as_tensor(tokens[:, :-1], device=device).long(),
           "labels": torch.as_tensor(tokens[:, 1:], device=device).long()}
    return add_extra(out, rng, cfg, batch, device)


def batch_extra(batch) -> dict | None:
    """The entries of a batch beside its tokens and labels (the memory
    input), or None."""
    return {k: v for k, v in batch.items()
            if k not in ("tokens", "labels")} or None


def warmup_importance(params, batch, cfg, rt):
    """Taylor importance (eq. 4) of `params` with the loss gradient on
    `batch` as the warm-up v^(s-1): each leaf's importance is taken from
    its gradient as backward completes it (steps.loss_and_leaf_grads), so
    no gradient tree is held beside it."""
    ws = leaves(params)
    imp = [None] * len(ws)

    def take(i, g):
        imp[i] = pruning.taylor_importance(ws[i], g)

    loss_and_leaf_grads(lambda p: T.loss_fn(
        p, batch["tokens"], batch["labels"], cfg, rt, batch_extra(batch)),
        params, take)
    return unflatten(params, imp)


def warmup_masks(params, batch, cfg, rt, lam):
    """uint8 masks at `lam` from the warm-up importance, the global
    threshold taken where the tree lies, each leaf made in uint8."""
    return pruning.build_masks(warmup_importance(params, batch, cfg, rt),
                               lam, dtype=torch.uint8)


def main(argv=None):
    """Returns (params, masks, losses) for callers that drive it."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lam", type=float, default=0.3,
                    help="pruning ratio (paper eq. 2)")
    ap.add_argument("--eta", type=float, default=1e-2)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (the card)")
    ap.add_argument("--data", choices=("random", "packed"), default="packed",
                    help="packed: document-packed deterministic LM pipeline")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (keeps latest 3)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    rt = Runtime(attn_impl="naive" if args.seq <= 512 else "chunked")
    rng = np.random.default_rng(0)
    params = T.init_params(torch.Generator(device=device).manual_seed(0),
                           cfg, device=device)

    masks = warmup_masks(params, synthetic_batch(rng, cfg, args.batch,
                                                 args.seq, device),
                         cfg, rt, args.lam)
    print(f"arch={cfg.name} params={T.param_count(cfg):,} "
          f"realized lambda={pruning.actual_ratio(masks):.3f}")

    data_it = None
    if args.data == "packed":
        from repro_torch.data.lm_pipeline import (PackedLMIterator,
                                                  ShardSpec,
                                                  SyntheticDocumentSource)
        data_it = PackedLMIterator(
            SyntheticDocumentSource(cfg.vocab_size, seed=0),
            ShardSpec(0, 1), batch=args.batch, seq=args.seq)
    mgr = None
    if args.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager
        mgr = CheckpointManager(args.ckpt_dir, keep=3)

    step = make_train_step(cfg, rt, eta=args.eta, microbatches=1)
    losses = []
    for i in range(args.steps):
        t0 = time.time()
        if data_it is not None:
            batch = packed_batch(data_it, cfg, args.batch, device)
        else:
            batch = synthetic_batch(rng, cfg, args.batch, args.seq, device)
        loss, params = step(params, masks, batch)
        losses.append(float(loss))
        print(f"step {i:3d} loss {losses[-1]:.4f} "
              f"({time.time() - t0:.2f}s)")
        if mgr is not None and (i + 1) % 10 == 0:
            mgr.save(i + 1, params)
    if mgr is not None:
        mgr.save(args.steps, params)
        print("checkpointed to", args.ckpt_dir)
    return params, masks, losses


if __name__ == "__main__":
    main()
