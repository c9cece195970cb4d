"""Serving launcher: batched prefill + decode with the KV-cache runtime
(the port of ``repro/launch/serve.py``, same flags).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
        --full --batch 4 --prompt-len 256 --gen 32

Random weights from a torch.Generator seeded with 0 (drawn on the card),
random prompts from numpy's seed 0 (drawn after the audio or vlm
family's memory input, as the JAX launcher draws them). Runs on CUDA (or
--device cpu, reduced configs only in practice) through the
flash-attention kernel for prompts longer than 128 tokens; times come
from the card's clock (the host clock around work that ends in a
synchronise).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs.registry import get_config, list_configs
from repro_torch.device import resolve_device
from repro_torch.launch.train import add_extra
from repro_torch.models import transformer as T
from repro_torch.models.blocks import Runtime


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs(), required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    rt = Runtime(attn_impl="cuda")
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(gen, cfg, device=device)
    max_seq = args.prompt_len + args.gen
    extra = add_extra({}, rng, cfg, args.batch, device) or None
    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, size=(args.batch, args.prompt_len)),
        device=device)
    cache = T.init_cache(cfg, args.batch, max_seq, device=device)

    _sync(device)
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, cache = T.prefill(params, prompts, cache, cfg, rt, extra)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    print(f"prefill {args.batch}x{args.prompt_len}: {t_prefill:.2f}s "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")

    tok = logits.argmax(-1, keepdim=True)
    generated = [tok]
    t0 = time.perf_counter()
    with torch.inference_mode():
        for i in range(args.gen - 1):
            logits, cache = T.decode_step(params, tok, cache,
                                          args.prompt_len + i, cfg, rt)
            if args.temperature > 0:
                probs = torch.softmax(logits / args.temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)
            else:
                tok = logits.argmax(-1, keepdim=True)
            generated.append(tok)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = torch.cat(generated, dim=1)
    print(f"decode {args.gen - 1} steps: {dt:.2f}s "
          f"({args.batch * (args.gen - 1) / max(dt, 1e-9):.0f} tok/s)")
    print("sample token ids:", toks[0, :16].tolist())


if __name__ == "__main__":
    main()
