"""Time kernel 8's bf16 forward (flash attention) at the shapes of PERF.md's
kernel-8 rows, beside SDPA's forward (the yardstick; the port never calls
it), on one CUDA card.

    python scripts/flash_forward_probe.py [--src DIR] [--tag NAME]
                                          [--only llama,granite]

`--src` is the `src` directory of the tree to time (default: this
checkout's), so a parent unpacked with `git archive` under `build/` is
timed in the same call as this tree (`--tag parent`), in turns: parent,
change, change, parent. Each shape prints one JSON line: the wrapper's
time a call by CUDA events over 30 back-to-back calls after 5 untimed ones
(for the short serving shapes this is the host's issue rate), SDPA's time
on the same inputs where there is no window, and for this tree's run
(`--tag change`) the max |o - plain| at up to 1,024 tokens. Random bf16
inputs from a seeded generator on the card; the train shapes in the model
layout [B, S, H, D] with lse, as the training path calls them.
"""
import argparse
import json
import pathlib
import sys

# name, batch, query heads, kv heads, tokens, head dim, window (-1: not
# causal), lse, model layout
SHAPES = [
    ("llama-vision train", 1, 64, 8, 4096, 128, 0, True, True),
    ("llama-vision noncausal", 1, 64, 8, 4096, 128, -1, True, True),
    ("mixtral train", 1, 48, 8, 4096, 128, 0, True, True),
    ("qwen train", 4, 16, 2, 4096, 128, 0, True, True),
    ("yi train", 4, 32, 4, 4096, 128, 0, True, True),
    ("llama-vision S1024", 1, 64, 8, 1024, 128, 0, False, False),
    ("arctic S1024", 1, 56, 8, 1024, 128, 0, False, False),
    ("granite train", 4, 32, 8, 4096, 64, 0, True, True),
    ("whisper train", 4, 12, 12, 4096, 64, 0, True, True),
    ("granite 16x16", 16, 2, 1, 4096, 64, 0, True, True),
    ("hymba train w1024", 4, 25, 5, 4096, 64, 1024, True, True),
    ("granite S1024", 1, 32, 8, 1024, 64, 0, False, False),
]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(
        pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--tag", default="change")
    ap.add_argument("--only", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.src)
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1

    def t_ms(fn, reps=30, warm=5):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    only = [o for o in args.only.split(",") if o]
    g = torch.Generator(device="cuda").manual_seed(0)
    for name, b, hq, hkv, s, d, window, lse, model in SHAPES:
        if only and not any(o in name for o in only):
            continue

        def mk(h):
            shape = (b, s, h, d) if model else (b, h, s, d)
            x = torch.randn(shape, generator=g, device="cuda",
                            dtype=torch.bfloat16)
            return x.transpose(1, 2) if model else x
        q, k, v = mk(hq), mk(hkv), mk(hkv)
        kw = dict(causal=window >= 0, window=max(window, 0), cap=0.0)

        def call():
            return fa.flash_attention(q, k, v, lse=lse, **kw)
        row = {"tag": args.tag, "shape": name, "ms": t_ms(call),
               "device": torch.cuda.get_device_name(0)}
        if args.tag == "change":
            out = call()
            o = out[0] if lse else out
            if s <= 1024:
                ref = fa.flash_attention_plain(q, k, v, **kw)
                row["max_abs_err"] = float((o.float() - ref.float()).abs()
                                           .max())
            if window <= 0:
                row["sdpa_ms"] = t_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=window == 0, enable_gqa=True))
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
