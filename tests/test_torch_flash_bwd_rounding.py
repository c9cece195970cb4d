"""The rounding budget of the bf16 attention backward, on the CPU.

The port's bf16 backward kernels (csrc/flash_attention_bwd.cu, the wgmma
design) run the five products of FlashAttention-2's backward on the
tensor cores: bf16 q, k, v, o and dO, p and ds rounded to bf16 before the
products that take them as an operand (dv += p^T dO; dq += ds k, dk +=
ds^T q), fp32 accumulation, outputs rounded to bf16; at D 256 (gemma2)
the two warpgroups of a block pass p^T and ds^T to each other through
shared memory in bf16, the same roundings. The card's gates
(chip_smoke.py's phase 14, tests/test_torch_cuda.py) hold the kernel's dq,
dk and dv against the fp32 plain scan within 2e-2 of each output's own
peak, with dO one position late (a planted fault) above that limit.

This file emulates those roundings in plain fp32 torch (the emulation is
the test's own, not the package's) and holds it against the JAX package's
`_bwd_scan` in fp32 on the same numpy inputs, at small granite-, qwen- and
gemma2-shaped cases: the emulated design stays within the limit and the
planted fault lands above it, so the gates have room for the design before
any card run.
"""
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import flash_vjp as jfv  # noqa: E402

LIMIT = 2e-2        # the gates' limit, at each output's own peak


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op torch thread per test (parallel workers share the
    cores with XLA's thread pools)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _emulated_bwd(q, k, v, o, do, lse, causal, window, cap):
    """(dq, dk, dv) as the bf16 kernels round them: model layout
    [B,S,H,D] fp32 tensors holding bf16 values, lse [B,Hkv,G,Sq]; p and ds
    in fp32 from fp32 scores, rounded to bf16 as product operands; the
    outputs rounded to bf16."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    q5, do5 = q.reshape(b, sq, hkv, g, d), do.reshape(b, sq, hkv, g, d)
    delta = torch.movedim((do5 * o.reshape(b, sq, hkv, g, d)).sum(-1), 1, -1)
    s = torch.einsum("bqhgd,bkhd->bhgqk", q5, k) * scale
    factor = torch.ones_like(s)
    if cap:
        t = torch.tanh(s / cap)
        s, factor = cap * t, 1.0 - t * t
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    seen = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        seen &= kpos <= qpos
    if window:
        seen &= kpos > qpos - window
    p = torch.where(seen, torch.exp(s - lse[..., None]), 0.0)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", _bf16(p), do5)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", do5, v)
    ds = _bf16(p * factor * (dp - delta[..., None]))
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k).reshape(b, sq, hq, d)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, q5)
    return _bf16(dq * scale), _bf16(dk * scale), _bf16(dv)


def _scaled_err(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(got.double().numpy() - want).max()
                 / np.abs(want).max())


@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window,cap", [
    (1, 256, 8, 2, 64, True, 0, 0.0),        # granite's heads, causal
    (2, 192, 8, 2, 64, True, 48, 0.0),       # granite's heads, a window
    (1, 256, 4, 1, 128, False, 0, 30.0),     # qwen-like D 128, g 4, a cap
    (1, 256, 4, 2, 256, True, 0, 50.0),      # gemma2 global layer
    (1, 256, 4, 2, 256, True, 64, 50.0),     # gemma2 local layer
    (1, 256, 4, 2, 256, False, 0, 0.0),      # D 256, no mask, no cap
])
def test_bf16_backward_roundings_fit_the_gates(b, s, hq, hkv, d, causal,
                                               window, cap):
    rng = np.random.default_rng(d + s + window)
    q, k, v, do = (np.asarray(_bf16(torch.from_numpy(rng.normal(
        size=(b, s, h, d)).astype(np.float32)))) for h in (hq, hkv, hkv, hq))
    args = (causal, window, cap, 64, 64)
    jo, jlse = jfv._fwd_scan(*(jnp.asarray(x) for x in (q, k, v)), *args)
    o = np.asarray(_bf16(torch.from_numpy(np.array(jo))))    # kernel 8's o
    want = jfv._bwd_scan(tuple(jnp.asarray(x) for x in (q, k, v, o, jlse)),
                         jnp.asarray(do), *args)
    tq, tk, tv, to, tdo = (torch.from_numpy(x) for x in (q, k, v, o, do))
    lse = torch.from_numpy(np.array(jlse))
    sound = [_scaled_err(x, w) for x, w in zip(_emulated_bwd(
        tq, tk, tv, to, tdo, lse, causal, window, cap), want)]
    late = [_scaled_err(x, w) for x, w in zip(_emulated_bwd(
        tq, tk, tv, to, tdo.roll(1, dims=1), lse, causal, window, cap),
        want)]
    assert max(sound) <= LIMIT < min(late), (sound, late)
    # the design's roundings use a small part of the limit
    assert max(sound) < LIMIT / 4, sound


def _launcher_body(src: str, fn: str) -> str:
    start = src.index(f"int {fn}(")
    return src[start:src.index("\n}\n", start)]


def _launched(src: str, fn: str) -> set:
    """The kernels a host launcher of the .cu file starts (each
    `name<...>` before a `<<<`), through the launchers it calls."""
    body = _launcher_body(src, fn)
    kernels = set(re.findall(r"(\w+)<[^<>]*>\s*<<<", body))
    for callee in set(re.findall(r"\b(launch_\w+)<", body)):
        kernels |= _launched(src, callee)
    return kernels


def test_backward_kernel_table_is_the_sources_dispatch():
    """WGMMA_KERNELS and CORE_KERNELS, which chip_smoke.py's symbol checks
    and the card tests read, are what csrc/flash_attention_bwd.cu's
    `launch_all` starts after the delta pass: bf16 at D 64 and 128 the
    wgmma pair, at D 256 the split-D pair, fp32 the CUDA-core pair at
    every head dim."""
    from repro_torch.kernels import flash_attention_bwd as fab
    src = (Path(fab.__file__).parent / "csrc"
           / "flash_attention_bwd.cu").read_text()
    dispatch = _launcher_body(src, "launch_all")
    bf16 = dispatch[dispatch.index("if (bf16) {"):]
    bf16, fp32 = bf16[:bf16.index("\n  }\n")], bf16[bf16.index("\n  }\n"):]
    cases = {int(d) if d else 256: fn for d, fn in re.findall(
        r"(?:case (\d+)|default): return (launch_\w+)<", bf16)}
    assert set(cases) == set(fab.WGMMA_KERNELS), cases
    for d, fn in cases.items():
        assert _launched(src, fn) == set(fab.WGMMA_KERNELS[d]), (d, fn)
    cores = re.findall(r"return (launch_\w+)<", fp32)
    assert len(cores) == 3, cores
    for fn in cores:
        assert _launched(src, fn) == set(fab.CORE_KERNELS), fn
