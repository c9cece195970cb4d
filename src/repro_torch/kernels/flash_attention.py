"""Forward flash attention: the CUDA wrapper and its plain version.

Replaces ``repro/kernels/flash_attention.py::flash_attention`` (the Pallas
TPU kernel, pallas_call at :103): GQA (query head h reads kv head
h // (Hq / Hkv)), causal masking, a sliding window (kpos > qpos - window),
a softcap cap * tanh(s / cap), an fp32 online softmax with NEG_INF = -2^30
and fp32 accumulation; blocks wholly outside the causal / window band are
skipped. Kernel layout q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D]; any strides with
a contiguous last dim are read in place (``ops.flash_attention`` passes the
model layout [B,S,H,D] as transposed views). D in {64, 128, 256}, fp32 or
bf16. Source: ``csrc/flash_attention.cu``, which states its bound and
design. The storage type picks the kernel: bf16 runs both products on the
tensor cores (``wgmma``, P rounded to bf16 before P V; rows must be
16-byte aligned), fp32 the exact CUDA-core kernel.

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches the kernel or raises, and adds one to LAUNCHES.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.counters import LAUNCHES

NEG_INF = -2.0**30
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_plain(q, k, v, *, causal=True, window=0, cap=0.0):
    """The function of ``ref.flash_attention_ref``: materialised fp32
    scores, masked with NEG_INF, softmax, P V; cast to q's type."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, hkv, g, sq, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qr, k.float()) / math.sqrt(d)
    if cap:
        s = cap * torch.tanh(s / cap)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, NEG_INF)
    o = torch.einsum("bhgqk,bhkd->bhgqd", torch.softmax(s, dim=-1),
                     v.float())
    return o.reshape(b, hq, sq, d).to(q.dtype)


def _check_attention_inputs(q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k and v must be CUDA tensors on one device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"expected 4-d q and k, v of one shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[-1] not in HEAD_DIMS or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"head dim must be one of {HEAD_DIMS} in q, k and "
                         f"v, got {q.shape[-1]}, {k.shape[-1]}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("q, k and v need a contiguous last dim")


def _check_rows_aligned(**tensors) -> None:
    """Every row a tensor's kernel reads starts on 16 bytes: the base and
    the strides of the leading dims (the kernels load 16 bytes a thread)."""
    for name, t in tensors.items():
        esize = t.element_size()
        if t.data_ptr() % 16 or any(st * esize % 16
                                    for st in t.stride()[:-1]):
            raise ValueError(f"{name}: rows must be 16-byte aligned")


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's type."""
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     cap=cap)
    from repro_torch.kernels import _build
    _check_attention_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hq % hkv:
        raise ValueError(f"GQA needs one batch and Hq % Hkv == 0, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v)
    # q's own strides: a transposed view of a [B,S,H,D] tensor gives an
    # output whose transpose back is contiguous
    o = torch.empty_like(q)
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    with torch.cuda.device(q.device):
        _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(),
                      _build.int64s((b, hq, hkv, sq, skv, d)),
                      _build.int64s(strides), int(q.dtype == torch.bfloat16),
                      int(bool(causal)), int(window), float(cap),
                      1.0 / math.sqrt(d), _build.stream_of(q))
    LAUNCHES["flash_attention"] += 1
    return o
