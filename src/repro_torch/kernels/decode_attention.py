"""Flash-decoding: the CUDA wrapper and its plain version.

Replaces ``repro/kernels/decode_attention.py::decode_attention`` (the
Pallas TPU kernel, pallas_call at :82): one query token of every query
head, q [B,Hq,1,D], against a KV cache [B,Skv,Hkv,D] whose keys at or past
`pos` are masked. The kernel reads the cache in place in that layout, by
strides (the JAX wrapper transposes the whole cache on every call), and
reads only the keys below pos. `pos` is an int or an int tensor [B] (one
valid length per batch row, as a continuous batch has them).

At pos = 0 no key is valid and the result is 0, as the TPU kernel returns
(its l stays 0 and acc / max(l, 1e-20) = 0); the plain version computes the
same function. The JAX package's oracle ``ref.decode_attention_ref`` is a
plain softmax there and returns the mean of v instead (ROADMAP section 3).

Source: ``csrc/decode_attention.cu``, which states its bound and design:
the key axis is split across blocks (``split_chunk``), each block writes an
fp32 partial (m, l, acc) of its chunk, and the last block of each (batch
row, kv head) merges them, in one launch. D in {64, 128, 256}, Hq / Hkv in
{1, 2, 4, 8}, fp32 or bf16; the cache rows and q must be 16-byte aligned.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.counters import LAUNCHES
from repro_torch.kernels.flash_attention import (NEG_INF,
                                                 _check_attention_inputs,
                                                 _check_rows_aligned)

GROUPS = (1, 2, 4, 8)
# keys a block may take, largest first, and the blocks that make two waves
# on the H100's 132 SMs
SPLIT_CHUNKS = (512, 256, 128, 64)
MIN_BLOCKS = 2 * 132
# per device: one int32 ticket counter per (batch row, kv head), zeroed
# once; the kernel's last block of each row resets its counter
_TICKETS: dict = {}


def split_chunk(skv: int, rows: int) -> int:
    """Keys per block of the split-KV kernel for a cache of skv keys and
    rows = B * Hkv (batch rows times kv heads): the largest chunk that
    still gives MIN_BLOCKS blocks, else the smallest. It depends on the
    shapes alone, never on the positions, which stay on the device."""
    for chunk in SPLIT_CHUNKS:
        if rows * -(-skv // chunk) >= MIN_BLOCKS:
            return chunk
    return SPLIT_CHUNKS[-1]


def _tickets(device, n: int) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None or t.numel() < n:
        t = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def positions(pos, batch: int, device) -> torch.Tensor:
    """pos as an int32 tensor [batch] on `device`."""
    if isinstance(pos, torch.Tensor):
        t = pos.to(device=device, dtype=torch.int32).reshape(-1)
        if t.numel() == 1:
            t = t.expand(batch)
        if t.shape != (batch,):
            raise ValueError(f"pos must be a scalar or [{batch}], got "
                             f"{tuple(pos.shape)}")
        return t.contiguous()
    return torch.full((batch,), int(pos), dtype=torch.int32, device=device)


def decode_attention_plain(q, k, v, pos):
    """Masked softmax over the keys below pos[b], as (sum_k p v) /
    max(sum_k p, 1e-20) with p = 0 on masked keys: the softmax where any key
    is valid, 0 where none is."""
    b, hq, _, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qr = q.reshape(b, hkv, g, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k.float()) / math.sqrt(d)
    n = positions(pos, b, q.device).long()
    valid = (torch.arange(skv, device=q.device)[None, :]
             < n[:, None])[:, None, None, :]
    s = torch.where(valid, s, NEG_INF)
    p = torch.where(valid, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    o = o / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-20)
    return o.reshape(b, hq, 1, d).to(q.dtype)


def decode_attention(q, k, v, pos, *, block_k: int = 512):
    """q [B,Hq,1,D]; k/v [B,Skv,Hkv,D]; pos an int or [B] -> [B,Hq,1,D].

    block_k keeps the TPU kernel's contract (Skv a multiple of
    min(block_k, Skv)); the kernel itself stops at each row's pos."""
    skv = k.shape[1]
    bk = min(block_k, skv)
    if skv % bk:
        raise ValueError(f"cache len {skv} must divide block_k {bk}")
    if not q.is_cuda:
        return decode_attention_plain(q, k, v, pos)
    from repro_torch.kernels import _build
    _check_attention_inputs(q, k, v)
    b, hq, one, d = q.shape
    hkv = k.shape[2]
    if one != 1 or k.shape[0] != b or hq % hkv or hq // hkv not in GROUPS:
        raise ValueError(f"expected q [B,Hq,1,D] and a cache [B,Skv,Hkv,D] "
                         f"with Hq / Hkv in {GROUPS}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    _check_rows_aligned(q=q, k=k, v=v)
    pos_t = positions(pos, b, q.device)
    o = torch.empty((b, hq, 1, d), dtype=q.dtype, device=q.device)
    chunk = split_chunk(skv, b * hkv)
    slots = b * hkv * -(-skv // chunk)
    part = torch.empty(slots * (hq // hkv) * (d + 2), dtype=torch.float32,
                       device=q.device)
    tickets = _tickets(q.device, b * hkv)
    strides = [q.stride(0), q.stride(1), *k.stride()[:3], *v.stride()[:3],
               o.stride(0), o.stride(1)]
    with torch.cuda.device(q.device):
        _build.launch("decode_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), pos_t.data_ptr(), o.data_ptr(),
                      part.data_ptr(), tickets.data_ptr(),
                      _build.int64s((b, hq, hkv, skv, d, chunk)),
                      _build.int64s(strides), int(q.dtype == torch.bfloat16),
                      1.0 / math.sqrt(d), _build.stream_of(q))
    LAUNCHES["decode_attention"] += 1
    return o
