"""Flash-attention backward: the CUDA wrapper and its plain version.

The training path's attention gradient (models/flash_vjp.py): given the
forward's q, k, v, its output o, the rows' log-sum-exp lse (the forward
kernel's ``lse=True``) and the output gradient dO, returns (dq, dk, dv),
the FlashAttention-2 backward of ``repro/models/flash_vjp.py::_bwd_scan``
(a jnp scan in the JAX package; it reaches no Pallas kernel). GQA (dk, dv
sum over the query heads of a kv head), causal masking, a sliding window
(kpos > qpos - window) and a softcap (the tanh chain rule on the capped
scores), NEG_INF = -2^30 as the forward. Kernel layout q, o, dO
[B,Hq,Sq,D], k/v [B,Hkv,Skv,D], any strides with a contiguous last dim
(the model layout [B,S,H,D] as transposed views); lse [B,Hq,Sq] fp32. D in
{64, 128, 256}, fp32 or bf16; outputs in the inputs' type, strided as q,
k, v. Source: ``csrc/flash_attention_bwd.cu``, which states its bound and
design: three launches (D = rowsum(dO o), then dk/dv, then dq; no
atomics, so a rerun is bit for bit). Storage type and head dim pick the
kernels: bf16 runs the five products on the tensor cores (``wgmma``; P
and dS rounded to bf16 before their products; at D 256 the two warpgroups
of a block split D), fp32 the CUDA-core kernels. bf16 rows must start on
16 bytes.

The plain version is `flash_vjp_plain_bwd`, the line-for-line translation
of ``_bwd_scan`` blocked by (bq, bk) in the model layout; the wrapper takes
it on the CPU (`flash_attention_bwd_plain`, the kernel layout).

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches the kernels or raises, and adds one to LAUNCHES (one for the
call's three launches).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.counters import count_launch
from repro_torch.kernels.flash_attention import (NEG_INF, _blocks,
                                                 _check_attention_inputs,
                                                 _check_rows_aligned, _mask,
                                                 plain_block)

# The kernels a CUDA call launches after the delta pass (dk/dv, then dq),
# as csrc/flash_attention_bwd.cu's `launch_all` picks them: bf16 on the
# tensor cores by head dim (at D 256 the kernels whose two warpgroups split
# D), fp32 on the CUDA cores at every head dim.
WGMMA_KERNELS = {
    64: ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    128: ("flash_bwd_dkdv_wgmma_kernel", "flash_bwd_dq_wgmma_kernel"),
    256: ("flash_bwd_dkdv_wgmma_split_kernel",
          "flash_bwd_dq_wgmma_split_kernel"),
}
CORE_KERNELS = ("flash_bwd_dkdv_kernel", "flash_bwd_dq_kernel")


def flash_vjp_plain_bwd(res, do, causal, window, cap, bq, bk):
    """(dq, dk, dv) of the JAX package's `_bwd_scan` from res = (q, k, v,
    o, lse) and dO in the model layout: q blocks outside, k blocks inside,
    dk and dv accumulated per k block; the blocks must divide the
    lengths."""
    q, k, v, o, lse = res
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    nq, nk = sq // bq, skv // bk
    dev = q.device

    do4 = do.reshape(b, sq, hkv, g, d).float()
    o4 = o.reshape(b, sq, hkv, g, d).float()
    delta = torch.movedim((do4 * o4).sum(-1), 1, -1)          # [B,hkv,g,Sq]

    qs = _blocks(q.reshape(b, sq, hkv, g, d), nq, bq)
    dos = _blocks(do.reshape(b, sq, hkv, g, d), nq, bq)
    ks, vs = _blocks(k, nk, bk), _blocks(v, nk, bk)
    dk_acc = [torch.zeros((b, bk, hkv, d), dtype=torch.float32, device=dev)
              for _ in range(nk)]
    dv_acc = [torch.zeros((b, bk, hkv, d), dtype=torch.float32, device=dev)
              for _ in range(nk)]
    dqs = []
    for qi, (qc, doc) in enumerate(zip(qs, dos)):
        lsec = lse[..., qi * bq:(qi + 1) * bq]                # [B,h,g,bq]
        dc = delta[..., qi * bq:(qi + 1) * bq]
        dq_c = torch.zeros((b, bq, hkv, g, d), dtype=torch.float32,
                           device=dev)
        for ki, (kc, vc) in enumerate(zip(ks, vs)):
            s_raw = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(),
                                 kc.float()) * scale
            s = cap * torch.tanh(s_raw / cap) if cap else s_raw
            msk = _mask(qi * bq, ki * bk, bq, bk, causal, window, dev)
            s = torch.where(msk, s, NEG_INF)
            p = torch.exp(s - lsec[..., None])                # [B,h,g,bq,bk]
            dv_blk = torch.einsum("bhgqk,bqhgd->bkhd", p, doc.float())
            dp = torch.einsum("bqhgd,bkhd->bhgqk", doc.float(), vc.float())
            ds = p * (dp - dc[..., None])
            if cap:
                ds = ds * (1.0 - torch.square(s / cap))
            ds = torch.where(msk, ds, 0.0)
            dq_c = dq_c + torch.einsum("bhgqk,bkhd->bqhgd", ds,
                                       kc.float()) * scale
            dk_blk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                                  qc.float()) * scale
            dk_acc[ki] = dk_acc[ki] + dk_blk
            dv_acc[ki] = dv_acc[ki] + dv_blk
        dqs.append(dq_c)
    dq = torch.cat(dqs, 1).reshape(b, sq, hq, d).to(q.dtype)
    dk = torch.cat(dk_acc, 1).to(k.dtype)
    dv = torch.cat(dv_acc, 1).to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, do, lse, *, causal=True, window=0,
                              cap=0.0):
    """The wrapper's plain version: flash_vjp_plain_bwd in the kernel
    layout, (dq, dk, dv) as views [B,H,S,D]."""
    b, hq, sq, _ = q.shape
    hkv = k.shape[1]
    res = [t.transpose(1, 2) for t in (q, k, v, o)]
    grads = flash_vjp_plain_bwd(
        (*res, lse.reshape(b, hkv, hq // hkv, sq)), do.transpose(1, 2),
        causal, window, cap, plain_block(sq), plain_block(k.shape[2]))
    return tuple(t.transpose(1, 2) for t in grads)


def flash_attention_bwd(q, k, v, o, do, lse, *, causal=True, window=0,
                        cap=0.0):
    """(dq, dk, dv) of flash attention; shapes as the module docstring."""
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         window=window, cap=cap)
    from repro_torch.kernels import _build
    _check_attention_inputs(q, k, v)
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    if k.shape[0] != b or hq % hkv:
        raise ValueError(f"GQA needs one batch and Hq % Hkv == 0, got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}")
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device \
                or t.stride(-1) != 1:
            raise ValueError(f"{name} must match q's shape, type and device "
                             f"with a contiguous last dim")
    if lse.shape != (b, hq, sq) or lse.dtype != torch.float32 \
            or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"lse must be a contiguous fp32 [B,Hq,Sq] tensor on "
                         f"q's device, got {tuple(lse.shape)} {lse.dtype}")
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.dtype == torch.bfloat16:
        _check_rows_aligned(q=q, k=k, v=v, o=o, do=do, dq=dq, dk=dk, dv=dv)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv)
               for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        _build.launch("flash_attention_bwd", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(), do.data_ptr(),
                      lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                      dk.data_ptr(), dv.data_ptr(),
                      _build.int64s((b, hq, hkv, sq, skv, d)),
                      _build.int64s(strides), int(q.dtype == torch.bfloat16),
                      int(bool(causal)), int(window), float(cap),
                      1.0 / math.sqrt(d), _build.stream_of(q))
    count_launch("flash_attention_bwd")
    return dq, dk, dv
