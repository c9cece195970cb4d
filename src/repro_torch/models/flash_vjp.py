"""Memory-optimal attention with a hand-written (flash) backward: the port
of ``repro/models/flash_vjp.py``, the training path's attention.

Autograd of an online-softmax forward would save every [BQ, BK]
probability block. This ``torch.autograd.Function`` saves only
(q, k, v, o, lse) and recomputes p blockwise in the backward, the
FlashAttention-2 backward:

    D  = rowsum(dO ∘ O)
    p  = exp(s - lse)
    dv += pᵀ dO ;  dp = dO vᵀ ;  ds = p ∘ (dp - D)
    dq += ds k scale ;  dk += dsᵀ q scale

with GQA, causal, sliding-window (banded) masks and the softcap's tanh
chain rule. On CUDA tensors the forward is the flash-attention kernel
(kernel 8, ``kernels/flash_attention.py``) asked for the rows' log-sum-exp,
and the backward the hand-written ``kernels/flash_attention_bwd.py`` (three
launches, no atomics: in bf16 the products run on the tensor cores with
P and dS rounded to bf16, in fp32 on the CUDA cores); on
CPU tensors both are those kernels' plain versions, `flash_vjp_plain_fwd`
and `flash_vjp_plain_bwd`, line-for-line translations of the JAX
package's ``_fwd_scan`` and ``_bwd_scan`` blocked by (bq, bk), which the
tests hold against JAX and the card's checks hold the kernels against.

Layout as in the JAX package: q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D], o like q,
lse [B,Hkv,G,Sq] (the kernels' [B,Hq,Sq] in the same memory order).
On meta tensors (the dry run, launch/dryrun.py) both directions give
shapes only, their matrix products as einsums a FLOP counter reads.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import flash_vjp_plain_fwd
from repro_torch.kernels.flash_attention_bwd import flash_vjp_plain_bwd


def _kernel_fwd(q, k, v, causal, window, cap):
    """Kernel 8 with the rows' lse, in the model layout."""
    o, lse = fa.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, cap=cap, lse=True)
    b, sq, hq, _ = q.shape
    hkv = k.shape[2]
    return o.transpose(1, 2), lse.reshape(b, hkv, hq // hkv, sq)


def _kernel_bwd(res, do, causal, window, cap):
    """The backward kernel, in the model layout."""
    q, k, v, o, lse = res
    b, sq, hq, _ = q.shape
    dq, dk, dv = fab.flash_attention_bwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        o.transpose(1, 2), do.transpose(1, 2), lse.reshape(b, hq, sq),
        causal=causal, window=window, cap=cap)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _meta_fwd(q, k, v):
    """Kernel 8's outputs on meta tensors (the dry run): shapes only, with
    its two products as einsums so that a FLOP counter sees them."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qr = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k)
    o = torch.einsum("bhgqk,bkhd->bqhgd", s, v).reshape(q.shape)
    return o, torch.empty((b, hkv, hq // hkv, sq), dtype=torch.float32,
                          device=q.device)


def _meta_bwd(res, do):
    """The backward's gradients on meta tensors: shapes, and the five
    products of the FlashAttention-2 backward (s recomputed, dv, dp, dq,
    dk) as einsums."""
    q, k, v, _, _ = res
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qr = q.reshape(b, sq, hkv, hq // hkv, d)
    dor = do.reshape(qr.shape)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", s, dor)
    ds = torch.einsum("bqhgd,bkhd->bhgqk", dor, v)
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k).reshape(q.shape)
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds, qr)
    del s
    return dq, dk, dv


class FlashChunked(torch.autograd.Function):
    """o = attention(q, k, v) whose backward recomputes p from (q, k, v, o,
    lse): the kernels on CUDA tensors, the plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap, bq, bk):
        if q.is_cuda:
            o, lse = _kernel_fwd(q, k, v, causal, window, cap)
        elif q.is_meta:
            o, lse = _meta_fwd(q, k, v)
        else:
            o, lse = flash_vjp_plain_fwd(q, k, v, causal, window, cap, bq,
                                         bk)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (causal, window, cap, bq, bk)
        return o

    @staticmethod
    def backward(ctx, do):
        causal, window, cap, bq, bk = ctx.args
        res = ctx.saved_tensors
        do = do.contiguous()
        if do.is_cuda:
            grads = _kernel_bwd(res, do, causal, window, cap)
        elif do.is_meta:
            grads = _meta_bwd(res, do)
        else:
            grads = flash_vjp_plain_bwd(res, do, causal, window, cap, bq, bk)
        return (*grads, None, None, None, None, None)


def chunked_attention_vjp(q, k, v, *, causal=True, window=0, cap=0.0,
                          q_chunk=512, kv_chunk=512):
    """Drop-in for attention.chunked_attention with O(S) backward memory.
    The chunks must divide the lengths, as in the JAX package (the CUDA
    kernels tile on their own)."""
    sq, skv = q.shape[1], k.shape[1]
    bq = min(q_chunk, sq)
    bk = min(kv_chunk, skv)
    if sq % bq or skv % bk:
        raise ValueError(f"seq lens ({sq},{skv}) must divide chunks")
    return FlashChunked.apply(q, k, v, causal, window, cap, bq, bk)
