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
design. The storage type and head dim pick the kernel: bf16 runs both
products on the tensor cores (``wgmma``, P rounded to bf16 before P V;
rows must be 16-byte aligned), at D 64 and 128 in the warp-specialised
kernel that takes q, k and v by TMA (the maps' geometry is
`tma_map_geometry`'s), at D 256 in the cp.async one; fp32 runs the exact
CUDA-core kernel. With ``lse=True`` every kernel
also returns each row's log-sum-exp m + log(max(l, 1e-20)) as [B,Hq,Sq]
fp32, the forward of the training path (models/flash_vjp.py), whose
backward is ``kernels/flash_attention_bwd.py``; o is the same either way.
That path's plain version is `flash_vjp_plain_fwd`, the line-for-line
translation of ``repro/models/flash_vjp.py::_fwd_scan`` blocked by
(bq, bk) in the model layout, which the wrapper's ``lse=True`` takes on
the CPU (`flash_attention_lse_plain`).

A wrapper given CPU tensors returns the plain version; given CUDA tensors
it launches the kernel or raises, and adds one to LAUNCHES.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels.counters import count_launch

NEG_INF = -2.0**30
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
# bf16 head dims of the TMA-fed kernel, and the rows of its boxes (a query
# tile and a key tile)
TMA_HEAD_DIMS = (64, 128)
TMA_BOX_ROWS = 128
# the kernel each bf16 head dim launches (the name in a device trace); fp32
# takes CORE_KERNEL at every head dim
BF16_KERNELS = {64: "flash_attention_ws_kernel",
                128: "flash_attention_ws_kernel",
                256: "flash_attention_wgmma_kernel"}
CORE_KERNEL = "flash_attention_kernel"


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


def _blocks(x: torch.Tensor, n: int, c: int) -> list:
    """[B, S, ...] -> n blocks [B, c, ...] along S."""
    return [x[:, i * c:(i + 1) * c] for i in range(n)]


def _mask(q_start, k_start, bq, bk, causal, window, device):
    qpos = q_start + torch.arange(bq, device=device)[:, None]
    kpos = k_start + torch.arange(bk, device=device)[None, :]
    m = torch.ones((bq, bk), dtype=torch.bool, device=device)
    if causal:
        m &= kpos <= qpos
    if window:
        m &= kpos > qpos - window
    return m


def flash_vjp_plain_fwd(q, k, v, causal, window, cap, bq, bk):
    """q [B,Sq,Hq,D], k/v [B,Skv,Hkv,D] -> o [B,Sq,Hq,D] (q's type) and
    lse [B,hkv,g,Sq] (fp32): the online softmax of the JAX package's
    `_fwd_scan`, block by block; the blocks must divide the lengths."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(d)
    nq, nk = sq // bq, skv // bk
    qs = _blocks(q.reshape(b, sq, hkv, g, d), nq, bq)
    ks, vs = _blocks(k, nk, bk), _blocks(v, nk, bk)
    dev = q.device
    os_, lses = [], []
    for qi, qc in enumerate(qs):
        m = torch.full((b, hkv, g, bq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, bq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, hkv, g, bq, d), dtype=torch.float32,
                          device=dev)
        for ki, (kc, vc) in enumerate(zip(ks, vs)):
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc.float(),
                             kc.float()) * scale
            if cap:
                s = cap * torch.tanh(s / cap)
            msk = _mask(qi * bq, ki * bk, bq, bk, causal, window, dev)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vc.float())
            m = m_new
        os_.append(acc / torch.clamp(l[..., None], min=1e-20))
        lses.append(m + torch.log(torch.clamp(l, min=1e-20)))
    # [nq, B, hkv, g, bq, d] -> [B, nq, bq, hkv, g, d]
    o = torch.stack(os_, 0).permute(1, 0, 4, 2, 3, 5)
    o = o.reshape(b, sq, hq, d).to(q.dtype)
    # [nq, B, hkv, g, bq] -> [B, hkv, g, nq, bq]
    lse = torch.stack(lses, 0).permute(1, 2, 3, 0, 4).reshape(b, hkv, g, sq)
    return o, lse


def plain_block(n: int, block: int = 512) -> int:
    """The plain scans' block along a length n: `block` where it divides
    n, else all of n."""
    return block if n % block == 0 else n


def flash_attention_lse_plain(q, k, v, *, causal=True, window=0, cap=0.0):
    """The plain version of ``flash_attention(..., lse=True)``:
    flash_vjp_plain_fwd in the kernel layout, (o [B,Hq,Sq,D], lse
    [B,Hq,Sq])."""
    b, hq, sq, _ = q.shape
    o, lse = flash_vjp_plain_fwd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal, window, cap,
                                 plain_block(sq), plain_block(k.shape[2]))
    return o.transpose(1, 2), lse.reshape(b, hq, sq)


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


def tma_map_geometry(t: torch.Tensor):
    """The TMA map of a bf16 [B,H,S,D] tensor in the kernel's terms: dims
    innermost first (D, S, H, B), the byte strides of S, H and B, and the
    box (64, TMA_BOX_ROWS, 1, 1), one 128-byte swizzled panel of a tile. Any
    strides with a contiguous last dim, so the model layout's transposed
    view is read in place. A dim of size 1 is never stepped, and takes the
    extent of the dims inside it as its stride. Raises on what a map cannot
    express: a stride that is not a positive multiple of 16 bytes below
    2^40, an empty dim, D not a multiple of 64."""
    return _geometry(tuple(t.shape), t.stride(), t.element_size())


@functools.lru_cache(maxsize=256)
def _geometry(shape, strides, esize):
    if len(shape) != 4 or strides[-1] != 1:
        raise ValueError(f"a TMA map needs a 4-d tensor with a contiguous "
                         f"last dim, got {shape} strides {strides}")
    b, h, s, d = shape
    if min(shape) < 1 or d % 64:
        raise ValueError(f"a TMA map needs non-empty dims and D a multiple "
                         f"of 64, got {shape}")
    out = []
    inner = d * esize           # the extent of the dims inside the next one
    for size, stride in ((s, strides[2]), (h, strides[1]), (b, strides[0])):
        nbytes = stride * esize if size > 1 else inner
        if nbytes <= 0 or nbytes % 16 or nbytes >= 2**40:
            raise ValueError(f"a TMA map needs strides that are positive "
                             f"multiples of 16 bytes below 2^40, got "
                             f"{nbytes} bytes in {strides}")
        out.append(nbytes)
        inner = max(inner, nbytes * size)
    return (d, s, h, b), tuple(out), (64, TMA_BOX_ROWS, 1, 1)


@functools.lru_cache(maxsize=256)
def _maps_arg(dims, strides):
    """The C entry point's maps argument: q's, k's and v's
    `tma_map_geometry`, 11 values each, from the wrapper's dims (b, hq, hkv,
    sq, skv, d) and element strides ((b, h, s) of q, k, v, o), cached: the
    wrapper's host time bounds the short serving calls."""
    from repro_torch.kernels import _build
    b, hq, hkv, sq, skv, d = dims
    shapes = ((b, hq, sq, d), (b, hkv, skv, d), (b, hkv, skv, d))
    return _build.int64s([
        x for i, shape in enumerate(shapes)
        for part in _geometry(shape, (*strides[3 * i:3 * i + 3], 1), 2)
        for x in part])


def flash_attention(q, k, v, *, causal=True, window=0, cap=0.0, lse=False):
    """q [B,Hq,Sq,D], k/v [B,Hkv,Skv,D] -> [B,Hq,Sq,D] in q's type; with
    lse=True, (o, lse [B,Hq,Sq] fp32)."""
    if not q.is_cuda:
        plain = flash_attention_lse_plain if lse else flash_attention_plain
        return plain(q, k, v, causal=causal, window=window, cap=cap)
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
    row_lse = torch.empty((b, hq, sq), dtype=torch.float32,
                          device=q.device) if lse else None
    strides = [*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
               *o.stride()[:3]]
    dims = (b, hq, hkv, sq, skv, d)
    maps = None
    if q.dtype == torch.bfloat16 and d in TMA_HEAD_DIMS:
        maps = _maps_arg(dims, tuple(strides))
    with torch.cuda.device(q.device):
        _build.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), o.data_ptr(),
                      None if row_lse is None else row_lse.data_ptr(),
                      _build.int64s(dims),
                      _build.int64s(strides), maps,
                      int(q.dtype == torch.bfloat16),
                      int(bool(causal)), int(window), float(cap),
                      1.0 / math.sqrt(d), _build.stream_of(q))
    count_launch("flash_attention")
    return (o, row_lse) if lse else o
