"""The Mamba2 SSD step inside one chunk: the CUDA wrapper and its plain
version.

Replaces ``repro/kernels/ssd_chunk.py::ssd_chunk`` (the Pallas TPU kernel,
pallas_call at :57). Per (batch, head), with a = cumsum(dt * A) over the
chunk and A = -exp(a_log):
  L     = exp(causal segsum), masked with -1e30 BEFORE the exp;
  y     = (C Bᵀ ∘ L) (dt ∘ X)                 [B,Q,H,P] in x's type;
  state = (exp(a_Q - a) ∘ B)ᵀ (dt ∘ X)         [B,H,N,P] fp32, the TPU
          kernel's [N, P] layout (``ref.ssd_chunk_ref`` returns [P, N]);
  decay = exp(a_Q)                             [B,H] fp32.
x [B,Q,H,P], b/c [B,Q,N] share x's type (fp32 or bf16); dt [B,Q,H] and
a_log [H] are read as fp32. The inter-chunk scan stays on the host
(``ops.ssd_chunked_pallas``, which passes every chunk as a batch row of
one call). On CUDA the storage type picks the kernel: bf16 the tensor-core
``ssd_chunk_wgmma_kernel`` (S' = C Bᵀ ∘ L ∘ dt and w ∘ X rounded to bf16,
fp32 accumulation), fp32 the CUDA-core ``ssd_chunk_kernel``. Source:
``csrc/ssd_chunk.cu``, which states the bound and both designs.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.counters import LAUNCHES

NEG = -1e30
DTYPES = (torch.float32, torch.bfloat16)
SMEM_LIMIT = 232448          # bytes of shared memory a Hopper block can use


def smem_bytes(q: int, p: int) -> int:
    """The fp32 kernel's shared memory: scores [Q][Q+1], dt*x [Q][P], two
    32-column B/C slices [Q][33], the cumsum and dt, all fp32."""
    return 4 * (q * (q + 1) + q * p + 2 * q * 33 + 2 * q)


def _round64(v: int) -> int:
    return -(-v // 64) * 64


def wgmma_smem_bytes(q: int, n: int, p: int) -> int:
    """The bf16 kernel's shared memory: 1 KB of alignment, C, B, X and
    w ∘ X as bf16 tiles of Q and N rounded up to 64 and one 64-column
    panel of P, the cumsum and dt in fp32, the tiles' 8-byte transaction
    barrier."""
    qp = _round64(q)
    return 1024 + 4 * qp * (_round64(n) + 64) + 8 * qp + 8


def _check_wgmma(x, b, c, q, n, p) -> None:
    """What the bf16 kernel takes: P <= 64 (one 64-column panel) and
    Q <= 256 (64 query rows a warpgroup, 4 warpgroups), N and P multiples
    of 8, 16-byte aligned rows (TMA), the tiles within shared memory."""
    if p > 64 or q > 256 or n % 8 or p % 8:
        raise ValueError(f"the bf16 kernel takes P <= 64, Q <= 256 and N, P "
                         f"multiples of 8; got Q {q}, N {n}, P {p}")
    if wgmma_smem_bytes(q, n, p) > SMEM_LIMIT:
        raise ValueError(f"Q {q}, N {n}, P {p} need "
                         f"{wgmma_smem_bytes(q, n, p)} B of shared memory, "
                         f"over {SMEM_LIMIT}")
    strides = (*x.stride()[:3], *b.stride()[:2], *c.stride()[:2])
    if any(t.data_ptr() % 16 for t in (x, b, c)) or any(s % 8
                                                         for s in strides):
        raise ValueError("the bf16 kernel needs 16-byte aligned rows of x, "
                         "b and c (pointers and strides)")


def ssd_chunk_plain(x, b, c, dt, a_log):
    """The function of ``ref.ssd_chunk_ref``, with the state as [N, P]."""
    q = x.shape[1]
    a = -torch.exp(a_log.float())
    acum = torch.cumsum(dt.float() * a, dim=1)                 # [B,Q,H]
    diff = acum[:, :, None, :] - acum[:, None, :, :]
    tril = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.exp(torch.where(tril[None, :, :, None], diff, NEG))
    cb = torch.einsum("bsn,brn->bsr", c.float(), b.float())
    xdt = x.float() * dt.float()[..., None]
    y = torch.einsum("bsrh,brhp->bshp", cb[..., None] * lmat, xdt)
    atot = acum[:, -1]
    decay_r = torch.exp(atot[:, None] - acum)
    state = torch.einsum("brn,brhp,brh->bhnp", b.float(), xdt, decay_r)
    return y.to(x.dtype), state, torch.exp(atot)


def ssd_chunk(x, b, c, dt, a_log):
    """One chunk, every batch row and head: (y, state [B,H,N,P], decay)."""
    if not x.is_cuda:
        return ssd_chunk_plain(x, b, c, dt, a_log)
    from repro_torch.kernels import _build
    if x.ndim != 4 or b.ndim != 3 or c.shape != b.shape:
        raise ValueError(f"expected x [B,Q,H,P] and b, c [B,Q,N], got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, q, h, p = x.shape
    n = b.shape[-1]
    if b.shape[:2] != (bsz, q) or tuple(dt.shape) != (bsz, q, h) \
            or tuple(a_log.shape) != (h,):
        raise ValueError(f"dt must be [{bsz},{q},{h}] and a_log [{h}], got "
                         f"{tuple(dt.shape)}, {tuple(a_log.shape)}")
    if x.dtype not in DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise ValueError(f"x, b, c must share one of {DTYPES}")
    if any(t.device != x.device for t in (b, c, dt, a_log)):
        raise ValueError("all inputs must be on x's device")
    if x.stride(-1) != 1 or b.stride(-1) != 1 or c.stride(-1) != 1:
        raise ValueError("x, b and c need a contiguous last dim")
    if x.dtype == torch.bfloat16:
        _check_wgmma(x, b, c, q, n, p)
    elif smem_bytes(q, p) > SMEM_LIMIT:
        raise ValueError(f"chunk {q} x head dim {p} needs "
                         f"{smem_bytes(q, p)} B of shared memory, over "
                         f"{SMEM_LIMIT}")
    dt32 = dt.float()
    if dt32.stride(-1) != 1:
        dt32 = dt32.contiguous()
    a32 = a_log.float().contiguous()
    y = torch.empty((bsz, q, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((bsz, h, n, p), dtype=torch.float32, device=x.device)
    decay = torch.empty((bsz, h), dtype=torch.float32, device=x.device)
    strides = [*x.stride()[:3], *b.stride()[:2], *c.stride()[:2],
               *dt32.stride(), *y.stride()[:3]]
    with torch.cuda.device(x.device):
        _build.launch("ssd_chunk", x.data_ptr(), b.data_ptr(), c.data_ptr(),
                      dt32.data_ptr(), a32.data_ptr(), y.data_ptr(),
                      state.data_ptr(), decay.data_ptr(),
                      _build.int64s((bsz, q, h, n, p)),
                      _build.int64s(strides), int(x.dtype == torch.bfloat16),
                      _build.stream_of(x))
    LAUNCHES["ssd_chunk"] += 1
    return y, state, decay
