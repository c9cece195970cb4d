"""The federated round's kernels: CUDA wrappers and plain versions.

Each function here has three parts:

  * a hand-written CUDA kernel for Hopper (``csrc/pruning_mask.cu``,
    built by ``_build.py`` at first CUDA use);
  * its wrapper, which checks device, dtype, shape and contiguity,
    allocates the outputs, launches the kernel on the current stream and
    adds one to ``LAUNCHES[name]``;
  * a plain PyTorch version of the same function (``*_plain``), op for op
    the ``impl="xla"`` mirror in ``repro/kernels/ops.py``, which the kernel
    matches bit for bit.

A wrapper given CPU tensors returns its plain version (the tests run there);
given CUDA tensors it launches the kernel or raises — it never falls back.

Denormals are zero where the JAX reference flushes them (XLA:CPU and the
TPU treat subnormal inputs as zero and flush a subnormal result): the
importance q = (w*v)^2 is flushed to +0 below FLT_MIN, and the threshold it
is compared with goes through the same `daz`. Without it, the round-0
threshold nextafter(0) (a subnormal) would prune every zero-importance
weight that JAX keeps. The aggregate tail (the weighted and unweighted
FedSGD steps, the masked update) computes every sum, difference and product
as XLA does (`flush_add`, `flush_sub`, `flush_mul`), in the plain versions
and in the kernels alike.

Shapes follow the packed layout: buffers [R, 128*k] fp32, client stacks
[C, R, 128*k] fp32.

The client-rank sort moves bits and does no arithmetic, so it needs no
flush; the robust reducers that consume it state theirs (kernels/ops.py).
"""
from __future__ import annotations

import numpy as np
import torch

# one count per kernel of the port, bumped only where the kernel launches
from repro_torch.kernels.counters import LAUNCHES, reset_launches  # noqa: F401

LANES = 128
FLT_MIN = torch.finfo(torch.float32).tiny
INT32_MAX = 2**31 - 1
# per (device, stream): the histogram kernel's int32 state, 256 accumulator
# bins and a ticket counter, zeroed once (the kernel's last block resets
# them); a stream of its own, so calls on two streams never share one
_HIST_STATE: dict = {}


def daz(x: torch.Tensor) -> torch.Tensor:
    """Denormals are zero: +0 where |x| < FLT_MIN, x elsewhere (NaN kept)."""
    return torch.where(x.abs() < FLT_MIN, torch.zeros_like(x), x)


def flush(x: torch.Tensor) -> torch.Tensor:
    """XLA's denormals-are-zero: a subnormal becomes a zero of its sign
    (x * 0 there; NaN and inf pass)."""
    return x * (x.abs() >= FLT_MIN)


# the operands' scale in flush_mul's tininess test
_SCALE = 2.0**32


def f32_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A host scalar as an fp32 0-dim tensor on `like`'s device (rounded
    from double as jnp.asarray(x, float32) rounds it). A fill, not a copy
    from the host, so a CUDA graph can capture it."""
    return torch.full((), float(np.float32(x)), dtype=torch.float32,
                      device=like.device)


def _host_f32(x) -> float:
    """A host scalar rounded to fp32 and flushed, as a Python float: a
    tensor op takes it exactly, with no copy to the device."""
    x = np.float32(x)
    return float(x * np.float32(abs(x) >= FLT_MIN))


def flush_mul(a, b) -> torch.Tensor:
    """a * b as XLA:CPU computes it: subnormal inputs read as zeros of their
    sign, and a tiny product is a zero of its sign. Tiny is decided after
    rounding, as x86 decides it: the exact product rounded to 24 bits with
    an unbounded exponent is below FLT_MIN. So a product just below FLT_MIN
    that rounds up to it in fp32 is flushed unless it lies within half an
    ulp (2^-151) of it. That rounding is the fp32 product of the operands
    scaled by 2^32 each (exact: a tiny product has no operand above 1 after
    the input flush), compared with FLT_MIN * 2^64. Either operand may be a
    host scalar (rounded to fp32, never copied to the device)."""
    if not isinstance(a, torch.Tensor):
        a, b = b, a                  # a * b is b * a, bit for bit
    a = flush(a.float())
    b = flush(b.float()) if isinstance(b, torch.Tensor) else _host_f32(b)
    scaled = (a * _SCALE) * (b * _SCALE)
    return (a * b) * (scaled.abs() >= FLT_MIN * _SCALE**2)


def flush_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b as XLA:CPU computes it: subnormal inputs read as zeros of their
    sign, a subnormal sum (always exact) flushed to a zero of its sign."""
    return flush(flush(a) + flush(b))


def flush_sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b with the flush of `flush_add`."""
    return flush(flush(a) - flush(b))


def importance(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """q = (w*v)^2 (eq. 4) in fp32, each product rounded, denormals zero."""
    p = w.float() * v.float()
    return daz(p * p)


# -- plain versions ------------------------------------------------------------

def importance_masks_plain(w, v, prunable, thresholds):
    """(q [R,L], masks [C,R,L]): mask c is 1 where prunable == 0, else
    q >= daz(thresholds[c])."""
    q = importance(w, v)
    thr = daz(thresholds.float().reshape(-1))
    keep = (q[None] >= thr[:, None, None]).float()
    return q, torch.where(prunable[None] > 0, keep, torch.ones_like(keep))


def weighted_grad_sum(grads, cweights):
    """sum_c cweights[c] * grads[c] in client-stack order, [C,R,L]->[R,L].
    A client whose weight is not > 0 is skipped by `where`, so a NaN on a
    padding client never reaches the sum; XLA compares the flushed weight,
    so a subnormal one is skipped too. Each product and sum is flushed as
    XLA flushes it, and the sum starts from client 0's term, not from +0.0
    + term: XLA folds the jitted mirror's zero start away, so a -0.0 there
    keeps its sign."""
    cw = flush(cweights.float())
    acc = torch.where(cw[0] > 0.0, flush_mul(cw[0], grads[0]),
                      torch.zeros(grads.shape[1:], dtype=torch.float32,
                                  device=grads.device))
    for c in range(1, grads.shape[0]):
        # both terms are flushed already: flush_add's input flush is a no-op
        acc = torch.where(cw[c] > 0.0,
                          flush(acc + flush_mul(cw[c], grads[c])), acc)
    return acc


def apply_mean_update(w, gsum, inv, eta, noise=None):
    """g = gsum * inv (+ noise), step = eta * g, w' = w - step: (w', g,
    step). Eager torch rounds every op on its own, so nothing is
    FMA-contracted: the product inv * gsum is rounded before the noise is
    added, as the JAX package's fenced noisy tail does. Every op is flushed
    as XLA flushes it; inv and eta are fp32 tensors or host scalars.
    inv=None takes g = gsum as it is: the robust path's, whose reducers
    flush their output and whose scale is the 1.0 that XLA drops."""
    g = gsum if inv is None else flush_mul(gsum, inv)
    if noise is not None:
        g = flush_add(g, noise.float())
    step = flush_mul(eta, g)
    return flush_sub(w.float(), step), g, step


def fedsgd_aggregate_weighted_plain(w, grads, cweights, inv, eta):
    """(w', g, step) of the weighted FedSGD step."""
    return apply_mean_update(w, weighted_grad_sum(grads, cweights), inv, eta)


def fedsgd_aggregate_plain(w, grads, eta):
    """(w', g, step) of the unweighted FedSGD step: the sum in client-stack
    order from the first client's gradient, times float32(1/C)."""
    acc = grads[0].float()
    for c in range(1, grads.shape[0]):
        acc = flush_add(acc, grads[c].float())
    return apply_mean_update(w, acc, 1.0 / grads.shape[0], eta)


def masked_update_plain(w, g, mask, eta):
    """(w - eta*g) * mask, each op rounded on its own and flushed."""
    return flush_mul(flush_sub(w.float(), flush_mul(eta, g)), mask.float())


def order_keys(x: torch.Tensor) -> torch.Tensor:
    """Monotone int32 total-order keys of fp32 values: b ^ ((b >> 31) &
    0x7fffffff) on the bit pattern (an arithmetic shift) compares like the
    values, -0.0 strictly below +0.0."""
    b = x.float().contiguous().view(torch.int32)
    return b ^ ((b >> 31) & 0x7FFFFFFF)


def client_rank_sort_plain(grads, cweights):
    """[C, R, L] sorted per coordinate along the client axis by
    `order_keys`, zero-weight clients keyed INT32_MAX (last): a stable sort
    of the keys and a gather, bitwise the transposition network's output on
    every rank (the network swaps only on a strict >, so it is stable). The
    weight is flushed before the test, as XLA compares it: a subnormal
    weight is zero."""
    g = grads.float()
    key = order_keys(g)
    invalid = ~(flush(cweights.float()) > 0.0)
    key = torch.where(invalid[:, None, None],
                      torch.full_like(key, INT32_MAX), key)
    idx = torch.sort(key, dim=0, stable=True).indices
    return torch.gather(g, 0, idx)


def exponent_histogram_plain(q, prunable):
    """[256] int32: bin b counts coordinates with bits(q) >> 23 == b and
    prunable > 0; bytes outside [0, 255] are dropped."""
    byte = q.reshape(-1).contiguous().view(torch.int32) >> 23
    ok = (prunable.reshape(-1) > 0) & (byte >= 0)
    idx = torch.where(ok, byte, torch.zeros_like(byte)).long()
    hist = torch.zeros(256, dtype=torch.int64, device=q.device)
    hist.scatter_add_(0, idx, ok.long())
    return hist.int()


# -- CUDA wrappers -------------------------------------------------------------

def _check(name: str, t: torch.Tensor, shape, device: torch.device, *,
           vector: bool = True) -> None:
    """Device, dtype (fp32), shape and contiguity; buffers the kernels read
    or write as float4/int4 (`vector`) must also be 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, "
                         f"got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected torch.float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if vector and t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _packed_shape(w: torch.Tensor) -> tuple[int, int]:
    if w.ndim != 2 or w.shape[1] % LANES:
        raise ValueError(f"expected a packed [R, {LANES}*k] buffer, "
                         f"got {tuple(w.shape)}")
    return int(w.shape[0]), int(w.shape[1])


def importance_mask_2d(w, v, prunable, threshold):
    """Shared-threshold importance + keep-mask, prunable override included.

    Replaces ``repro/kernels/pruning_mask.py::importance_mask_2d`` together
    with ``ops.packed_importance_mask``'s ``where(prunable > 0, keep, 1)``.
    w, v, prunable: [R, 128*k] fp32; threshold: fp32 scalar tensor (on the
    device, from the threshold search). Returns (q, mask), both [R, 128*k].
    Bound by bytes: 3 reads + 2 writes of one buffer."""
    if not w.is_cuda:
        q, masks = importance_masks_plain(w, v, prunable, threshold)
        return q, masks[0]
    from repro_torch.kernels import _build
    shape = _packed_shape(w)
    for nm, t in (("w", w), ("v", v), ("prunable", prunable)):
        _check(nm, t, shape, w.device)
    _check("threshold", threshold.reshape(()), (), w.device, vector=False)
    n = shape[0] * shape[1]
    q = torch.empty(shape, dtype=torch.float32, device=w.device)
    mask = torch.empty(shape, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        _build.launch("importance_mask_2d", w.data_ptr(), v.data_ptr(),
                      prunable.data_ptr(), threshold.data_ptr(), n,
                      q.data_ptr(), mask.data_ptr(), _build.stream_of(w))
    LAUNCHES["importance_mask_2d"] += 1
    return q, mask


def importance_mask_batched(w, v, prunable, thresholds):
    """Per-client keep-masks from one read of (w, v, prunable).

    Replaces ``repro/kernels/pruning_mask.py::importance_mask_batched``.
    thresholds: [C] fp32 on the device. Returns (q [R,L], masks [C,R,L]).
    Bound by bytes: 3 reads + (1 + C) writes of one buffer."""
    if not w.is_cuda:
        return importance_masks_plain(w, v, prunable, thresholds)
    from repro_torch.kernels import _build
    shape = _packed_shape(w)
    n_clients = int(thresholds.numel())
    for nm, t in (("w", w), ("v", v), ("prunable", prunable)):
        _check(nm, t, shape, w.device)
    _check("thresholds", thresholds, (n_clients,), w.device, vector=False)
    if n_clients < 1:
        raise ValueError("need at least one threshold")
    q = torch.empty(shape, dtype=torch.float32, device=w.device)
    masks = torch.empty((n_clients,) + shape, dtype=torch.float32,
                        device=w.device)
    with torch.cuda.device(w.device):
        _build.launch("importance_masks", w.data_ptr(), v.data_ptr(),
                      prunable.data_ptr(), thresholds.data_ptr(), n_clients,
                      w.numel(), q.data_ptr(), masks.data_ptr(),
                      _build.stream_of(w))
    LAUNCHES["importance_mask_batched"] += 1
    return q, masks


def fedsgd_aggregate_weighted(w, grads, cweights, inv, eta):
    """Weighted eqs. (6)-(7) fused: (w', g, step) from one pass.

    Replaces ``repro/kernels/pruning_mask.py::fedsgd_aggregate_weighted``.
    w: [R,L]; grads: [C,R,L]; cweights: [C]; inv, eta: fp32 scalar tensors
    on the device. Bound by bytes: reads w and the gradients of the clients
    with weight > 0, writes three buffers."""
    if not w.is_cuda:
        return fedsgd_aggregate_weighted_plain(w, grads, cweights, inv, eta)
    from repro_torch.kernels import _build
    shape = _packed_shape(w)
    n_clients = int(grads.shape[0])
    if n_clients < 1:
        raise ValueError("need at least one client gradient")
    _check("w", w, shape, w.device)
    _check("grads", grads, (n_clients,) + shape, w.device)
    _check("cweights", cweights, (n_clients,), w.device, vector=False)
    _check("inv", inv, (), w.device, vector=False)
    _check("eta", eta, (), w.device, vector=False)
    outs = [torch.empty(shape, dtype=torch.float32, device=w.device)
            for _ in range(3)]
    with torch.cuda.device(w.device):
        _build.launch("fedsgd_aggregate_weighted", w.data_ptr(),
                      grads.data_ptr(), cweights.data_ptr(), n_clients,
                      inv.data_ptr(), eta.data_ptr(), w.numel(),
                      *(o.data_ptr() for o in outs), _build.stream_of(w))
    LAUNCHES["fedsgd_aggregate_weighted"] += 1
    return tuple(outs)


def fedsgd_aggregate(w, grads, eta):
    """Unweighted eqs. (6)-(7) fused: (w', g, step) from one pass.

    Replaces ``repro/kernels/pruning_mask.py::fedsgd_aggregate``. w: [R,L];
    grads: [C,R,L]; eta: host scalar. g = (g[0] + ... + g[C-1]) *
    float32(1/C), rounded op by op in the order the xla mirror writes
    (step = eta * g, w' = w - step). Bound by bytes:
    reads w and C gradients, writes three buffers."""
    if not w.is_cuda:
        return fedsgd_aggregate_plain(w, grads, eta)
    from repro_torch.kernels import _build
    shape = _packed_shape(w)
    n_clients = int(grads.shape[0])
    if n_clients < 1:
        raise ValueError("need at least one client gradient")
    _check("w", w, shape, w.device)
    _check("grads", grads, (n_clients,) + shape, w.device)
    outs = [torch.empty(shape, dtype=torch.float32, device=w.device)
            for _ in range(3)]
    with torch.cuda.device(w.device):
        _build.launch("fedsgd_aggregate", w.data_ptr(), grads.data_ptr(),
                      n_clients, float(np.float32(1.0 / n_clients)),
                      float(np.float32(eta)), w.numel(),
                      *(o.data_ptr() for o in outs), _build.stream_of(w))
    LAUNCHES["fedsgd_aggregate"] += 1
    return tuple(outs)


def masked_update_2d(w, g, mask, eta):
    """Fused (w - eta*g) * mask on one packed buffer.

    Replaces ``repro/kernels/pruning_mask.py::masked_update_2d``. w, g,
    mask: [R, 128*k] fp32; eta: host scalar. Bound by bytes: 3 reads and 1
    write of one buffer."""
    if not w.is_cuda:
        return masked_update_plain(w, g, mask, eta)
    from repro_torch.kernels import _build
    shape = _packed_shape(w)
    for nm, t in (("w", w), ("g", g), ("mask", mask)):
        _check(nm, t, shape, w.device)
    out = torch.empty(shape, dtype=torch.float32, device=w.device)
    with torch.cuda.device(w.device):
        _build.launch("masked_update", w.data_ptr(), g.data_ptr(),
                      mask.data_ptr(), float(np.float32(eta)), w.numel(),
                      out.data_ptr(), _build.stream_of(w))
    LAUNCHES["masked_update_2d"] += 1
    return out


def client_rank_sort(grads, cweights):
    """Per-coordinate stable sort of a [C, R, 128*k] stack along clients.

    Replaces ``repro/kernels/pruning_mask.py::client_rank_sort``, the first
    stage of the coordinate-wise median and the trimmed mean. cweights: [C]
    fp32 on the device; a client whose weight is not > 0 sorts last. Any C
    runs in the kernel: up to 32 in registers, beyond that over an int32
    key scratch the wrapper allocates. Bound by bytes: one read and one
    write of the stack."""
    if not grads.is_cuda:
        return client_rank_sort_plain(grads, cweights)
    from repro_torch.kernels import _build
    if grads.ndim != 3 or grads.shape[0] < 1:
        raise ValueError(f"expected a [C >= 1, R, {LANES}*k] stack, "
                         f"got {tuple(grads.shape)}")
    shape = _packed_shape(grads[0])
    n_clients = int(grads.shape[0])
    _check("grads", grads, (n_clients,) + shape, grads.device, vector=False)
    _check("cweights", cweights, (n_clients,), grads.device, vector=False)
    out = torch.empty_like(grads)
    n = shape[0] * shape[1]
    keys = (torch.empty((n_clients,) + shape, dtype=torch.int32,
                        device=grads.device) if n_clients > 32 else None)
    with torch.cuda.device(grads.device):
        _build.launch("client_rank_sort", grads.data_ptr(),
                      cweights.data_ptr(), n_clients, n, out.data_ptr(),
                      None if keys is None else keys.data_ptr(),
                      _build.stream_of(grads))
    LAUNCHES["client_rank_sort"] += 1
    return out


def _hist_state(device: torch.device, stream: int) -> torch.Tensor:
    """The histogram's state for one stream of one device, made (zeroed, on
    that stream) at its first call there."""
    t = _HIST_STATE.get((device, stream))
    if t is None:
        t = torch.zeros(257, dtype=torch.int32, device=device)
        _HIST_STATE[(device, stream)] = t
    return t


def exponent_histogram(q, prunable):
    """256 int32 bins of the fp32 exponent byte over prunable coordinates.

    Replaces ``repro/kernels/pruning_mask.py::exponent_histogram``: the
    coarse pass of ``kth_smallest_threshold(coarse="histogram")``.
    q, prunable: [R, 128*k] fp32 -> [256] int32. One launch: each block
    adds its bins to an accumulator, and the block that takes the last
    ticket of a counter moves them to the output and zeroes the accumulator
    (no fill). Accumulator and counter belong to the current stream of q's
    device, so calls in flight on two streams never meet. Bound by bytes: 2
    reads of one buffer."""
    if not q.is_cuda:
        return exponent_histogram_plain(q, prunable)
    from repro_torch.kernels import _build
    shape = _packed_shape(q)
    _check("q", q, shape, q.device)
    _check("prunable", prunable, shape, q.device)
    n = shape[0] * shape[1]
    hist = torch.empty(256, dtype=torch.int32, device=q.device)
    with torch.cuda.device(q.device):
        stream = _build.stream_of(q)
        _build.launch("exponent_histogram", q.data_ptr(),
                      prunable.data_ptr(), n,
                      _hist_state(q.device, stream).data_ptr(),
                      hist.data_ptr(), stream)
    LAUNCHES["exponent_histogram"] += 1
    return hist
