"""Packed-buffer entry points of the round engine (core/packing.py layout).

Each entry point calls its wrapper in kernels/pruning_mask.py, which
launches the hand-written Hopper kernel on CUDA tensors and runs the plain
PyTorch version (bit-identical to the kernel) on CPU tensors. ``impl``
mirrors ``repro/kernels/ops.py`` and only checks that choice:

  * "auto"  — whatever the tensors' device gives;
  * "cuda"  — the kernel; raises on a CPU tensor;
  * "torch" — the plain version; raises on a CUDA tensor.

The quarantine, the weighted sum and the mean-update tail are plain torch
in both packages' non-kernel paths; eager torch rounds every op on its own,
so the FedSGD step's ``eta * g`` is never FMA-contracted with the
subtraction (the fence ``repro/kernels/ops._rounded_product`` builds inside
a jitted graph is implicit here).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import pruning_mask as _pm

# q = (w*v)^2 with denormals zero: the round engine's threshold input
importance = _pm.importance


def _check_impl(impl: str, t: torch.Tensor) -> None:
    if impl not in ("auto", "cuda", "torch"):
        raise ValueError(f"unknown impl {impl!r}")
    if impl != "auto" and impl != ("cuda" if t.is_cuda else "torch"):
        raise ValueError(f"impl={impl!r} does not run on {t.device} tensors "
                         "('cuda' needs CUDA tensors, 'torch' CPU tensors)")


def packed_importance_mask(w, v, prunable, threshold, *, impl="auto"):
    """Shared-threshold path: (importance fp32, mask fp32), both [R, 128];
    protected/padding coordinates (prunable == 0) are always kept."""
    _check_impl(impl, w)
    return _pm.importance_mask_2d(w, v, prunable, threshold)


def packed_importance_masks(w, v, prunable, thresholds, *, impl="auto"):
    """Per-client-threshold path: (importance [R,128], masks [C,R,128])."""
    _check_impl(impl, w)
    return _pm.importance_mask_batched(w, v, prunable, thresholds)


def packed_exponent_histogram(q, prunable, *, impl="auto"):
    """256-bin histogram of fp32 exponent bytes over valid coordinates —
    the coarse first pass of ``kth_smallest_threshold(coarse="histogram")``."""
    _check_impl(impl, q)
    return _pm.exponent_histogram(q, prunable)


def packed_fedsgd_update_weighted(w, grads, cweights, inv, eta, *,
                                  impl="auto"):
    """Weighted eqs. (6)-(7): g = (sum_c cw[c]*grads[c]) * inv, w' = w -
    eta*g, returning (w', g, step). inv and eta are fp32 scalar tensors on
    w's device (inv from the quarantine, never synced to the host)."""
    _check_impl(impl, w)
    return _pm.fedsgd_aggregate_weighted(w, grads, cweights, inv, eta)


# the plain tail pieces, as the JAX package's ops names them
packed_weighted_grad_sum = _pm.weighted_grad_sum
packed_apply_mean_update = _pm.apply_mean_update


def packed_client_quarantine(grads, cweights, inv):
    """Always-on non-finite upload guard over the stacked masked gradients
    [C, R, 128]: returns (cw_eff, inv_eff, n_ok, alive), all on the device.

    cw_eff zeroes non-finite clients; inv_eff passes the host `inv` through
    when nobody was quarantined and renormalizes to 1/n_ok otherwise (0
    when nobody survives); n_ok is the int32 survivor count; alive is False
    when no client survives (the caller then keeps (w, v) unchanged)."""
    cw = cweights.float()
    fin = torch.isfinite(grads).flatten(1).all(dim=1)
    cw_eff = cw * fin.float()
    n_w = cw.sum()
    n_ok = cw_eff.sum()
    inv_t = torch.as_tensor(inv, dtype=torch.float32, device=grads.device)
    inv_eff = torch.where(
        n_ok == n_w, inv_t,
        torch.where(n_ok > 0.0, 1.0 / torch.clamp(n_ok, min=1.0),
                    torch.zeros_like(n_ok)))
    return cw_eff, inv_eff, n_ok.int(), n_ok > 0.0
