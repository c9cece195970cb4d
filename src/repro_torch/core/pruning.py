"""Model pruning: importance scores (eq. 4) and mask construction.

The port of ``repro/core/pruning.py`` over parameter trees of tensors
(nested dicts and lists, repro_torch/tree.py). The paper prunes, per selected client and round, the fraction lambda_n of model
weights with the *lowest* first-order Taylor importance

    Q_{n,m} = (v_m^{(s-1)} * rho_{n,m}^{(s-1)})^2

(v = global gradient of weight m from the previous round, rho = the
weight). Masks are trees of {0,1} fp32 tensors congruent with the
parameters; only leaves whose path passes `PruneSpec.prunable` are masked.

Paths are the strings JAX's ``keystr`` gives, e.g. ``"['fc1']"`` or
``"['blocks'][0]['scale1']"``, taken in JAX's flatten order, so
`default_prunable` decides leaf for leaf as the JAX package does. Importance
and the mask compare follow the JAX reference's denormals-are-zero
semantics (kernels/pruning_mask.daz).

Importance keeps a leaf's type, as JAX's ``(w * g) ** 2`` does: a bf16
tree (the LM configs) has bf16 importance, and each leaf compares with the
threshold in bf16 (`global_threshold` says what that keeps). The k-th
smallest is found where the tree lies, without a sort: the values' bit
patterns, mapped to an order-preserving unsigned key, are counted in
65,536 bins (twice for fp32: the high, then the low 16 bits), so a
full-width model's importances never leave the card.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.pruning_mask import FLT_MIN, daz, importance
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

# a tree of tensors: nested dicts and lists (repro_torch/tree.py)
Params = dict

# Parameters whose leaf-path contains one of these substrings are never pruned.
PROTECTED_SUBSTRINGS = (
    "embed", "norm", "scale", "bias", "router", "gate_logit", "pos_emb",
    "a_log", "dt",  # SSM time-constant / decay params: tiny & dynamics-critical
)


def default_prunable(path: str) -> bool:
    p = path.lower()
    return not any(s in p for s in PROTECTED_SUBSTRINGS)


def keystr(name: str) -> str:
    """JAX ``keystr`` of a flat dict key: ``"['fc1']"``."""
    return f"[{name!r}]"


# (path, leaf) in JAX flatten order: dict keys sorted, lists by index
flatten_with_paths = flatten_with_path


_BF16 = torch.bfloat16
_CHUNK = 1 << 26          # values a counting pass reads at once


def _leaf_importance(w: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """(w * g)^2 in the promoted type of w and g: `importance` (fp32,
    denormals zero) unless that type is bf16, where the product and the
    square are each rounded to bf16 from their exact fp32 value, as XLA
    evaluates bf16 arithmetic."""
    if torch.promote_types(w.dtype, g.dtype) != _BF16:
        return importance(w, g)
    p = daz(w.float() * g.float()).to(_BF16).float()
    return daz(p * p).to(_BF16)


def taylor_importance(params: Params, grads: Params) -> Params:
    """Eq. (4): Q = (v * rho)^2, elementwise over every leaf, in each
    leaf's type."""
    return tree_map(_leaf_importance, params, grads)


def exact_importance(loss_fn: Callable[[Params], torch.Tensor],
                     params: Params) -> Params:
    """Eq. (3): Q_m = (L(w) - L(w|rho_m=0))^2, the O(M) oracle: one loss
    per scalar, so for tiny models (tests) only. fp32 scores."""
    base = float(loss_fn(params))
    flat = flatten_with_path(params)
    out = []
    for i, (_, leaf) in enumerate(flat):
        scores = np.zeros(leaf.numel(), dtype=np.float64)
        for j in range(leaf.numel()):
            pert = leaf.detach().clone().reshape(-1)
            pert[j] = 0.0
            new = [x for _, x in flat]
            new[i] = pert.reshape(leaf.shape)
            scores[j] = (base - float(loss_fn(unflatten(params, new)))) ** 2
        out.append(torch.from_numpy(scores.reshape(tuple(leaf.shape))).to(
            device=leaf.device, dtype=torch.float32))
    return unflatten(params, out)


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Which tensors may be pruned."""

    prunable: Callable[[str], bool] = default_prunable


def _order_keys(x: torch.Tensor) -> torch.Tensor:
    """Unsigned keys (int64) that sort as the values of x, a flat bf16 or
    fp32 tensor: the sign bit set on non-negatives, every bit flipped on
    negatives; NaN, any sign, maps to the largest key, as np.partition puts
    NaN last."""
    if x.dtype == _BF16:
        bits, top = x.view(torch.int16).long() & 0xFFFF, 1 << 15
    else:
        bits, top = x.view(torch.int32).long() & 0xFFFFFFFF, 1 << 31
    full = 2 * top - 1
    key = torch.where(bits >= top, full - bits, bits | top)
    return torch.where(torch.isnan(x), full, key)


def _from_key(key: int, dtype: torch.dtype) -> torch.Tensor:
    """The value (a 0-dim CPU tensor of `dtype`) whose `_order_keys` key
    is `key`; the largest key gives a NaN."""
    nbits = 16 if dtype == _BF16 else 32
    top = 1 << (nbits - 1)
    bits = key & (top - 1) if key & top else (2 * top - 1) - key
    signed = bits - 2 * top if bits >= top else bits
    itype = torch.int16 if nbits == 16 else torch.int32
    return torch.tensor(signed, dtype=itype).view(dtype)


def _select(counts: torch.Tensor, k: int) -> tuple[int, int]:
    """(bin holding the k-th smallest, rank of it inside that bin)."""
    cum = torch.cumsum(counts, 0)
    b = int(torch.searchsorted(cum, torch.tensor([k], device=cum.device)))
    below = int(cum[b - 1]) if b else 0
    return b, k - below


def _kth_smallest(vals: list, k: int, dtype: torch.dtype) -> torch.Tensor:
    """k-th smallest (1-based) of the values of `vals` cast to `dtype`,
    found by counting keys where the tensors lie (no sort, no host copy of
    the values): 65,536 bins of the key for bf16; for fp32 the high 16
    bits, then the low 16 of the keys in the chosen bin."""
    chunks = [c for v in vals for c in v.detach().to(dtype).reshape(-1)
              .split(_CHUNK)]
    dev = chunks[0].device

    def count(keys_of):
        hist = torch.zeros(1 << 16, dtype=torch.int64, device=dev)
        for c in chunks:
            keys = keys_of(_order_keys(c))
            if keys.numel():
                hist += torch.bincount(keys, minlength=1 << 16)
        return hist

    if dtype == _BF16:
        key, _ = _select(count(lambda key: key), k)
        return _from_key(key, dtype)
    hi, rank = _select(count(lambda key: key >> 16), k)
    lo, _ = _select(count(lambda key: key[(key >> 16) == hi] & 0xFFFF), rank)
    return _from_key(hi << 16 | lo, dtype)


def global_threshold(importance: Params, lam: float,
                     spec: PruneSpec = PruneSpec()) -> float:
    """k-th smallest importance over all prunable leaves, k = lam * M_prunable,
    nudged one fp32 ulp up: exactly k entries are strictly below it when
    they are fp32. The k-th smallest is taken in the importance type (the
    leaves' promoted type, as np.concatenate promotes them in the JAX
    package; fp32 for any type but bf16); the nudge is fp32's for
    every type, as the JAX package's np.nextafter has no bf16 loop and
    computes it in fp32. A bf16 leaf compares in bf16 (`build_masks`),
    where the nudged threshold rounds back to the k-th value, so bf16 ties
    with it are kept and fewer than k entries may be pruned."""
    if not (0.0 <= lam < 1.0):
        raise ValueError(f"lambda must be in [0,1), got {lam}")
    vals = [v for pth, v in flatten_with_paths(importance)
            if spec.prunable(pth)]
    if not vals or lam == 0.0:
        return -np.inf
    k = int(np.floor(lam * sum(v.numel() for v in vals)))
    if k <= 0:
        return -np.inf
    dtype = functools.reduce(torch.promote_types, [v.dtype for v in vals])
    if dtype != _BF16:
        dtype = torch.float32
    kth = _kth_smallest(vals, k, dtype).float()
    return float(torch.nextafter(kth, torch.tensor(np.inf)))


def _leaf_threshold(thr: float, dtype: torch.dtype) -> float:
    """thr rounded to a leaf's type (JAX compares a leaf with a weak-typed
    Python float in the leaf's type), denormals zero."""
    t = float(torch.tensor(thr, dtype=_BF16 if dtype == _BF16
                           else torch.float32))
    return 0.0 if abs(t) < FLT_MIN else t


def build_masks(importance: Params, lam: float,
                spec: PruneSpec = PruneSpec(),
                dtype: torch.dtype = torch.float32) -> Params:
    """Binary {0,1} masks: 0 = pruned. Non-prunable leaves get all-ones.
    The compare is q >= daz(thr) in q's type, as the JAX reference
    evaluates it. The masks are fp32, as the JAX package's are, unless
    `dtype` says otherwise: each leaf is made in it directly (uint8 for a
    full-width model's step: 1 byte a parameter, with no fp32 tree
    first)."""
    thr = global_threshold(importance, lam, spec)
    masks = [torch.ones_like(q, dtype=dtype)
             if thr == -np.inf or not spec.prunable(pth)
             else (q >= _leaf_threshold(thr, q.dtype)).to(dtype)
             for pth, q in flatten_with_path(importance)]
    return unflatten(importance, masks)


def apply_masks(params: Params, masks: Params) -> Params:
    """w~ = w * mask (pruned model of eq. (2))."""
    return tree_map(lambda w, m: w * m.to(w.dtype), params, masks)


def actual_ratio(masks: Params, spec: PruneSpec = PruneSpec()) -> float:
    """Realized pruning ratio lambda = pruned / prunable."""
    pruned = total = 0
    for pth, m in flatten_with_path(masks):
        if spec.prunable(pth):
            total += m.numel()
            pruned += int((m == 0).sum())
    return pruned / total if total else 0.0


def pruning_distortion(params: Params, masks: Params) -> tuple[float, float]:
    """(||w - w~||^2, ||w||^2) in fp64: Assumption 4's
    E||w - w~||^2 <= lambda * E||w||^2."""
    d2 = n2 = 0.0
    for w, m in zip(leaves(params), leaves(masks)):
        w, m = w.double(), m.double()
        d2 += float(((w * (1 - m)) ** 2).sum())
        n2 += float((w ** 2).sum())
    return d2, n2
