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
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels.pruning_mask import FLT_MIN, importance
from repro_torch.tree import flatten_with_path, tree_map, unflatten

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


def taylor_importance(params: Params, grads: Params) -> Params:
    """Eq. (4): Q = (v * rho)^2, elementwise over every leaf."""
    return tree_map(importance, params, grads)


@dataclasses.dataclass(frozen=True)
class PruneSpec:
    """Which tensors may be pruned."""

    prunable: Callable[[str], bool] = default_prunable


def global_threshold(importance: Params, lam: float,
                     spec: PruneSpec = PruneSpec()) -> float:
    """k-th smallest importance over all prunable leaves, k = lam * M_prunable,
    nudged one fp32 ulp up: exactly k entries are strictly below it."""
    if not (0.0 <= lam < 1.0):
        raise ValueError(f"lambda must be in [0,1), got {lam}")
    vals = [v.detach().float().cpu().numpy().ravel()
            for pth, v in flatten_with_paths(importance) if spec.prunable(pth)]
    if not vals or lam == 0.0:
        return -np.inf
    allv = np.concatenate(vals)
    k = int(np.floor(lam * allv.size))
    if k <= 0:
        return -np.inf
    # threshold such that exactly k entries are strictly below it
    part = np.partition(allv, k - 1)
    return float(np.nextafter(part[k - 1], np.float32(np.inf)))


def _daz_scalar(thr: float) -> float:
    t = float(np.float32(thr))
    return 0.0 if abs(t) < FLT_MIN else t


def build_masks(importance: Params, lam: float,
                spec: PruneSpec = PruneSpec()) -> Params:
    """Binary {0,1} masks: 0 = pruned. Non-prunable leaves get all-ones.
    The compare is q >= daz(thr), as the JAX reference evaluates it."""
    thr = global_threshold(importance, lam, spec)
    thr_d = None if thr == -np.inf else _daz_scalar(thr)
    masks = [torch.ones_like(q, dtype=torch.float32)
             if thr_d is None or not spec.prunable(pth)
             else (q >= thr_d).float()
             for pth, q in flatten_with_path(importance)]
    return unflatten(importance, masks)


def apply_masks(params: Params, masks: Params) -> Params:
    """w~ = w * mask (pruned model of eq. (2))."""
    return tree_map(lambda w, m: w * m.to(w.dtype), params, masks)
