"""Carry parameters exported as numpy into the port.

The JAX package initialises its models with ``jax.random``, whose numbers
torch cannot reproduce. A caller that wants both packages to start from the
same weights exports the JAX parameter tree as numpy arrays
(``jax.tree.map(np.asarray, params)``: a flat dict for LeNet, nested dicts
and lists for ResNet) and hands it to `params_from_numpy`; the LM stack's
nested, layer-stacked trees (parameters and caches, bfloat16 among them)
go through `lm_params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree):
    """A tree of arrays (nested dicts and lists) -> the same nesting of CPU
    tensors, each holding a copy, dtype kept."""
    if isinstance(tree, dict):
        return {str(k): params_from_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v) for v in tree]
    return torch.from_numpy(np.array(tree, copy=True))


def _tensor(a) -> torch.Tensor:
    """One array as a CPU tensor. bfloat16 arrays (ml_dtypes.bfloat16,
    which torch.from_numpy refuses) travel as their uint16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a.view(np.uint16), copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_numpy(tree):
    """A nested dict of arrays (an LM parameter or cache tree, exported
    with ``jax.tree.map(np.asarray, tree)``) -> the same nesting of CPU
    tensors, dtype kept, like `params_from_numpy`; a caller that wants the
    card moves them with ``.to``."""
    if isinstance(tree, dict):
        return {str(k): lm_params_from_numpy(v) for k, v in tree.items()}
    return _tensor(tree)
