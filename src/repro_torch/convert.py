"""Carry parameters exported as numpy into the port.

The JAX package initialises its models with ``jax.random``, whose numbers
torch cannot reproduce. A caller that wants both packages to start from the
same weights exports the JAX parameter dict as numpy arrays
(``{k: np.asarray(v) for k, v in params.items()}``) and hands it here.
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree) -> dict[str, torch.Tensor]:
    """{name: array} -> {name: CPU tensor holding a copy, dtype kept}."""
    return {str(k): torch.from_numpy(np.array(v, copy=True))
            for k, v in tree.items()}
