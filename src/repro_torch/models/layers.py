"""Init helpers shared by the port's models (``repro/models/layers.py``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def dense_init(gen: torch.Generator, fan_in: int, shape,
               device=None) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), the JAX package's distribution. The numbers
    differ from jax.random's; tests that compare the two packages start
    both from JAX's parameters (repro_torch.convert). device=None means
    CUDA (`resolve_device`)."""
    device = resolve_device(device)
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
    return (w * scale).to(device=device)
