"""Shared layers and init helpers (the port of ``repro/models/layers.py``).

Everything is functional: parameters are plain dicts of tensors and the
layer functions take them as arguments. Weights stacked over layers carry
a leading [L] axis; the caller indexes a layer out of them (a Python loop
over layers takes the place of ``lax.scan``).

Initialisation draws from an explicit ``torch.Generator`` on the
generator's own device, so a generator on the card draws a full-width
model there. The numbers differ from ``jax.random``'s; tests that compare
the two packages start both from JAX's parameters (``repro_torch.convert``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device


# -- init ---------------------------------------------------------------------

def _normal(gen: torch.Generator, shape, scale: float, dtype, device):
    if device.type == "meta":       # shapes only (transformer.param_count)
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    w = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=gen.device)
    # scaled in place: one fp32 draw at a time beside the tree (an expert
    # leaf of arctic-480b draws 17.8 GB; `w * scale` held two)
    return w.mul_(scale).to(device=device, dtype=dtype)


def dense_init(gen: torch.Generator, fan_in: int, shape, device=None,
               dtype=torch.float32) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), the JAX package's distribution, drawn in
    fp32 and cast to `dtype`. device=None means CUDA (`resolve_device`)."""
    scale = 1.0 / np.sqrt(max(fan_in, 1))
    return _normal(gen, shape, scale, dtype, resolve_device(device))


def embed_init(gen: torch.Generator, shape, dtype, device=None) -> torch.Tensor:
    """normal * 0.02, drawn in fp32 and cast to `dtype`."""
    return _normal(gen, shape, 0.02, dtype, resolve_device(device))


# -- norms --------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale), in fp32, cast back."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps) * scale.float() + bias.float()
    return out.to(x.dtype)


# -- rotary embeddings --------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    """[head_dim/2] inverse frequencies."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate interleaved pairs (x[..., 0::2], x[..., 1::2]), as the JAX
    package does (not the half-split of some other codebases).
    x: [..., S, H, D]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    inv = rope_frequencies(d, theta, device=x.device)
    ang = positions[..., :, None, None].float() * inv     # [.., S, 1, D/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., 0::2], x[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# -- soft capping (gemma2) ----------------------------------------------------

def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x / cap)).to(x.dtype)


# -- MLPs ---------------------------------------------------------------------

def gated_mlp_params(gen, d_model: int, d_ff: int, dtype, *, stacked: int = 0,
                     device=None) -> dict:
    """SwiGLU weights: w_gate, w_up [D, F], w_down [F, D]."""
    lead = (stacked,) if stacked else ()
    return {
        "w_gate": dense_init(gen, d_model, (*lead, d_model, d_ff), device,
                             dtype),
        "w_up": dense_init(gen, d_model, (*lead, d_model, d_ff), device,
                           dtype),
        "w_down": dense_init(gen, d_ff, (*lead, d_ff, d_model), device,
                             dtype),
    }


def gated_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """silu(x @ w_gate) * (x @ w_up) @ w_down, the silu in fp32."""
    g = x @ p["w_gate"]
    u = x @ p["w_up"]
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"]


def mlp_params(gen, d_model: int, d_ff: int, dtype, *, stacked: int = 0,
               device=None) -> dict:
    """Plain 2-layer GELU MLP (whisper)."""
    lead = (stacked,) if stacked else ()
    device = resolve_device(device)
    return {
        "w_in": dense_init(gen, d_model, (*lead, d_model, d_ff), device,
                           dtype),
        "b_in": torch.zeros((*lead, d_ff), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_ff, (*lead, d_ff, d_model), device,
                            dtype),
        "b_out": torch.zeros((*lead, d_model), dtype=dtype, device=device),
    }


def mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """GELU MLP; jax.nn.gelu's default is the tanh approximation."""
    h = x @ p["w_in"] + p["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ p["w_out"] + p["b_out"]
