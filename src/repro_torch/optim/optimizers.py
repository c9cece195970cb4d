"""Functional optimizers over parameter trees (the port of
``repro/optim/optimizers.py``: the same names, the same arithmetic).

Trees are nested dicts and lists of tensors (repro_torch/tree.py); every
function returns new tensors and leaves its inputs as they are.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the sum over leaves of sum(x^2), in fp32."""
    sq = [torch.sum(torch.square(x.float())) for x in leaves(tree)]
    return torch.sqrt(sum(sq)) if sq else torch.zeros(())


def clip_by_global_norm(tree: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), tree)


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr: float) -> Optimizer:
    """Plain SGD: the paper's FedSGD server update (eq. 7)."""
    def init(params):
        return ()

    def update(grads, state, params=None):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer(init, update)


def momentum(lr: float, beta: float = 0.9,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params=None):
        new_v = tree_map(lambda v, g: beta * v + g, state, grads)
        if nesterov:
            upd = tree_map(lambda v, g: -lr * (beta * v + g), new_v, grads)
        else:
            upd = tree_map(lambda v: -lr * v, new_v)
        return upd, new_v

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam with fp32 moments and an int32 step count t."""
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    def init(params):
        dev = leaves(params)[0].device if leaves(params) else None
        return {"mu": tree_map(zeros32, params),
                "nu": tree_map(zeros32, params),
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params=None):
        t = state["t"] + 1
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state["mu"], grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * torch.square(
            g.float()), state["nu"], grads)
        bc1 = 1 - b1 ** t.float()
        bc2 = 1 - b2 ** t.float()

        def upd(m, n, p):
            step = -lr * (m / bc1) / (torch.sqrt(n / bc2) + eps)
            if weight_decay:
                step = step - lr * weight_decay * p.float()
            return step

        if params is None:
            params = tree_map(torch.zeros_like, mu)
        return tree_map(upd, mu, nu, params), {"mu": mu, "nu": nu, "t": t}

    return Optimizer(init, update)
