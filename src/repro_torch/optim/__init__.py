"""Optimizers (the port of ``repro/optim``): SGD, momentum-SGD, Adam.

Each optimizer is a pair (init_fn, update_fn) over parameter trees of
tensors (repro_torch/tree.py), in the functional style:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)
"""
from repro_torch.optim.optimizers import (
    Optimizer, sgd, momentum, adam, apply_updates, clip_by_global_norm,
    global_norm,
)

__all__ = ["Optimizer", "sgd", "momentum", "adam", "apply_updates",
           "clip_by_global_norm", "global_norm"]
