"""The paper's MNIST models (LeNet, mlp-edge) over parameter dicts."""
from repro_torch.models.cnn import (
    lenet_init, lenet_apply, mlp_edge_init, mlp_edge_apply,
    make_loss_fn, make_weighted_loss_fn, make_eval_fn,
)

__all__ = [
    "lenet_init", "lenet_apply", "mlp_edge_init", "mlp_edge_apply",
    "make_loss_fn", "make_weighted_loss_fn", "make_eval_fn",
]
