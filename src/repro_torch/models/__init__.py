"""The paper's models (LeNet and mlp-edge for MNIST, ResNet-CIFAR) over
parameter trees, and the language-model stack for serving (`transformer`,
dense and ssm families)."""
from repro_torch.models.blocks import Runtime
from repro_torch.models.cnn import (
    lenet_init, lenet_apply, mlp_edge_init, mlp_edge_apply, resnet_init,
    resnet_apply, make_loss_fn, make_weighted_loss_fn, make_eval_fn,
)
from repro_torch.models.transformer import (
    init_params, init_cache, forward, prefill, decode_step,
)

__all__ = [
    "lenet_init", "lenet_apply", "mlp_edge_init", "mlp_edge_apply",
    "resnet_init", "resnet_apply",
    "make_loss_fn", "make_weighted_loss_fn", "make_eval_fn",
    "Runtime", "init_params", "init_cache", "forward", "prefill",
    "decode_step",
]
