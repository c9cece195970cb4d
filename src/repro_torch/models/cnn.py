"""The paper's MNIST models, LeNet and mlp-edge, as functions of parameter
dicts (the port of ``repro/models/cnn.py``; ResNet is not ported yet).

Layouts are the JAX package's: images NHWC, conv weights HWIO, dense
weights [in, out]. The convolution is the same stride-1 SAME im2col GEMM
and the pooling the same reshape max-pool, so the port computes the same
function with the same shapes; the GEMMs go to `torch.matmul`, as the JAX
package leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init

Params = dict[str, torch.Tensor]


def _conv_init(gen, shape, device=None):
    fan_in = int(np.prod(shape[:-1]))
    return dense_init(gen, fan_in, shape, device=device)


def _conv_im2col(x, w):
    """Stride-1 SAME conv as shifted-slice patches + one GEMM (NHWC, HWIO)."""
    kh, kw, cin, cout = w.shape
    b, h, wd, _ = x.shape
    # XLA SAME padding: (k-1)//2 low, k//2 high; F.pad lists the last dim first
    xp = F.pad(x, (0, 0, (kw - 1) // 2, kw // 2, (kh - 1) // 2, kh // 2))
    cols = [xp[:, i:i + h, j:j + wd, :]
            for i in range(kh) for j in range(kw)]
    patches = torch.cat(cols, dim=-1)               # [B, H, W, kh*kw*cin]
    return patches @ w.reshape(kh * kw * cin, cout)


def _max_pool_2x2(x):
    """2x2/stride-2 VALID max pool via reshape (even spatial dims only)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


# ---------------------------------------------------------------------------
# LeNet-5 (28x28x1 -> 10)
# ---------------------------------------------------------------------------

def lenet_init(gen: torch.Generator, *, num_classes: int = 10,
               in_channels: int = 1, device=None) -> Params:
    """LeNet-5 parameters from `gen`, on `device` (None: CUDA)."""
    device = resolve_device(device)
    z = dict(dtype=torch.float32, device=device)
    return {
        "conv1": _conv_init(gen, (5, 5, in_channels, 6), device),
        "conv2": _conv_init(gen, (5, 5, 6, 16), device),
        "fc1": dense_init(gen, 784, (7 * 7 * 16, 120), device=device),
        "b1": torch.zeros((120,), **z),
        "fc2": dense_init(gen, 120, (120, 84), device=device),
        "b2": torch.zeros((84,), **z),
        "fc3": dense_init(gen, 84, (84, num_classes), device=device),
        "b3": torch.zeros((num_classes,), **z),
    }


def lenet_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(_conv_im2col(x, params["conv1"]))
    x = _max_pool_2x2(x)
    x = torch.relu(_conv_im2col(x, params["conv2"]))
    x = _max_pool_2x2(x)
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"] + params["b1"])
    x = torch.relu(x @ params["fc2"] + params["b2"])
    return x @ params["fc3"] + params["b3"]


# ---------------------------------------------------------------------------
# mlp-edge: a two-layer MLP (~100k params) over flattened images
# ---------------------------------------------------------------------------

def mlp_edge_init(gen: torch.Generator, *, hidden: int = 128,
                  num_classes: int = 10, in_dim: int = 784,
                  device=None) -> Params:
    """mlp-edge parameters from `gen`, on `device` (None: CUDA)."""
    device = resolve_device(device)
    z = dict(dtype=torch.float32, device=device)
    return {"fc1": (torch.randn((in_dim, hidden), generator=gen) * 0.05
                    ).to(device),
            "b1": torch.zeros((hidden,), **z),
            "fc2": (torch.randn((hidden, num_classes), generator=gen) * 0.05
                    ).to(device),
            "b2": torch.zeros((num_classes,), **z)}


def mlp_edge_apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = x.reshape(x.shape[0], -1)
    x = torch.relu(x @ params["fc1"] + params["b1"])
    return x @ params["fc2"] + params["b2"]


# ---------------------------------------------------------------------------
# Shared loss / eval helpers
# ---------------------------------------------------------------------------

def _per_sample_ce(logits, y):
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return lse - gold


def make_loss_fn(apply_fn):
    """Mean cross-entropy. The mean is sum/B with B a device tensor, the
    same division the weighted form does, so the two agree bit for bit at
    sw = 1 (value and gradient) on every device."""
    def loss(params, x, y):
        ce = _per_sample_ce(apply_fn(params, x), y)
        return ce.sum() / ce.new_full((), float(ce.shape[0]))
    loss.weighted = make_weighted_loss_fn(apply_fn)
    return loss


def make_weighted_loss_fn(apply_fn):
    """Mean CE with per-sample weights: sum(sw * ce) / sum(sw). Zero-weight
    samples (the padding of a ragged client batch) drop out of the value
    and the gradient exactly."""
    def loss(params, x, y, sw):
        ce = _per_sample_ce(apply_fn(params, x), y)
        return (ce * sw).sum() / sw.sum()
    return loss


def make_eval_fn(apply_fn, x_test, y_test, batch: int = 500, device=None):
    """eval_fn(params) -> (mean test loss, mean test accuracy), averaged over
    batches of `batch` as the JAX package does. The test set lives on
    `device` (None: CUDA)."""
    device = resolve_device(device)
    x_test = torch.as_tensor(np.asarray(x_test), device=device)
    y_test = torch.as_tensor(np.asarray(y_test), device=device).long()

    @torch.no_grad()
    def eval_fn(params):
        losses, accs = [], []
        for i in range(0, len(y_test), batch):
            xb, yb = x_test[i:i + batch], y_test[i:i + batch]
            logits = apply_fn(params, xb)
            losses.append(float(_per_sample_ce(logits, yb).mean()))
            accs.append(float((logits.argmax(-1) == yb).float().mean()))
        return float(np.mean(losses)), float(np.mean(accs))

    return eval_fn
