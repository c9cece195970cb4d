"""The paper's evaluation models as functions of parameter trees (the port
of ``repro/models/cnn.py``): LeNet and mlp-edge for MNIST, ResNet-CIFAR
for CIFAR-10.

Layouts are the JAX package's: images NHWC, conv weights HWIO, dense
weights [in, out], so the parameter trees (and their packed layout) are
the JAX package's leaf for leaf. LeNet's convolution is the same stride-1
SAME im2col GEMM and its pooling the same reshape max-pool; the GEMMs go to
`torch.matmul`, as the JAX package leaves them to XLA. ResNet's
convolutions go to cuDNN (`F.conv2d`) as the JAX package's go to
`lax.conv_general_dilated`, in NCHW inside the network, with XLA's SAME
padding stated explicitly: a stride-2 3x3 convolution on an even input
pads one row and column after and none before, which `padding=1` would
not. Their gradients are taken under `device.exact_fp32` (fp32,
deterministic cuDNN algorithms), so every path gives the same bits.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import exact_fp32, resolve_device
from repro_torch.models.layers import dense_init

# a tree of tensors: a flat dict (LeNet, mlp-edge) or nested (ResNet)
Params = dict


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
# ResNet-CIFAR (depth = 6n+2) with scale/shift instance norms and no
# running statistics, the JAX package's functional variant
# ---------------------------------------------------------------------------

def resnet_init(gen: torch.Generator, *, depth: int = 20,
                num_classes: int = 10, in_channels: int = 3, width: int = 16,
                device=None):
    """ResNet-CIFAR parameters from `gen`, on `device` (None: CUDA): the JAX
    package's tree ({"stem", "blocks": [block dicts], "head", "head_b"}),
    shapes and draw order. A block whose channels change (stride 2) carries
    a 1x1 projection "proj"."""
    if (depth - 2) % 6:
        raise ValueError("CIFAR ResNet depth must be 6n+2")
    device = resolve_device(device)
    n = (depth - 2) // 6
    z = dict(dtype=torch.float32, device=device)
    params: dict = {"stem": _conv_init(gen, (3, 3, in_channels, width),
                                       device)}
    chans = [width, 2 * width, 4 * width]
    blocks = []
    c_in = width
    for stage, c_out in enumerate(chans):
        for b in range(n):
            stride = 2 if (stage > 0 and b == 0) else 1
            blk = {
                "conv1": _conv_init(gen, (3, 3, c_in, c_out), device),
                "conv2": _conv_init(gen, (3, 3, c_out, c_out), device),
                "scale1": torch.ones((c_out,), **z),
                "bias1": torch.zeros((c_out,), **z),
                "scale2": torch.ones((c_out,), **z),
                "bias2": torch.zeros((c_out,), **z),
            }
            if stride != 1 or c_in != c_out:
                blk["proj"] = _conv_init(gen, (1, 1, c_in, c_out), device)
            blocks.append(blk)
            c_in = c_out
    params["blocks"] = blocks
    params["head"] = dense_init(gen, chans[-1], (chans[-1], num_classes),
                                device=device)
    params["head_b"] = torch.zeros((num_classes,), **z)
    return params


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the output is ceil(size /
    stride), the padding its total need, the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """SAME convolution of NCHW `x` with an HWIO weight, as
    `lax.conv_general_dilated(..., "SAME")` computes it: symmetric padding
    goes to cuDNN, any other (a stride-2 3x3 on an even input: 0 before, 1
    after) is padded explicitly."""
    kh, kw = int(w.shape[0]), int(w.shape[1])
    ph = _same_pads(int(x.shape[2]), kh, stride)
    pw = _same_pads(int(x.shape[3]), kw, stride)
    w = w.permute(3, 2, 0, 1)                       # HWIO -> OIHW
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    return F.conv2d(F.pad(x, (pw[0], pw[1], ph[0], ph[1])), w, stride=stride)


def _norm_act(x, scale, bias):
    """relu((x - mean) / sqrt(var + 1e-5) * scale + bias) over each
    image's spatial dims (NCHW), the population variance as jnp.var."""
    mu = x.mean(dim=(2, 3), keepdim=True)
    d = x - mu
    var = (d * d).mean(dim=(2, 3), keepdim=True)
    return torch.relu(d / torch.sqrt(var + 1e-5) * scale[:, None, None]
                      + bias[:, None, None])


def resnet_apply(params, x: torch.Tensor) -> torch.Tensor:
    x = _conv(x.permute(0, 3, 1, 2).contiguous(), params["stem"])
    for blk in params["blocks"]:
        # the stride follows from the weights, as in the JAX package
        stride = 2 if blk["conv1"].shape[2] != blk["conv1"].shape[3] else 1
        h = _norm_act(_conv(x, blk["conv1"], stride),
                      blk["scale1"], blk["bias1"])
        h = _conv(h, blk["conv2"])
        sc = _conv(x, blk["proj"], stride) if "proj" in blk else x
        x = torch.relu(_norm_act(h, blk["scale2"], blk["bias2"]) + sc)
    x = x.mean(dim=(2, 3))
    return x @ params["head"] + params["head_b"]


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
    @exact_fp32()
    def eval_fn(params):
        losses, accs = [], []
        for i in range(0, len(y_test), batch):
            xb, yb = x_test[i:i + batch], y_test[i:i + batch]
            logits = apply_fn(params, xb)
            losses.append(float(_per_sample_ce(logits, yb).mean()))
            accs.append(float((logits.argmax(-1) == yb).float().mean()))
        return float(np.mean(losses)), float(np.mean(accs))

    return eval_fn
