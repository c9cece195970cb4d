"""The port's device rule: entry points run on CUDA unless told otherwise;
and the numerics the models' gradients are taken under."""
from __future__ import annotations

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """None means CUDA, which must then be available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no CUDA device is "
                "available; pass device='cpu' to run on the CPU")
        device = "cuda"
    return torch.device(device)


@contextlib.contextmanager
def exact_fp32():
    """fp32 convolutions on cuDNN's deterministic algorithms, whatever the
    caller's global flags: TF32 off (through the convolution's own
    precision setting; mixing it with the legacy `allow_tf32` flag makes
    torch raise), no benchmarking (its choice can vary between calls),
    deterministic kernels only. The round engine and the trainer hold it
    around a loss and its `autograd.grad`, so ResNet's forward and
    backward give the same bits on every path (the autograd thread reads
    these process-wide flags while the block runs); the previous flags
    come back on exit."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
             cudnn.conv.fp32_precision)
    cudnn.enabled, cudnn.benchmark, cudnn.deterministic = True, False, True
    cudnn.conv.fp32_precision = "ieee"
    try:
        yield
    finally:
        (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
         cudnn.conv.fp32_precision) = saved
