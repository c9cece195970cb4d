"""The port's device rule: entry points run on CUDA unless told otherwise;
and the numerics the models' gradients are taken under."""
from __future__ import annotations

import contextlib
import threading

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


# exact_fp32's process-wide state: how many scopes are open (in any
# thread) and the caller's flags the first one saved
_FP32_LOCK = threading.Lock()
_fp32_depth = 0
_fp32_saved: tuple | None = None

# Held by every CUDA-graph capture (the eager round before it included) and
# by every copy issued on a side stream. Captures run in "thread_local"
# mode so that other threads may allocate and synchronise meanwhile; what
# they may not do is put work on the stream being captured, and torch hands
# out pooled streams, so two engines (or an engine and a cohort store's copy
# stream) can share one. Under this lock no two threads ever use such
# streams at once.
CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def exact_fp32():
    """fp32 convolutions on cuDNN's deterministic algorithms, whatever the
    caller's global flags: TF32 off (through the convolution's own
    precision setting; mixing it with the legacy `allow_tf32` flag makes
    torch raise), no benchmarking (its choice can vary between calls),
    deterministic kernels only. The round engine and the trainer hold it
    around a loss and its `autograd.grad`, so ResNet's forward and
    backward give the same bits on every path (the autograd thread reads
    these process-wide flags while the block runs).

    The flags are process-wide, and sweep workers run trainers in several
    threads, so the scope is counted: the first entry (in any thread)
    saves the caller's flags and sets them, the last exit restores them.
    A thread leaving while another is still inside leaves them set, so no
    worker ever runs a convolution under another's restored flags."""
    global _fp32_depth, _fp32_saved
    cudnn = torch.backends.cudnn
    with _FP32_LOCK:
        if _fp32_depth == 0:
            _fp32_saved = (cudnn.enabled, cudnn.benchmark,
                           cudnn.deterministic, cudnn.conv.fp32_precision)
            cudnn.enabled, cudnn.benchmark, cudnn.deterministic = \
                True, False, True
            cudnn.conv.fp32_precision = "ieee"
        _fp32_depth += 1
    try:
        yield
    finally:
        with _FP32_LOCK:
            _fp32_depth -= 1
            if _fp32_depth == 0:
                (cudnn.enabled, cudnn.benchmark, cudnn.deterministic,
                 cudnn.conv.fp32_precision) = _fp32_saved
                _fp32_saved = None
