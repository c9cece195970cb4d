"""Synthetic class-conditional image datasets (MNIST-/CIFAR-shaped).

The container is offline (no MNIST/CIFAR binaries), so the paper's datasets
are replaced by *learnable* synthetic classification problems with the same
tensor shapes and class counts (DESIGN.md §7). Each class is a mixture of
smooth random template images plus noise; difficulty is controlled by the
template-to-noise ratio, giving non-trivial accuracy curves that separate the
six benchmark schemes.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    x_train: np.ndarray  # [N, H, W, C] float32 in [0, 1]
    y_train: np.ndarray  # [N] int32
    x_test: np.ndarray
    y_test: np.ndarray
    num_classes: int
    name: str

    @property
    def image_shape(self) -> tuple[int, int, int]:
        return self.x_train.shape[1:]


def _smooth_templates(
    n_classes: int, shape: tuple[int, int, int], n_templates: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Per-class smooth random images: low-frequency Fourier noise."""
    h, w, c = shape
    fy = np.fft.fftfreq(h)[:, None]
    fx = np.fft.fftfreq(w)[None, :]
    lowpass = 1.0 / (1.0 + 64.0 * (fy**2 + fx**2))
    t = rng.normal(size=(n_classes, n_templates, h, w, c))
    spec = np.fft.fft2(t, axes=(2, 3)) * lowpass[None, None, :, :, None]
    img = np.real(np.fft.ifft2(spec, axes=(2, 3)))
    img -= img.min(axis=(2, 3, 4), keepdims=True)
    img /= img.max(axis=(2, 3, 4), keepdims=True) + 1e-9
    return img.astype(np.float32)


def make_dataset(
    name: str = "synthetic-mnist",
    *,
    n_train: int = 6000,
    n_test: int = 1000,
    noise: float = 0.35,
    seed: int = 0,
) -> SyntheticImageDataset:
    """Build a synthetic dataset. Names: synthetic-mnist | synthetic-cifar10."""
    shapes = {
        "synthetic-mnist": (28, 28, 1),
        "synthetic-cifar10": (32, 32, 3),
    }
    if name not in shapes:
        raise ValueError(f"unknown dataset {name!r}; options: {sorted(shapes)}")
    shape = shapes[name]
    n_classes = 10
    rng = np.random.default_rng(seed)
    templates = _smooth_templates(n_classes, shape, n_templates=4, rng=rng)

    def sample(n: int) -> tuple[np.ndarray, np.ndarray]:
        y = rng.integers(0, n_classes, size=n)
        t_idx = rng.integers(0, templates.shape[1], size=n)
        mix = rng.uniform(0.6, 1.0, size=(n, 1, 1, 1)).astype(np.float32)
        x = mix * templates[y, t_idx] + noise * rng.normal(
            size=(n, *shape)).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = sample(n_train)
    x_te, y_te = sample(n_test)
    # standardize with train statistics: plain (Fed)SGD on the unnormalized
    # low-contrast images stalls (conditioning), matching how the paper's
    # MNIST/CIFAR pipelines normalize inputs
    mu, sd = x_tr.mean(), x_tr.std() + 1e-8
    x_tr = (x_tr - mu) / sd
    x_te = (x_te - mu) / sd
    return SyntheticImageDataset(x_tr, y_tr, x_te, y_te, n_classes, name)
