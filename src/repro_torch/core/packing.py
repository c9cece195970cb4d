"""Packed parameter buffers for the round engine.

The port of ``repro/core/packing.py``: `ParamPack` flattens a parameter dict
once into a single zero-padded ``[R, 128]`` fp32 buffer, recording per-leaf
offsets and shapes. Leaves go in JAX flatten order (dict keys sorted) and
paths are JAX ``keystr`` strings, so a packed buffer is coordinate for
coordinate the JAX package's (and `prunable_mask` decides the same way).

``unpack`` gives every leaf freshly allocated, contiguous storage (a clone
of its slice), which stays differentiable: gradients can be taken with
respect to the packed buffer. A leaf viewed at an odd offset of the buffer
could make cuBLAS pick another GEMM kernel than the reference backend's
fresh tensors get, and break the packed-vs-reference bit equality on the
card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning import PruneSpec, keystr

LANES = 128
# Rows are padded to a multiple of this, as in the JAX package, so packed
# buffers of one model have the same shape in both packages.
ROW_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class ParamPack:
    """Static layout of a parameter dict inside a padded [rows, LANES] buffer."""

    keys: tuple[str, ...]
    paths: tuple[str, ...]
    shapes: tuple[tuple[int, ...], ...]
    dtypes: tuple[torch.dtype, ...]
    offsets: tuple[int, ...]
    sizes: tuple[int, ...]
    n_total: int          # real (unpadded) coordinate count
    rows: int             # padded row count; buffer is [rows, LANES]
    prunable_leaf: tuple[bool, ...]
    n_prunable: int       # prunable coordinate count (threshold denominator)

    @classmethod
    def build(cls, params: dict[str, torch.Tensor],
              spec: PruneSpec = PruneSpec()) -> "ParamPack":
        keys = tuple(sorted(params))
        paths = tuple(keystr(k) for k in keys)
        shapes = tuple(tuple(params[k].shape) for k in keys)
        dtypes = tuple(params[k].dtype for k in keys)
        sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
        n_total = int(sum(sizes))
        rows = max(1, -(-n_total // LANES))           # ceil div
        rows = -(-rows // ROW_BLOCK) * ROW_BLOCK      # round up to block
        prunable_leaf = tuple(bool(spec.prunable(p)) for p in paths)
        n_prunable = int(sum(s for s, pr in zip(sizes, prunable_leaf) if pr))
        return cls(keys=keys, paths=paths, shapes=shapes, dtypes=dtypes,
                   offsets=offsets, sizes=sizes, n_total=n_total, rows=rows,
                   prunable_leaf=prunable_leaf, n_prunable=n_prunable)

    @property
    def n_padded(self) -> int:
        return self.rows * LANES

    def prunable_mask(self) -> np.ndarray:
        """{0,1} fp32 [rows, LANES]: 1 on real coordinates of prunable leaves."""
        m = np.zeros(self.n_padded, np.float32)
        for off, size, pr in zip(self.offsets, self.sizes, self.prunable_leaf):
            if pr:
                m[off:off + size] = 1.0
        return m.reshape(self.rows, LANES)

    def valid_mask(self) -> np.ndarray:
        """{0,1} fp32 [rows, LANES]: 1 on real (non-padding) coordinates."""
        m = np.zeros(self.n_padded, np.float32)
        m[:self.n_total] = 1.0
        return m.reshape(self.rows, LANES)

    def pack(self, tree: dict[str, torch.Tensor]) -> torch.Tensor:
        if sorted(tree) != list(self.keys):
            raise ValueError(f"tree keys {sorted(tree)} != pack keys "
                             f"{list(self.keys)}")
        flat = torch.cat([tree[k].reshape(-1).float() for k in self.keys])
        flat = torch.nn.functional.pad(flat, (0, self.n_padded - self.n_total))
        return flat.reshape(self.rows, LANES)

    def unpack(self, buf: torch.Tensor) -> dict[str, torch.Tensor]:
        flat = buf.reshape(-1)
        return {k: flat[off:off + size].view(shape).clone().to(dtype)
                for k, off, size, shape, dtype in zip(
                    self.keys, self.offsets, self.sizes, self.shapes,
                    self.dtypes)}
