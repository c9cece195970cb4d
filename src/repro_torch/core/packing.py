"""Packed parameter buffers for the round engine.

The port of ``repro/core/packing.py``: `ParamPack` flattens a parameter
tree (nested dicts and lists, repro_torch/tree.py) once into a single
zero-padded ``[R, 128]`` fp32 buffer, recording per-leaf offsets and
shapes and the tree's structure. Leaves go in JAX flatten order (dict keys
sorted, lists by index) and paths are JAX ``keystr`` strings, so a packed
buffer is coordinate for coordinate the JAX package's (and
`prunable_mask` decides the same way).

``unpack`` rebuilds the tree and gives every leaf freshly allocated,
contiguous storage (a clone of its slice), which stays differentiable: gradients can be taken with
respect to the packed buffer. A leaf viewed at an odd offset of the buffer
could make cuBLAS pick another GEMM kernel than the reference backend's
fresh tensors get, and break the packed-vs-reference bit equality on the
card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.pruning import PruneSpec
from repro_torch.tree import flatten_with_path, unflatten

LANES = 128
# Rows are padded to a multiple of this, as in the JAX package, so packed
# buffers of one model have the same shape in both packages.
ROW_BLOCK = 256


@dataclasses.dataclass(frozen=True)
class ParamPack:
    """Static layout of a parameter tree inside a padded [rows, LANES]
    buffer. `keys` are the top-level dict keys (sorted), `skeleton` the
    tree with None at every leaf."""

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
    skeleton: object = dataclasses.field(default=None, compare=False,
                                         repr=False)

    @classmethod
    def build(cls, params, spec: PruneSpec = PruneSpec()) -> "ParamPack":
        flat = flatten_with_path(params)
        keys = tuple(sorted(params)) if isinstance(params, dict) else ()
        paths = tuple(p for p, _ in flat)
        shapes = tuple(tuple(leaf.shape) for _, leaf in flat)
        dtypes = tuple(leaf.dtype for _, leaf in flat)
        sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
        offsets = tuple(int(o) for o in np.cumsum((0,) + sizes)[:-1])
        n_total = int(sum(sizes))
        rows = max(1, -(-n_total // LANES))           # ceil div
        rows = -(-rows // ROW_BLOCK) * ROW_BLOCK      # round up to block
        prunable_leaf = tuple(bool(spec.prunable(p)) for p in paths)
        n_prunable = int(sum(s for s, pr in zip(sizes, prunable_leaf) if pr))
        skeleton = unflatten(params, [None] * len(flat))
        return cls(keys=keys, paths=paths, shapes=shapes, dtypes=dtypes,
                   offsets=offsets, sizes=sizes, n_total=n_total, rows=rows,
                   prunable_leaf=prunable_leaf, n_prunable=n_prunable,
                   skeleton=skeleton)

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

    def pack(self, tree) -> torch.Tensor:
        flat = flatten_with_path(tree)
        paths = tuple(p for p, _ in flat)
        if paths != self.paths:
            raise ValueError(f"tree paths {list(paths)} != pack paths "
                             f"{list(self.paths)}")
        buf = torch.cat([leaf.reshape(-1).float() for _, leaf in flat])
        buf = torch.nn.functional.pad(buf, (0, self.n_padded - self.n_total))
        return buf.reshape(self.rows, LANES)

    def unpack(self, buf: torch.Tensor):
        flat = buf.reshape(-1)
        return unflatten(self.skeleton, [
            flat[off:off + size].view(shape).clone().to(dtype)
            for off, size, shape, dtype in zip(
                self.offsets, self.sizes, self.shapes, self.dtypes)])
