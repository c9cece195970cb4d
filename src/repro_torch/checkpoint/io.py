"""Checkpointing of parameter trees: path-keyed npz storage + JSON metadata.

The port of ``repro/checkpoint/io.py``, with the same on-disk format: each
leaf is stored under its tree path as the JAX package writes it
(``jax.tree_util.keystr``: ``"['params']['conv1']"``, a list index as
``"[0]"``, with "/" stored as "⁄"), the meta JSON beside it, so a
checkpoint written by either package loads in the other. A tree here is
nested dicts, lists and tuples with torch tensors or numpy arrays as
leaves, walked as JAX flattens it (repro_torch/tree.py); tensors are
stored from the host and restored onto the device and dtype of the
template leaf. A bf16 leaf is stored as the JAX package stores one
(numpy writes its ml_dtypes array as 2-byte "<V2" records of the bits),
byte for byte, and such records read back as bf16 bits; the JAX package's
own ``load_checkpoint`` cannot cast them back (ROADMAP section 3).

Crash safety: both files of a step are written via mkstemp + os.replace, so
a step is either fully present or absent — never half-written under its
final name. The meta JSON is renamed BEFORE the npz: `_steps()` lists steps
by their .npz, so a listed step always has its metadata (a crash between
the two renames leaves only an orphaned .meta.json, which nothing lists).
A torn file copied in from a dirty filesystem still surfaces as
`CheckpointCorruptError`; `CheckpointManager.restore(step=None)` skips such
steps and falls back to the newest intact one.
"""
from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.tree import flatten_with_path, unflatten

PyTree = Any


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file is truncated or unreadable — typically a process
    killed mid-write before the atomic renames existed, or a torn copy.
    `CheckpointManager.restore(step=None)` catches this and resumes from
    the previous intact step; an explicitly requested step re-raises."""


# A bf16 leaf's npy header, as numpy writes an ml_dtypes bfloat16 array
# (the JAX package's bf16 leaves): records of 2 bytes, little-endian.
BF16_DESCR = "<V2"


class _Bf16Bits:
    """A bf16 leaf on the host as its uint16 bit patterns (numpy has no
    bfloat16), written as `BF16_DESCR` records."""

    def __init__(self, t: torch.Tensor):
        self.bits = t.detach().contiguous().view(torch.int16).cpu().numpy() \
            .view(np.uint16)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return _Bf16Bits(leaf)
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _path_dict(tree: PyTree) -> dict:
    return {key: _host(leaf) for key, leaf in flatten_with_path(tree)}


def _savez(f, arrays: dict) -> None:
    """np.savez(f, **arrays), member for member (the same zip and npy
    bytes), with a `_Bf16Bits` leaf written as the JAX package's file
    holds a bf16 leaf: a header naming `BF16_DESCR`, then the bits."""
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zipf:
        for key, val in arrays.items():
            with zipf.open(key + ".npy", "w", force_zip64=True) as fid:
                if isinstance(val, _Bf16Bits):
                    np.lib.format.write_array_header_1_0(fid, {
                        "descr": BF16_DESCR, "fortran_order": False,
                        "shape": val.bits.shape})
                    fid.write(val.bits.tobytes("C"))
                else:
                    np.lib.format.write_array(fid, np.asanyarray(val))


def _restore(arr: np.ndarray, leaf):
    """A stored array as `leaf`'s type (and device): 2-byte records are a
    bf16 leaf's bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(np.array(arr.view(np.int16), copy=True)).view(
            torch.bfloat16)
        if isinstance(leaf, torch.Tensor):
            return t.to(device=leaf.device, dtype=leaf.dtype)
        return t.float().numpy().astype(np.asarray(leaf).dtype)
    if isinstance(leaf, torch.Tensor):
        return torch.from_numpy(np.array(arr, copy=True)).to(
            device=leaf.device, dtype=leaf.dtype)
    return arr.astype(np.asarray(leaf).dtype)


def atomic_write_text(path: str, text: str) -> None:
    """Write `text` to `path` via mkstemp + os.replace in the target
    directory: the file is either fully present under its final name or
    absent, never torn."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)



def save_checkpoint(
    path: str, params: PyTree, *, step: int = 0,
    sharding_meta: dict[str, str] | None = None,
    extra: dict | None = None,
) -> None:
    """Atomically save a tree (+ metadata json) to `path` (.npz appended)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = _path_dict(params)
    meta = {
        "step": step,
        "keys": sorted(arrays),
        "sharding": sharding_meta or {},
        "extra": extra or {},
    }
    # meta first (see module docstring): once the .npz rename makes the
    # step visible to _steps(), its metadata is guaranteed on disk
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    atomic_write_text(meta_path, json.dumps(meta, indent=2))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)) or ".",
                               suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            _savez(f, {k.replace("/", "⁄"): v for k, v in arrays.items()})
        os.replace(tmp, path if path.endswith(".npz") else path + ".npz")
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def verify_checkpoint(path: str) -> None:
    """Cheap integrity probe: raise CheckpointCorruptError when the npz
    zip at `path` fails its CRC walk or the meta JSON is missing/unparsable
    (save writes meta first, so an intact step always has one). Does not
    reconstruct the tree."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    if not os.path.exists(npz_path):
        raise FileNotFoundError(npz_path)
    try:
        with zipfile.ZipFile(npz_path) as z:
            bad = z.testzip()
        if bad is not None:
            raise CheckpointCorruptError(
                f"checkpoint {npz_path!r}: member {bad!r} fails its CRC — "
                f"truncated or corrupt file, likely interrupted mid-write")
    except (zipfile.BadZipFile, EOFError, OSError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {npz_path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}) — likely interrupted mid-write"
        ) from e
    if not os.path.exists(meta_path):
        raise CheckpointCorruptError(
            f"checkpoint {npz_path!r} has no metadata sidecar "
            f"{meta_path!r} — torn write from a pre-atomic save")
    try:
        with open(meta_path) as f:
            json.load(f)
    except json.JSONDecodeError as e:
        raise CheckpointCorruptError(
            f"checkpoint metadata {meta_path!r} is not valid JSON "
            f"({e}) — truncated or corrupt file") from e


def load_checkpoint(path: str, like: PyTree) -> tuple[PyTree, dict]:
    """Restore a tree saved by save_checkpoint into the structure of
    `like` (tensor leaves come back on the template's device and dtype).
    Raises CheckpointCorruptError (not a raw zip/JSON error) when the files
    are truncated, so callers can fall back to an older step."""
    npz_path = path if path.endswith(".npz") else path + ".npz"
    meta_path = (path[:-4] if path.endswith(".npz") else path) + ".meta.json"
    try:
        with np.load(npz_path) as data:
            arrays = {k.replace("⁄", "/"): data[k] for k in data.files}
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, EOFError, OSError, ValueError) as e:
        raise CheckpointCorruptError(
            f"checkpoint {npz_path!r} is truncated or corrupt "
            f"({type(e).__name__}: {e}) — likely interrupted mid-write; "
            f"resume from an earlier step") from e
    meta = {}
    if os.path.exists(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
        except json.JSONDecodeError as e:
            raise CheckpointCorruptError(
                f"checkpoint metadata {meta_path!r} is not valid JSON "
                f"({e}) — truncated or corrupt file") from e
    leaves = []
    for key, leaf in flatten_with_path(like):
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        shape = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) \
            else np.shape(leaf)
        if arr.shape != shape:
            raise ValueError(f"shape mismatch for {key}: "
                             f"ckpt {arr.shape} vs model {shape}")
        leaves.append(_restore(arr, leaf))
    return unflatten(like, leaves), meta


class CheckpointManager:
    """Keeps the latest k checkpoints under a directory."""

    def __init__(self, directory: str, *, keep: int = 3, prefix: str = "ckpt"):
        self.directory = directory
        self.keep = keep
        self.prefix = prefix
        os.makedirs(directory, exist_ok=True)

    def _name(self, step: int) -> str:
        return os.path.join(self.directory, f"{self.prefix}_{step:08d}")

    def meta_path(self, step: int) -> str:
        """Path of the JSON metadata sidecar for `step` (readable without
        reconstructing the tree — the CLI resume path uses this)."""
        return self._name(step) + ".meta.json"

    def save(self, step: int, params: PyTree, **kw) -> str:
        path = self._name(step)
        save_checkpoint(path, params, step=step, **kw)
        self._gc()
        return path + ".npz"

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def latest_intact_step(self) -> int | None:
        """Newest step that passes `verify_checkpoint` — the step
        `restore(step=None)` will land on after corruption fallback.
        None when no step is usable."""
        for s in reversed(self._steps()):
            try:
                verify_checkpoint(self._name(s))
                return s
            except CheckpointCorruptError:
                continue
        return None

    def restore(self, like: PyTree, step: int | None = None) -> tuple[PyTree, dict]:
        if step is not None:
            # explicitly requested step: corruption is an error the caller
            # asked to see, no silent fallback
            return load_checkpoint(self._name(step), like)
        steps = self._steps()
        if not steps:
            raise FileNotFoundError("no checkpoints found")
        last_err: CheckpointCorruptError | None = None
        for s in reversed(steps):
            try:
                verify_checkpoint(self._name(s))
                return load_checkpoint(self._name(s), like)
            except CheckpointCorruptError as e:
                last_err = e  # fall back to the previous intact step
        raise last_err

    def clear(self) -> None:
        """Delete every checkpoint step (npz + metadata) under this
        manager's prefix. The sweep service calls this once a cell's
        final result is durable in the sink: its mid-cell resume
        checkpoints are dead weight, and a stale step would shadow a
        later sweep's same-named cell."""
        for s in self._steps():
            for suffix in (".npz", ".meta.json"):
                p = self._name(s) + suffix
                if os.path.exists(p):
                    os.unlink(p)

    def _steps(self) -> list[int]:
        out = []
        for fn in os.listdir(self.directory):
            if fn.startswith(self.prefix) and fn.endswith(".npz"):
                try:
                    out.append(int(fn[len(self.prefix) + 1:-4]))
                except ValueError:
                    pass
        return sorted(out)

    def _gc(self) -> None:
        steps = self._steps()
        for s in steps[:-self.keep]:
            for suffix in (".npz", ".meta.json"):
                p = self._name(s) + suffix
                if os.path.exists(p):
                    os.unlink(p)
