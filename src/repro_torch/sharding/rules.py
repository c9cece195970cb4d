"""Partition rules: parameter, activation and cache specs per arch (the port
of ``repro/sharding/rules.py``), and their DTensor placements.

Logical axes:
  * "batch"  -> ("pod", "data") on the multi-pod mesh, "data" single-pod.
  * "model"  -> the tensor-parallel axis.

Modes:
  * train: FSDP + TP. Every big weight shards its non-TP dim over the batch
    axes (ZeRO-3 style: the model all-gathers a layer's weights over them
    before the layer runs, transformer._layer_weights). MoE experts shard E
    over "model" when divisible, else (F -> "model", D -> "data").
  * serve: TP first; weights also shard over "data" only when one TP shard
    exceeds the per-device memory budget (llama-vision-90b, arctic,
    mixtral). KV caches shard batch over "batch" and the cache sequence
    over "model" when divisible.

The rules are divisibility-guarded: a dim that does not divide its mesh
axis is left unsharded (hymba's 25 heads, granite's 49155 vocab).

A spec (`Spec`) is a tuple with one entry per tensor dim, each a mesh axis
name, a tuple of names or None; the empty spec means replicated. It
compares equal to ``tuple(jax.sharding.PartitionSpec)`` for the same
decision (a one-name tuple is the name, as JAX normalises it). The rules
are pure functions of (config, mesh shape, mode): `MeshShape` stands for a
mesh of any size without a process group (the dry run's arithmetic, the
tests), a ``DeviceMesh`` for a real one. `param_shardings` turns specs into
DTensor placements: on mesh dim i, ``Shard(d)`` where dim d's entry names
that mesh dim, else ``Replicate()``. Two mesh dims on one tensor dim (the
entry ``("pod", "data")``) split it major first, in mesh order, as JAX's
mesh order does.

`constrain` / `constrain_batch_model` redistribute a DTensor while a mesh
is active (`set_mesh`, the counterpart of ``jax.sharding.set_mesh``); on a
plain tensor or outside a mesh they return their input. A redistribution
that fails raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.tree import flatten_with_path, unflatten

PyTree = Any


class Spec(tuple):
    """Spec(*entries): one entry per tensor dim (an axis name, a tuple of
    names or None); Spec() is replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, without devices or a process group
    (``jax.sharding.AbstractMesh``'s role)."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @staticmethod
    def of(mesh) -> "MeshShape":
        """The MeshShape of a DeviceMesh, or `mesh` itself."""
        if isinstance(mesh, MeshShape):
            return mesh
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    batch: tuple[str, ...]   # ("pod", "data") or ("data",)
    model: str               # "model"

    @staticmethod
    def from_mesh(mesh) -> "MeshAxes":
        names = MeshShape.of(mesh).axis_names
        return MeshAxes(batch=tuple(n for n in names if n in ("pod", "data")),
                        model="model")

    def size(self, mesh, axis) -> int:
        if axis is None:
            return 1
        shape = MeshShape.of(mesh).shape
        if isinstance(axis, tuple):
            return math.prod(shape[a] for a in axis)
        return shape[axis]


def _div(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    """The resolved (arch, mode) policy over `mesh` (a DeviceMesh or a
    MeshShape)."""

    mode: str                 # "train" | "serve"
    fsdp: bool                # shard weight non-TP dims over batch axes
    axes: MeshAxes
    mesh: Any

    def batch_axis(self):
        return self.axes.batch if self.axes.batch else None

    def batch_size_divisor(self) -> int:
        return self.axes.size(self.mesh, self.axes.batch)

    def model_size(self) -> int:
        return self.axes.size(self.mesh, self.axes.model)


# Per-device memory budget that decides serve-time FSDP (bf16 bytes): the
# JAX package's, kept so both packages shard the same leaves.
HBM_BUDGET_BYTES = 16e9
SERVE_PARAM_BUDGET = 0.5 * HBM_BUDGET_BYTES


def make_policy(cfg: ModelConfig, mesh, mode: str) -> ShardingPolicy:
    axes = MeshAxes.from_mesh(mesh)
    if mode == "train":
        fsdp = True
    else:
        from repro_torch.models.transformer import param_count
        msize = MeshShape.of(mesh).shape["model"]
        fsdp = 2 * param_count(cfg) / max(msize, 1) > SERVE_PARAM_BUDGET
    return ShardingPolicy(mode=mode, fsdp=fsdp, axes=axes, mesh=mesh)


# -- parameter specs ------------------------------------------------------------

def _spec_for(path: str, shape: tuple[int, ...], cfg: ModelConfig,
              pol: ShardingPolicy) -> Spec:
    """The spec of one parameter leaf (path is its keystr)."""
    m = pol.axes.model
    msize = pol.model_size()
    baxis = pol.batch_axis()
    bsize = pol.batch_size_divisor()
    pth = path.lower()
    ndim = len(shape)

    def fsdp_axis(dim: int):
        return baxis if (pol.fsdp and baxis and _div(shape[dim], bsize)) \
            else None

    def tp_last(bias: bool = False) -> Spec:
        """[.., D, F]: F -> model, D -> the batch axes (FSDP); a bias
        [.., F]: F -> model."""
        spec = [None] * ndim
        if _div(shape[-1], msize):
            spec[-1] = m
        if not bias:
            spec[-2] = fsdp_axis(ndim - 2)
        return Spec(*spec)

    def tp_second_last() -> Spec:
        """[.., F, D]: F -> model, D -> the batch axes (FSDP)."""
        spec = [None] * ndim
        if _div(shape[-2], msize):
            spec[-2] = m
        spec[-1] = fsdp_axis(ndim - 1)
        return Spec(*spec)

    # embeddings / heads: embed [V, D]; lm_head [D, V]
    if "embed" in pth and "pos" not in pth or pth.endswith("['lm_head']"):
        vdim, ddim = (1, 0) if "lm_head" in pth else (0, 1)
        spec = [None] * ndim
        if _div(shape[vdim], msize):
            spec[vdim] = m
        elif _div(shape[ddim], msize):
            spec[ddim] = m
        if pol.fsdp and spec[ddim] is None and baxis and \
                _div(shape[ddim], bsize):
            spec[ddim] = baxis
        return Spec(*spec)
    if "pos_embed" in pth or "vision_proj" in pth:
        return Spec()

    # MoE expert weights [L, E, D, F] / [L, E, F, D]
    if "moe" in pth and any(w in pth for w in ("w_gate", "w_up", "w_down")):
        e_, a_, b_ = 1, 2, 3
        spec = [None] * 4
        if pol.mode == "train" and _div(shape[e_], msize):
            spec[e_] = m                      # expert parallel
            spec[a_] = fsdp_axis(a_)
        else:
            # (F -> model, D -> batch axes): works for E < model shards and
            # bounds serve memory
            f_dim = b_ if "w_down" not in pth else a_
            d_dim = a_ if "w_down" not in pth else b_
            if _div(shape[f_dim], msize):
                spec[f_dim] = m
            if baxis and (pol.fsdp or pol.mode == "serve") and \
                    _div(shape[d_dim], bsize):
                spec[d_dim] = baxis
            if spec == [None] * 4 and _div(shape[e_], msize):
                spec[e_] = m
        return Spec(*spec)
    if "router" in pth:
        return Spec()

    # attention projections: heads (flattened) -> TP
    if any(k in pth for k in ("['wq']", "['wk']", "['wv']")):
        return tp_last()
    if "['wo']" in pth:
        return tp_second_last()
    if any(k in pth for k in ("['bq']", "['bk']", "['bv']")):
        return tp_last(bias=True)

    # MLPs
    if any(k in pth for k in ("w_gate", "w_up", "w_in")):
        return tp_last()
    if any(k in pth for k in ("w_down", "w_out")):
        return tp_second_last()
    if "b_in" in pth:
        return tp_last(bias=True)

    # SSM
    if "in_proj" in pth:
        return tp_last()
    if "out_proj" in pth:
        return tp_second_last()

    # norms, scalars, conv, gates, biases: replicated
    return Spec()


def param_shapes(cfg: ModelConfig) -> dict:
    """The parameter tree on the meta device (shapes and dtypes only)."""
    from repro_torch.models.transformer import init_params
    return init_params(torch.Generator(), cfg, device="meta")


def param_specs(cfg: ModelConfig, pol: ShardingPolicy,
                shapes: PyTree | None = None) -> PyTree:
    """The spec tree congruent with the parameter tree."""
    shapes = param_shapes(cfg) if shapes is None else shapes
    flat = flatten_with_path(shapes)
    return unflatten(shapes, [_spec_for(p, tuple(leaf.shape), cfg, pol)
                              for p, leaf in flat])


def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of `spec` over `mesh`'s dims: Shard(d) on the
    mesh dim named in tensor dim d's entry, Replicate() elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in MeshShape.of(mesh).axis_names:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def param_shardings(cfg: ModelConfig, pol: ShardingPolicy,
                    shapes: PyTree | None = None) -> PyTree:
    """The placements tree congruent with the parameter tree, over the
    policy's DeviceMesh."""
    return spec_placements(param_specs(cfg, pol, shapes), pol.mesh)


def is_spec(x) -> bool:
    return isinstance(x, Spec)


def spec_leaves(specs: PyTree) -> list:
    """[(keystr path, Spec)] of a spec tree, in flattening order."""
    return flatten_with_path(specs, is_leaf=is_spec)


def spec_placements(specs: PyTree, mesh) -> PyTree:
    """placements() of every Spec of a spec tree."""
    return unflatten(specs, [placements(s, mesh)
                             for _, s in spec_leaves(specs)], is_leaf=is_spec)


def local_shape(shape, spec: Spec, mesh) -> tuple[int, ...]:
    """The shape of one device's shard of a `shape` tensor under `spec`
    (every sharded dim divides its axes: the rules guard it)."""
    sizes = MeshShape.of(mesh).shape
    out = list(shape)
    for d, e in enumerate(spec):
        if e is None:
            continue
        names = e if isinstance(e, tuple) else (e,)
        out[d] //= math.prod(sizes[n] for n in names)
    return tuple(out)


def distribute(tree: PyTree, specs: PyTree, mesh) -> PyTree:
    """Every leaf of `tree` as a DTensor over `mesh` under its spec in
    `specs`: each rank keeps its own shard of the full tensor it holds
    (every rank builds the same tree from the same seed), so nothing is
    sent. Meta tensors give meta shards."""
    from torch.distributed.tensor import distribute_tensor
    flat = flatten_with_path(tree)
    sp = [s for _, s in spec_leaves(specs)]
    return unflatten(tree, [
        distribute_tensor(t, mesh, placements(s, mesh), src_data_rank=None)
        for (_, t), s in zip(flat, sp)])


# -- batch / cache specs --------------------------------------------------------

def batch_spec(global_batch: int, pol: ShardingPolicy,
               rank: int = 2) -> Spec:
    """Tokens / labels [B, S]: B over the batch axes when divisible."""
    bax = pol.batch_axis()
    if bax and _div(global_batch, pol.batch_size_divisor()):
        return Spec(bax, *([None] * (rank - 1)))
    return Spec(*([None] * rank))


def cache_specs(cfg: ModelConfig, pol: ShardingPolicy, cache: PyTree,
                global_batch: int) -> PyTree:
    """KV / SSM cache specs: batch -> batch axes, cache seq -> model."""
    bax = pol.batch_axis()
    bdiv = pol.batch_size_divisor()
    msize = pol.model_size()
    m = pol.axes.model

    def spec(path, leaf):
        pth = path.lower()
        shp = leaf.shape
        nd = len(shp)
        s = [None] * nd

        def batch_seq(b_dim, s_dim=None):
            if bax and _div(shp[b_dim], bdiv):
                s[b_dim] = bax
            if s_dim is not None and _div(shp[s_dim], msize):
                s[s_dim] = m

        if "scale" in pth:
            batch_seq(nd - 3, nd - 2)     # int8-KV scales [*, B, S, Hkv]
        elif "'k'" in pth or "'v'" in pth:
            batch_seq(nd - 4, nd - 3)     # [*, B, S, Hkv, Dh]
        elif "ssm" in pth:
            batch_seq(nd - 4)             # [L, B, H, P, N]
        elif "conv" in pth:
            batch_seq(nd - 3)
        elif "enc_out" in pth or "vision" in pth:
            batch_seq(0)
            if _div(shp[-1], msize):
                s[-1] = m
        return Spec(*s)

    flat = flatten_with_path(cache)
    return unflatten(cache, [spec(p, leaf) for p, leaf in flat])


# -- the active mesh and activation constraints ---------------------------------

_ACTIVE: list = []


@contextlib.contextmanager
def set_mesh(mesh):
    """Make `mesh` (a DeviceMesh) the one `constrain` and the model's
    sharded paths read, for the body of the with-statement. Inside it a
    plain tensor meeting a DTensor counts as replicated (DTensor's
    ``implicit_replication``): the positions, masks and constants that
    every rank builds alike."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACTIVE.append(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    """The DeviceMesh of the innermost `set_mesh`, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def unshard_batch(tree: PyTree) -> PyTree:
    """A layer's weights with their FSDP shards gathered: every batch-axis
    Shard of a DTensor leaf becomes Replicate (one all-gather a weight;
    its backward is the gradient's reduce-scatter), the model axis kept.
    Plain leaves pass through; outside a mesh the tree itself is returned
    (nothing is flattened on an unsharded run)."""
    if active_mesh() is None:
        return tree

    def one(w):
        if not _is_dtensor(w):
            return w
        from torch.distributed.tensor import Replicate
        names = w.device_mesh.mesh_dim_names
        want = tuple(Replicate() if n in ("pod", "data") else p
                     for n, p in zip(names, w.placements))
        return w if want == tuple(w.placements) else \
            w.redistribute(w.device_mesh, want)
    return unflatten(tree, [one(w) for _, w in flatten_with_path(tree)])


def batch_rows(t, model=None) -> list:
    """Placements for an op on DTensor `t`'s own rows: Shard(0) on the
    batch axes where `t` is split there, `model` (default Replicate) on
    the model axis: the in- and out-placements of ``local_map`` around
    ops DTensor has no strategy for."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(0) if n in ("pod", "data") and p == Shard(0)
            else (model or Replicate()) if n == "model" else Replicate()
            for n, p in zip(t.device_mesh.mesh_dim_names, t.placements)]


def head_layout(mesh, batch: int, hq: int, hkv: int):
    """Placements of q [B, S, Hq, D] and k/v [B, S, Hkv', D] for attention
    on local shards, and the repeat r that makes Hkv' = Hkv * r: batch over
    the batch axes when it divides them; on the model axis (size M):
      * Hq and Hkv both divide by M: heads sharded, r = 1;
      * Hq divides by M and Hkv divides M (GQA with fewer KV heads than
        model shards, granite's 8 at 16): each KV head repeated r = M / Hkv
        times and the M copies sharded, so model rank i holds KV head
        i // r, the one its Hq / M query heads read (they sit inside one
        group of Hq / Hkv, as M / Hkv divides Hq / Hkv); the kernel sees
        Hq / M query heads on one KV head;
      * otherwise (hymba's 25 heads, or a group straddling two ranks):
        heads replicated on the model axis, every rank attends all heads.
    """
    from torch.distributed.tensor import Replicate, Shard
    shape = MeshShape.of(mesh)
    batch_axes = _batch_names(shape.axis_names)
    bsz = math.prod(shape.shape[a] for a in batch_axes) if batch_axes else 1
    m = shape.shape.get("model", 1)
    if hq % m == 0 and hkv % m == 0:
        heads, rep = Shard(2), 1
    elif hq % m == 0 and m % hkv == 0:
        heads, rep = Shard(2), m // hkv
    else:
        heads, rep = Replicate(), 1
    pl = tuple(Shard(0) if n in batch_axes and batch % bsz == 0
               else heads if n == "model" else Replicate()
               for n in shape.axis_names)
    return pl, rep


def hold_grad(x):
    """x itself; on a DTensor, its gradient is redistributed to x's
    placements on the way back (before it reaches the op that made x).
    A reshape that split a dim DTensor shards (heads whole on the model
    axis, hymba's 25 or arctic's 56 on 16 ranks) cannot take back a
    gradient sharded along the flat dim."""
    if not _is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _batch_names(names) -> tuple[str, ...]:
    return tuple(n for n in names if n in ("pod", "data"))


def _redistribute(x, spec: list):
    mesh = active_mesh()
    return x.redistribute(mesh, placements(Spec(*spec), mesh))


def constrain(x, *axes):
    """Redistribute x by logical axis names, one per dim: "batch" (->
    ("pod", "data")), "model" or None. A dim that does not divide its
    axes is left unsharded; each axis is used once. The identity on a
    plain tensor or outside a mesh."""
    mesh = active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    shape = MeshShape.of(mesh)
    sizes = shape.shape
    batch = _batch_names(shape.axis_names)
    bsz = math.prod(sizes[a] for a in batch) if batch else 1
    spec = []
    used_model = used_batch = False
    for dim, ax in enumerate(axes):
        if ax == "batch" and batch and not used_batch \
                and x.shape[dim] % bsz == 0:
            spec.append(batch)
            used_batch = True
        elif ax == "model" and "model" in sizes and not used_model and \
                x.shape[dim] % sizes["model"] == 0:
            spec.append("model")
            used_model = True
        else:
            spec.append(None)
    return _redistribute(x, spec)


def constrain_batch_model(x, *, d_threshold: int = 2048):
    """Constrain [B, S, D] activations to (batch, None, model-if-big): the
    residual stream is batch-sharded, and its feature dim also
    model-sharded for d_model >= d_threshold. The identity on a plain
    tensor or outside a mesh (every one-device run)."""
    mesh = active_mesh()
    if mesh is None or not _is_dtensor(x):
        return x
    shape = MeshShape.of(mesh)
    sizes = shape.shape
    batch = _batch_names(shape.axis_names)
    bsz = math.prod(sizes[a] for a in batch) if batch else 1
    spec = [None] * x.ndim
    if batch and x.shape[0] % bsz == 0:
        spec[0] = batch
    if "model" in sizes and x.shape[-1] >= d_threshold and \
            x.shape[-1] % sizes["model"] == 0:
        spec[-1] = "model"
    return _redistribute(x, spec)
