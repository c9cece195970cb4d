"""Step functions and abstract inputs for every (arch x shape) (the port of
``repro/launch/steps.py``): the masked-FedSGD train step, prefill and
serve.

`make_train_step` realizes the paper's parameter-efficient FedSGD: the
pruning masks ride with the parameters (identically sharded on a mesh),
gradients are masked before the update (the pruned-gradient upload,
DESIGN.md §3) and the server SGD update (eq. 7) is applied, w - eta (g m),
so pruned coordinates never move. The same step runs on one card on plain
tensors and on a mesh on DTensors (sharding/rules.py: parameters, masks
and batch placed by `param_shardings` / `batch_spec`, under
`rules.set_mesh`): there the update works on each rank's local shards, the
gradients come back at their parameters' placements and the loss is
replicated, as the JAX package's jit shardings give them.

`batch_specs` / `input_specs` are the abstract inputs of each shape's step:
meta tensors where the JAX package has ``ShapeDtypeStruct`` (the dry run,
launch/dryrun.py).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import InputShape
from repro_torch.models import transformer as T
from repro_torch.models.blocks import Runtime
from repro_torch.sharding.rules import constrain
from repro_torch.tree import flatten_with_path, leaves, tree_map, unflatten

PyTree = Any


def specialize(cfg: ModelConfig,
               shape: InputShape) -> tuple[ModelConfig, Runtime]:
    """Adapt config + runtime to an input shape (DESIGN.md §5): training
    takes flash_vjp (O(S) attention backward memory) with remat, prefill
    the causal triangle-skip scan."""
    impl = {"train": "flash_vjp", "prefill": "chunked_skip",
            "decode": "chunked"}[shape.kind]
    rt = Runtime(attn_impl=impl, q_chunk=512, kv_chunk=512,
                 loss_chunk=256, remat=(shape.kind == "train"))
    if shape.name == "long_500k" and cfg.local_global:
        rt = dataclasses.replace(rt, swa_only=True)
    if cfg.family == "audio" and shape.seq_len > cfg.max_seq:
        cfg = dataclasses.replace(cfg, max_seq=shape.seq_len)
    return cfg, rt


def train_microbatches(cfg: ModelConfig) -> int:
    """Gradient-accumulation factor: bounds activation memory for the
    widest archs (d_model >= 6144: mixtral, llama-vision-90b, arctic;
    arctic additionally needs x8 for its 128 experts' dispatch buffers)."""
    if cfg.num_experts >= 64:
        return 8
    return 4 if cfg.d_model >= 6144 else 1


def structured_slice(params: PyTree,
                     lam: float) -> tuple[PyTree, ModelConfig | None]:
    """Structured (width) pruning: drop the trailing lam fraction of every
    FFN hidden dimension by slicing the weights (views), leaves chosen by
    the same path substrings as the JAX package (w_gate / w_up: last dim;
    w_down: second to last). Returns (sliced params, None); the config is
    unchanged because the FFN width is read from the weights."""
    if lam <= 0:
        return params, None

    def slc(path, w):
        if any(k in path for k in ("w_gate", "w_up")) and w.ndim >= 2:
            return w.narrow(-1, 0, max(1, int(w.shape[-1] * (1 - lam))))
        if "w_down" in path and w.ndim >= 2:
            return w.narrow(-2, 0, max(1, int(w.shape[-2] * (1 - lam))))
        return w

    return unflatten(params, [slc(p, w) for p, w in
                              flatten_with_path(params)]), None


def value_and_grad(loss_of, params: PyTree):
    """(detached loss, gradient tree) of the scalar loss_of(params), by
    autograd with respect to every leaf of params; a leaf the loss does
    not read gets zeros, as jax.grad gives it (the gate of whisper's
    ungated cross layers, llama-vision's cross layers' ln_self)."""
    req = [w.detach().requires_grad_() for w in leaves(params)]
    loss = loss_of(unflatten(params, req))
    grads = torch.autograd.grad(loss, req, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), unflatten(params, [
        _like(g, w) for g, w in zip(grads, req)])


def backward_leaves(loss, req: list, on_grad) -> None:
    """Backpropagate the scalar `loss` to the tensors `req` (leaves that
    require grad) and hand each one's gradient to on_grad(i, g) as soon
    as autograd has completed it, then drop it: no gradient tree is held
    beside the model, only the gradients still being summed. A leaf the
    loss does not read gets zeros. Each g is the sum autograd forms at
    the leaf, so bit for bit what torch.autograd.grad returns for it."""
    done = [False] * len(req)

    def hook(i):
        def take(t):
            g, t.grad = t.grad, None
            done[i] = True
            on_grad(i, g)
        return take

    handles = [w.register_post_accumulate_grad_hook(hook(i))
               for i, w in enumerate(req)]
    try:
        torch.autograd.backward(loss, inputs=req)
    finally:
        for h in handles:
            h.remove()
    for i, w in enumerate(req):
        if not done[i]:
            on_grad(i, torch.zeros_like(w))


def loss_and_leaf_grads(loss_of, params: PyTree, on_grad) -> torch.Tensor:
    """value_and_grad's gradients one leaf at a time: on_grad(i, g) gets
    leaf i's gradient (at its parameter's placements) as backward
    completes it (backward_leaves). Returns the detached loss."""
    req = [w.detach().requires_grad_() for w in leaves(params)]
    loss = loss_of(unflatten(params, req))
    backward_leaves(loss, req, lambda i, g: on_grad(i, _like(g, req[i])))
    return loss.detach()


def _like(g, w):
    """A DTensor gradient at its parameter's placements (the reduce-scatter
    of FSDP), as the JAX package keeps gradients at the parameter
    sharding; a plain gradient as it is."""
    if isinstance(w, DTensor) and tuple(g.placements) != tuple(w.placements):
        return g.redistribute(w.device_mesh, w.placements)
    return g


# values of a plain leaf read at once when a gradient is masked into the
# accumulator and when a leaf is updated (their transients are a slice's:
# the head of a 128,256-word vocabulary is 1.05e9 values)
UPDATE_CHUNK = 1 << 26


def _slices(*ts):
    """Aligned slices of tensors of one shape, UPDATE_CHUNK values each,
    for plain contiguous tensors; else the tensors whole (a DTensor works
    on its shards)."""
    if ts[0].numel() <= UPDATE_CHUNK or any(
            isinstance(t, DTensor) or not t.is_contiguous() for t in ts):
        return [ts]
    return zip(*(t.view(-1).split(UPDATE_CHUNK) for t in ts))


def _masked(g, m, w):
    """The VJP of w * m.to(w.dtype) for the gradient g of the product:
    g m in w's type, at w's placements on a mesh."""
    return _like(g * m.to(w.dtype), w)


def _update(w, g, m, eta: float, mb: int, vjp: bool = False):
    """The server step on one leaf, w - eta (g m) in g's type cast to w's
    (pruned coordinates neither upload nor update, eq. 5-7), g first
    divided in place by mb when mb > 1 (the microbatch mean); with `vjp`,
    g is the gradient of the masked copy, turned into w's first
    (`_masked`). A slice at a time (`_slices`), the same elementwise
    expression."""
    def one(w, g, m):
        if vjp:
            g = _masked(g, m, w)
        if mb > 1:
            g.div_(mb)
        return w - eta * (g * m.to(g.dtype)).to(w.dtype)

    parts = list(_slices(w, g, m))
    if len(parts) == 1:
        return one(*parts[0])
    out = torch.empty_like(w)
    for o, part in zip(out.view(-1).split(UPDATE_CHUNK), parts):
        o.copy_(one(*part))
    return out


def _release(ts) -> None:
    """Free the storage of the masked copy once its last backward has run.
    The loss's checkpoints leave a reference cycle through autograd's
    graph, whose AccumulateGrad nodes hold their leaves: without this the
    copy (12 GiB for llama-vision's group) would live on until the
    garbage collector ran, into the next step."""
    with torch.no_grad():
        for t in ts:
            local = t.to_local() if isinstance(t, DTensor) else t
            local.untyped_storage().resize_(0)


def make_train_step(cfg: ModelConfig, rt: Runtime, *, eta: float = 1e-2,
                    microbatches: int | None = None,
                    structured_lambda: float = 0.0):
    """(params, masks, batch) -> (loss, new_params): the masked-FedSGD step.

    batch: {"tokens", "labels"} [B, S] integer tensors, and the audio or
    vlm family's memory input ("encoder_input" / "vision_embeddings"
    [B, T, D], transformer.forward's `extra`). With microbatches > 1
    every entry of the batch is cut into that many slices (a loop in
    place of ``lax.scan``), dividing activation memory; gradients
    accumulate in fp32 (bf16 above 100e9 parameters). structured_lambda
    > 0 also width-prunes the FFNs (structured_slice). Returns new
    tensors; the inputs are left as they are.

    The step holds only its state: the weights, the masks, the masked
    copy w * m the forward reads (made once a step, as leaves of their
    own) and the accumulator, beside one microbatch's activations. Each
    leaf's gradient is taken as backward completes it (backward_leaves):
    the VJP of w * m, g m in w's type, goes into the accumulator (with
    one microbatch, straight into the leaf's update) and is dropped; the
    update runs leaf by leaf, each accumulator leaf freed once its new
    leaf exists. The results are those of autograd over w * m, bit for
    bit."""
    mb = train_microbatches(cfg) if microbatches is None else microbatches
    # >= 100B params: bf16 gradient accumulation (an fp32 accumulator is
    # 7.5 GB/device for arctic-480b at the JAX package's FSDP sharding)
    acc_dtype = torch.bfloat16 if T.param_count(cfg) > 100e9 \
        else torch.float32

    def train_step(params, masks, batch):
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        ws, ms = leaves(params), leaves(masks)
        with torch.no_grad():
            pm = [(w * m.to(w.dtype)).requires_grad_()
                  for w, m in zip(ws, ms)]
        tree = unflatten(params, pm)
        if structured_lambda > 0:
            tree, _ = structured_slice(tree, structured_lambda)
        new = [None] * len(ws)

        def grad_pass(tokens, labels, xtra, on_grad):
            loss = T.loss_fn(tree, tokens, labels, cfg, rt, xtra or None)
            backward_leaves(loss, pm, on_grad)
            return loss.detach()

        if mb == 1:
            def apply(i, g):
                new[i] = _update(ws[i], g, ms[i], eta, 1, vjp=True)

            loss = grad_pass(batch["tokens"], batch["labels"], extra, apply)
            _release(pm)
        else:
            parts = {k: _chunks(v, mb) for k, v in batch.items()}
            # the accumulator sits at each parameter's placements on a
            # mesh and starts at +0.0 (a pruned coordinate's sum of
            # masked gradients stays +0.0); each gradient is added in
            # place as backward completes it
            acc = [torch.zeros_like(w, dtype=acc_dtype) for w in ws]

            def add(i, g):
                for a, gc, mc in _slices(acc[i], g, ms[i]):
                    a.add_(_masked(gc, mc, ws[i]))

            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(mb):
                loss = loss + grad_pass(
                    parts["tokens"][i], parts["labels"][i],
                    {k: parts[k][i] for k in extra}, add)
            loss = loss / mb
            _release(pm)
            with torch.no_grad():
                for i, w in enumerate(ws):
                    new[i] = _update(w, acc[i], ms[i], eta, mb)
                    acc[i] = None
        return constrain(loss), unflatten(params, new)

    return train_step


def _chunks(v, mb: int) -> list:
    """v cut into mb microbatches along dim 0, as the JAX package cuts
    them: microbatch i is the global rows [i R, (i + 1) R), R = B / mb. A
    DTensor whose rows are split over the batch axes (P ranks) keeps each
    microbatch split over them, R / P rows a rank: one all-to-all over
    the batch ranks sends each of the rank's mb blocks of R / P rows to
    the rank that holds it in its microbatch (rank d's block j is global
    block n = d mb + j, which is microbatch n // P on batch rank n % P).
    Rows replicated on every rank are cut alike on every rank."""
    if not isinstance(v, DTensor):
        return list(v.chunk(mb))
    from torch.distributed.tensor import Shard
    mesh = v.device_mesh
    dims = [k for k, p in enumerate(v.placements) if p == Shard(0)]
    local = v.to_local()
    if dims:
        local = _to_microbatch_order(local, mb, mesh, dims)
    return [DTensor.from_local(part, mesh, v.placements, run_check=False)
            for part in local.chunk(mb)]


def _to_microbatch_order(local, mb: int, mesh, dims: list):
    """This rank's rows of microbatches 0 .. mb - 1, stacked (see
    `_chunks`); `dims` are the mesh dims that split the rows, major
    first."""
    import math

    from torch.distributed import _functional_collectives as funcol
    sizes = [mesh.size(k) for k in dims]
    p_all = math.prod(sizes)
    rows = local.shape[0]                  # B / P
    if rows % mb:
        raise ValueError(f"{rows} rows a rank do not cut into {mb} "
                         "microbatches")
    if p_all == 1:
        return local
    coord = mesh.get_coordinate()
    d = 0
    for k, n in zip(dims, sizes):
        d = d * n + coord[k]
    blk = rows // mb                       # R / P rows a block
    dest = [(d * mb + j) % p_all for j in range(mb)]
    order = sorted(range(mb), key=lambda j: dest[j])
    send = torch.cat([local[j * blk:(j + 1) * blk] for j in order])
    in_splits = [blk * dest.count(r) for r in range(p_all)]
    # what arrives, in source order: every (source s, block j) bound here
    src = [(s, j) for s in range(p_all) for j in sorted(
        range(mb), key=lambda j, s=s: (s * mb + j) % p_all)
        if (s * mb + j) % p_all == d]
    out_splits = [blk * sum(1 for s, _ in src if s == r)
                  for r in range(p_all)]
    group = mesh.get_group(dims[0]) if len(dims) == 1 else \
        mesh[tuple(mesh.mesh_dim_names[k] for k in dims)]._flatten() \
        .get_group()
    got = funcol.wait_tensor(funcol.all_to_all_single(
        send.contiguous(), out_splits, in_splits, group))
    # arrival k is microbatch (s mb + j) // P
    micro = [(s * mb + j) // p_all for s, j in src]
    pos = sorted(range(len(src)), key=lambda k: micro[k])
    return torch.cat([got[k * blk:(k + 1) * blk] for k in pos])


def make_prefill_step(cfg: ModelConfig, rt: Runtime):
    def prefill_step(params, batch, cache):
        extra = {k: v for k, v in batch.items() if k != "tokens"} or None
        return T.prefill(params, batch["tokens"], cache, cfg, rt, extra)

    return prefill_step


def make_serve_step(cfg: ModelConfig, rt: Runtime):
    def serve_step(params, cache, token, pos):
        return T.decode_step(params, token, cache, pos, cfg, rt)

    return serve_step


# -- abstract inputs (meta tensors; nothing is allocated) ----------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: InputShape, *,
                with_labels: bool) -> dict:
    """The batch of a shape's step: tokens (and labels) [B, S] int32, and
    the audio / vlm family's memory input [B, T, D]."""
    b, s = shape.global_batch, shape.seq_len
    d = {"tokens": _meta((b, s), torch.int32)}
    if with_labels:
        d["labels"] = _meta((b, s), torch.int32)
    dtype = getattr(torch, cfg.dtype)
    if cfg.family == "audio":
        d["encoder_input"] = _meta((b, cfg.encoder_tokens, cfg.d_model),
                                   dtype)
    if cfg.family == "vlm":
        d["vision_embeddings"] = _meta((b, cfg.vision_tokens, cfg.d_model),
                                       dtype)
    return d


def input_specs(cfg: ModelConfig, shape: InputShape, rt: Runtime) -> dict:
    """All inputs of the shape's step function, on the meta device.

    train:   params, masks (uint8, as the JAX package stores them: a bf16
             mask tree would double parameter memory), batch
    prefill: params, batch, cache (init_cache on the meta device)
    decode:  params, cache, token [B, 1], pos: the int position of the
             one new token against a seq_len-deep cache (seq_len - 1; the
             port's decode step takes a Python int where the JAX package
             traces a scalar)
    """
    from repro_torch.sharding.rules import param_shapes
    pshapes = param_shapes(cfg)
    if shape.kind == "train":
        return {"params": pshapes,
                "masks": tree_map(lambda w: _meta(w.shape, torch.uint8),
                                  pshapes),
                "batch": batch_specs(cfg, shape, with_labels=True)}
    cache = T.init_cache(cfg, shape.global_batch, shape.seq_len,
                         swa_only=rt.swa_only, device="meta")
    if shape.kind == "prefill":
        return {"params": pshapes,
                "batch": batch_specs(cfg, shape, with_labels=False),
                "cache": cache}
    return {"params": pshapes, "cache": cache,
            "token": _meta((shape.global_batch, 1), torch.int32),
            "pos": shape.seq_len - 1}
