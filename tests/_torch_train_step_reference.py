"""The straightforward masked-FedSGD train step, kept as the reference the
port's step is held to bit for bit (tests/test_torch_train_step_memory.py
on the CPU, tests/test_torch_cuda.py on the card). Imports no JAX.

It is the step as it was written before the step learned to hold only its
state: the masked tree w * m built for every microbatch, the gradient of
w by torch.autograd.grad as a whole tree beside it, the fp32 accumulator
(bf16 above 1e11 parameters) added to after each microbatch, then the
update w - eta (g m) over the whole tree at once. Its results are the
ones JAX's step is compared with (test_make_train_step_matches_jax)."""
import torch

from repro_torch.launch.steps import (_chunks, structured_slice,
                                      train_microbatches, value_and_grad)
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import constrain
from repro_torch.tree import leaves, tree_map


def make_train_step(cfg, rt, *, eta=1e-2, microbatches=None,
                    structured_lambda=0.0):
    mb = train_microbatches(cfg) if microbatches is None else microbatches
    acc_dtype = torch.bfloat16 if T.param_count(cfg) > 100e9 \
        else torch.float32

    def masked_loss(p, masks, tokens, labels, extra):
        pm = tree_map(lambda w, m: w * m.to(w.dtype), p, masks)
        if structured_lambda > 0:
            pm, _ = structured_slice(pm, structured_lambda)
        return T.loss_fn(pm, tokens, labels, cfg, rt, extra or None)

    def loss_and_grad(params, masks, tokens, labels, extra):
        return value_and_grad(
            lambda p: masked_loss(p, masks, tokens, labels, extra), params)

    def train_step(params, masks, batch):
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        if mb == 1:
            loss, grads = loss_and_grad(params, masks, batch["tokens"],
                                        batch["labels"], extra)
        else:
            parts = {k: _chunks(v, mb) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype),
                             params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            for i in range(mb):
                li, gi = loss_and_grad(
                    params, masks, parts["tokens"][i], parts["labels"][i],
                    {k: parts[k][i] for k in extra})
                for a, g in zip(leaves(grads), leaves(gi)):
                    a.add_(g)
                del gi
                loss = loss + li
            for g in leaves(grads):
                g.div_(mb)
            loss = loss / mb
        with torch.no_grad():
            new_params = tree_map(
                lambda w, g, m: w - eta * (g * m.to(g.dtype)).to(w.dtype),
                params, grads, masks)
        return constrain(loss), new_params

    return train_step
