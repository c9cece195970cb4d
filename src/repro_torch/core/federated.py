"""Parameter-efficient FedSGD trainer (paper Sec. II-A, eqs. 2-7).

The port of ``repro/core/federated.py`` (one device). Per round s:

  1. the server broadcasts the previous global gradient v^(s-1);
  2. each selected client computes the importance Q = (v * rho)^2 (eq. 4)
     and prunes the lambda_n fraction of lowest-importance weights (eq. 2);
  3. the client computes a mini-batch gradient on the pruned model (eq. 5)
     and uploads it masked;
  4. the server averages the uploads (eq. 6) and steps w <- w - eta*G (eq. 7).

A ``local_scheme`` (core/local.py: FedAvg with E local steps, FedProx,
FedDyn) replaces step 3's single gradient with E local steps a client; the
client uploads the sum of its step directions, and FedDyn keeps a
per-client correction state ``[N, R, 128]`` (`_ensure_h`), updated in
place by both backends and saved with checkpoints. A client's E batches
are drawn in the JAX package's order: round, then client, then step.

Beyond the paper, as in the JAX package (DESIGN.md §9-§11): a
``channel_noise`` model (the server observes mean + noise, drawn per round
in the packed layout), a ``fault_model`` (dropouts, stragglers, corrupted
uploads and byzantine attacks, drawn on the host per (seed, round, client)
and consumed identically by both backends), and a robust ``aggregator``
(core/aggregators.py) in place of the mean. Every upload passes the
always-on non-finite quarantine; a round with no survivor skips the update.

Two backends, as in the JAX package:

  * ``backend="packed"`` (default) — the device-resident round engine
    (core/round_engine.py) over one packed [R, 128] buffer, with the
    hand-written kernels on CUDA;
  * ``backend="reference"`` — the per-client loop with host thresholds
    (`np.partition`), kept as the numerical oracle. The packed backend
    reproduces it value for value (signed zeros aside), on the CPU and on
    the card.

Batches are drawn with the JAX package's numpy RNG calls, in the same
order, so both packages and both backends see the same batches. Time and
energy bookkeeping uses the port's wireless substrate with the schedule's
per-round (a, lambda, p, f).

Block execution (``rounds_per_dispatch`` > 1, packed backend): the
wireless bookkeeping and stop conditions are schedule-pure, so the
surviving rounds are split into homogeneous blocks that end at eval and
checkpoint rounds (`_plan_blocks`), and each block is one
`RoundEngine.block_step` over a device-resident `ClientStore`: one upload
of the block's schedule operands, batches gathered on the device, and on
CUDA one CUDA-graph replay a round. ``"auto"`` (the default) resolves to
32-round blocks on CUDA and to one round a dispatch on the CPU, as the JAX
package resolves it per backend. Both modes give the same bits.

Fleet-scale populations (``client_store="streamed"``, or "auto" past the
device-memory budget): the trainer takes a lazy roster (data/fleet.py) as
it is, reads sample counts from its ``counts``, and the blocks gather from
per-block cohorts (core/cohort_store.py) in place of the replicated store,
prefetched while the block before them runs. Streaming moves data only:
a streamed run is bit for bit the replicated one. FedDyn's state stays
population-sized; a block works on its cohort's rows of it in a fixed slab
(`_exec_block`).

``run(callbacks=, start_round=)`` take the experiment API's lifecycle hooks
(repro_torch.api.callbacks), fired at materialisation points only, and
resume from a checkpoint taken after round ``start_round - 1``.

Sharded client axis (``shards`` > 1, packed backend): every rank of a
process group (launch/mesh.py) builds the same trainer from the same seed,
draws the same schedule and batches, and runs the engine's sharded bodies
(core/round_engine.py), which meet the other ranks in one collective a
round; streamed cohorts are then sharded too, each rank holding only its
own sub-cohort's rows. Every rank returns the same history. Only rank 0
writes files (checkpoints, through `api.callbacks`); a resume reads on
every rank. The reference backend ignores ``shards``, as the JAX package's
does.

The trainer runs on CUDA unless the caller passes ``device="cpu"``. On
CUDA the packed backend needs a per-sample-weighted loss, so that ragged
clients are padded and every round goes through the engine's kernels; only
on the CPU may a ragged round fall back to the reference loop.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import pruning
from repro_torch.core.cohort_store import CohortStore, fleet_counters_zero
from repro_torch.core.client_store import (ClientStore, StoreBudgetError,
                                           default_device_budget,
                                           estimated_store_nbytes, to_device)
from repro_torch.core.local import local_spec_key
from repro_torch.core.optimizer_ao import Schedule
from repro_torch.core.packing import LANES, ParamPack
from repro_torch.core.round_engine import (RoundEngine, bucket_capacity,
                                           h_scatter)
from repro_torch.device import exact_fp32, resolve_device
from repro_torch.kernels import ops
from repro_torch.tree import leaves, tree_map, unflatten
from repro_torch.wireless.comm import (SystemParams, per_client_delay,
                                       round_energy)

# a tree of tensors: a flat dict (LeNet, mlp-edge) or nested (ResNet)
Params = dict

# the block length "auto" targets on CUDA
DEFAULT_ROUNDS_PER_DISPATCH = 32


def _resolve_rounds_per_dispatch(rpd, device: torch.device) -> int:
    """"auto" -> 1 on the CPU (rounds there are bound by the gradients'
    arithmetic, and one round a dispatch is the audited default for parity
    work), DEFAULT_ROUNDS_PER_DISPATCH on CUDA (where launching a round's
    kernels one by one from Python dominates). Ints pass through; both
    modes give the same bits."""
    if rpd == "auto":
        return 1 if device.type == "cpu" else DEFAULT_ROUNDS_PER_DISPATCH
    r = int(rpd)
    if r < 1:
        raise ValueError(f"rounds_per_dispatch must be >= 1, got {rpd!r}")
    return r


@dataclasses.dataclass
class ClientData:
    x: np.ndarray
    y: np.ndarray

    def __len__(self) -> int:
        return len(self.y)

    def label_histogram(self, num_classes: int) -> np.ndarray:
        return np.bincount(self.y.astype(int), minlength=num_classes).astype(float)


@dataclasses.dataclass
class RoundMetrics:
    round: int
    train_loss: float
    selected: list[int]
    mean_lambda: float
    delay: float
    energy: float
    cumulative_delay: float
    cumulative_energy: float
    test_loss: float | None = None
    test_accuracy: float | None = None
    # uploads that never arrived (dropout / straggler draw) and
    # arrived-but-non-finite uploads the quarantine dropped
    n_faulted: int = 0
    n_quarantined: int = 0
    # clients the robust reducer trimmed / clipped / excluded this round
    # (the aggregator's `stat_field` names which); 0 on the mean path
    n_agg_adjusted: int = 0


class FederatedTrainer:
    """FedSGD with client selection + importance pruning + masked aggregation."""

    def __init__(
        self,
        loss_fn: Callable,
        params: Params,
        clients: Sequence[ClientData],
        *,
        eta: float,
        batch_size: int,
        seed: int = 0,
        prune_spec: pruning.PruneSpec = pruning.PruneSpec(),
        backend: str = "packed",
        weighted_loss_fn: Callable | None = None,
        device=None,
        shards: int | None = None,
        rounds_per_dispatch: int | str = "auto",
        channel_noise=None,
        fault_model=None,
        aggregator=None,
        client_store: str = "auto",
        device_mem_budget: int | None = None,
        local_scheme=None,
        group=None,
    ):
        if backend not in ("packed", "reference"):
            raise ValueError(f"unknown backend {backend!r}")
        if client_store not in ("auto", "replicated", "streamed"):
            raise ValueError(f"unknown client_store {client_store!r}")
        self.device = resolve_device(device)
        # Per-sample-weighted loss: ragged client batches are padded with
        # zero-weight samples so they stay on the packed path
        # (models.make_loss_fn attaches one as loss_fn.weighted).
        self._weighted_loss = (weighted_loss_fn
                               or getattr(loss_fn, "weighted", None))
        if (backend == "packed" and self.device.type == "cuda"
                and self._weighted_loss is None):
            # without it ragged rounds would leave the kernels for the
            # host-threshold reference loop
            raise ValueError(
                "backend='packed' on CUDA needs a per-sample-weighted loss: "
                "pass weighted_loss_fn or a loss_fn with a .weighted "
                "companion (models.make_loss_fn attaches one)")
        self.loss_fn = loss_fn
        # a sequence that publishes per-client `counts` (FleetRoster) stays
        # lazy: list()-ing a 1e5-client roster would materialise the fleet
        self.clients = (clients if getattr(clients, "counts", None)
                        is not None else list(clients))
        self.eta = float(eta)
        self.batch_size = int(batch_size)
        self.rng = np.random.default_rng(seed)
        self.prune_spec = prune_spec
        self.backend = backend
        self.n_fallback_rounds = 0
        # block execution (packed backend): K rounds a block_step over the
        # device-resident store; n_batch_uploads counts per-round
        # host-to-device batch uploads (the block path makes none)
        self.rounds_per_dispatch = (
            _resolve_rounds_per_dispatch(rounds_per_dispatch, self.device)
            if backend == "packed" else 1)
        self._store: ClientStore | None = None
        self.n_batch_uploads = 0
        self.n_block_dispatches = 0
        # the client-store policy: "replicated" builds the full store,
        # "streamed" moves per-block cohorts (core/cohort_store.py), "auto"
        # replicates while the estimated store fits device_mem_budget
        self.client_store = client_store
        self.device_mem_budget = (int(device_mem_budget) if device_mem_budget
                                  else default_device_budget())
        self._store_nbytes: int | None = None
        # the current run's cohort store, and the device slots it leaves
        # for the next run's (the captured graphs gather from them)
        self._cohorts: CohortStore | None = None
        self._cohort_slots = None
        self.streaming = False
        self.fleet_counters = fleet_counters_zero()
        # lifecycle hooks of the current run() (the api.Callback protocol)
        self._callbacks: tuple = ()
        # channel noise (wireless/channel.GaussianAggregateNoise protocol:
        # sample_packed(round, shape, valid)), drawn on the host per round
        # in the packed layout; the reference backend unpacks the same draw
        self.channel_noise = channel_noise
        self._noise_ref_pack: ParamPack | None = None
        self._noise_valid: np.ndarray | None = None
        # client faults (core/faults.FaultModel): host draws keyed (seed,
        # round, kind), consumed identically by both backends
        self.fault_model = fault_model
        self.fault_counters = {"n_dropped": 0, "n_quarantined": 0,
                               "n_skipped_rounds": 0, "n_corrupt_finite": 0}
        # robust aggregation (core/aggregators.py); None keeps the mean
        self.aggregator = aggregator
        self.aggregator_key = (aggregator.spec_key
                               if aggregator is not None else "mean")
        self.agg_counters = ({aggregator.stat_field: 0}
                             if aggregator is not None else {})
        # the local-update scheme (core/local.py; None is single-step
        # FedSGD) and its trainer-reuse key
        self.local_scheme = local_scheme
        self.local_key = local_spec_key(local_scheme)
        # FedDyn's per-client correction state [N, R, 128], zeros at first
        # use (`_ensure_h`) on both backends; allocated once and updated in
        # place, so a CUDA graph that captured it stays valid (restore and
        # reset write into it)
        self._h: torch.Tensor | None = None
        params = tree_map(lambda t: t.detach().to(self.device), params)
        if backend == "packed":
            self.pack = ParamPack.build(params, prune_spec)
            self.engine = RoundEngine(loss_fn, self.pack, eta=self.eta,
                                      weighted_loss_fn=self._weighted_loss,
                                      max_clients=len(self.clients),
                                      aggregator=aggregator,
                                      local_scheme=local_scheme,
                                      device=self.device, shards=shards,
                                      group=group)
            self._w, self._v = self.engine.init_buffers(params)
        else:
            self.pack = self.engine = None
            self._params = params
            self._global_grad = tree_map(torch.zeros_like, params)
        # this process's rank (0 unless the client axis is sharded): rank 0
        # writes the files
        self.rank = 0 if self.engine is None else self.engine.rank

    def reset(self, params: Params, seed: int, *, channel_noise=None,
              fault_model=None) -> None:
        """Reinitialise all run state for a fresh run over the same wiring
        (clients, loss, eta, batch, backend): the trainer-reuse hook of
        `Experiment.build(trainer=)`. The engine, its captured CUDA graphs
        and the device-resident ClientStore survive; params, the global
        gradient, the batch RNG and every counter are reset as the
        constructor sets them, so a reused trainer's trajectory is bit for
        bit a new one's. FedDyn's state is zeroed in place (its tensor stays
        the one the captured graphs update)."""
        self.rng = np.random.default_rng(seed)
        self.channel_noise = channel_noise
        self.fault_model = fault_model
        self.fault_counters = {"n_dropped": 0, "n_quarantined": 0,
                               "n_skipped_rounds": 0, "n_corrupt_finite": 0}
        self.agg_counters = ({self.aggregator.stat_field: 0}
                             if self.aggregator is not None else {})
        self.n_fallback_rounds = 0
        self.n_batch_uploads = 0
        self.n_block_dispatches = 0
        self._callbacks = ()
        # zeroed IN PLACE: a run's CohortStore accumulates into this dict
        self.fleet_counters.update(fleet_counters_zero())
        self.streaming = False
        self._cohorts = None
        if self._h is not None:
            self._h.zero_()
        params = tree_map(lambda t: t.detach().to(self.device), params)
        if self.backend == "packed":
            self._w, self._v = self.engine.init_buffers(params)
        else:
            self._params = params
            self._global_grad = tree_map(torch.zeros_like, params)

    # Params / global gradient are stored packed on the packed backend; the
    # properties give both backends the same dict view.

    @property
    def params(self) -> Params:
        if self.backend == "packed":
            with torch.no_grad():
                return self.pack.unpack(self._w)
        return self._params

    @params.setter
    def params(self, tree: Params) -> None:
        if self.backend == "packed":
            self._w = self.pack.pack(tree)
        else:
            self._params = tree

    @property
    def global_grad(self) -> Params:
        if self.backend == "packed":
            with torch.no_grad():
                return self.pack.unpack(self._v)
        return self._global_grad

    @global_grad.setter
    def global_grad(self, tree: Params) -> None:
        if self.backend == "packed":
            self._v = self.pack.pack(tree)
        else:
            self._global_grad = tree

    # -- round primitives ---------------------------------------------------

    def _draw_indices(self, count: int) -> np.ndarray:
        """THE batch-index draw — one `choice` call per (round, selected
        client), the JAX package's call verbatim, so both packages draw
        the same batches from the same seed."""
        count = int(count)
        return self.rng.choice(
            count, size=min(self.batch_size, count),
            replace=count < self.batch_size)

    def _client_len(self, n: int) -> int:
        """Sample count of client n without materialising it: a roster
        publishes `counts`; a client list falls back to len()."""
        counts = getattr(self.clients, "counts", None)
        return int(counts[n]) if counts is not None else len(self.clients[n])

    def _sample_batch(self, client: ClientData):
        """Draw one mini-batch: (x, y, sample_weights) as numpy arrays.

        A client smaller than the batch size yields a short batch; with a
        weighted loss it is padded back to batch_size with repeated samples
        carrying weight 0, so every batch stacks and the round stays on the
        packed path. The RNG stream is the unpadded draw's."""
        idx = self._draw_indices(len(client))
        x, y = client.x[idx], client.y[idx]
        n = len(idx)
        if n < self.batch_size and self._weighted_loss is not None:
            pad = self.batch_size - n
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)])
            y = np.concatenate([y, np.repeat(y[-1:], pad, axis=0)])
            sw = np.zeros(self.batch_size, np.float32)
            sw[:n] = 1.0
        else:
            sw = np.ones(n, np.float32)
        return x, y, sw

    def _value_and_grad(self, params: Params, x, y, sw=None):
        ps = [t.detach().requires_grad_(True) for t in leaves(params)]
        tree = unflatten(params, ps)
        with torch.enable_grad(), exact_fp32():
            if sw is None:
                loss = self.loss_fn(tree, x, y)
            else:
                loss = self._weighted_loss(tree, x, y, sw)
            grads = torch.autograd.grad(loss, ps)
        return loss.detach(), unflatten(params, grads)

    def _batch_grad(self, params: Params, batch):
        """(loss, gradient tree) of one drawn batch (x, y, sample weights):
        the plain mean for a full batch, the weighted mean the packed engine
        takes for a ragged client."""
        x, y, sw = batch
        x = torch.as_tensor(x, device=self.device)
        y = torch.as_tensor(y, device=self.device)
        if sw is None or sw.all():
            return self._value_and_grad(params, x, y)
        return self._value_and_grad(params, x, y,
                                    torch.as_tensor(sw, device=self.device))

    def _masks(self, lam: float) -> Params:
        """Client masks at pruning ratio lam from the host threshold."""
        if lam > 0.0:
            imp = pruning.taylor_importance(self.params, self.global_grad)
            return pruning.build_masks(imp, lam, self.prune_spec)
        return tree_map(lambda w: torch.ones_like(w, dtype=torch.float32),
                        self.params)

    def client_update(self, n: int, lam: float, batch: tuple | None = None):
        """Steps 2-3 for client n: returns (masked gradient, mask, loss)."""
        masks = self._masks(lam)
        pruned = pruning.apply_masks(self.params, masks)
        if batch is None:
            batch = self._sample_batch(self.clients[n])
        loss, grads = self._batch_grad(pruned, batch)
        grads = pruning.apply_masks(grads, masks)  # pruned coords not uploaded
        return grads, masks, float(loss)

    @torch.no_grad()
    def _client_update_local(self, n: int, lam: float, batches: list,
                             h_row=None):
        """The reference body of the local-update schemes, op for op the
        engine's `_local_client`: E local steps from the pruned start u0 =
        w*mask, each taking the masked gradient at the current iterate
        (with respect to the leaves, from the host-threshold masks), adding
        the scheme's regularizer, accumulating the direction into the
        upload (from zeros) and stepping u <- u - eta*d, every op flushed
        as XLA flushes it. The step arithmetic runs on the packed layout,
        as the reference's round tail does: every op is elementwise, so
        each coordinate gets the per-leaf bits, in one launch an op.
        `batches`: the client's E drawn batches in step order; `h_row`: its
        packed FedDyn state row or None. Returns (upload tree, loss at step
        0, packed FedDyn state delta or None)."""
        ls = self.local_scheme
        pack = self._noise_layout()
        masks = self._masks(lam)
        u0 = pack.pack(pruning.apply_masks(self.params, masks))
        u, acc = u0, torch.zeros_like(u0)
        hm = None if h_row is None else h_row * pack.pack(masks)
        loss0 = None
        for t, batch in enumerate(batches):
            loss, g = self._batch_grad(pack.unpack(u), batch)
            if t == 0:
                loss0 = float(loss)
            g = pack.pack(pruning.apply_masks(g, masks))
            d = (g if ls.name == "fedavg" else
                 ops.packed_local_delta(g, u, u0, ls.coeff, hm=hm))
            acc = ops.flush_add(acc, d)
            u = ops.flush_sub(u, ops.flush_mul(self.eta, d))
        hd = (ops.flush_mul(ls.alpha, ops.flush_sub(u, u0)) if ls.stateful
              else None)
        return pack.unpack(acc), loss0, hd

    def _ensure_h(self) -> torch.Tensor:
        """FedDyn's correction state [N, R, 128] on the trainer's device,
        zeros at first use; the same tensor for the trainer's life."""
        if self._h is None:
            pack = self._noise_layout()
            self._h = torch.zeros((len(self.clients), pack.rows, LANES),
                                  dtype=torch.float32, device=self.device)
        return self._h

    def _client_upload(self, n: int, lam: float, batch, dyn: bool):
        """(upload tree, loss, packed FedDyn state delta or None) of client
        n in the reference loop: `client_update`, or the local steps (batch
        is then the client's E batches)."""
        if self.local_scheme is None:
            g, _, loss = self.client_update(n, lam, batch=batch)
            return g, loss, None
        return self._client_update_local(
            n, lam, batch, h_row=self._h[n] if dyn else None)

    @torch.no_grad()
    def server_step(self, grads: list[Params],
                    noise: Params | None = None) -> None:
        """Eqs. (6)-(7): average the uploads, FedSGD update. `noise` (a
        dict like the params) is the noisy aggregation channel: the server
        observes mean(g) + noise and broadcasts and steps with it. Every op
        is its own eager dispatch, so eta*g is rounded before the
        subtraction, exactly as the packed engine's aggregate computes it,
        and flushed as XLA flushes it (`ops.flush_add` / `flush_mul`)."""
        pack = self._noise_layout()
        self._server_step_packed(
            [pack.pack(g) for g in grads],
            None if noise is None else pack.pack(noise))

    def _server_step_packed(self, gps: list[torch.Tensor],
                            noise: torch.Tensor | None = None) -> None:
        """`server_step` on uploads (and noise) in the packed [R, 128]
        layout. Every op is elementwise, so each coordinate gets the bits
        the same ops would give leaf by leaf, in one launch an op."""
        if not gps:
            return
        g = gps[0]
        for extra in gps[1:]:
            g = ops.flush_add(g, extra)
        g = ops.flush_mul(g, 1.0 / len(gps))
        if noise is not None:
            g = ops.flush_add(g, noise)
        self._step(g)

    def _step(self, gp: torch.Tensor) -> None:
        """Broadcast the packed g and take the FedSGD step w - eta*g,
        flushed, on the packed layout."""
        pack = self._noise_layout()
        w = pack.pack(self.params)
        self.global_grad = pack.unpack(gp)
        self.params = pack.unpack(
            ops.flush_sub(w, ops.flush_mul(self.eta, gp)))

    # -- scenario operands (noise, poison) ----------------------------------

    def _noise_layout(self) -> ParamPack:
        """The packed layout noise and poison are drawn in, and the
        reference backend's round tail runs in: the engine's pack on the
        packed backend, a layout-only pack on the reference backend."""
        if self.pack is not None:
            return self.pack
        if self._noise_ref_pack is None:
            self._noise_ref_pack = ParamPack.build(self._params,
                                                   self.prune_spec)
        return self._noise_ref_pack

    def _valid_lanes(self) -> np.ndarray:
        if self._noise_valid is None:
            self._noise_valid = self._noise_layout().valid_mask()
        return self._noise_valid

    def _noise_packed(self, s: int) -> np.ndarray:
        """Round-s aggregation noise as a packed [R, 128] host array with
        padding lanes zeroed."""
        pack = self._noise_layout()
        return self.channel_noise.sample_packed(s, (pack.rows, LANES),
                                                self._valid_lanes())

    def _noise_tensor(self, s: int) -> torch.Tensor:
        """The same round-s draw on the device, packed (reference backend):
        every coordinate gets the packed engine's value."""
        return torch.as_tensor(self._noise_packed(s), device=self.device)

    def _poison_stack(self, fault) -> np.ndarray | None:
        """A fault draw's lazy additive poison in the packed [C_sel, R, 128]
        layout (padding lanes 0.0), shared by both backends."""
        if fault is None or getattr(fault, "poison", None) is None:
            return None
        pack = self._noise_layout()
        return fault.poison((pack.rows, LANES), self._valid_lanes())

    # -- rounds -------------------------------------------------------------

    def _reference_round(self, selected: list[int], lam_s: np.ndarray,
                         batches: list, s: int = 0, fault=None):
        """Per-client loop with host-side thresholds, the fault draw applied
        eagerly as the packed engine applies it: every selected client
        computes its update, corruption factors scale the upload, poison is
        added, uploads that never arrived are dropped, a non-finite upload
        is quarantined, and `server_step` averages the survivors (and skips
        the update when none survive). The uploads are packed as they
        arrive: the fault ops are elementwise, so the layout does not change
        their bits. With FedDyn the survivors' state rows then move by
        their deltas (`h_scatter`, the engine's own update). A robust
        aggregator routes through `_reference_robust_round`. Returns
        (per-client losses, surviving upload count, reducer count or
        None)."""
        if self.aggregator is not None:
            return self._reference_robust_round(selected, lam_s, batches,
                                                s=s, fault=fault)
        pack = self._noise_layout()
        gps, losses = [], []
        ok = (np.asarray(fault.upload_ok, bool) if fault is not None
              else np.ones(len(selected), bool))
        cf = fault.corrupt if fault is not None else None
        po = self._poison_stack(fault)
        dyn = self._dyn()
        surv_ids, surv_hds = [], []
        for j, (n, batch) in enumerate(zip(selected, batches)):
            g, loss, hd = self._client_upload(n, float(lam_s[n]), batch, dyn)
            losses.append(loss)
            if not ok[j]:
                continue                     # the upload never arrived
            gp = pack.pack(g)
            if cf is not None:
                gp = ops.flush_mul(gp, cf[j])
            if po is not None:
                # added to EVERY arriving upload (zeros for clean clients),
                # as the engine adds the whole stack: g + 0.0 turns -0.0
                # into +0.0 on both backends alike
                gp = ops.flush_add(gp, torch.as_tensor(po[j],
                                                       device=self.device))
            if bool(torch.isfinite(gp).all()):
                gps.append(gp)
                if dyn:
                    surv_ids.append(n)
                    surv_hds.append(hd)
        self._server_step_packed(
            gps, noise=self._noise_tensor(s) if self.channel_noise else None)
        self._h_update(surv_ids, surv_hds)
        return losses, len(gps), None

    def _dyn(self) -> bool:
        """Whether the scheme carries FedDyn's state (allocated here)."""
        if self.local_scheme is None or not self.local_scheme.stateful:
            return False
        self._ensure_h()
        return True

    @torch.no_grad()
    def _h_update(self, ids: list[int], hds: list) -> None:
        """The reference's FedDyn update: h[n] -= hd for each surviving
        client, in place."""
        if ids:
            h_scatter(self._h, torch.as_tensor(ids, device=self.device),
                      -torch.stack(hds))

    @torch.no_grad()
    def _reference_robust_round(self, selected: list[int],
                                lam_s: np.ndarray, batches: list, s: int = 0,
                                fault=None):
        """Eager robust round over the SAME bucket-padded [C_b, R, 128]
        stack as the packed engine: each selected client's masked gradient
        packed at its position, faults applied as ``cf * g + poison``, the
        effective weight ``arrived & finite``, padding rows zero with weight
        0 (the reducers are weight-aware and bucket-capacity invariant, so
        zero padding and the engine's replicated batches give the same
        bits). The same `Aggregator.reduce` runs, and the update is the
        eager form of the engine's inv = 1 tail. No survivor: no update.
        FedDyn's survivors move their state rows as in `_reference_round`."""
        pack = self._noise_layout()
        ok = (np.asarray(fault.upload_ok, bool) if fault is not None
              else np.ones(len(selected), bool))
        cf = fault.corrupt if fault is not None else None
        po = self._poison_stack(fault)
        dyn = self._dyn()
        losses, gps, cws, hds = [], [], [], []
        for j, (n, batch) in enumerate(zip(selected, batches)):
            g, loss, hd = self._client_upload(n, float(lam_s[n]), batch, dyn)
            losses.append(loss)
            hds.append(hd)
            gp = pack.pack(g)
            if cf is not None:
                gp = ops.flush_mul(gp, cf[j])
            if po is not None:
                gp = ops.flush_add(gp, torch.as_tensor(po[j],
                                                       device=self.device))
            fin = bool(torch.isfinite(gp).all())
            gps.append(gp)
            cws.append(1.0 if (ok[j] and fin) else 0.0)
        c_b = bucket_capacity(len(selected), max_clients=len(self.clients))
        zero = torch.zeros((pack.rows, LANES), dtype=torch.float32,
                           device=self.device)
        gps += [zero] * (c_b - len(selected))
        cws += [0.0] * (c_b - len(selected))
        cw = torch.as_tensor(np.asarray(cws, np.float32), device=self.device)
        ghat, ast = self.aggregator.reduce(torch.stack(gps), cw)
        n_ok = int(np.asarray(cws).sum())
        if dyn:
            live = [j for j, c in enumerate(cws[:len(selected)]) if c > 0]
            self._h_update([selected[j] for j in live],
                           [hds[j] for j in live])
        if n_ok > 0:
            if self.channel_noise:
                ghat = ops.flush_add(ghat, self._noise_tensor(s))
            self._step(ghat)
        return losses, n_ok, ast

    def _round(self, selected: list[int], lam_s: np.ndarray, s: int = 0,
               fault=None):
        """Steps 2-4 for one round; batches are drawn once, in selected
        order (with a local scheme E a client, client-major), so both
        backends consume the identical RNG sequence.
        Returns (losses, n_ok, agg_stat) without synchronizing on the packed
        path (agg_stat is None on the mean path)."""
        ls = self.local_scheme
        if ls is None:
            batches = [self._sample_batch(self.clients[n]) for n in selected]
            flat = batches
        else:
            batches = [[self._sample_batch(self.clients[n])
                        for _ in range(ls.steps)] for n in selected]
            flat = [b for bs in batches for b in bs]
        stackable = len({b[0].shape for b in flat}) <= 1
        if self.backend == "packed" and not stackable:
            if self.device.type == "cuda":
                raise RuntimeError(
                    "the round's client batches do not stack "
                    f"({sorted({b[0].shape for b in batches})}); the packed "
                    "backend on CUDA runs only through the round engine")
            # CPU only: ragged batches without a weighted loss take the
            # reference loop, through the dict views of the packed buffers
            self.n_fallback_rounds += 1
        if self.backend != "packed" or not stackable:
            return self._reference_round(selected, lam_s, batches, s=s,
                                         fault=fault)
        lam_sel = np.asarray([lam_s[n] for n in selected], np.float64)
        shape = (len(selected), -1) if ls is None else (len(selected),
                                                         ls.steps, -1)
        xs = np.stack([b[0] for b in flat])
        xs = to_device(xs.reshape(shape[:-1] + xs.shape[1:]), self.device)
        ys = to_device(np.stack([b[1] for b in flat]).reshape(shape),
                       self.device)
        sws = np.stack([b[2] for b in flat]).reshape(shape)
        dyn = {}
        if self._dyn():
            dyn = dict(h=self._h, client_ids=np.asarray(selected, np.int64))
        self.n_batch_uploads += 1
        self._w, self._v, losses, _, _ = self.engine.round_step(
            self._w, self._v, xs, ys, lam_sel,
            # all-ones weights carry no information: the engine keeps a
            # device copy of them
            sample_weights=None if sws.all() else sws,
            noise=self._noise_packed(s) if self.channel_noise else None,
            upload_weights=(fault.upload_ok.astype(np.float32)
                            if fault is not None else None),
            corrupt=fault.corrupt if fault is not None else None,
            poison=self._poison_stack(fault), **dyn)
        ast = (self.engine.last_agg_stat if self.aggregator is not None
               else None)
        return losses, self.engine.last_n_ok, ast

    # -- block execution ----------------------------------------------------

    def store_nbytes(self) -> int:
        """Estimated device bytes of a replicated ClientStore for this
        trainer's clients (cached; never materialises a roster)."""
        if self._store_nbytes is None:
            self._store_nbytes = estimated_store_nbytes(self.clients)
        return self._store_nbytes

    def store_mode(self) -> str:
        """The resolved client-store policy, "replicated" or "streamed":
        "auto" replicates while the estimated store fits device_mem_budget
        and streams past it."""
        if self.client_store != "auto":
            return self.client_store
        return ("replicated" if self.store_nbytes() <= self.device_mem_budget
                else "streamed")

    def check_store_budget(self) -> None:
        """Raise StoreBudgetError when block execution would build a
        replicated store over the device-memory budget; `Experiment.build`
        calls it at spec time and `_ensure_store` before the copy."""
        if (self.backend == "packed" and self.rounds_per_dispatch > 1
                and self.store_mode() == "replicated"
                and self.store_nbytes() > self.device_mem_budget):
            raise StoreBudgetError(len(self.clients), self.store_nbytes(),
                                   self.device_mem_budget)

    def _ensure_store(self) -> ClientStore:
        """Build (once) the device-resident store the blocks gather from."""
        if self._store is None:
            self.check_store_budget()
            self._store = ClientStore.build(self.clients, device=self.device)
        return self._store

    def _block_key(self, selected: list[int], lam_s: np.ndarray):
        """What rounds of one block share (client-axis bucket, shared or
        per-client lambda, batch length), or None for a round the block
        path cannot take (empty, or mixed batch lengths without a weighted
        loss: the per-round path handles those as before)."""
        if not selected:
            return None
        lens = [min(self.batch_size, self._client_len(n)) for n in selected]
        if self._weighted_loss is not None:
            blen = self.batch_size       # ragged clients pad to batch_size
        elif len(set(lens)) == 1:
            blen = lens[0]               # uniformly short: packed, no pad
        else:
            return None
        ks = np.floor(np.asarray([lam_s[n] for n in selected], np.float64)
                      * self.pack.n_prunable).astype(np.int32)
        shared = bool((ks == ks[0]).all())
        return (self.engine.bucket_size(len(selected)), shared, blen)

    def _plan_blocks(self, infos, boundaries: set, rpd: int,
                     first_round: int = 0) -> dict:
        """Split the (truncated) schedule into blocks: {start: K}. Rounds
        group while their _block_key matches, and a group ends at a
        boundary round (eval or checkpoint: both read the state after that
        round). Each group is cut into power-of-two blocks of at most `rpd`
        rounds (no padded rounds, which would cost a round of gradients
        each). `first_round` skips rounds already run before a resume."""
        blocks: dict[int, int] = {}
        n = len(infos)
        i = first_round
        while i < n:
            key = self._block_key(infos[i][0], infos[i][1])
            if key is None:
                i += 1
                continue
            j = i
            while j < n and self._block_key(infos[j][0], infos[j][1]) == key:
                j += 1
                if (j - 1) in boundaries:
                    break
            start, left = i, j - i
            while left:
                k = 1 << (min(left, rpd).bit_length() - 1)
                blocks[start] = k
                start += k
                left -= k
            i = j
        return blocks

    def _block_cids(self, start: int, n_rounds: int,
                    infos) -> tuple[np.ndarray, np.ndarray]:
        """The block's client ids [K, c_max] (a round padded by repeating
        its last real client) and real counts [K]; consumes no RNG."""
        sels = [infos[start + k][0] for k in range(n_rounds)]
        counts = np.asarray([len(s) for s in sels], np.int64)
        cids = np.empty((n_rounds, int(counts.max())), np.int32)
        for k, sel in enumerate(sels):
            cids[k, :len(sel)] = sel
            cids[k, len(sel):] = sel[-1]
        return cids, counts

    def _exec_block(self, start: int, n_rounds: int, infos,
                    out: dict) -> None:
        """Rounds [start, start + n_rounds) as one engine.block_step; each
        round's (losses, n_ok, agg stat), still on the device, lands in
        `out`. The indices are drawn with the `choice` calls `_sample_batch`
        makes, in the same order (round, client, then local step), so the
        batch stream is the per-round path's bit for bit."""
        sels = [infos[start + k][0] for k in range(n_rounds)]
        cids, counts = self._block_cids(start, n_rounds, infos)
        c_max = int(counts.max())
        blen = self._block_key(sels[0], infos[start][1])[2]
        ls = self.local_scheme
        steps = 1 if ls is None else ls.steps
        idxs = np.empty((n_rounds, c_max, steps, blen), np.int32)
        sw = np.ones((n_rounds, c_max, steps, blen), np.float32)
        lams = np.empty((n_rounds, c_max), np.float64)
        fault_on = self.fault_model is not None
        fw = np.ones((n_rounds, c_max), np.float32) if fault_on else None
        # per round: its factors and poison, or None where round_step
        # would take none
        cfs: list = [None] * n_rounds
        pos: list = [None] * n_rounds
        any_ragged = False
        for k, sel in enumerate(sels):
            lam_s = infos[start + k][1]
            fault = infos[start + k][6]
            if fault is not None:
                fw[k, :len(sel)] = np.asarray(fault.upload_ok, np.float32)
                po = self._poison_stack(fault)
                if fault.corrupt is not None or po is not None:
                    cf = np.ones(c_max, np.float32)
                    if fault.corrupt is not None:
                        cf[:len(sel)] = fault.corrupt
                    cfs[k] = cf
                if po is not None:
                    pk = np.zeros((c_max,) + po.shape[1:], np.float32)
                    pk[:len(sel)] = po
                    pos[k] = pk
            for j, n in enumerate(sel):
                lams[k, j] = lam_s[n]
                for t in range(steps):
                    draw = self._draw_indices(self._client_len(n))
                    m = len(draw)
                    if m < blen:         # ragged: repeat the last sample
                        idxs[k, j, t, :m] = draw         # with weight 0, as
                        idxs[k, j, t, m:] = draw[-1]     # _sample_batch pads
                        sw[k, j, t, m:] = 0.0
                        any_ragged = True
                    else:
                        idxs[k, j, t] = draw
            c_k = len(sel)               # pad rows as _block_cids pads cids
            idxs[k, c_k:] = idxs[k, c_k - 1]
            sw[k, c_k:] = sw[k, c_k - 1]
            lams[k, c_k:] = lam_s[sel[-1]]
        if ls is None:                   # the FedSGD body's [K, C, B]
            idxs, sw = idxs[:, :, 0], sw[:, :, 0]
        h_arg = self._h if self._dyn() else None
        slab = None
        if self._cohorts is not None:
            # streamed: this block's prefetched cohort stands in for the
            # full store, and global ids remap to its device rows (the
            # index draws above do not depend on the layout)
            store = self._cohorts.acquire(start)
            cids = store.remap(cids)
            if h_arg is not None and not store.sharded:
                # FedDyn over a cohort (the engine refuses a sharded one): its clients' rows of h, in cohort
                # row order and padded with the last id, go into the slots'
                # fixed slab (the graphs capture its address), which the
                # remapped ids index as they index the data; afterwards
                # only the unique prefix goes back, an exact round trip
                ids = store.ids_by_shard[0]
                rows = len(store.counts)
                gidx = np.concatenate(
                    [ids, np.full(rows - len(ids), ids[-1], np.int64)])
                full = self._cohorts.slots.h_slab(self.pack.rows, LANES)
                slab = full[store.base:store.base + rows]
                slab.copy_(h_arg.index_select(
                    0, torch.as_tensor(gidx, device=self.device)))
                h_arg = full
        else:
            store = self._ensure_store()
        noises = (np.stack([self._noise_packed(start + k)
                            for k in range(n_rounds)])
                  if self.channel_noise else None)
        self._w, self._v, losses, _ = self.engine.block_step(
            self._w, self._v, store, cids, idxs, lams, counts,
            sample_weights=sw if any_ragged else None, noises=noises,
            upload_weights=fw,
            corrupt=cfs if any(c is not None for c in cfs) else None,
            poisons=pos if any(p is not None for p in pos) else None,
            h=h_arg)
        if slab is not None:
            n_ids = len(store.ids_by_shard[0])
            self._h.index_copy_(
                0, torch.as_tensor(store.ids_by_shard[0], device=self.device),
                slab[:n_ids])
        n_oks = self.engine.last_n_ok
        asts = (self.engine.last_agg_stat if self.aggregator is not None
                else None)
        self.n_block_dispatches += 1
        for k in range(n_rounds):
            out[start + k] = (losses[k, :int(counts[k])], n_oks[k],
                              asts[k] if asts is not None else None)
        # right after the dispatch: the block's results are still on the
        # device, so a hook here forces no sync
        for cb in self._callbacks:
            cb.on_block_end(start, n_rounds, self)

    # -- full run -----------------------------------------------------------

    def run(
        self,
        schedule: Schedule,
        sp: SystemParams,
        h_up: np.ndarray,
        h_down: np.ndarray,
        *,
        eval_fn: Callable[[Params], tuple[float, float]] | None = None,
        eval_every: int = 10,
        stop_delay: float | None = None,
        stop_energy: float | None = None,
        callbacks: Sequence = (),
        start_round: int = 0,
    ) -> list[RoundMetrics]:
        """Execute the schedule. eval_fn(params) -> (test_loss, test_acc),
        at rounds s % eval_every == 0 and at the last round.

        ``callbacks`` follow the repro_torch.api.Callback protocol and fire
        at materialisation points only (never a per-round device sync):
        ``on_round_end(m, self)`` once a round, in order, batched at the
        next materialisation point; ``on_eval(m, self)`` after eval_fn;
        ``on_block_end(start, k, self)`` after each block dispatch;
        ``on_checkpoint(m, self)`` at rounds where ``m.round %
        cb.checkpoint_every == 0``, which become block boundaries, so the
        state there is exactly the state after that round.

        ``start_round`` skips the rounds before it (their bookkeeping is
        still computed, so cumulative counters, stop truncation and the
        eval cadence are an uninterrupted run's): with params, the global
        gradient and the batch RNG restored from a checkpoint taken after
        round ``start_round - 1`` the rest of the run replays bit for bit.
        The returned history covers the executed rounds only.

        Per-round train losses stay device tensors and are materialised
        lazily (at eval and checkpoint points and at the end), so the
        packed rounds never wait on a device->host sync. With
        ``rounds_per_dispatch`` > 1 the rounds run in blocks
        (`_plan_blocks`, `_exec_block`)."""
        callbacks = tuple(callbacks)
        self._callbacks = callbacks
        history: list[RoundMetrics] = []
        # rounds whose losses / survivor counts are still device values:
        # (metrics, losses, n_ok, fault draw, reducer count)
        pending: list[tuple[RoundMetrics, Any, Any, Any, Any]] = []

        def materialize():
            for m, losses, n_ok, fault, ast in pending:
                mask = (np.asarray(fault.upload_ok, bool)
                        if fault is not None else None)
                if losses is not None:
                    if isinstance(losses, torch.Tensor):
                        losses = losses.cpu()
                    # float64 mean over the arrived uploads' fp32 losses
                    # (the server never observes a dropped client's loss)
                    arr = np.asarray(losses, np.float64)
                    if mask is not None:
                        arr = arr[mask]
                    m.train_loss = (float(arr.mean()) if arr.size
                                    else float("nan"))
                n_sel = len(m.selected)
                n_up = int(mask.sum()) if mask is not None else n_sel
                m.n_faulted = n_sel - n_up
                if n_ok is not None:
                    ok = int(n_ok)
                    m.n_quarantined = max(0, n_up - ok)
                    if n_sel and ok == 0:
                        self.fault_counters["n_skipped_rounds"] += 1
                self.fault_counters["n_dropped"] += m.n_faulted
                self.fault_counters["n_quarantined"] += m.n_quarantined
                # corrupt-but-FINITE arrivals, which the isfinite guard
                # cannot see, counted from the draw
                if fault is not None:
                    arrived = (mask if mask is not None
                               else np.ones(n_sel, bool))
                    ncf = 0
                    if fault.corrupt is not None:
                        cfv = np.asarray(fault.corrupt, np.float64)
                        ncf += int((arrived & np.isfinite(cfv)
                                    & (cfv != 1.0)).sum())
                    flags = getattr(fault.poison, "flags", None)
                    if flags is not None:
                        ncf += int((arrived & np.asarray(flags, bool)).sum())
                    self.fault_counters["n_corrupt_finite"] = (
                        self.fault_counters.get("n_corrupt_finite", 0) + ncf)
                if ast is not None and self.aggregator is not None:
                    m.n_agg_adjusted = int(ast)
                    sf = self.aggregator.stat_field
                    self.agg_counters[sf] = (self.agg_counters.get(sf, 0)
                                             + m.n_agg_adjusted)
                for cb in callbacks:
                    cb.on_round_end(m, self)
            pending.clear()

        n_rounds = schedule.a.shape[0]
        infos = []
        cum_t = cum_e = 0.0
        for s in range(n_rounds):
            a_s, lam_s = schedule.a[s], schedule.lam[s]
            p_s, f_s = schedule.power[s], schedule.freq[s]
            selected = [int(i) for i in np.flatnonzero(a_s > 0)]
            per = per_client_delay(lam_s, p_s, f_s, h_up, h_down, sp)
            gated = np.asarray(a_s, np.float64) * per
            d = float(gated.max()) if gated.size else 0.0
            e = round_energy(a_s, lam_s, p_s, f_s, h_up, h_down, sp)
            cum_t += d
            cum_e += e
            fault = None
            if self.fault_model is not None and selected:
                sel_arr = np.asarray(selected, int)
                fault = self.fault_model.draw(
                    s, len(self.clients), sel_arr,
                    delays=per[sel_arr], deadline=d)
            infos.append((selected, lam_s, d, e, cum_t, cum_e, fault))
            if stop_delay is not None and cum_t >= stop_delay:
                break
            if stop_energy is not None and cum_e >= stop_energy:
                break

        # checkpoint rounds: materialisation points and block boundaries,
        # so the hook sees the state after exactly that round
        def _ckpt_cbs(s: int) -> list:
            return [cb for cb in callbacks
                    if getattr(cb, "checkpoint_every", None)
                    and s % cb.checkpoint_every == 0]

        ckpt_rounds = {s for s in range(start_round, len(infos))
                       if _ckpt_cbs(s)}
        blocks: dict[int, int] = {}
        if self.rounds_per_dispatch > 1 and self.backend == "packed":
            boundaries = set(ckpt_rounds)
            if eval_fn is not None:
                boundaries |= {s for s in range(len(infos))
                               if s % eval_every == 0}
                boundaries.add(n_rounds - 1)
            blocks = self._plan_blocks(infos, boundaries,
                                       self.rounds_per_dispatch,
                                       first_round=start_round)

        self.streaming = False
        self._cohorts = None
        if blocks and self.store_mode() == "streamed":
            # the cohort plans are a pure function of the block partition
            # (selections only, no RNG), so a resumed run replays the same
            # cohort schedule; the first two cohorts prefetch from here
            self._cohorts = CohortStore(
                self.clients, shards=self.engine.shards,
                rank=self.engine.rank, bucket_size=self.engine.bucket_size,
                max_clients=len(self.clients),
                counters=self.fleet_counters, device=self.device,
                slots=self._cohort_slots)
            self._cohorts.schedule(
                [(st, *self._block_cids(st, blocks[st], infos))
                 for st in sorted(blocks)])
            self._cohort_slots = self._cohorts.slots
            self.streaming = True

        block_losses: dict[int, Any] = {}
        try:
            for s, (selected, lam_s, d, e, cum_t, cum_e,
                    fault) in enumerate(infos):
                if s < start_round:
                    continue       # run before the checkpoint
                if s in blocks:
                    self._exec_block(s, blocks[s], infos, block_losses)
                if s in block_losses:
                    losses, n_ok, ast = block_losses.pop(s)
                elif selected:
                    losses, n_ok, ast = self._round(selected, lam_s, s=s,
                                                    fault=fault)
                else:
                    losses = n_ok = ast = None
                m = RoundMetrics(
                    round=s, train_loss=float("nan"), selected=selected,
                    mean_lambda=(float(lam_s[selected].mean())
                                 if selected else 0.0),
                    delay=d, energy=e,
                    cumulative_delay=cum_t, cumulative_energy=cum_e)
                pending.append((m, losses, n_ok, fault, ast))
                is_eval = (eval_fn is not None
                           and (s % eval_every == 0 or s == n_rounds - 1))
                if is_eval or s in ckpt_rounds:
                    materialize()
                    if is_eval:
                        m.test_loss, m.test_accuracy = eval_fn(self.params)
                        for cb in callbacks:
                            cb.on_eval(m, self)
                    for cb in _ckpt_cbs(s):
                        cb.on_checkpoint(m, self)
                history.append(m)
            materialize()
        finally:
            # a raising hook (a simulated kill after a checkpoint) must not
            # leave callback references on the trainer; the cohort store's
            # prefetch threads go with it (self.streaming stays set for the
            # run's summary)
            self._callbacks = ()
            if self._cohorts is not None:
                self._cohorts.close()
                self._cohorts = None
        return history
