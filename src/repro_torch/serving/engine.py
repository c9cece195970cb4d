"""Continuous-batching serving engine (the port of
``repro/serving/engine.py``).

A fixed pool of `max_batch` decode slots shares one cache. Requests queue
in; when a slot frees, the next request is prefilled into that slot's row
of the cache and joins the decode batch. Every engine step decodes one
token for each active slot, each at its own position.

As in the JAX package:
  * slots are taken with `free_slots.pop()` and returned to its end;
  * the prompt minus its last token is prefilled, right-padded with token
    0 to a bucket of `prompt_buckets` (the SSM family prefills the exact
    length: its state has no positional mask), and the first decode step
    feeds the last prompt token at pos = len(prompt) - 1, so the padded
    cache entries are never attended;
  * each slot decodes as a batch of one against its own cache row, so the
    engine computes exactly what a sequential generation computes;
  * `extra` (the audio family's encoder input, the vlm's vision
    embeddings: one batch-1 memory) goes to every prefill, which writes
    the memory into the slot's cache row for its decode steps;
  * greedy decoding takes the first maximum of the fp32 logits.

Where the port differs:
  * the cache rows are views into the engine's cache, written in place;
  * a slot's SSM state and conv rows are zeroed when a request is admitted.
    The JAX engine does not zero them, so a request inherits the state its
    slot's previous occupant (and the free slot's garbage decodes) left,
    and its output then differs from a fresh sequential generation
    (ROADMAP.md section 3); with the zeroing the port meets the engine's
    own contract, engine == sequential generation;
  * free slots are not decoded (the JAX engine decodes them and ignores
    the result);
  * temperature sampling draws from an explicit torch.Generator seeded
    with `seed`, on the engine's device; it is not the JAX draw.

The default runtime is the kernel path, Runtime(attn_impl="cuda"), and the
engine runs on CUDA unless given device="cpu".
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.blocks import Runtime


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # [P] int32 token ids
    max_new_tokens: int = 32
    eos_id: int | None = None
    temperature: float = 0.0


@dataclasses.dataclass
class RequestState:
    request: Request
    slot: int
    pos: int                      # tokens written so far (prompt + generated)
    generated: list[int] = dataclasses.field(default_factory=list)
    next_token: int = 0           # token to feed at the next decode step
    t_enqueue: float = 0.0
    t_first_token: float | None = None
    t_done: float | None = None

    @property
    def done(self) -> bool:
        r = self.request
        if len(self.generated) >= r.max_new_tokens:
            return True
        return bool(self.generated and r.eos_id is not None
                    and self.generated[-1] == r.eos_id)


def _bucket(n: int, buckets: tuple[int, ...]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _batch_axis(path: tuple[str, ...], leaf: torch.Tensor) -> int:
    """The batch dim of a cache leaf, from its role (size matching is
    ambiguous: num_layers can equal max_batch)."""
    name = path[-1]
    if name in ("k_scale", "v_scale"):
        return leaf.ndim - 3              # [*, B, S, H]
    if name in ("k", "v", "ssm"):
        return leaf.ndim - 4              # [*, B, S, Hkv, Dh] / [L, B, H, P, N]
    if name == "conv":
        return leaf.ndim - 3              # [L, B, W-1, Cd]
    if name in ("enc_out", "vision"):
        return 0                          # [B, T, D]
    raise ValueError(f"unknown cache leaf {'/'.join(path)} "
                     f"{tuple(leaf.shape)}")


def _row(tree, slot: int, path=()):
    """Views of one slot's row of every cache leaf (width 1 kept)."""
    if isinstance(tree, dict):
        return {k: _row(v, slot, path + (k,)) for k, v in tree.items()}
    return tree.narrow(_batch_axis(path, tree), slot, 1)


def _state_leaves(tree, path=()):
    """The recurrent-state leaves (SSM state, conv window) of a cache."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _state_leaves(v, path + (k,))
    elif path[-1] in ("ssm", "conv"):
        yield tree


class ServingEngine:
    """Slot-based continuous batching over (prefill, decode_step)."""

    def __init__(self, params, cfg, *, max_batch: int = 8,
                 max_seq: int = 512,
                 rt: Runtime = Runtime(attn_impl="cuda"),
                 prompt_buckets: tuple[int, ...] = (32, 64, 128, 256),
                 extra: dict | None = None, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.rt = rt
        self.max_batch = max_batch
        self.max_seq = max_seq
        self.prompt_buckets = tuple(b for b in prompt_buckets
                                    if b <= max_seq) or (max_seq,)
        self.extra = extra
        self.cache = T.init_cache(cfg, max_batch, max_seq, device=self.device)
        self.rows = [_row(self.cache, s) for s in range(max_batch)]
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

        self.queue: deque[Request] = deque()
        self.active: dict[int, RequestState] = {}   # slot -> state
        self.free_slots = list(range(max_batch))
        self.finished: list[RequestState] = []
        self._uid = itertools.count()

    # ---------------- public API ----------------

    def submit(self, prompt: np.ndarray, **kw) -> int:
        req = Request(uid=next(self._uid),
                      prompt=np.asarray(prompt, np.int32), **kw)
        self.queue.append(req)
        return req.uid

    def prefill_tokens(self, prompt: np.ndarray) -> np.ndarray:
        """The tokens `_admit` prefills for `prompt`: prompt[:-1] padded
        with 0 to its bucket (exact length for the SSM family)."""
        p = len(prompt)
        if self.cfg.family in ("ssm", "hybrid"):
            bucket = max(p - 1, 1)
        else:
            bucket = _bucket(max(p - 1, 1), self.prompt_buckets)
        padded = np.zeros(bucket, np.int32)
        padded[:p - 1] = prompt[:p - 1]
        return padded

    def _admit(self):
        while self.queue and self.free_slots:
            req = self.queue.popleft()
            slot = self.free_slots.pop()
            row = self.rows[slot]
            for leaf in _state_leaves(row):
                leaf.zero_()                 # no state carried over
            tokens = torch.as_tensor(self.prefill_tokens(req.prompt),
                                     device=self.device)[None]
            T.prefill(self.params, tokens.long(), row, self.cfg, self.rt,
                      self.extra)
            st = RequestState(request=req, slot=slot,
                              pos=len(req.prompt) - 1, t_enqueue=time.time())
            st.next_token = int(req.prompt[-1])
            self.active[slot] = st

    def _pick(self, logits: torch.Tensor, states) -> list[int]:
        """Greedy (first maximum) or temperature-sampled next tokens."""
        greedy = logits.argmax(dim=-1)
        out = []
        for i, st in enumerate(states):
            t = st.request.temperature
            if t > 0:
                probs = torch.softmax(logits[i] / t, dim=-1)
                out.append(torch.multinomial(probs, 1, generator=self.gen))
            else:
                out.append(greedy[i:i + 1])
        return [int(x) for x in torch.cat(out).cpu()]

    def step(self) -> int:
        """Admit, then one decode token for every active slot. Returns the
        number of slots still active."""
        self._admit()
        if not self.active:
            return 0
        slots = list(self.active)            # admission order, as JAX's
        states = [self.active[s] for s in slots]
        logits = []
        for slot, st in zip(slots, states):
            tok = torch.tensor([[st.next_token]], dtype=torch.long,
                               device=self.device)
            lg, _ = T.decode_step(self.params, tok, self.rows[slot], st.pos,
                                  self.cfg, self.rt)
            logits.append(lg)
        toks = self._pick(torch.cat(logits), states)
        done_slots = []
        for slot, st, tok in zip(slots, states, toks):
            st.generated.append(tok)
            st.next_token = tok
            if st.t_first_token is None:
                st.t_first_token = time.time()
            st.pos += 1
            if st.done or st.pos >= self.max_seq - 1:
                st.t_done = time.time()
                done_slots.append(slot)
        for slot in done_slots:
            self.finished.append(self.active.pop(slot))
            self.free_slots.append(slot)
        return len(self.active)

    def run_to_completion(self, max_steps: int = 10_000) -> list[RequestState]:
        for _ in range(max_steps):
            self._admit()
            if not self.active and not self.queue:
                break
            self.step()
        return self.finished
