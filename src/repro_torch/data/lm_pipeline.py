"""LM training data pipeline: document packing + deterministic sharding.

The port's numpy copy of ``repro/data/lm_pipeline.py``: the same documents
and the same packing, byte for byte, so both packages train on the same
batches.

Production-shaped substrate for the assigned-architecture training path
(launch/train.py): variable-length token documents are packed into fixed
[batch, seq] examples with EOS separators and cross-document attention-mask
boundaries (segment ids), sharded deterministically per host so every data-
parallel worker sees a disjoint stream and any step is reproducible from
(seed, step) alone — no data state in checkpoints beyond the step counter.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    tokens: np.ndarray       # [B, S] int32
    labels: np.ndarray       # [B, S] int32 (next token; EOS at doc ends)
    segment_ids: np.ndarray  # [B, S] int32 (0 = padding; 1.. = document id)
    positions: np.ndarray    # [B, S] int32 (position within document)


class SyntheticDocumentSource:
    """Deterministic stream of variable-length token documents.

    Stands in for a tokenized corpus reader (the container is offline); the
    interface — `doc(index) -> np.ndarray` — matches what a real
    shard-indexed reader provides, so packing/sharding logic is the real
    thing.
    """

    def __init__(self, vocab_size: int, *, mean_len: int = 384,
                 min_len: int = 16, seed: int = 0):
        self.vocab_size = vocab_size
        self.mean_len = mean_len
        self.min_len = min_len
        self.seed = seed

    def doc(self, index: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed << 32) ^ index)
        n = self.min_len + int(rng.exponential(self.mean_len))
        return rng.integers(1, self.vocab_size,
                            size=min(n, 8 * self.mean_len)).astype(np.int32)


def pack_documents(
    docs: Iterator[np.ndarray], batch: int, seq: int, *, eos_id: int = 0,
) -> PackedBatch | None:
    """Greedy first-fit packing of documents into a [batch, seq] example."""
    tokens = np.zeros((batch, seq + 1), np.int32)
    seg = np.zeros((batch, seq + 1), np.int32)
    pos = np.zeros((batch, seq + 1), np.int32)
    fill = [0] * batch
    next_seg = [1] * batch
    for doc in docs:
        doc = np.concatenate([doc, [eos_id]]).astype(np.int32)
        placed = False
        for b in range(batch):
            room = seq + 1 - fill[b]
            if len(doc) <= room:
                s, e = fill[b], fill[b] + len(doc)
                tokens[b, s:e] = doc
                seg[b, s:e] = next_seg[b]
                pos[b, s:e] = np.arange(len(doc))
                fill[b] = e
                next_seg[b] += 1
                placed = True
                break
        if not placed:  # truncate into the emptiest row
            b = int(np.argmin(fill))
            room = seq + 1 - fill[b]
            if room <= 0:
                break
            s = fill[b]
            tokens[b, s:] = doc[:room]
            seg[b, s:] = next_seg[b]
            pos[b, s:] = np.arange(room)
            fill[b] = seq + 1
        if min(fill) >= seq + 1:
            break
    if max(fill) == 0:
        return None
    return PackedBatch(
        tokens=tokens[:, :seq],
        labels=tokens[:, 1:],
        segment_ids=seg[:, :seq],
        positions=pos[:, :seq],
    )


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    host_index: int
    host_count: int

    def __post_init__(self):
        if not (0 <= self.host_index < self.host_count):
            raise ValueError("host_index out of range")


class PackedLMIterator:
    """Deterministic per-host packed-batch stream.

    Document index for (host, step, k) is a bijective interleave:
    `index = (step * docs_per_step + k) * host_count + host_index`, so hosts
    never overlap and `state == step` (restart-safe)."""

    def __init__(self, source: SyntheticDocumentSource, spec: ShardSpec, *,
                 batch: int, seq: int, docs_per_step: int | None = None,
                 eos_id: int = 0):
        self.source = source
        self.spec = spec
        self.batch = batch
        self.seq = seq
        self.eos_id = eos_id
        # heuristic: enough docs to fill batch*seq tokens with slack
        self.docs_per_step = docs_per_step or max(
            2 * batch * seq // max(source.mean_len, 1), batch)
        self.step = 0

    def seek(self, step: int) -> None:
        self.step = step

    def __iter__(self):
        return self

    def __next__(self) -> PackedBatch:
        base = self.step * self.docs_per_step
        docs = (self.source.doc((base + k) * self.spec.host_count
                                + self.spec.host_index)
                for k in range(self.docs_per_step))
        out = pack_documents(docs, self.batch, self.seq, eos_id=self.eos_id)
        self.step += 1
        if out is None:
            raise StopIteration
        return out
