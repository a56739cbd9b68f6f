"""Host-side dataset views and static-shaped batch iterators (numpy copy of
``recformer_tpu/data/datasets.py``).

The reference wraps user->sequence dicts in torch ``Dataset``/``DataLoader``
pairs with Python collators (``reference/dataloader.py``). Here the host
side only pads item-id sequences into fixed ``(B, S)`` int arrays (plus
lengths/labels); all per-token work happens on device
(``device_pipeline.py``). Batches are padded to full size with a ``valid``
row mask so shapes stay static.

Dataset semantics preserved:

- train: one row per user, the full training sequence
  (``dataloader.py:4-27``); target sampling happens later (on device).
- eval 'val': history = train seq, label = val item;
  eval 'test': history = train + val, label = test item
  (``dataloader.py:30-56``).
- fraud: sequences carry a binary label (``dataloader.py:59-82``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np


@dataclass
class SequenceBatch:
    item_ids: np.ndarray  # (B, S) int32, chronological, 0-padded
    seq_lens: np.ndarray  # (B,) int32 (>=1 for valid rows)
    valid: np.ndarray  # (B,) bool — False for padding rows of the last batch
    labels: Optional[np.ndarray] = None  # (B,) int32/float32

    def as_dict(self) -> Dict[str, np.ndarray]:
        out = {"item_ids": self.item_ids, "seq_lens": self.seq_lens, "valid": self.valid}
        if self.labels is not None:
            out["labels"] = self.labels
        return out


def _pad_sequences(seqs: Sequence[Sequence[int]], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    B = len(seqs)
    out = np.zeros((B, max_len), np.int32)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        s = list(s)[-max_len:]  # keep newest if over-long (oldest dropped anyway)
        out[i, : len(s)] = s
        lens[i] = len(s)
    return out, lens


class SequenceDataset:
    """Train-time view: one row per user (sorted user ids for determinism,
    matching ``dataloader.py:13``). Batches are packed in numpy, with the
    semantics of the JAX package's ragged batcher: a row keeps its newest
    ``max_items`` items, and rows past the end (or empty sequences) are
    invalid with length 1. A shuffled order comes from numpy's generator,
    not from the native batcher's shuffle."""

    def __init__(self, user2seq: Dict[int, List[int]], max_items: int):
        self.users = sorted(user2seq.keys())
        self.seqs = [list(user2seq[u]) for u in self.users]
        self.max_items = max_items

    def __len__(self):
        return len(self.seqs)

    def epoch_order(self, shuffle: bool, seed: int) -> np.ndarray:
        order = np.arange(len(self.seqs), dtype=np.int64)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        return order

    def pack(self, order: np.ndarray, start: int, batch: int) -> SequenceBatch:
        ids = np.zeros((batch, self.max_items), np.int32)
        lens = np.ones(batch, np.int32)
        valid = np.zeros(batch, bool)
        for b in range(batch):
            pos = start + b
            if pos >= len(order):
                continue
            seq = self.seqs[order[pos]][-self.max_items:]
            ids[b, : len(seq)] = seq
            lens[b] = max(len(seq), 1)
            valid[b] = len(seq) > 0
        return SequenceBatch(ids, lens, valid)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_last: bool = False, process_index: int = 0,
                process_count: int = 1) -> Iterator[SequenceBatch]:
        """``process_index/count`` shard the (shuffled) row order across
        processes."""
        order = self.epoch_order(shuffle, seed)[process_index::process_count]
        n = len(order)
        nb = n // batch_size if drop_last else -(-n // batch_size)
        for b in range(nb):
            yield self.pack(order, b * batch_size, batch_size)


class EvalDataset:
    """Leave-one-out eval view (``dataloader.py:30-56``)."""

    def __init__(self, user2train, user2val, user2test, mode: str, max_items: int):
        assert mode in ("val", "test")
        self.mode = mode
        self.max_items = max_items
        users = list(user2val.keys()) if mode == "val" else list(user2test.keys())
        self.users = users
        self.seqs, self.labels = [], []
        for u in users:
            if mode == "val":
                hist = user2train.get(u, [])
                label = user2val[u]
            else:
                hist = user2train.get(u, []) + user2val.get(u, [])
                label = user2test[u]
            self.seqs.append(hist)
            self.labels.append(label[0] if isinstance(label, list) else label)

    def __len__(self):
        return len(self.seqs)

    def batches(self, batch_size: int) -> Iterator[SequenceBatch]:
        n = len(self.seqs)
        for b in range(math.ceil(n / batch_size)):
            seqs = self.seqs[b * batch_size : (b + 1) * batch_size]
            labels = self.labels[b * batch_size : (b + 1) * batch_size]
            valid = np.ones(batch_size, bool)
            if len(seqs) < batch_size:
                valid[len(seqs) :] = False
                seqs = seqs + [[0]] * (batch_size - len(seqs))
                labels = list(labels) + [0] * (batch_size - len(labels))
            ids, lens = _pad_sequences(seqs, self.max_items)
            yield SequenceBatch(ids, lens, valid, np.asarray(labels, np.int32))


class FraudDataset:
    """Per-user sequence with a binary fraud label
    (``dataloader.py:59-82``: user -> (sequence, [label]))."""

    def __init__(self, user_sequences: Dict, max_items: int):
        self.users = sorted(user_sequences.keys())
        self.seqs = []
        self.labels = []
        for u in self.users:
            seq, label = user_sequences[u][0], user_sequences[u][1]
            self.seqs.append(seq)
            self.labels.append(label[0] if isinstance(label, list) else label)
        self.max_items = max_items

    def __len__(self):
        return len(self.seqs)

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0) -> Iterator[SequenceBatch]:
        n = len(self.seqs)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for b in range(math.ceil(n / batch_size)):
            idx = order[b * batch_size : (b + 1) * batch_size]
            seqs = [self.seqs[i] for i in idx]
            labels = [self.labels[i] for i in idx]
            valid = np.ones(batch_size, bool)
            if len(seqs) < batch_size:
                valid[len(seqs) :] = False
                seqs = seqs + [[0]] * (batch_size - len(seqs))
                labels = list(labels) + [0] * (batch_size - len(labels))
            ids, lens = _pad_sequences(seqs, self.max_items)
            yield SequenceBatch(ids, lens, valid, np.asarray(labels, np.float32))
