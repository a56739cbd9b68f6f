"""Packed item-token table: the device-resident tokenized corpus (numpy
copy of ``recformer_tpu/data/item_table.py``, packed in Python).

The reference keeps tokenized items in a Python dict and re-assembles token
sequences per batch on the host (``reference/collator.py:71-90``,
``finetune.py:223-245``). Here the corpus is packed once into dense
arrays — ``(num_items + 1, max_item_token_len)`` token ids / token types /
word-begin flags plus per-item lengths — and uploaded to the device. Batch assembly
then becomes pure gather/scatter on device (``device_pipeline.py``), so the
host only ships tiny ``(B, max_items)`` item-id arrays per step.

Row ``num_items`` is the empty "null item" used for padding slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np

from ..config import RecformerConfig
from .tokenization import EncodedItem


@dataclass
class ItemTable:
    token_ids: np.ndarray  # (N+1, M) int32
    token_types: np.ndarray  # (N+1, M) int32
    word_begin: np.ndarray  # (N+1, M) int32
    lengths: np.ndarray  # (N+1,) int32

    @property
    def num_items(self) -> int:
        return self.token_ids.shape[0] - 1

    @property
    def null_item(self) -> int:
        return self.num_items

    @classmethod
    def build(
        cls,
        tokenized_items: Dict[int, EncodedItem],
        config: RecformerConfig,
        pad_token_id: int,
    ) -> "ItemTable":
        """``tokenized_items``: item id -> (input_ids, token_type_ids[,
        word_begin]). Ids must be dense in [0, N)."""
        n = (max(tokenized_items) + 1) if tokenized_items else 0
        m = config.max_item_token_len

        token_ids = np.full((n + 1, m), pad_token_id, np.int32)
        token_types = np.full((n + 1, m), 3, np.int32)
        word_begin = np.zeros((n + 1, m), np.int32)
        lengths = np.zeros(n + 1, np.int32)
        for item_id, enc in tokenized_items.items():
            ids, types = enc[0], enc[1]
            begins = enc[2] if len(enc) > 2 else [1] * len(ids)
            L = min(len(ids), m)
            token_ids[item_id, :L] = ids[:L]
            token_types[item_id, :L] = types[:L]
            word_begin[item_id, :L] = begins[:L]
            lengths[item_id] = L
        return cls(token_ids, token_types, word_begin, lengths)

    def as_arrays(self) -> Dict[str, np.ndarray]:
        return {
            "token_ids": self.token_ids,
            "token_types": self.token_types,
            "word_begin": self.word_begin,
            "lengths": self.lengths,
        }

    def save(self, path: str) -> None:
        np.savez(path, **self.as_arrays())

    @classmethod
    def load(cls, path: str) -> "ItemTable":
        z = np.load(path)
        return cls(z["token_ids"], z["token_types"], z["word_begin"], z["lengths"])
