"""Item / sequence encoding with reference-parity semantics (the port's copy
of ``recformer_tpu/data/tokenization.py``).

Reproduces the behavioral contract of the reference tokenizer
(``reference/recformer/tokenization.py:38-159``) on top of a pluggable
:class:`~.vocab.TextBackend`:

- ``encode_item``: flatten an attribute dict into key tokens (token type 1)
  followed by value tokens (token type 2); truncate to ``max_attr_num``
  attributes and ``max_attr_length`` tokens per attribute.
- ``encode``: *reverse* the item order (newest first, so truncation drops the
  oldest items — ``tokenization.py:70-71``), keep at most
  ``max_item_embeddings - 1`` items, prepend ``<s>`` (item position 0, token
  type 0), give item i tokens item position i+1, truncate everything to
  ``max_token_num``, attention mask of ones, global attention only on ``<s>``.
- ``padding``: pad token ids with ``pad_token_id``, item positions with
  ``max_item_embeddings - 1``, token types with 3, masks with 0
  (``tokenization.py:109-152``).

Additions over the reference:

- every encoded item also carries per-token *word-begin* flags so whole-word
  MLM masking becomes pure integer work on device (no string introspection in
  the training loop, unlike ``reference/collator.py:92-159``);
- ``pad_to_max`` is the default: batches are statically shaped.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import RecformerConfig
from .vocab import TextBackend, backend_for_config

# An encoded item: (input_ids, token_type_ids, word_begin)
EncodedItem = Tuple[List[int], List[int], List[int]]


@dataclass
class EncodedSeq:
    """One encoded (unpadded) sequence."""

    input_ids: List[int]
    item_position_ids: List[int]
    token_type_ids: List[int]
    attention_mask: List[int]
    global_attention_mask: List[int]
    word_begin: List[int]

    def as_dict(self) -> Dict[str, List[int]]:
        return {
            "input_ids": self.input_ids,
            "item_position_ids": self.item_position_ids,
            "token_type_ids": self.token_type_ids,
            "attention_mask": self.attention_mask,
            "global_attention_mask": self.global_attention_mask,
        }


class RecformerTokenizer:
    def __init__(self, config: RecformerConfig, backend: Optional[TextBackend] = None):
        self.config = config
        self.backend = backend if backend is not None else backend_for_config(config)

    # -- item level ----------------------------------------------------
    def encode_item(self, item: Dict[str, str]) -> EncodedItem:
        """Flatten one attribute dict; see module docstring for semantics."""
        cfg = self.config
        input_ids: List[int] = []
        token_type_ids: List[int] = []
        word_begin: List[int] = []
        for attr_name, attr_value in list(item.items())[: cfg.max_attr_num]:
            name_ids, name_begin = self.backend.tokenize_text(attr_name)
            value_ids, value_begin = self.backend.tokenize_text(attr_value)
            attr_ids = (name_ids + value_ids)[: cfg.max_attr_length]
            attr_types = ([1] * len(name_ids) + [2] * len(value_ids))[: cfg.max_attr_length]
            attr_begin = (name_begin + value_begin)[: cfg.max_attr_length]
            input_ids += attr_ids
            token_type_ids += attr_types
            word_begin += [int(b) for b in attr_begin]
        return input_ids, token_type_ids, word_begin

    # -- sequence level ------------------------------------------------
    def encode(
        self,
        items: Sequence,
        encode_item: bool = True,
    ) -> EncodedSeq:
        """Encode a chronological item sequence ``[past ... present]``.

        ``items`` is either a list of attribute dicts (``encode_item=True``) or
        a list of pre-encoded items — ``(ids, types)`` or
        ``(ids, types, word_begin)`` tuples (``encode_item=False``).
        """
        cfg = self.config
        items = list(items)[::-1][: cfg.max_item_embeddings - 1]

        input_ids = [self.backend.bos_token_id]
        item_position_ids = [0]
        token_type_ids = [0]
        word_begin = [0]  # <s> never participates in MLM

        for item_idx, item in enumerate(items):
            if encode_item:
                ids, types, begins = self.encode_item(item)
            else:
                if len(item) == 3:
                    ids, types, begins = item
                else:
                    ids, types = item
                    begins = [1] * len(ids)  # degrade: every token its own word
            input_ids += list(ids)
            token_type_ids += list(types)
            word_begin += list(begins)
            item_position_ids += [item_idx + 1] * len(ids)

        L = cfg.max_token_num
        input_ids = input_ids[:L]
        item_position_ids = item_position_ids[:L]
        token_type_ids = token_type_ids[:L]
        word_begin = word_begin[:L]

        n = len(input_ids)
        return EncodedSeq(
            input_ids=input_ids,
            item_position_ids=item_position_ids,
            token_type_ids=token_type_ids,
            attention_mask=[1] * n,
            global_attention_mask=[1] + [0] * (n - 1),
            word_begin=word_begin,
        )

    # -- batching ------------------------------------------------------
    def padding(
        self,
        batch: Sequence[EncodedSeq],
        pad_to_max: bool = True,
        max_length: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        """Pad a list of encoded sequences into dense int32 arrays."""
        cfg = self.config
        if max_length is None:
            max_length = (
                cfg.max_token_num if pad_to_max else max(len(s.input_ids) for s in batch)
            )
        B = len(batch)
        out = {
            "input_ids": np.full((B, max_length), self.backend.pad_token_id, np.int32),
            "item_position_ids": np.full(
                (B, max_length), cfg.max_item_embeddings - 1, np.int32
            ),
            "token_type_ids": np.full((B, max_length), 3, np.int32),
            "attention_mask": np.zeros((B, max_length), np.int32),
            "global_attention_mask": np.zeros((B, max_length), np.int32),
            "word_begin": np.zeros((B, max_length), np.int32),
        }
        for i, seq in enumerate(batch):
            n = len(seq.input_ids)
            out["input_ids"][i, :n] = seq.input_ids
            out["item_position_ids"][i, :n] = seq.item_position_ids
            out["token_type_ids"][i, :n] = seq.token_type_ids
            out["attention_mask"][i, :n] = seq.attention_mask
            out["global_attention_mask"][i, :n] = seq.global_attention_mask
            out["word_begin"][i, :n] = seq.word_begin
        return out

    def batch_encode(
        self,
        item_batch: Sequence[Sequence],
        encode_item: bool = True,
        pad_to_max: bool = True,
        max_length: Optional[int] = None,
    ) -> Dict[str, np.ndarray]:
        encoded = [self.encode(items, encode_item) for items in item_batch]
        return self.padding(encoded, pad_to_max=pad_to_max, max_length=max_length)

    def __call__(self, items, pad_to_max: bool = True):
        if len(items) > 0 and isinstance(items[0], (list, tuple)):
            return self.batch_encode(items, pad_to_max=pad_to_max)
        return self.encode(items).as_dict()

    # -- corpus tokenization -------------------------------------------
    def tokenize_corpus(self, item_meta: Dict, item2id: Dict[str, int]) -> Dict[int, EncodedItem]:
        """Tokenize every item's attribute dict, keyed by integer item id
        (reference: ``reference/finetune.py:225-243``)."""
        out: Dict[int, EncodedItem] = {}
        for raw_id, attrs in item_meta.items():
            if raw_id not in item2id:
                continue
            out[item2id[raw_id]] = self.encode_item(attrs)
        return out

    def encode_corpus_table(self, item_meta: Dict, item2id: Dict[str, int]):
        """Corpus -> packed ItemTable, through the port's C++ tokenizer and
        packer (``native/``) when the backend is the hash ``SimpleVocab`` and
        the text is ASCII; through the Python ``encode_item`` loop and
        ``ItemTable.build`` otherwise. Both give the same table
        (``tests/test_torch_native.py``)."""
        from ..native import pack_item_table_native, tokenize_corpus_hash_native
        from .item_table import ItemTable
        from .vocab import SimpleVocab

        cfg = self.config
        if isinstance(self.backend, SimpleVocab):
            mapped = [item2id[k] for k in item_meta if k in item2id]
            n = (max(mapped) + 1) if mapped else 0  # ItemTable.build sizing
            items_attrs = [[] for _ in range(n)]
            for raw_id, attrs in item_meta.items():
                if raw_id in item2id:
                    items_attrs[item2id[raw_id]] = list(attrs.items())
            ragged = tokenize_corpus_hash_native(items_attrs, self.backend, cfg.max_attr_num,
                                                 cfg.max_attr_length)
            if ragged is not None:
                return ItemTable(*pack_item_table_native(*ragged, cfg.max_item_token_len,
                                                         self.backend.pad_token_id))
        return ItemTable.build(self.tokenize_corpus(item_meta, item2id), cfg,
                               self.backend.pad_token_id)
