"""Pluggable text->token-id backends (copy of ``recformer_tpu/data/vocab.py``).

The reference hard-wires HF's ``LongformerTokenizer`` (RoBERTa BPE) as the text
tokenizer (``reference/recformer/tokenization.py:4-8``). The framework's
item/sequence encoding semantics live one level up (``tokenization.py`` here)
and only need a backend that maps text to ids and reports, per token, whether
it *begins a word* (needed for whole-word MLM masking,
``reference/collator.py:112-159``).

Two backends:

- :class:`HFTextBackend` — wraps any HF fast/slow tokenizer when its files are
  available locally (no network access is assumed).
- :class:`SimpleVocab` — deterministic, dependency-free backend for tests and
  synthetic benchmarks: whitespace words split into fixed-size character
  chunks, hashed into the vocab range.
"""

from __future__ import annotations

import hashlib
import unicodedata
from typing import List, Tuple


def is_punctuation(char: str) -> bool:
    """ASCII-range + Unicode-category punctuation test (reference semantics at
    ``reference/collator.py:161-171``)."""
    cp = ord(char)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(char).startswith("P")


class TextBackend:
    """Protocol: subclasses provide special ids and ``tokenize_text``."""

    vocab_size: int
    pad_token_id: int
    bos_token_id: int
    eos_token_id: int
    mask_token_id: int

    def tokenize_text(self, text: str) -> Tuple[List[int], List[bool]]:
        """Return (token_ids, word_begin flags). ``word_begin[i]`` is True iff
        token i starts a new whole word (i.e. is NOT a subword continuation in
        the sense of ``collator.py:152-159``)."""
        raise NotImplementedError


class SimpleVocab(TextBackend):
    """Deterministic hash tokenizer for tests/synthetic data.

    Words are whitespace-separated; each word is split into ``chunk`` - sized
    character pieces so whole-word masking has real multi-token words to mask.
    Ids are stable across processes (md5, not Python ``hash``).
    """

    def __init__(self, vocab_size: int = 1024, chunk: int = 4):
        if vocab_size < 16:
            raise ValueError("vocab_size too small")
        self.vocab_size = vocab_size
        self.chunk = chunk
        self.pad_token_id = 1
        self.bos_token_id = 0
        self.eos_token_id = 2
        self.mask_token_id = vocab_size - 1
        self._reserved = 4  # 0..3 special; mask at top

    def _hash_id(self, piece: str) -> int:
        h = int.from_bytes(hashlib.md5(piece.encode("utf-8")).digest()[:4], "little")
        lo = self._reserved
        hi = self.vocab_size - 1  # exclusive of mask token
        return lo + h % (hi - lo)

    def tokenize_text(self, text: str) -> Tuple[List[int], List[bool]]:
        ids: List[int] = []
        begins: List[bool] = []
        for word in str(text).split():
            for j in range(0, len(word), self.chunk):
                ids.append(self._hash_id(word[j : j + self.chunk]))
                begins.append(j == 0)
        return ids, begins


class HFTextBackend(TextBackend):
    """Adapter around a HuggingFace tokenizer instance (loaded by the caller
    from local files). Word-begin detection reproduces the reference's
    ``_is_subword`` (``collator.py:152-159``): a token continues a word iff its
    string form does not start with a space and its first char is not
    punctuation."""

    def __init__(self, hf_tokenizer):
        self.hf = hf_tokenizer
        self.vocab_size = len(hf_tokenizer)
        self.pad_token_id = hf_tokenizer.pad_token_id
        self.bos_token_id = hf_tokenizer.bos_token_id
        self.eos_token_id = hf_tokenizer.eos_token_id
        self.mask_token_id = hf_tokenizer.mask_token_id

    def tokenize_text(self, text: str) -> Tuple[List[int], List[bool]]:
        tokens = self.hf.tokenize(str(text))
        ids = self.hf.convert_tokens_to_ids(tokens)
        begins = []
        for tok in tokens:
            as_str = self.hf.convert_tokens_to_string([tok])
            begins.append(as_str.startswith(" ") or (len(tok) > 0 and is_punctuation(tok[0])))
        return ids, begins


def backend_for_config(config, hf_tokenizer=None) -> TextBackend:
    if hf_tokenizer is not None:
        return HFTextBackend(hf_tokenizer)
    return SimpleVocab(vocab_size=config.vocab_size)
