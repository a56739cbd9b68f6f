"""The port's host library: ragged batch packing, the epoch shuffle and the
hash tokenizer in C++ through ``ctypes`` (the port's copy of
``recformer_tpu/native/``, with the same entry points and results).

``batcher.cpp`` and ``tokenizer.cpp`` build with ``g++`` at first use into
``recformer_tpu_torch/_build/`` (listed in ``.gitignore``), under a name
that hashes the sources and the flags, so an edit rebuilds; concurrent
builds each write a temporary file and rename it into place. A failed
build raises with the compiler's output: there is no numpy fallback, since
a fallback with its own shuffle is how two stacks come to train on
different batch orders.

Each C++ entry point has a plain twin, which the tests hold it to:
:func:`shuffle_order_plain` (numpy, bit-exact), :meth:`RaggedSequences.pack_plain`
(the Python packing loop), and for the tokenizer and the item-table packer
the Python ``RecformerTokenizer.encode_item`` / ``ItemTable.build`` path
(``data/tokenization.py``, ``data/item_table.py``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
SOURCES = tuple(os.path.join(_HERE, f) for f in ("batcher.cpp", "tokenizer.cpp"))
# no -march=native: the library may be built on one host and run on another
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32, _i64, _u64 = ctypes.c_int32, ctypes.c_int64, ctypes.c_uint64
# function name: (argtypes, restype), as recformer_tpu/native/__init__.py:50-65
SIGNATURES = {
    "pack_batch": ([_i32p, _i64p, _i64, _i64p, _i64, _i64, _i64, _i32p, _i32p, _u8p], None),
    "shuffle_order": ([_i64p, _i64, _u64], None),
    "pack_item_table": ([_i32p, _i32p, _i32p, _i64p, _i64, _i64, _i32,
                         _i32p, _i32p, _i32p, _i32p], None),
    "tokenize_corpus_hash": ([_u8p, _i64p, _i32p, _i64, _i32, _i32, _i32, _i32, _i32,
                              _i32p, _i32p, _i32p, _i64, _i64p], _i64),
}

_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libnative_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library if it is not built yet; returns its path. Raises
    with the compiler's output when ``g++`` fails or is missing."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    try:
        out = subprocess.run(["g++", *GXX_FLAGS, *SOURCES, "-o", tmp],
                             capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("g++ not found: the port's host library builds with g++") from e
    if out.returncode != 0:
        raise RuntimeError(f"g++ failed building the host library:\n{out.stderr}")
    os.replace(tmp, so)
    return so


def load_library() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# splitmix64's constants (batcher.cpp)
_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_MIX2 = np.uint64(0x94D049BB133111EB)


def shuffle_order_plain(n: int, seed: int) -> np.ndarray:
    """numpy twin of ``shuffle_order`` (``batcher.cpp``), bit for bit: the
    splitmix64 stream computed at once in ``uint64`` (its state after t
    draws is ``seed + t * gamma`` mod 2**64, and numpy's ``uint64``
    arithmetic wraps as C's does); only the Fisher-Yates swaps run in a
    loop."""
    order = list(range(n))
    if n > 1:
        z = np.uint64(seed % 2**64) + np.arange(1, n, dtype=np.uint64) * _GAMMA
        z = (z ^ (z >> np.uint64(30))) * _MIX1
        z = (z ^ (z >> np.uint64(27))) * _MIX2
        z ^= z >> np.uint64(31)
        i = np.arange(n - 1, 0, -1, dtype=np.uint64)
        for a, b in zip(i.tolist(), (z % (i + np.uint64(1))).tolist()):
            order[a], order[b] = order[b], order[a]
    return np.asarray(order, np.int64)


class RaggedSequences:
    """Contiguous ragged store of int sequences with batch packing and the
    epoch shuffle in C++."""

    def __init__(self, sequences: Sequence[Sequence[int]]):
        lens = np.fromiter((len(s) for s in sequences), np.int64, len(sequences))
        self.offsets = np.zeros(len(sequences) + 1, np.int64)
        np.cumsum(lens, out=self.offsets[1:])
        self.flat = np.empty(int(self.offsets[-1]), np.int32)
        for i, s in enumerate(sequences):
            self.flat[self.offsets[i]: self.offsets[i + 1]] = s
        self.n = len(sequences)

    def epoch_order(self, shuffle: bool, seed: int) -> np.ndarray:
        """Row order of an epoch: ``0..n-1``, or the splitmix64 Fisher-Yates
        shuffle of it from ``seed``."""
        order = np.arange(self.n, dtype=np.int64)
        if shuffle:
            load_library().shuffle_order(_ptr(order, ctypes.c_int64), self.n,
                                         ctypes.c_uint64(seed % 2**64))
        return order

    def _check(self, order: np.ndarray, start: int, batch: int, max_len: int) -> np.ndarray:
        order = np.ascontiguousarray(order, np.int64)
        if start < 0 or batch < 0 or max_len < 1:
            raise ValueError(f"start {start}, batch {batch}, max_len {max_len}")
        if len(order) and (order.min() < 0 or order.max() >= self.n):
            raise ValueError(f"order holds rows outside [0, {self.n})")
        return order

    def pack(self, order: np.ndarray, start: int, batch: int, max_len: int
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Rows ``order[start:start + batch]`` as (ids (B, max_len), lens (B,),
        valid (B,)): each row keeps its newest ``max_len`` items; positions
        past the end of ``order``, and empty rows, are invalid with length 1.
        ``order`` may be a per-process shard of the epoch order."""
        order = self._check(order, start, batch, max_len)
        out_ids = np.zeros((batch, max_len), np.int32)
        out_lens = np.zeros(batch, np.int32)
        out_valid = np.zeros(batch, np.uint8)
        load_library().pack_batch(
            _ptr(self.flat, ctypes.c_int32), _ptr(self.offsets, ctypes.c_int64), len(order),
            _ptr(order, ctypes.c_int64), start, batch, max_len,
            _ptr(out_ids, ctypes.c_int32), _ptr(out_lens, ctypes.c_int32),
            _ptr(out_valid, ctypes.c_uint8))
        return out_ids, out_lens, out_valid.astype(bool)

    def pack_plain(self, order: np.ndarray, start: int, batch: int, max_len: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The Python packing loop :meth:`pack` replaces (its twin)."""
        order = self._check(order, start, batch, max_len)
        out_ids = np.zeros((batch, max_len), np.int32)
        out_lens = np.ones(batch, np.int32)
        out_valid = np.zeros(batch, bool)
        for b in range(batch):
            pos = start + b
            if pos >= len(order):
                continue
            row = order[pos]
            seq = self.flat[self.offsets[row]: self.offsets[row + 1]][-max_len:]
            out_ids[b, : len(seq)] = seq
            out_lens[b] = max(len(seq), 1)
            out_valid[b] = len(seq) > 0
        return out_ids, out_lens, out_valid


def pack_item_table_native(flat_ids, flat_types, flat_begin, offsets,
                           max_item_len: int, pad_id: int):
    """The ragged tokenized corpus packed into the four dense ``ItemTable``
    arrays (ids, types, word-begin flags, lengths), with the null item as
    the last row; the C++ twin of ``ItemTable.build``'s loop."""
    flat_ids, flat_types, flat_begin = (np.ascontiguousarray(a, np.int32)
                                        for a in (flat_ids, flat_types, flat_begin))
    offsets = np.ascontiguousarray(offsets, np.int64)
    n_items = len(offsets) - 1
    if not (len(flat_ids) == len(flat_types) == len(flat_begin) == int(offsets[-1])):
        raise ValueError("ragged corpus arrays disagree with the offsets")
    out_ids = np.empty((n_items + 1, max_item_len), np.int32)
    out_types = np.empty((n_items + 1, max_item_len), np.int32)
    out_begin = np.empty((n_items + 1, max_item_len), np.int32)
    out_lens = np.empty(n_items + 1, np.int32)
    load_library().pack_item_table(
        _ptr(flat_ids, ctypes.c_int32), _ptr(flat_types, ctypes.c_int32),
        _ptr(flat_begin, ctypes.c_int32), _ptr(offsets, ctypes.c_int64),
        n_items, max_item_len, pad_id,
        _ptr(out_ids, ctypes.c_int32), _ptr(out_types, ctypes.c_int32),
        _ptr(out_begin, ctypes.c_int32), _ptr(out_lens, ctypes.c_int32))
    return out_ids, out_types, out_begin, out_lens


def tokenize_corpus_hash_native(items_attrs, vocab, max_attr_num: int,
                                max_attr_length: int):
    """C++ corpus tokenization for the hash ``SimpleVocab`` backend
    (``tokenizer.cpp``): ``items_attrs`` is a list (dense item-id order) of
    ``[(name, value), ...]`` attribute pairs. Returns the ragged corpus
    ``(flat_ids, flat_types, flat_begin, offsets)``, or None when the text
    is not pure ASCII: the C++ chunker counts bytes, Python's counts code
    points, so such text takes the Python path."""
    strings = []
    attr_counts = np.empty(len(items_attrs), np.int32)
    for i, attrs in enumerate(items_attrs):
        attr_counts[i] = len(attrs)
        for name, value in attrs:
            strings.append(str(name))
            strings.append(str(value))
    joined = "".join(strings)
    if not joined.isascii():
        return None
    buf = np.frombuffer(joined.encode("ascii"), np.uint8)
    offs = np.zeros(len(strings) + 1, np.int64)
    np.cumsum(np.fromiter((len(s) for s in strings), np.int64, len(strings)), out=offs[1:])
    cap = int(len(items_attrs)) * max_attr_num * max_attr_length
    out_ids = np.empty(cap, np.int32)
    out_types = np.empty(cap, np.int32)
    out_begin = np.empty(cap, np.int32)
    out_offsets = np.empty(len(items_attrs) + 1, np.int64)
    total = load_library().tokenize_corpus_hash(
        _ptr(buf, ctypes.c_uint8), _ptr(offs, ctypes.c_int64),
        _ptr(attr_counts, ctypes.c_int32), len(items_attrs), max_attr_num, max_attr_length,
        vocab.vocab_size, vocab._reserved, vocab.chunk,
        _ptr(out_ids, ctypes.c_int32), _ptr(out_types, ctypes.c_int32),
        _ptr(out_begin, ctypes.c_int32), cap, _ptr(out_offsets, ctypes.c_int64))
    if total < 0:  # cap is an exact upper bound: each attribute emits <= max_attr_length
        raise RuntimeError("tokenize_corpus_hash: output capacity exceeded")
    return out_ids[:total], out_types[:total], out_begin[:total], out_offsets
