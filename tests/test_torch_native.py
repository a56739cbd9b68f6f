"""The port's host library (``recformer_tpu_torch/native``) against the JAX
package's native library and against its own plain twins: the epoch
shuffle, batch packing, the hash tokenizer and the item-table packer, and
the shuffled, sharded batches of ``SequenceDataset``.

The JAX package's library must build here (g++ is on the machine): its
numpy fallback shuffles in another order, so a comparison against it would
prove nothing.
"""

import os

import numpy as np
import pytest

from recformer_tpu import native as jax_native
from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.datasets import SequenceDataset as JaxSequenceDataset
from recformer_tpu.data.tokenization import RecformerTokenizer as JaxTokenizer
from recformer_tpu_torch import native
from recformer_tpu_torch.config import RecformerConfig
from recformer_tpu_torch.data.datasets import SequenceDataset
from recformer_tpu_torch.data.item_table import ItemTable
from recformer_tpu_torch.data.tokenization import RecformerTokenizer

SEEDS = (0, 1, 7, 2**63 + 5, 2**64 - 1)


def test_both_libraries_build():
    assert jax_native.native_available(), "the JAX package's native library must build here"
    lib = native.load_library()
    assert lib is native.load_library()
    path = native.library_path()
    assert os.path.exists(path)
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(native.__file__)))
    assert os.path.dirname(path) == os.path.join(pkg, "_build")


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "broken.cpp"
    broken.write_text('extern "C" void f() { this is not C++; }\n')
    monkeypatch.setattr(native, "SOURCES", (str(broken),))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed building the host library") as err:
        native.build()
    assert "broken.cpp" in str(err.value)
    assert not any(p.suffix == ".so" for p in (tmp_path / "build").iterdir())


@pytest.mark.parametrize("n", [0, 1, 2, 10, 1000, 12345])
def test_shuffle_matches_jax_and_numpy_twin(n):
    """The C++ shuffle gives the JAX package's order, and the numpy twin
    gives the C++ order, for every seed (one above 2**63, one at 2**64 - 1)."""
    ours = native.RaggedSequences([[i] for i in range(n)])
    ref = jax_native.RaggedSequences([[i] for i in range(n)])
    for seed in SEEDS:
        want = ref.epoch_order(True, seed)
        np.testing.assert_array_equal(ours.epoch_order(True, seed), want, err_msg=str(seed))
        np.testing.assert_array_equal(native.shuffle_order_plain(n, seed), want,
                                      err_msg=str(seed))
    np.testing.assert_array_equal(ours.epoch_order(False, 3), np.arange(n))


def ragged(seed, n=23):
    rng = np.random.default_rng(seed)
    seqs = [[int(x) for x in rng.integers(0, 500, size=rng.integers(0, 30))] for _ in range(n)]
    seqs[4] = []  # an empty row: invalid with length 1
    return seqs


@pytest.mark.parametrize("max_len", [1, 8, 40])
def test_pack_matches_jax_and_python_loop(max_len):
    """Full orders, shuffled orders, strided shards and windows past the end
    pack alike in the C++ packer, its Python loop and the JAX package's."""
    seqs = ragged(max_len)
    ours, ref = native.RaggedSequences(seqs), jax_native.RaggedSequences(seqs)
    full = ours.epoch_order(True, 5)
    for order in (np.arange(len(seqs), dtype=np.int64), full, full[1::3]):
        for start, batch in ((0, 8), (5, 8), (len(order) - 2, 8), (len(order) + 3, 4)):
            want = ref.pack(np.ascontiguousarray(order), start, batch, max_len)
            for got in (ours.pack(order, start, batch, max_len),
                        ours.pack_plain(order, start, batch, max_len)):
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def test_pack_rejects_rows_outside_the_store():
    ours = native.RaggedSequences(ragged(0, n=5))
    with pytest.raises(ValueError):
        ours.pack(np.array([0, 5]), 0, 2, 4)
    with pytest.raises(ValueError):
        ours.pack(np.array([0, 1]), -1, 2, 4)


WORDS = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan", "alpha-beta", "x",
         "extraordinarily"]


def corpus(seed, text="ascii"):
    """30 items (some unmapped), 1-5 attributes each (more than
    ``max_attr_num`` of the tiny config for some), long values that hit
    ``max_attr_length``."""
    rng = np.random.default_rng(seed)
    meta = {}
    for i in range(30):
        attrs = {}
        for a in range(int(rng.integers(1, 6))):
            value = " ".join(rng.choice(WORDS, int(rng.integers(0, 12))))
            if text == "separators":  # ASCII separators 0x1c-0x1f: Python splits on them
                value = value.replace(" ", chr(0x1c + a % 4), 1)
            elif text == "non_ascii" and i == 9:
                value += " café"
            attrs[f"attr{a}" if a % 2 else f"name {a}"] = value
        meta[f"I{i:03d}"] = attrs
    item2id = {f"I{i:03d}": j for j, i in enumerate(range(0, 30, 3))}
    return meta, item2id


def items_attrs(meta, item2id):
    out = [[] for _ in range(max(item2id.values()) + 1)]
    for k, attrs in meta.items():
        if k in item2id:
            out[item2id[k]] = list(attrs.items())
    return out


def test_tokenizer_and_item_packer_match_jax():
    """On ASCII text the C++ tokenizer and item-table packer give the JAX
    package's ragged corpus and dense table, array for array."""
    cfg, jcfg = RecformerConfig.tiny(), JaxConfig.tiny()
    meta, item2id = corpus(0)
    tok, jtok = RecformerTokenizer(cfg), JaxTokenizer(jcfg)
    attrs = items_attrs(meta, item2id)
    ours = native.tokenize_corpus_hash_native(attrs, tok.backend, cfg.max_attr_num,
                                              cfg.max_attr_length)
    ref = jax_native.tokenize_corpus_hash_native(attrs, jtok.backend, jcfg.max_attr_num,
                                                 jcfg.max_attr_length)
    for g, w in zip(ours, ref):
        np.testing.assert_array_equal(g, w)
    packed = native.pack_item_table_native(*ours, cfg.max_item_token_len, 1)
    for g, w in zip(packed, jax_native.pack_item_table_native(*ref, jcfg.max_item_token_len, 1)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("text", ["ascii", "separators", "non_ascii"])
def test_corpus_table_native_equals_python_path(text):
    """``encode_corpus_table`` (the C++ path on ASCII text, the Python path
    on non-ASCII text) equals the Python ``encode_item`` loop +
    ``ItemTable.build``, and the JAX package's Python path. The ASCII
    separators 0x1c-0x1f split words in Python's ``str.split``; the port's
    C++ splits on them too (the JAX package's C++ does not)."""
    cfg = RecformerConfig.tiny()
    meta, item2id = corpus(1, text)
    tok = RecformerTokenizer(cfg)
    attrs = items_attrs(meta, item2id)
    native_ragged = native.tokenize_corpus_hash_native(attrs, tok.backend, cfg.max_attr_num,
                                                       cfg.max_attr_length)
    assert (native_ragged is None) == (text == "non_ascii")
    got = tok.encode_corpus_table(meta, item2id).as_arrays()
    plain = ItemTable.build(tok.tokenize_corpus(meta, item2id), cfg,
                            tok.backend.pad_token_id).as_arrays()
    jtok = JaxTokenizer(JaxConfig.tiny())
    jax_python = jtok.tokenize_corpus(meta, item2id)
    for key, want in plain.items():
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    if text == "separators":  # the JAX package's C++ keeps 0x1c-0x1f inside words
        jax_ids = jax_native.tokenize_corpus_hash_native(attrs, jtok.backend,
                                                         cfg.max_attr_num, cfg.max_attr_length)[0]
        assert not np.array_equal(jax_ids, native_ragged[0])
    for item_id, (ids, types, begins) in jax_python.items():
        n = len(ids)
        np.testing.assert_array_equal(got["token_ids"][item_id, :n], ids)
        np.testing.assert_array_equal(got["token_types"][item_id, :n], types)
        np.testing.assert_array_equal(got["word_begin"][item_id, :n], begins)
        assert got["lengths"][item_id] == n


@pytest.mark.parametrize("drop_last,process_count", [(False, 1), (True, 1), (False, 2),
                                                     (True, 2)])
def test_sequence_dataset_batches_match_jax(drop_last, process_count):
    """The port's ``SequenceDataset`` gives the JAX package's batches for
    the same seed: shuffled epochs, sharded across processes, with and
    without the last partial batch. Before the port had its own native
    library it shuffled with numpy's generator, and this failed."""
    seqs = {u: s for u, s in enumerate(ragged(3, n=37))}
    ours, ref = SequenceDataset(seqs, max_items=9), JaxSequenceDataset(seqs, max_items=9)
    for epoch, shuffle in ((0, False), (0, True), (1, True), (2, True), (3, True)):
        for index in range(process_count):
            kw = dict(shuffle=shuffle, seed=epoch, drop_last=drop_last, process_index=index,
                      process_count=process_count)
            got, want = list(ours.batches(5, **kw)), list(ref.batches(5, **kw))
            assert len(got) == len(want) > 0
            for g, w in zip(got, want):
                for field in ("item_ids", "seq_lens", "valid"):
                    np.testing.assert_array_equal(getattr(g, field), getattr(w, field),
                                                  err_msg=f"{epoch} {index} {field}")
