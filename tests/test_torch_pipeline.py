"""The port's on-device sequence assembly against the JAX package's: every
output array must be equal, including truncation past ``out_len`` and empty
histories."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recformer_tpu.config import RecformerConfig as JaxConfig
from recformer_tpu.data.device_pipeline import assemble_sequences as jax_assemble
from recformer_tpu_torch.data.device_pipeline import assemble_sequences


def table_and_ids(seed, n_items=12, M=8, B=5, S_in=7):
    rng = np.random.default_rng(seed)
    table = {
        "token_ids": rng.integers(4, 200, size=(n_items + 1, M)).astype(np.int32),
        "token_types": rng.integers(1, 3, size=(n_items + 1, M)).astype(np.int32),
        "word_begin": rng.integers(0, 2, size=(n_items + 1, M)).astype(np.int32),
        "lengths": rng.integers(1, M + 1, size=n_items + 1).astype(np.int32),
    }
    table["lengths"][-1] = 0
    item_ids = rng.integers(0, n_items, size=(B, S_in)).astype(np.int32)
    # an empty history, a single item, a full row and two in between
    seq_lens = np.array([0, 1, S_in, 4, 2], np.int32)[:B]
    return table, item_ids, seq_lens


@pytest.mark.parametrize("out_len,max_items", [(64, 10), (16, 10), (24, 3), (9, 6)])
def test_assemble_sequences_matches_jax(out_len, max_items):
    table, item_ids, seq_lens = table_and_ids(out_len + max_items)
    kw = dict(out_len=out_len, max_items=max_items, pad_token_id=1, bos_token_id=0,
              max_item_embeddings=max_items + 1)
    ref = jax_assemble({k: jnp.asarray(v) for k, v in table.items()}, jnp.asarray(item_ids),
                       jnp.asarray(seq_lens), **kw)
    out = assemble_sequences({k: torch.from_numpy(v) for k, v in table.items()},
                             torch.from_numpy(item_ids), torch.from_numpy(seq_lens), **kw)
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].dtype == torch.int32
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)
    # empty history: <s> and padding only
    assert out["attention_mask"][0].sum() == 1
    if out_len == 16:  # some rows overflow the token budget and are cut mid-item
        assert bool((out["attention_mask"].sum(1) == out_len).any())


def test_config_json_is_shared():
    from recformer_tpu_torch.config import RecformerConfig

    jcfg = JaxConfig.base(pooler_type="avg")
    tcfg = RecformerConfig.from_json(jcfg.to_json())
    assert tcfg.to_json() == jcfg.to_json()
    assert tcfg == RecformerConfig.base(pooler_type="avg")
    assert tcfg.compute_dtype == torch.bfloat16 and tcfg.params_dtype == torch.float32
    assert RecformerConfig.tiny().to_json() == JaxConfig.tiny().to_json()
    with pytest.raises(ValueError):
        RecformerConfig.tiny(attention_impl="flash")


def test_corpus_table_and_batches_match_jax():
    """The port's Python tokenizer and numpy batch packing give the tables and
    batches the JAX package builds with its C++ paths."""
    from recformer_tpu.data.datasets import SequenceDataset as JaxSequenceDataset
    from recformer_tpu.data.tokenization import RecformerTokenizer as JaxTokenizer
    from recformer_tpu_torch.config import RecformerConfig
    from recformer_tpu_torch.data.datasets import SequenceDataset
    from recformer_tpu_torch.data.tokenization import RecformerTokenizer

    rng = np.random.default_rng(0)
    words = ["red", "blue", "bolt", "nut", "gear", "led", "cap", "fan", "alpha-beta", "x"]
    meta = {f"I{i:03d}": {"make": " ".join(rng.choice(words, 4)), "hue": str(rng.choice(words)),
                          "size": "extraordinarily " * int(rng.integers(0, 5))}
            for i in range(30)}
    item2id = {f"I{i:03d}": i for i in range(0, 30, 2)}  # half the catalog is mapped
    ref = JaxTokenizer(JaxConfig.tiny()).encode_corpus_table(meta, item2id)
    out = RecformerTokenizer(RecformerConfig.tiny()).encode_corpus_table(meta, item2id)
    for k, v in ref.as_arrays().items():
        np.testing.assert_array_equal(out.as_arrays()[k], v, err_msg=k)

    seqs = {u: [int(x) for x in rng.integers(0, 15, size=rng.integers(0, 9))] for u in range(11)}
    seqs[3] = []  # an empty history: invalid row with length 1
    got_all = list(SequenceDataset(seqs, max_items=6).batches(4))
    want_all = list(JaxSequenceDataset(seqs, max_items=6).batches(4))
    assert len(got_all) == len(want_all) == 3
    for got, want in zip(got_all, want_all):
        for field in ("item_ids", "seq_lens", "valid"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
