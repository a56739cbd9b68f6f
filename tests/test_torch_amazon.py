"""The port's Amazon review pipeline writes the JAX package's artifacts byte
for byte: the pretrain corpus (last category = dev) and a finetune category
(leave-one-out, the seeded 1-in-5 user subsample or every user)."""

import gzip
import json
import os

import numpy as np
import pytest

from recformer_tpu.pipelines import amazon as jax_amazon
from recformer_tpu_torch.pipelines import amazon as torch_amazon


def write_jsonl_gz(path, rows):
    with gzip.open(path, "wt", encoding="utf-8") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")


@pytest.fixture
def amazon_raw(tmp_path):
    """``tests/test_pipelines.py``'s raw dump, with items lacking a title or a
    review and a list-less category among them."""
    rng = np.random.default_rng(0)
    asins = [f"A{i:03d}" for i in range(30)]
    meta = [{"asin": a, "title": f"item {a}", "brand": f"brand{i%5}",
             "category": ["Cat", f"sub{i%3}"]} for i, a in enumerate(asins)]
    meta += [{"asin": "A900", "brand": "untitled"},
             {"asin": "A901", "title": "never reviewed", "category": "Cat"}]
    reviews = []
    for u in range(40):
        n = rng.integers(4, 10)
        for t in range(n):
            reviews.append({"reviewerID": f"U{u:03d}",
                            "asin": asins[rng.integers(len(asins))],
                            "unixReviewTime": int(1e9 + u * 1000 + t)})
    reviews.append({"reviewerID": "U000", "asin": "A900", "unixReviewTime": 5})
    raw = tmp_path / "raw"
    raw.mkdir()
    write_jsonl_gz(raw / "Cat_metadata.jsonl.gz", meta)
    write_jsonl_gz(raw / "Cat_reviews.jsonl.gz", reviews)
    write_jsonl_gz(raw / "Dev_metadata.jsonl.gz", meta)
    write_jsonl_gz(raw / "Dev_reviews.jsonl.gz", reviews[:100])
    return raw


def same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return names


@pytest.mark.parametrize("artifacts", ["pretrain", "finetune_subsampled", "finetune_all"])
def test_amazon_artifacts_equal_the_jax_package(artifacts, amazon_raw, tmp_path):
    outs = []
    for mod in (jax_amazon, torch_amazon):
        out = str(tmp_path / mod.__name__.split(".")[0])
        if artifacts == "pretrain":
            mod.build_pretrain_corpus(["Cat", "Dev"], str(amazon_raw), out)
        else:
            mod.build_finetune_category(
                str(amazon_raw / "Cat_reviews.jsonl.gz"), str(amazon_raw / "Cat_metadata.jsonl.gz"),
                out, subsample_one_in=5 if artifacts == "finetune_subsampled" else 1)
        outs.append(out)
    names = same_files(*outs)
    expected = (["dev.json", "meta_data.json", "smap.json", "train.json"]
                if artifacts == "pretrain"
                else ["meta_data.json", "smap.json", "test.json", "train.json", "umap.json",
                      "val.json"])
    assert names == expected
    with open(os.path.join(outs[1], "smap.json")) as f:
        smap = json.load(f)
    assert sorted(smap.values()) == list(range(len(smap))) and "A900" not in smap
