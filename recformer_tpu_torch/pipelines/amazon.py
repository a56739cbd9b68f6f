"""Amazon review-data pipelines: pretrain corpus + per-category finetune
artifacts (a copy of ``recformer_tpu/pipelines/amazon.py``: the same files,
byte for byte).

Offline host tooling producing the same JSON artifact contract as the
reference pipelines:

- pretrain (``reference/pretrain_data/meta_data_process.py`` +
  ``interaction_data_process.py``): intersect meta/review asins, extract
  {title, brand, category} into ``meta_data.json``; per-user-per-category
  time-sorted sequences; the LAST category's sequences become the dev set.
  Improvement over the reference (documented deviation): sequences are
  emitted as dense int ids with an accompanying ``smap.json`` instead of raw
  asin strings, so the training path is integer-only.
- finetune (``reference/finetune_data/process.py``): users with > 3
  interactions, 1-in-5 user subsample, leave-one-out split (last item = test,
  second-to-last = val), ``train/val/test/umap/smap/meta_data.json``.
- download (``reference/pretrain_data/download_data.py``): resumable
  size-checked streaming download of the McAuley Amazon v2 dumps (needs
  network; everything else runs offline).
"""

from __future__ import annotations

import gzip
import json
import os
import random
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

from ..utils.io import write_json

AMAZON_BASE_URL = (
    "https://mcauleylab.ucsd.edu/public_datasets/data/amazon_v2"
)


class LabelField:
    """Insertion-ordered label -> dense int id (``process.py:9-22``)."""

    def __init__(self):
        self.label2id: Dict[str, int] = {}

    def get_id(self, label: str) -> int:
        if label not in self.label2id:
            self.label2id[label] = len(self.label2id)
        return self.label2id[label]


def _iter_jsonl_gz(path: str):
    with gzip.open(path, "rt", encoding="utf-8") as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


def extract_meta(meta_path: str, selected_asins: Optional[set] = None) -> Dict[str, Dict]:
    """{asin: {title, brand, category}} (``meta_data_process.py:20-43``)."""
    meta = {}
    for line in _iter_jsonl_gz(meta_path):
        asin = line.get("asin")
        title = line.get("title")
        if asin is None or title is None:
            continue
        if selected_asins is not None and asin not in selected_asins:
            continue
        category = line.get("category") or []
        if isinstance(category, list):
            category = " ".join(category)
        meta[asin] = {
            "title": title,
            "brand": line.get("brand") or "",
            "category": category,
        }
    return meta


def build_pretrain_corpus(categories: Sequence[str], raw_dir: str, out_dir: str) -> None:
    """Last category = dev (``interaction_data_process.py:52-82``)."""
    os.makedirs(out_dir, exist_ok=True)
    meta_paths = [os.path.join(raw_dir, f"{c}_metadata.jsonl.gz") for c in categories]
    seq_paths = [os.path.join(raw_dir, f"{c}_reviews.jsonl.gz") for c in categories]

    meta_asins, seq_asins = set(), set()
    for p in meta_paths:
        for line in _iter_jsonl_gz(p):
            if line.get("asin") is not None and line.get("title") is not None:
                meta_asins.add(line["asin"])
    for p in seq_paths:
        for line in _iter_jsonl_gz(p):
            if line.get("asin") is not None and line.get("reviewerID") is not None:
                seq_asins.add(line["asin"])
    selected = meta_asins & seq_asins
    print(f"[amazon] {len(meta_asins)} meta asins, {len(seq_asins)} seq asins, "
          f"{len(selected)} selected")

    meta: Dict[str, Dict] = {}
    for p in meta_paths:
        meta.update(extract_meta(p, selected))

    smap = LabelField()

    def extract_sequences(path: str) -> List[List[int]]:
        raw = defaultdict(list)
        category = os.path.basename(path)
        for line in _iter_jsonl_gz(path):
            asin = line.get("asin")
            if asin in meta:
                raw[str(line["reviewerID"]) + "_" + category].append(
                    (line.get("unixReviewTime", 0), asin)
                )
        return [[smap.get_id(a) for _, a in sorted(v)] for v in raw.values()]

    train_seqs: List[List[int]] = []
    for p in seq_paths[:-1]:
        train_seqs.extend(extract_sequences(p))
    dev_seqs = extract_sequences(seq_paths[-1])

    # meta keyed by raw asin, filtered to mapped items
    meta = {a: v for a, v in meta.items() if a in smap.label2id}
    write_json(train_seqs, os.path.join(out_dir, "train.json"))
    write_json(dev_seqs, os.path.join(out_dir, "dev.json"))
    write_json(meta, os.path.join(out_dir, "meta_data.json"))
    write_json(smap.label2id, os.path.join(out_dir, "smap.json"))
    print(f"[amazon] pretrain corpus: {len(train_seqs)} train, {len(dev_seqs)} dev "
          f"sequences, {len(smap.label2id)} items -> {out_dir}")


def build_finetune_category(
    reviews_path: str,
    meta_path: str,
    out_dir: str,
    min_interactions: int = 3,
    subsample_one_in: int = 5,
    seed: int = 12345,
) -> None:
    """Leave-one-out per-category finetune artifacts
    (``finetune_data/process.py:66-134``)."""
    os.makedirs(out_dir, exist_ok=True)
    meta = extract_meta(meta_path)

    raw = defaultdict(list)
    for line in _iter_jsonl_gz(reviews_path):
        asin = line.get("asin")
        if asin in meta:
            raw[line["reviewerID"]].append((asin, line.get("unixReviewTime", 0)))

    rng = random.Random(seed)
    user_field, s_field = LabelField(), LabelField()
    sequences: Dict[int, List[int]] = {}
    for user, inter in raw.items():
        if len(inter) > min_interactions and rng.randint(0, subsample_one_in - 1) == 0:
            ordered = [a for a, _ in sorted(inter, key=lambda x: x[1])]
            sequences[user_field.get_id(user)] = [s_field.get_id(a) for a in ordered]

    train, val, test = {}, {}, {}
    for u, seq in sequences.items():
        if len(seq) < 3:
            train[u] = seq
        else:
            train[u] = seq[:-2]
            val[u] = [seq[-2]]
            test[u] = [seq[-1]]

    meta = {a: v for a, v in meta.items() if a in s_field.label2id}
    write_json(train, os.path.join(out_dir, "train.json"))
    write_json(val, os.path.join(out_dir, "val.json"))
    write_json(test, os.path.join(out_dir, "test.json"))
    write_json(user_field.label2id, os.path.join(out_dir, "umap.json"))
    write_json(s_field.label2id, os.path.join(out_dir, "smap.json"))
    write_json(meta, os.path.join(out_dir, "meta_data.json"))
    print(f"[amazon] finetune artifacts: {len(sequences)} users, "
          f"{len(s_field.label2id)} items -> {out_dir}")


def download_category(category: str, out_dir: str, kinds=("reviews", "metadata"),
                      chunk: int = 1 << 20) -> None:
    """Resumable download (``download_data.py:17-100``); requires network."""
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    urls = {
        "reviews": f"{AMAZON_BASE_URL}/categoryFiles/{category}.json.gz",
        "metadata": f"{AMAZON_BASE_URL}/metaFiles2/meta_{category}.json.gz",
    }
    names = {
        "reviews": f"{category}_reviews.jsonl.gz",
        "metadata": f"{category}_metadata.jsonl.gz",
    }
    for kind in kinds:
        dest = os.path.join(out_dir, names[kind])
        start = os.path.getsize(dest) if os.path.exists(dest) else 0
        req = urllib.request.Request(urls[kind])
        if start:
            req.add_header("Range", f"bytes={start}-")
        try:
            with urllib.request.urlopen(req) as resp, open(dest, "ab") as f:
                while True:
                    block = resp.read(chunk)
                    if not block:
                        break
                    f.write(block)
        except Exception as e:  # zero-egress environments
            raise RuntimeError(
                f"download of {urls[kind]} failed ({e}); place the file at {dest} manually"
            ) from e
