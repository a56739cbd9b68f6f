"""Artifact IO helpers (JSON contracts shared with the reference pipelines;
copy of ``recformer_tpu/utils/io.py``).

Reference: ``reference/utils.py:7-15`` and the artifact layout produced
by ``finetune_data/process.py:59-65`` — ``train/val/test.json`` (user -> item
id list), ``meta_data.json`` (item raw id -> attribute dict), ``smap.json``
(item raw id -> dense int id), ``umap.json``.
"""

from __future__ import annotations

import json
import os


def read_json(path: str, as_int: bool = False):
    with open(path) as f:
        raw = json.load(f)
    if isinstance(raw, list):
        return raw
    if as_int:
        return {int(k): v for k, v in raw.items()}
    return dict(raw)


def write_json(obj, path: str) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f)


def load_finetune_artifacts(data_path: str, train_file="train.json", dev_file="val.json",
                            test_file="test.json", meta_file="meta_data.json",
                            item2id_file="smap.json"):
    """Reference ``finetune.py:20-35``: load splits + metadata, filter meta to
    mapped items."""
    train = read_json(os.path.join(data_path, train_file), as_int=True)
    val = read_json(os.path.join(data_path, dev_file), as_int=True)
    test = read_json(os.path.join(data_path, test_file), as_int=True)
    meta = read_json(os.path.join(data_path, meta_file))
    item2id = read_json(os.path.join(data_path, item2id_file))
    id2item = {v: k for k, v in item2id.items()}
    meta = {k: v for k, v in meta.items() if k in item2id}
    return train, val, test, meta, item2id, id2item
