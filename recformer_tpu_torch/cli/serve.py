"""Batch recommendation serving: user sequences in, top-k item ids out.

Counterpart of ``recformer_tpu/cli/serve.py`` with the same flags, plus
``--device`` (default ``cuda``; without a GPU the command raises unless
``--device cpu`` is given). The catalog is encoded (or read from a ``.npy``)
and each batch of users takes a dense top-k over the full catalog on one
device; the sharded multi-device top-k comes with the parallel slice.

Input: JSON file mapping user id -> item-id list (chronological), or a JSON
list of sequences. Output: JSONL of {user, items: [...], scores: [...]}.

    python -m recformer_tpu_torch.cli.serve --data_path DIR --sequences S.json \\
        --model_size base --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.datasets import SequenceDataset
from ..data.device_pipeline import assemble_for_config
from ..models.heads import RecformerForSeqRec, similarity_scores
from ..training.loops import encode_all_items
from ..utils.device import resolve_device
from ..utils.io import read_json
from .common import (
    build_config,
    init_model_params,
    make_tokenizer,
    maybe_load_pretrained,
    table_to_device,
    tokenize_corpus_cached,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True,
                   help="dir with meta_data.json + smap.json (catalog)")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch .bin/.pt state dict with HF Longformer names")
    p.add_argument("--hf_tokenizer", type=str, default=None)
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--sequences", type=str, required=True,
                   help="JSON: user -> item ids, or list of sequences")
    p.add_argument("--top_k", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--encode_batch_size", type=int, default=256)
    p.add_argument("--item_embeddings", type=str, default=None,
                   help="precomputed .npy catalog (skips encoding)")
    p.add_argument("--output", type=str, default="-")
    p.add_argument("--attention_impl", choices=["dense", "chunked", "pallas"], default=None)
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    meta = read_json(os.path.join(args.data_path, "meta_data.json"))
    item2id = read_json(os.path.join(args.data_path, "smap.json"))
    id2item = {v: k for k, v in item2id.items()}
    config = build_config(args, item_num=len(item2id))
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table_np = tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name
    )
    table = table_to_device(table_np, device)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.ckpt)

    if args.item_embeddings:
        item_emb = torch.from_numpy(np.load(args.item_embeddings)).to(device)
    else:
        item_emb = encode_all_items(
            model, table, config, args.encode_batch_size,
            cache_path=os.path.join(args.data_path, "preprocess", f"item_emb_{name}.npz"))
    item_emb = item_emb.float()

    raw = read_json(args.sequences)
    if isinstance(raw, dict):
        users = sorted(raw)
        seqs = {i: raw[u] for i, u in enumerate(users)}
    else:
        users = list(range(len(raw)))
        seqs = {i: s for i, s in enumerate(raw)}
    max_items = max(max((len(s) for s in seqs.values()), default=1), 1)
    ds = SequenceDataset(seqs, max_items=max_items)

    out_f = open(args.output, "w") if args.output != "-" else None
    emitted = 0
    try:
        for batch in ds.batches(args.batch_size):
            with torch.inference_mode():
                b = assemble_for_config(table, torch.from_numpy(batch.item_ids).to(device),
                                        torch.from_numpy(batch.seq_lens).to(device), config)
                pooled = model(b).float()
                scores = similarity_scores(pooled, item_emb, config.temp)
                scores_k, ids_k = torch.topk(scores, args.top_k, dim=-1)
            scores_k = scores_k.cpu().numpy()
            ids_k = ids_k.cpu().numpy()
            for i in range(len(batch.valid)):
                if not batch.valid[i]:
                    continue
                row = {
                    "user": users[emitted],
                    "items": [id2item.get(int(j), int(j)) for j in ids_k[i]],
                    "scores": [round(float(s), 4) for s in scores_k[i]],
                }
                line = json.dumps(row)
                (out_f.write(line + "\n") if out_f else print(line))
                emitted += 1
    finally:
        if out_f:
            out_f.close()
    print(f"[serve] recommended top-{args.top_k} for {emitted} users")
    return emitted


if __name__ == "__main__":
    main()
