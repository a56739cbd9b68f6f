"""Batch recommendation serving: user sequences in, top-k item ids out.

Counterpart of ``recformer_tpu/cli/serve.py`` with the same flags, plus
``--device`` (default ``cuda``; without a GPU the command raises unless
``--device cpu`` is given). The catalog is encoded (or read from a ``.npy``)
and each batch of users takes a dense top-k over the full catalog on one
device. Started by torchrun on more than one rank, the catalog is
row-sharded over all of them (each rank encodes its rows, or takes them
from ``--item_embeddings``; no cache is written) and each batch's top-k is
``parallel.catalog.sharded_topk``, which masks the padding rows; rank 0
writes the output.

Input: JSON file mapping user id -> item-id list (chronological), or a JSON
list of sequences. Output: JSONL of {user, items: [...], scores: [...]}.

    python -m recformer_tpu_torch.cli.serve --data_path DIR --sequences S.json \\
        --model_size base --device cuda
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m recformer_tpu_torch.cli.serve --data_path DIR --sequences S.json --device cuda
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
from ..parallel.catalog import shard_rows, sharded_topk
from ..parallel.mesh import destroy, make_mesh, world_size
from ..training.loops import encode_all_items, encode_catalog_shard
from ..utils.device import resolve_device
from ..utils.io import read_json
from .common import (
    MODEL_SIZES,
    build_config,
    init_model_params,
    make_tokenizer,
    maybe_load_pretrained,
    rank0_first,
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
    p.add_argument("--model_size", choices=MODEL_SIZES, default="base")
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
    mesh = make_mesh(world_size(), args.device) if world_size() > 1 else None
    try:
        return _serve(args, mesh)
    finally:
        if mesh is not None:
            destroy(mesh)


def _serve(args, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    meta = read_json(os.path.join(args.data_path, "meta_data.json"))
    item2id = read_json(os.path.join(args.data_path, "smap.json"))
    id2item = {v: k for k, v in item2id.items()}
    config = build_config(args, item_num=len(item2id))
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table_np = rank0_first(mesh, lambda: tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name))
    table = table_to_device(table_np, device)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.ckpt)

    n_items = int(table["lengths"].shape[0]) - 1
    if args.item_embeddings:
        item_emb = torch.from_numpy(np.load(args.item_embeddings)).to(device)
        if mesh is not None:
            item_emb = shard_rows(item_emb, mesh.model_group)
    elif mesh is not None:
        item_emb = encode_catalog_shard(model, table, config, mesh.model_group,
                                        args.encode_batch_size)
    else:
        item_emb = encode_all_items(
            model, table, config, args.encode_batch_size,
            cache_path=os.path.join(args.data_path, "preprocess", f"item_emb_{name}.npz"))
    item_emb = item_emb.float()
    writes = mesh is None or mesh.rank == 0

    raw = read_json(args.sequences)
    if isinstance(raw, dict):
        users = sorted(raw)
        seqs = {i: raw[u] for i, u in enumerate(users)}
    else:
        users = list(range(len(raw)))
        seqs = {i: s for i, s in enumerate(raw)}
    max_items = max(max((len(s) for s in seqs.values()), default=1), 1)
    ds = SequenceDataset(seqs, max_items=max_items)

    out_f = open(args.output, "w") if args.output != "-" and writes else None
    emitted = 0
    try:
        for batch in ds.batches(args.batch_size):
            with torch.no_grad():
                b = assemble_for_config(table, torch.from_numpy(batch.item_ids).to(device),
                                        torch.from_numpy(batch.seq_lens).to(device), config)
                pooled = model(b).float()
                if mesh is not None:
                    scores_k, ids_k = sharded_topk(pooled, item_emb, args.top_k, config.temp,
                                                   n_items, mesh.model_group)
                else:
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
                if writes:
                    (out_f.write(line + "\n") if out_f else print(line))
                emitted += 1
    finally:
        if out_f:
            out_f.close()
    if writes:
        print(f"[serve] recommended top-{args.top_k} for {emitted} users")
    return emitted


if __name__ == "__main__":
    main()
