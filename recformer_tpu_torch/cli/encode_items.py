"""Item-embedding encoding: batch-encode a whole catalog with a trained
encoder and save the ``(N, H)`` matrix.

Counterpart of ``recformer_tpu/cli/encode_items.py`` with the same flags,
plus ``--embed_ln_impl`` and ``--device`` (default ``cuda``; without a GPU
the command raises unless ``--device cpu`` is given). ``--ckpt`` is a torch
state dict with HF Longformer names. The matrix is written as float32
(``.npy`` has no bfloat16; float32 holds the bf16 values exactly), which
``cli.evaluate_seq --item_embeddings`` and ``cli.serve --item_embeddings``
read.

    python -m recformer_tpu_torch.cli.encode_items --data_path DIR --ckpt M.bin \\
        --output item_embeddings.npy --device cuda
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..models.heads import RecformerForSeqRec
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
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--meta_file", type=str, default="meta_data.json")
    p.add_argument("--item2id_file", type=str, default="smap.json")
    p.add_argument("--ckpt", type=str, default=None,
                   help="torch .bin/.pt state dict with HF Longformer names")
    p.add_argument("--hf_tokenizer", type=str, default=None)
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--output", type=str, default="item_embeddings.npy")
    p.add_argument("--attention_impl", choices=["dense", "chunked", "pallas"], default=None)
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--embed_ln_impl", choices=["xla", "pallas"], default=None,
                   help="embedding sum + LayerNorm: plain (default) or the fused kernel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    meta = read_json(os.path.join(args.data_path, args.meta_file))
    item2id = read_json(os.path.join(args.data_path, args.item2id_file))
    config = build_config(args, item_num=len(item2id))
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table_np = tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name
    )
    table = table_to_device(table_np, device)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.ckpt)
    emb = encode_all_items(model, table, config, args.batch_size).float().cpu().numpy()
    np.save(args.output, emb)
    print(f"[encode] wrote {emb.shape} embeddings to {args.output}")
    return emb


if __name__ == "__main__":
    main()
