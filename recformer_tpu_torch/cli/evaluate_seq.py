"""Evaluation only: load a checkpoint, encode the catalog, run full-corpus
ranked evaluation on the test (or validation) split.

Counterpart of ``recformer_tpu/cli/evaluate_seq.py`` with the same flags,
plus ``--embed_ln_impl`` and ``--device`` (default ``cuda``; without a GPU
the command raises unless ``--device cpu`` is given). ``--ckpt`` is a torch
state dict with HF Longformer names (``""`` keeps the random weights from
seed 0: the zero-shot protocol on a fresh model). ``--item_embeddings``
reads a saved catalog ``.npy``; otherwise the catalog is encoded and cached
in ``<data>/preprocess/item_emb_<name>.npz`` under a fingerprint of the
parameters. ``--scan_layers``, ``--scan_unroll``, ``--remat`` and
``--remat_policy`` are recorded in the config and change no forward pass.

``--sharded_eval N`` ranks against a catalog row-sharded over N ranks
(``training.loops.evaluate_seqrec_sharded``), one process per rank under
torchrun, with a world size that N divides: each group of N ranks encodes
its rows of the catalog (or takes them from ``--item_embeddings``; no cache
is written) and the users' batches are dealt over the world / N groups.
Rank 0 prints and writes the metrics.

    python -m recformer_tpu_torch.cli.evaluate_seq --data_path DIR --ckpt M.bin \\
        --device cuda
    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m recformer_tpu_torch.cli.evaluate_seq --data_path DIR --ckpt M.bin \\
        --sharded_eval 2 --device cuda
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.datasets import EvalDataset
from ..models.heads import RecformerForSeqRec
from ..parallel.catalog import shard_rows
from ..parallel.mesh import destroy, make_mesh, world_size
from ..training.loops import (encode_all_items, encode_catalog_shard, evaluate_seqrec,
                              evaluate_seqrec_sharded)
from ..utils.device import resolve_device
from ..utils.io import load_finetune_artifacts
from .common import (
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
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--ckpt", type=str, required=True,
                   help="torch .bin/.pt state dict with HF Longformer names; '' = random")
    p.add_argument("--hf_tokenizer", type=str, default=None)
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--split", choices=["val", "test"], default="test")
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--encode_batch_size", type=int, default=256)
    p.add_argument("--temp", type=float, default=0.05)
    p.add_argument("--attention_impl", choices=["dense", "chunked", "pallas"], default=None)
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--scan_layers", action="store_true", default=None,
                   help="recorded in the config; the forward pass is the same")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recorded in the config; a forward pass keeps no activations")
    p.add_argument("--remat_policy", default=None,
                   choices=["full", "save_attention", "dots", "dots_attn"])
    p.add_argument("--pooler_type", choices=["cls", "avg"], default=None,
                   help="sequence pooling: CLS token (default) or masked mean")
    p.add_argument("--max_token_num", type=int, default=None,
                   help="max sequence length in tokens")
    p.add_argument("--scan_unroll", type=int, default=None,
                   help="recorded in the config; the forward pass is the same")
    p.add_argument("--item_embeddings", type=str, default=None,
                   help="precomputed catalog .npy (e.g. from cli.encode_items); without "
                        "it the catalog is encoded afresh (the zero-shot protocol)")
    p.add_argument("--output_file", type=str, default=None)
    p.add_argument("--sharded_eval", type=int, default=0, metavar="N_SHARDS",
                   help="rank against a catalog row-sharded over N ranks (under torchrun; "
                        "the world size a multiple of N)")
    p.add_argument("--embed_ln_impl", choices=["xla", "pallas"], default=None,
                   help="embedding sum + LayerNorm: plain (default) or the fused kernel")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    mesh = None
    if args.sharded_eval:
        n_world = world_size()
        if "MASTER_ADDR" not in os.environ or n_world % args.sharded_eval:
            raise SystemExit(f"--sharded_eval {args.sharded_eval} runs one process per rank: "
                             "start it with python -m torch.distributed.run --standalone "
                             f"--nproc_per_node M, M a multiple of {args.sharded_eval} "
                             f"(world size here: {n_world})")
        mesh = make_mesh(args.sharded_eval, args.device)
    try:
        return _evaluate(args, mesh)
    finally:
        if mesh is not None:
            destroy(mesh)


def _evaluate(args, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    train, val, test, meta, item2id, _ = load_finetune_artifacts(args.data_path)
    config = build_config(args, item_num=len(item2id))
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table_np = rank0_first(mesh, lambda: tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name))
    table = table_to_device(table_np, device)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.ckpt)
    max_items = max(max((len(s) for s in train.values()), default=1), 1) + 1
    ds = EvalDataset(train, val, test, args.split, max_items=max_items)

    if mesh is not None:
        n_items = int(table["lengths"].shape[0]) - 1
        if args.item_embeddings:
            emb_shard = shard_rows(torch.from_numpy(np.load(args.item_embeddings)).to(device),
                                   mesh.model_group)
        else:
            emb_shard = encode_catalog_shard(model, table, config, mesh.model_group,
                                             args.encode_batch_size)
        metrics = evaluate_seqrec_sharded(model, table, ds, emb_shard, n_items, config, mesh,
                                          args.batch_size)
    else:
        if args.item_embeddings:
            item_embeddings = torch.from_numpy(np.load(args.item_embeddings)).to(device)
        else:
            item_embeddings = encode_all_items(
                model, table, config, args.encode_batch_size,
                cache_path=os.path.join(args.data_path, "preprocess", f"item_emb_{name}.npz"))
        metrics = evaluate_seqrec(model, table, ds, item_embeddings, config, args.batch_size)
    if mesh is None or mesh.rank == 0:
        print(f"{args.split} set: {metrics}")
        if args.output_file:
            with open(args.output_file, "w") as f:
                json.dump(metrics, f, indent=2)
    return metrics


if __name__ == "__main__":
    main()
