"""Two-stage sequential-recommendation finetune, on one device.

Counterpart of ``recformer_tpu/cli/finetune.py``, with its flags plus
``--device`` (default ``cuda``; without a GPU the command raises unless
``--device cpu`` is given). Stage 1 re-encodes the item catalog every epoch
and trains the sequence tower against it; stage 2 reloads the stage-1 best
with its catalog and trains against that catalog, frozen; the test split is
ranked against the selected parameters' own catalog
(``training.loops.finetune_two_stage``).

Outputs under ``<output_dir>/<data name>/``: ``best_model.pt`` (a torch
state dict in HF Longformer names, which ``cli.evaluate_seq --ckpt`` and the
JAX package's ``import_torch_state_dict`` read), ``item_embeddings.npy``
(float32, the catalog the selected parameters were trained with:
``cli.evaluate_seq --item_embeddings``), ``config.json`` and
``test_metrics.json``. ``loop_state/`` there holds the rolling per-epoch
checkpoint; it is removed when the run completes, and a leftover one is
continued with ``--resume`` (without it the command refuses to start).

``--pretrain_ckpt`` reads a torch state dict (``cli.pretrain``'s
``best.pt``, or an HF/reference ``.bin``): every name and shape match is
copied, the MLM head is skipped. ``--remat``/``--remat_policy`` recompute
each encoder layer in the backward (``models/encoder.py``).

    python -m recformer_tpu_torch.cli.finetune --data_path DIR \\
        --pretrain_ckpt pretrain_ckpts/best.pt --output_dir checkpoints --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from ..data.datasets import EvalDataset, SequenceDataset
from ..models.heads import RecformerForSeqRec
from ..training.checkpoint import save_params
from ..training.loops import finetune_two_stage
from ..training.optimizer import create_optimizer
from ..utils.device import resolve_device
from ..utils.io import load_finetune_artifacts
from .common import (
    MODEL_SIZES,
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
    p.add_argument("--output_dir", type=str, default="checkpoints")
    p.add_argument("--pretrain_ckpt", type=str, default=None,
                   help="torch state dict to start from (cli.pretrain's best.pt, a .bin)")
    p.add_argument("--hf_tokenizer", type=str, default=None,
                   help="local HF tokenizer dir (RoBERTa BPE); hash backend if absent")
    p.add_argument("--model_size", choices=MODEL_SIZES, default="base")
    p.add_argument("--temp", type=float, default=0.05)
    p.add_argument("--num_train_epochs", type=int, default=16)
    p.add_argument("--gradient_accumulation_steps", type=int, default=8)
    p.add_argument("--finetune_negative_sample_size", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--encode_batch_size", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--verbose", type=int, default=3)
    p.add_argument("--attention_impl", choices=["dense", "chunked", "pallas"], default=None)
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--scan_layers", action="store_true", default=None,
                   help="recorded in the config; the port runs the same layer loop either way")
    p.add_argument("--remat", action="store_true", default=None,
                   help="recompute each encoder layer in the backward (less memory)")
    p.add_argument("--remat_policy", default=None,
                   choices=["full", "save_attention", "dots", "dots_attn"],
                   help="what a recomputed layer keeps (see config.remat_policy)")
    p.add_argument("--pooler_type", choices=["cls", "avg"], default=None,
                   help="sequence pooling: CLS token (default) or masked mean")
    p.add_argument("--max_token_num", type=int, default=None,
                   help="max sequence length in tokens")
    p.add_argument("--scan_unroll", type=int, default=None,
                   help="recorded in the config; no effect on the port's layer loop")
    p.add_argument("--steps_per_call", type=int, default=16,
                   help="the JAX CLI's steps per device dispatch, which it calls bit-equal "
                        "to sequential steps; the port runs every step back to back, so "
                        "the value changes nothing")
    p.add_argument("--fix_word_embedding", action="store_true",
                   help="freeze the word-embedding table: no update, no decay, out of the "
                        "clip norm")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the rolling per-epoch "
                        "checkpoint under output_dir")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mirror_file", default=None,
                   help="append-only JSONL mirror of every dev/test metric row, written "
                        "(fsync'd) as each is produced")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    train, val, test, meta, item2id, _ = load_finetune_artifacts(args.data_path)
    config = build_config(args, item_num=len(item2id))
    if config.inference_only:
        raise SystemExit(f"--model_size {args.model_size} runs for inference only (cli.serve)")
    tokenizer = make_tokenizer(config, args.hf_tokenizer)

    name = os.path.basename(os.path.normpath(args.data_path))
    cache_dir = os.path.join(args.data_path, "preprocess")
    table = table_to_device(tokenize_corpus_cached(tokenizer, meta, item2id, cache_dir, name),
                            device)

    max_items = max(len(s) for s in train.values())
    max_items = max(max_items, max(len(train.get(u, [])) + 1 for u in test))
    train_ds = SequenceDataset(train, max_items=max_items)
    val_ds = EvalDataset(train, val, test, "val", max_items=max_items)
    test_ds = EvalDataset(train, val, test, "test", max_items=max_items)

    model = init_model_params(RecformerForSeqRec(config), config, device)
    model = maybe_load_pretrained(model, args.pretrain_ckpt)
    if args.fix_word_embedding:
        model.longformer.embeddings.word_embeddings.weight.requires_grad_(False)

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    optimizer = create_optimizer(
        model, learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=steps_per_epoch * args.num_train_epochs * 2,
        grad_accum_steps=args.gradient_accumulation_steps)

    out = os.path.join(args.output_dir, name)
    resume_dir = os.path.join(out, "loop_state")
    if not args.resume and os.path.exists(os.path.join(resume_dir, "loop.json")):
        # a stale rolling checkpoint must not silently take over a fresh launch
        raise SystemExit(f"{resume_dir} holds an interrupted run; pass --resume to "
                         "continue it or remove the directory")
    model, item_embeddings, test_metrics = finetune_two_stage(
        model, optimizer, table, config, train_ds, val_ds, test_ds,
        num_epochs=args.num_train_epochs, batch_size=args.batch_size,
        eval_batch_size=args.eval_batch_size, encode_batch_size=args.encode_batch_size,
        verbose=args.verbose, seed=args.seed,
        encode_cache=os.path.join(cache_dir, f"item_emb_init_{name}.npz"),
        resume_dir=resume_dir, mirror_path=args.mirror_file)
    print(f"Test set: {test_metrics}")
    if args.mirror_file:
        with open(f"{args.mirror_file.rsplit('.', 1)[0]}_test_metrics.json", "w") as f:
            json.dump(test_metrics, f, indent=2)

    os.makedirs(out, exist_ok=True)
    save_params(os.path.join(out, "best_model.pt"), model)
    np.save(os.path.join(out, "item_embeddings.npy"), item_embeddings.float().cpu().numpy())
    config.save(os.path.join(out, "config.json"))
    with open(os.path.join(out, "test_metrics.json"), "w") as f:
        json.dump(test_metrics, f, indent=2)
    # the run completed: a later fresh launch must not be told to resume it
    shutil.rmtree(resume_dir, ignore_errors=True)
    return test_metrics


if __name__ == "__main__":
    main()
