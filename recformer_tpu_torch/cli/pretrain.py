"""Pretraining entry point: MLM + in-batch item-item contrastive retrieval, on one
device.

Counterpart of ``recformer_tpu/cli/pretrain.py``'s single-device path, with
its flags plus ``--device`` (default ``cuda``; without a GPU the command
raises unless ``--device cpu`` is given). ``--remat``/``--remat_policy`` are
not taken yet: in the port they need per-layer activation checkpointing
that redraws the same dropout masks in the recomputed forward. Each step builds its batch on the
device (pair sampling, two views, whole-word MLM), runs the two towers with
dropout, and takes an AdamW micro-step; validation on the dev set (the
contrastive accuracy) runs every ``--valid_step_interval`` steps and after
every epoch. The parameters are saved as torch state dicts, ``best.pt`` (by
dev accuracy) and ``last.pt`` in ``--output_dir``, which
``cli.common.maybe_load_pretrained`` reads back.

Data contract: ``--train_file``/``--dev_file`` are JSON lists (or dicts) of
item sequences, raw item keys or dense ids; ``--item_attr_file`` maps item
key -> attribute dict; ``--item2id_file`` maps item key -> dense id.

    python -m recformer_tpu_torch.cli.pretrain --data_path DIR --model_size base \\
        --device cuda
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..data.datasets import SequenceDataset
from ..models.heads import RecformerForPretraining
from ..training.optimizer import create_optimizer
from ..training.steps import make_pretrain_eval_step, make_pretrain_step
from ..utils.device import resolve_device
from ..utils.io import read_json
from ..utils.rng import StepRNG
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
    p.add_argument("--train_file", type=str, default="train.json")
    p.add_argument("--dev_file", type=str, default="dev.json")
    p.add_argument("--item_attr_file", type=str, default="meta_data.json")
    p.add_argument("--item2id_file", type=str, default="smap.json")
    p.add_argument("--output_dir", type=str, default="pretrain_ckpts")
    p.add_argument("--longformer_ckpt", type=str, default=None,
                   help="HF Longformer torch .bin to initialize from")
    p.add_argument("--hf_tokenizer", type=str, default=None,
                   help="local path of a Hugging Face tokenizer (no download)")
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--num_train_epochs", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--gradient_accumulation_steps", type=int, default=8)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--temp", type=float, default=0.05)
    p.add_argument("--mlm_weight", type=float, default=0.1)
    p.add_argument("--attention_impl", default=None, choices=["dense", "chunked", "pallas"])
    p.add_argument("--hidden_act", choices=["gelu", "gelu_tanh", "relu"], default=None,
                   help="override activation: 'gelu' (exact erf) restores HF parity "
                        "for imported checkpoints; base() defaults to gelu_tanh")
    p.add_argument("--scan_layers", action="store_true", default=None,
                   help="recorded in the config (the JAX package's stacked layers); the "
                        "port runs the same layer loop either way")
    p.add_argument("--scan_unroll", type=int, default=None,
                   help="recorded in the config; no effect on the port's layer loop")
    p.add_argument("--pooler_type", choices=["cls", "avg"], default=None,
                   help="sequence pooling: CLS token (default) or masked mean")
    p.add_argument("--max_token_num", type=int, default=None,
                   help="max sequence length in tokens")
    p.add_argument("--ln_impl", choices=["xla", "pallas_bwd", "split_bwd"], default=None,
                   help="encoder-block LayerNorm: flax's (default), the backward kernel, "
                        "or the split plain backward (see config.ln_impl)")
    p.add_argument("--fix_word_embedding", action="store_true")
    p.add_argument("--valid_step_interval", type=int, default=2000)
    p.add_argument("--valid_batches", type=int, default=0,
                   help="cap dev validation at this many batches; 0 = the full dev set")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def _crossed(interval: int, prev_step: int, step: int) -> bool:
    """True when [prev_step, step] crossed a multiple of ``interval``."""
    return interval > 0 and step // interval > prev_step // interval


def _validate(eval_step, seed, device, table, dev_ds, batch_size, max_batches=0) -> float:
    """Contrastive dev accuracy. The batches are drawn from a generator made
    anew from ``seed``, so every validation sees the same batches."""
    generator = StepRNG(seed, device).device
    correct = total = None
    for i, batch in enumerate(dev_ds.batches(batch_size, drop_last=True)):
        if max_batches and i >= max_batches:
            print(f"[pretrain] dev subsampled to {max_batches} batches (--valid_batches)")
            break
        out = eval_step(generator, table, torch.from_numpy(batch.item_ids).to(device),
                        torch.from_numpy(batch.seq_lens).to(device))
        correct = out["cl_correct"] if correct is None else correct + out["cl_correct"]
        total = out["cl_total"] if total is None else total + out["cl_total"]
    if total is None:
        return 0.0
    return float(correct) / max(float(total), 1.0)


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    config = build_config(args)
    tokenizer = make_tokenizer(config, args.hf_tokenizer)

    train_seqs = read_json(os.path.join(args.data_path, args.train_file))
    if isinstance(train_seqs, dict):
        train_seqs = list(train_seqs.values())
    dev_path = os.path.join(args.data_path, args.dev_file)
    dev_seqs = read_json(dev_path) if os.path.exists(dev_path) else train_seqs
    if isinstance(dev_seqs, dict):
        dev_seqs = list(dev_seqs.values())
    meta = read_json(os.path.join(args.data_path, args.item_attr_file))
    item2id = read_json(os.path.join(args.data_path, args.item2id_file))

    def to_int_ids(seqs):
        """Raw item keys map through ``item2id`` (unknown ones are dropped);
        dense int ids pass as they are."""
        out = []
        for s in seqs:
            if s and isinstance(s[0], str):
                s = [item2id[a] for a in s if a in item2id]
            if s:
                out.append(s)
        return out

    train_seqs = to_int_ids(train_seqs)
    dev_seqs = to_int_ids(dev_seqs)
    table_np = tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), "pretrain")
    table = table_to_device(table_np, device)

    max_items = max(len(s) for s in train_seqs)
    train_ds = SequenceDataset({i: s for i, s in enumerate(train_seqs)}, max_items=max_items)
    dev_ds = SequenceDataset({i: s for i, s in enumerate(dev_seqs)}, max_items=max_items)

    model = init_model_params(RecformerForPretraining(config), config, device)
    model = maybe_load_pretrained(model, args.longformer_ckpt)
    if args.fix_word_embedding:
        # no update for the word-embedding table
        model.longformer.embeddings.word_embeddings.weight.requires_grad_(False)

    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    total = steps_per_epoch * args.num_train_epochs
    optimizer = create_optimizer(
        model, learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=total,
        grad_accum_steps=args.gradient_accumulation_steps)
    step = make_pretrain_step(config, model, optimizer)
    eval_step = make_pretrain_eval_step(config, model)

    rng = StepRNG(args.seed, device)
    os.makedirs(args.output_dir, exist_ok=True)
    best_acc = -1.0
    global_step = 0
    last_log_step = 0
    t0 = time.time()

    def validate_and_keep_best():
        nonlocal best_acc
        acc = _validate(eval_step, args.seed, device, table, dev_ds, args.batch_size,
                        args.valid_batches)
        if acc > best_acc:
            best_acc = acc
            torch.save(model.state_dict(), os.path.join(args.output_dir, "best.pt"))
        return acc

    for epoch in range(args.num_train_epochs):
        for batch in train_ds.batches(args.batch_size, shuffle=True, seed=epoch,
                                      drop_last=True):
            prev_step = global_step
            metrics = step(rng, table, torch.from_numpy(batch.item_ids).to(device),
                           torch.from_numpy(batch.seq_lens).to(device))
            global_step += 1
            if _crossed(50, prev_step, global_step):
                m = {k: float(v) for k, v in metrics.items()}
                rate = args.batch_size * (global_step - last_log_step) / (time.time() - t0)
                t0 = time.time()
                last_log_step = global_step
                print(f"[pretrain] step {global_step} loss {m['loss']:.4f} "
                      f"acc {m['accuracy']:.4f} ({rate:.1f} ex/s)")
            if _crossed(args.valid_step_interval, prev_step, global_step):
                print(f"[pretrain] dev accuracy {validate_and_keep_best():.4f}")
        print(f"[pretrain] epoch {epoch} dev accuracy {validate_and_keep_best():.4f}")
        torch.save(model.state_dict(), os.path.join(args.output_dir, "last.pt"))
    config.save(os.path.join(args.output_dir, "config.json"))
    print(f"[pretrain] done; {global_step} steps, {optimizer.updates} updates; "
          f"best dev accuracy {best_acc:.4f}")
    return {"steps": global_step, "updates": optimizer.updates, "best_dev_accuracy": best_acc}


if __name__ == "__main__":
    main()
