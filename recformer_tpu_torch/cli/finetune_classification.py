"""Fraud-detection finetune (binary sequence classification), on one device.

Counterpart of ``recformer_tpu/cli/finetune_classification.py``, with its
flags plus ``--device`` (default ``cuda``; without a GPU the command raises
unless ``--device cpu`` is given): the backbone and a 3-layer MLP head,
BCE-with-logits with a ``pos_weight`` from the training labels' imbalance
scaled by 0.2, a threshold sweep that selects by F1 on the dev split every
epoch, early stopping after ``--patience`` epochs without a better F1, and
the test split scored with the selected parameters. As in the JAX CLI, the
item catalog is not re-encoded every epoch: the fraud forward never reads
it. The schedule's length is the JAX CLI's, ``(len(train) // batch_size)
* epochs`` updates, although each epoch runs ``ceil(len(train) /
batch_size)`` batches (the last padded with invalid rows).

Data: ``train/val/test.json`` map a user to ``[sequence, [label]]`` (the
transactional pipeline's ``classification_data/``), beside
``meta_data.json`` and ``smap.json``.

Outputs under ``<output_dir>/<data name>/``: ``best_model.pt`` (the
selected parameters in HF names, the head's ``fc1``-``fc3`` included),
``config.json``, ``test_metrics.json`` and ``epoch_metrics.json``.
``loop_state/`` there holds the rolling per-epoch checkpoint (``state.pt``,
``best_params.pt``, ``loop.json`` with the optimizer recipe); it is removed
when the run completes. A leftover one is continued with ``--resume``
(without it the command refuses to start), and refused if the recipe
(``--learning_rate``, ``--head_lr``) changed. ``--remat``/``--remat_policy``
recompute each encoder layer in the backward (``models/encoder.py``);
``--steps_per_call`` is accepted and its steps run back to back.

    python -m recformer_tpu_torch.cli.finetune_classification \\
        --data_path DIR/artifacts/classification_data --pretrain_ckpt fraud.pt \\
        --head_lr 1e-3 --device cuda
"""

from __future__ import annotations

import argparse
import json
import os
import shutil

import numpy as np

from ..data.datasets import FraudDataset
from ..models.heads import RecformerForFraudDetection
from ..training.checkpoint import (
    restore_params,
    restore_train_state,
    save_params,
    save_train_state,
)
from ..training.loops import evaluate_fraud, train_fraud_epoch
from ..training.optimizer import create_optimizer
from ..training.steps import make_fraud_train_step
from ..utils.device import resolve_device
from ..utils.io import read_json
from ..utils.logging import append_jsonl
from .common import (
    build_config,
    init_model_params,
    make_tokenizer,
    maybe_load_pretrained,
    table_to_device,
    tokenize_corpus_cached,
)


def calculate_pos_weight(dataset: FraudDataset, scale: float = 0.2) -> float:
    """neg/pos ratio times ``scale``, at least 1 (1 without positives)."""
    labels = np.asarray(dataset.labels, np.float32)
    pos = float(labels.sum())
    neg = float(len(labels) - pos)
    if pos == 0:
        return 1.0
    return max(1.0, (neg / pos) * scale)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--train_file", type=str, default="train.json")
    p.add_argument("--dev_file", type=str, default="val.json")
    p.add_argument("--test_file", type=str, default="test.json")
    p.add_argument("--meta_file", type=str, default="meta_data.json")
    p.add_argument("--item2id_file", type=str, default="smap.json")
    p.add_argument("--output_dir", type=str, default="checkpoints_fraud")
    p.add_argument("--pretrain_ckpt", type=str, default=None,
                   help="torch state dict to start from (cli.convert_ckpt's fraud.pt, a .bin)")
    p.add_argument("--hf_tokenizer", type=str, default=None,
                   help="local HF tokenizer dir (RoBERTa BPE); hash backend if absent")
    p.add_argument("--model_size", choices=["base", "tiny"], default="base")
    p.add_argument("--num_train_epochs", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--eval_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=5e-5)
    p.add_argument("--head_lr", type=float, default=None,
                   help="separate rate for the 3-layer MLP head (the encoder stays at "
                        "--learning_rate)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--patience", type=int, default=3)
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run from the rolling per-epoch "
                        "checkpoint under output_dir")
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
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--mirror_file", default=None,
                   help="append-only JSONL mirror of every epoch/test metric row, written "
                        "(fsync'd) as each is produced")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device; 'cuda' (default) raises without a GPU")
    return p.parse_args(argv)


def _no_confusion(metrics):
    return {k: v for k, v in metrics.items() if k != "confusion"}


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    splits = [read_json(os.path.join(args.data_path, f), as_int=True)
              for f in (args.train_file, args.dev_file, args.test_file)]
    meta = read_json(os.path.join(args.data_path, args.meta_file))
    item2id = read_json(os.path.join(args.data_path, args.item2id_file))

    max_items = max(len(v[0]) for v in splits[0].values())
    train_ds, val_ds, test_ds = (FraudDataset(s, max_items=max_items) for s in splits)
    pos_weight = calculate_pos_weight(train_ds)
    print(f"[fraud] pos_weight={pos_weight:.3f}")

    config = build_config(args, item_num=len(item2id)).replace(pos_weight=pos_weight)
    tokenizer = make_tokenizer(config, args.hf_tokenizer)
    name = os.path.basename(os.path.normpath(args.data_path))
    table = table_to_device(tokenize_corpus_cached(
        tokenizer, meta, item2id, os.path.join(args.data_path, "preprocess"), name), device)

    model = init_model_params(RecformerForFraudDetection(config), config, device)
    model = maybe_load_pretrained(model, args.pretrain_ckpt)
    steps_per_epoch = max(1, len(train_ds) // args.batch_size)
    optimizer = create_optimizer(
        model, learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=steps_per_epoch * args.num_train_epochs,
        head_lr=args.head_lr)
    step = make_fraud_train_step(config, model, optimizer)

    out = os.path.join(args.output_dir, name)
    resume_dir = os.path.join(out, "loop_state")
    loop_meta = os.path.join(resume_dir, "loop.json")
    # the optimizer's parameter groups depend on the recipe (head_lr splits
    # them): a state saved under another recipe must not be loaded into these
    recipe = {"learning_rate": args.learning_rate, "head_lr": args.head_lr}
    best_f1, best_params, patience = -1.0, None, args.patience
    epoch_metrics, start_epoch = [], 0
    if os.path.exists(loop_meta):
        if not args.resume:
            raise SystemExit(f"{resume_dir} holds an interrupted run; pass --resume to "
                             "continue it or remove the directory")
        with open(loop_meta) as f:
            saved = json.load(f)
        if saved.get("recipe") != recipe:
            raise SystemExit(
                f"{resume_dir} was saved with optimizer recipe {saved.get('recipe')} but "
                f"this run uses {recipe}; the optimizer states are incompatible — remove "
                "the loop_state directory to start fresh")
        restore_train_state(os.path.join(resume_dir, "state.pt"), model, optimizer)
        best_f1, patience = saved["best_f1"], saved["patience"]
        start_epoch, epoch_metrics = saved["epoch"] + 1, saved["epoch_metrics"]
        if os.path.exists(os.path.join(resume_dir, "best_params.pt")):
            best_params = {k: v.to(device) for k, v in restore_params(
                os.path.join(resume_dir, "best_params.pt")).items()}
        print(f"[fraud] resumed at epoch {start_epoch} "
              f"(best F1 {best_f1:.4f}, patience {patience})")

    for epoch in range(start_epoch, args.num_train_epochs):
        epoch_loss = train_fraud_epoch(step, args.seed, table, train_ds, args.batch_size,
                                       epoch, device)
        dev = evaluate_fraud(model, table, val_ds, config, args.eval_batch_size)
        print(f"[fraud] epoch {epoch} loss {epoch_loss:.4f} dev {dev}")
        epoch_metrics.append({"epoch": epoch, "loss": epoch_loss, **_no_confusion(dev)})
        append_jsonl(args.mirror_file, {"event": "dev", **epoch_metrics[-1]})
        improved = dev["f1"] > best_f1
        if improved:
            best_f1 = dev["f1"]
            best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
            patience = args.patience
        else:
            patience -= 1
        save_train_state(os.path.join(resume_dir, "state.pt"), model, optimizer)
        if improved:
            save_params(os.path.join(resume_dir, "best_params.pt"), best_params)
        with open(loop_meta, "w") as f:
            json.dump({"epoch": epoch, "best_f1": best_f1, "patience": patience,
                       "recipe": recipe, "epoch_metrics": epoch_metrics}, f, default=str)
        if patience == 0:
            break

    if best_params is not None:
        model.load_state_dict(best_params)
    test_metrics = evaluate_fraud(model, table, test_ds, config, args.eval_batch_size)
    print(f"[fraud] test {test_metrics}")
    append_jsonl(args.mirror_file, {"event": "test", **_no_confusion(test_metrics)})

    os.makedirs(out, exist_ok=True)
    save_params(os.path.join(out, "best_model.pt"), model)
    config.save(os.path.join(out, "config.json"))
    with open(os.path.join(out, "test_metrics.json"), "w") as f:
        json.dump(test_metrics, f, indent=2, default=str)
    with open(os.path.join(out, "epoch_metrics.json"), "w") as f:
        json.dump(epoch_metrics, f, indent=2)
    # the run completed: a later fresh launch must not be told to resume it
    shutil.rmtree(resume_dir, ignore_errors=True)
    return test_metrics


if __name__ == "__main__":
    main()
