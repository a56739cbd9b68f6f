"""Host-side orchestration: catalog encoding, ranked evaluation, the
two-stage seq-rec finetune and fraud evaluation.

Counterparts of ``encode_all_items``, ``evaluate_seqrec``,
``train_seqrec_epoch``, ``finetune_two_stage``,
``binary_classification_metrics``, ``roc_auc`` and ``evaluate_fraud`` in
``recformer_tpu/training/loops.py``; the fraud metrics are computed on the
host in numpy, as there. Each streams fixed-size batches
through the model on its device and keeps its results there; the host reads
once at the end (an epoch's loss: once per epoch).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import RecformerConfig
from ..data.datasets import EvalDataset, FraudDataset, SequenceDataset
from ..utils.logging import append_jsonl
from .checkpoint import restore_params, restore_train_state, save_params, save_train_state
from .steps import (
    make_encode_items_step,
    make_eval_step,
    make_finetune_step,
    make_fraud_eval_step,
)


def _model_device(model) -> torch.device:
    return next(model.parameters()).device


def params_fingerprint(model) -> str:
    """Cheap content fingerprint: float64 sums of the 8 largest parameters."""
    params = sorted((p for p in model.state_dict().values()), key=lambda p: -p.numel())[:8]
    return ",".join(f"{float(p.double().sum()):.6e}" for p in params)


def encode_all_items(model, table, config: RecformerConfig, batch_size: int = 256,
                     cache_path: Optional[str] = None) -> torch.Tensor:
    """Encode every catalog item as a one-item sequence and return the pooled
    ``(N, H)`` matrix on the model's device, in the compute type.

    Items go in chunks of ``batch_size`` (the tail chunk is padded with item
    0 and trimmed). ``cache_path``: optional ``.npz`` cache holding the
    embeddings with a fingerprint of the parameters; a changed model
    re-encodes."""
    n = int(table["lengths"].shape[0]) - 1
    dev = _model_device(model)
    if cache_path:
        fp = params_fingerprint(model)
        if os.path.exists(cache_path):
            with np.load(cache_path, allow_pickle=False) as data:
                if str(data["fingerprint"]) == fp and int(data["n_items"]) == n:
                    print(f"[encode] item-embedding cache hit: {cache_path}")
                    return torch.from_numpy(data["embeddings"]).to(
                        dev, getattr(torch, str(data["dtype"])))
        emb = encode_all_items(model, table, config, batch_size)
        os.makedirs(os.path.dirname(os.path.abspath(cache_path)), exist_ok=True)
        # stored as float32: npz has no bfloat16, and float32 holds bf16 exactly
        np.savez(cache_path, embeddings=emb.float().cpu().numpy(),
                 dtype=str(emb.dtype).removeprefix("torch."), fingerprint=fp, n_items=n)
        return emb
    step = make_encode_items_step(config, model)
    pad_to = -(-n // batch_size) * batch_size
    ids = torch.zeros(pad_to, dtype=torch.int32)
    ids[:n] = torch.arange(n, dtype=torch.int32)
    ids = ids.to(dev)
    out = None
    for c in range(0, pad_to, batch_size):
        pooled = step(table, ids[c:c + batch_size])
        if out is None:
            out = torch.empty((pad_to, pooled.shape[-1]), dtype=pooled.dtype, device=dev)
        out[c:c + batch_size] = pooled
    return out[:n]


def evaluate_seqrec(model, table, dataset: EvalDataset, item_embeddings,
                    config: RecformerConfig, batch_size: int = 32,
                    ks: Sequence[int] = (10, 50)) -> Dict[str, float]:
    """Full-catalog ranked evaluation; exact (sum / count) aggregation, with
    the sums kept on the device until the end."""
    step = make_eval_step(config, model, ks=ks)
    dev = _model_device(model)
    totals = None
    for batch in dataset.batches(batch_size):
        out = step(table, *(torch.from_numpy(a).to(dev) for a in (
            batch.item_ids, batch.seq_lens, batch.labels, batch.valid)), item_embeddings)
        totals = out if totals is None else {k: totals[k] + v for k, v in out.items()}
    if totals is None:
        return {}
    totals = {k: float(v) for k, v in totals.items()}
    count = totals.pop("count")
    return {k: v / max(count, 1.0) for k, v in totals.items()}


def train_seqrec_epoch(step, seed: int, table, dataset: SequenceDataset, item_embeddings,
                       batch_size: int, epoch: int) -> float:
    """One epoch of finetune steps over ``dataset`` shuffled with seed
    ``epoch`` (full batches only). Returns the mean step loss, read from the
    device once."""
    dev = item_embeddings.device
    losses = []
    for batch in dataset.batches(batch_size, shuffle=True, seed=epoch, drop_last=True):
        metrics = step(seed, table, torch.from_numpy(batch.item_ids).to(dev),
                       torch.from_numpy(batch.seq_lens).to(dev), item_embeddings)
        losses.append(metrics["loss"])
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().mean())


def finetune_two_stage(
    model,
    optimizer,
    table,
    config: RecformerConfig,
    train_dataset: SequenceDataset,
    val_dataset: EvalDataset,
    test_dataset: EvalDataset,
    *,
    num_epochs: int = 16,
    batch_size: int = 16,
    eval_batch_size: int = 32,
    encode_batch_size: int = 256,
    verbose: int = 3,
    seed: int = 42,
    encode_cache: Optional[str] = None,
    resume_dir: Optional[str] = None,
    mirror_path: Optional[str] = None,
    log: Callable = print,
) -> Tuple[object, torch.Tensor, Dict[str, float]]:
    """The reference two-stage schedule, as the JAX package runs it.

    Stage 1: every epoch re-encodes the catalog from the current encoder,
    then trains; every ``verbose`` epochs the dev split is ranked, NDCG@10
    selects, patience 5. Stage 2: the stage-1 best parameters come back
    with the catalog snapshotted beside them, that catalog stays frozen,
    patience 3 (the optimizer's state carries over, as the JAX TrainState's
    does). The test split is ranked against the selected parameters' own
    catalog, with no re-encode. Returns (model with the selected
    parameters, that catalog, test metrics).

    ``resume_dir``: after each epoch's update (and at the stage-1 -> 2
    switch, marked ``epoch = -1``) it receives ``loop.json`` (position,
    best NDCG@10, patience, catalog dtype), ``state.pt`` (the train
    state), ``best_params.pt`` and ``best_emb.npy`` (the best so far) and
    ``frozen_emb.npy`` (stage 2's catalog). A run that finds them continues
    from the first unfinished epoch, and draws what the uninterrupted run
    would have: shuffles are seeded by the epoch, a step's draws by
    ``(seed, micro-step)``.

    ``mirror_path``: an append-only JSONL that receives every dev row and
    the test row as they are produced (fsync'd)."""
    step = make_finetune_step(config, model, optimizer)
    dev = next(model.parameters()).device

    def encode(cache=None):
        return encode_all_items(model, table, config, encode_batch_size, cache_path=cache)

    def evaluate(dataset, item_embeddings):
        return evaluate_seqrec(model, table, dataset, item_embeddings, config, eval_batch_size)

    best_target = float("-inf")
    best_params = best_emb = None  # the catalog is snapshotted WITH the params
    item_embeddings = None
    start_stage, start_epoch, patience = 1, 0, 5
    loop_meta = os.path.join(resume_dir, "loop.json") if resume_dir else None
    if loop_meta and os.path.exists(loop_meta):
        with open(loop_meta) as f:
            meta = json.load(f)
        restore_train_state(os.path.join(resume_dir, "state.pt"), model, optimizer)
        best_target, patience = meta["best_target"], meta["patience"]
        start_stage, start_epoch = meta["stage"], meta["epoch"] + 1
        if os.path.exists(os.path.join(resume_dir, "best_params.pt")):
            best_params = {k: v.to(dev) for k, v in restore_params(
                os.path.join(resume_dir, "best_params.pt")).items()}
            best_emb = torch.from_numpy(np.load(os.path.join(resume_dir, "best_emb.npy"))).to(dev)
        if start_stage == 2:
            item_embeddings = torch.from_numpy(
                np.load(os.path.join(resume_dir, "frozen_emb.npy"))).to(
                dev, getattr(torch, meta["emb_dtype"]))
        log(f"[finetune] resumed at stage {start_stage} epoch {start_epoch} "
            f"(best NDCG@10 {best_target:.4f}, patience {patience})")

    def checkpoint(stage, epoch, improved):
        """The rolling checkpoint, written after the epoch's update (after
        the switch, for the stage-2 ``epoch = -1`` marker), so a resume
        restores exactly the position recorded."""
        if not resume_dir:
            return
        save_train_state(os.path.join(resume_dir, "state.pt"), model, optimizer)
        if improved:
            save_params(os.path.join(resume_dir, "best_params.pt"), best_params)
            np.save(os.path.join(resume_dir, "best_emb.npy"), best_emb.cpu().numpy())
        frozen = os.path.join(resume_dir, "frozen_emb.npy")
        if stage == 2 and not os.path.exists(frozen):  # saved once, at the switch
            np.save(frozen, item_embeddings.float().cpu().numpy())
        with open(loop_meta, "w") as f:
            json.dump({"stage": stage, "epoch": epoch, "best_target": best_target,
                       "patience": patience,
                       "emb_dtype": str(item_embeddings.dtype).removeprefix("torch.")}, f)

    def train_and_select(stage, epoch, shuffle_seed, reset_patience):
        """One epoch, then (every ``verbose`` epochs) the dev ranking;
        returns whether NDCG@10 improved."""
        nonlocal best_target, best_params, best_emb, patience
        loss = train_seqrec_epoch(step, seed, table, train_dataset, item_embeddings,
                                  batch_size, shuffle_seed)
        if (epoch + 1) % verbose:
            return False
        dev_metrics = evaluate(val_dataset, item_embeddings)
        log(f"[stage{stage}] epoch {epoch} loss {loss:.4f} dev {dev_metrics}")
        append_jsonl(mirror_path, {"event": "dev", "stage": stage, "epoch": epoch,
                                   "loss": loss, **dev_metrics})
        if dev_metrics["NDCG@10"] > best_target:
            best_target = dev_metrics["NDCG@10"]
            best_params = {k: v.detach().clone() for k, v in model.state_dict().items()}
            best_emb = item_embeddings.float().clone()
            patience = reset_patience
            return True
        patience -= 1
        return False

    if start_stage == 1:
        if start_epoch == 0:
            # the initial encode is the one cached between launches; the
            # per-epoch re-encodes see fresh parameters every time
            item_embeddings = encode(cache=encode_cache)
        for epoch in range(start_epoch, num_epochs):
            item_embeddings = encode()
            improved = train_and_select(1, epoch, epoch, 5)
            checkpoint(1, epoch, improved)
            if patience == 0:
                break
        if best_params is not None:
            model.load_state_dict(best_params)
            item_embeddings = best_emb
        elif item_embeddings is None:  # resumed after the last stage-1 epoch
            item_embeddings = encode()
        # stage 2 keeps this catalog frozen through training, selection, test
        patience, start_epoch = 3, 0
        checkpoint(2, -1, improved=False)

    for epoch in range(start_epoch, num_epochs):
        improved = train_and_select(2, epoch, num_epochs + epoch, 3)
        checkpoint(2, epoch, improved)
        if patience == 0:
            break

    if best_params is not None:
        model.load_state_dict(best_params)
        item_embeddings = best_emb
    # no re-encode: the test ranks against the catalog the selected
    # parameters were trained with
    test_metrics = evaluate(test_dataset, item_embeddings)
    append_jsonl(mirror_path, {"event": "test", **test_metrics})
    return model, item_embeddings, test_metrics


# ---------------------------------------------------------------------------
# fraud classification
# ---------------------------------------------------------------------------

def train_fraud_epoch(step, seed: int, table, dataset: FraudDataset, batch_size: int,
                      epoch: int, device) -> float:
    """One epoch of fraud steps over ``dataset`` shuffled with seed
    ``epoch``; the last batch is padded with invalid rows. Returns the mean
    step loss, read from the device once."""
    losses = []
    for batch in dataset.batches(batch_size, shuffle=True, seed=epoch):
        metrics = step(seed, table, *(torch.from_numpy(a).to(device) for a in (
            batch.item_ids, batch.seq_lens, batch.labels, batch.valid)))
        losses.append(metrics["loss"])
    if not losses:
        return 0.0
    return float(torch.stack(losses).double().mean())


def binary_classification_metrics(probs: np.ndarray, labels: np.ndarray,
                                  threshold: float) -> Dict:
    preds = (probs >= threshold).astype(np.int64)
    y = labels.astype(np.int64)
    tp = int(((preds == 1) & (y == 1)).sum())
    tn = int(((preds == 0) & (y == 0)).sum())
    fp = int(((preds == 1) & (y == 0)).sum())
    fn = int(((preds == 0) & (y == 1)).sum())
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-12)
    acc = (tp + tn) / max(len(y), 1)
    tpr = tp / max(tp + fn, 1)
    tnr = tn / max(tn + fp, 1)
    return {
        "accuracy": acc,
        "balanced_accuracy": 0.5 * (tpr + tnr),
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "threshold": threshold,
        "confusion": {"tp": tp, "tn": tn, "fp": fp, "fn": fn},
    }


def roc_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """Rank-based ROC AUC (Mann-Whitney U), ties averaged; 0.5 when a class
    is missing."""
    y = labels.astype(bool)
    n_pos, n_neg = int(y.sum()), int((~y).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    order = np.argsort(probs, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    sorted_p = probs[order]
    i = 0
    r = 1
    while i < len(sorted_p):
        j = i
        while j + 1 < len(sorted_p) and sorted_p[j + 1] == sorted_p[i]:
            j += 1
        ranks[order[i: j + 1]] = (r + r + (j - i)) / 2.0
        r += j - i + 1
        i = j + 1
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def fraud_probabilities(model, table, dataset: FraudDataset, config: RecformerConfig,
                        batch_size: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """The fraud probability and label of every valid row of ``dataset``,
    in its order; the probabilities stay on the device until the end."""
    step = make_fraud_eval_step(config, model)
    dev = _model_device(model)
    probs, labels, valid = [], [], []
    for batch in dataset.batches(batch_size):
        probs.append(step(table, torch.from_numpy(batch.item_ids).to(dev),
                          torch.from_numpy(batch.seq_lens).to(dev)))
        labels.append(batch.labels)
        valid.append(batch.valid)
    if not probs:
        return np.zeros(0, np.float32), np.zeros(0, np.float32)
    keep = np.concatenate(valid)
    return torch.cat(probs).cpu().numpy()[keep], np.concatenate(labels)[keep]


def evaluate_fraud(model, table, dataset: FraudDataset, config: RecformerConfig,
                   batch_size: int = 32,
                   thresholds: Sequence[float] = tuple(np.arange(0.1, 0.91, 0.1))) -> Dict:
    """The threshold sweep: the metrics at the first threshold with the
    highest F1, plus the ROC AUC over the valid rows."""
    probs, labels = fraud_probabilities(model, table, dataset, config, batch_size)
    best = None
    for t in thresholds:
        m = binary_classification_metrics(probs, labels, float(t))
        if best is None or m["f1"] > best["f1"]:
            best = m
    best["auc"] = roc_auc(probs, labels)
    return best
