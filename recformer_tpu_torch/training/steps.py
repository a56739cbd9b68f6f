"""Training and serving steps: pretraining, seq-rec finetuning, ranked
evaluation, item encoding, fraud classification.

Counterparts of ``make_pretrain_step``, ``make_pretrain_eval_step``,
``make_finetune_step``, ``make_eval_step``, ``make_encode_items_step``,
``make_fraud_train_step`` and ``make_fraud_eval_step`` in
``recformer_tpu/training/steps.py``, single device, as plain functions over a
model that holds its parameters. Batch construction runs on the model's
device inside the step; the host ships item-id arrays only. Metrics come
back as device tensors, so a step never waits on the host: the caller
converts them when it logs.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

from ..config import RecformerConfig
from ..data.device_pipeline import assemble_for_config, make_finetune_batch, make_pretrain_batch
from ..models.heads import similarity_scores
from ..utils.rng import StepRNG, fold_in
from . import losses
from .metrics import MAX_VAL, rank_from_scores


def pretrain_loss(config: RecformerConfig, out, batch_a, batch_b):
    """InfoNCE over the batch plus ``mlm_weight`` times the MLM loss of each
    view. Returns (loss, metrics)."""
    cl_loss, correct, total = losses.info_nce_loss(out.z1, out.z2, config.temp)
    loss = cl_loss
    metrics = {"cl_loss": cl_loss, "cl_correct": correct, "cl_total": total}
    if out.mlm_logits_a is not None:
        mlm_a = losses.mlm_loss(out.mlm_logits_a, batch_a["mlm_labels"])
        loss = loss + config.mlm_weight * mlm_a
        metrics["mlm_loss_a"] = mlm_a
    if out.mlm_logits_b is not None:
        mlm_b = losses.mlm_loss(out.mlm_logits_b, batch_b["mlm_labels"])
        loss = loss + config.mlm_weight * mlm_b
        metrics["mlm_loss_b"] = mlm_b
    metrics["loss"] = loss
    metrics["accuracy"] = correct / total.clamp_min(1e-5)
    return loss, metrics


def make_pretrain_step(config: RecformerConfig, model, optimizer):
    """step(rng, table, item_ids, seq_lens) -> metrics: device-side pair
    sampling and MLM, the two towers with dropout, the loss, its backward and
    one optimizer micro-step. ``rng`` is a
    :class:`~recformer_tpu_torch.utils.rng.StepRNG`."""

    def step(rng, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        batch_a, batch_b = make_pretrain_batch(rng.device, table, item_ids, seq_lens, config)
        out = model(batch_a, batch_b, deterministic=False, rng=rng)
        loss, metrics = pretrain_loss(config, out, batch_a, batch_b)
        loss.backward()
        optimizer.step()
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_pretrain_eval_step(config: RecformerConfig, model):
    """step(generator, table, item_ids, seq_lens) -> {val_loss, cl_correct,
    cl_total}: the batch drawn from ``generator``, a deterministic forward."""

    @torch.no_grad()
    def step(generator, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        batch_a, batch_b = make_pretrain_batch(generator, table, item_ids, seq_lens, config)
        out = model(batch_a, batch_b, deterministic=True)
        loss, metrics = pretrain_loss(config, out, batch_a, batch_b)
        return {"val_loss": loss, "cl_correct": metrics["cl_correct"],
                "cl_total": metrics["cl_total"]}

    return step


def finetune_loss(config: RecformerConfig, pooled, item_embeddings, labels, generator):
    """Sampled softmax over ``finetune_negative_sample_size`` negatives drawn
    from ``generator`` when that size is positive, else the full softmax
    over the catalog."""
    if config.finetune_negative_sample_size > 0:
        return losses.seqrec_sampled_softmax_loss(
            pooled, item_embeddings, labels, config.temp,
            config.finetune_negative_sample_size, generator)
    return losses.seqrec_full_softmax_loss(pooled, item_embeddings, labels, config.temp)


def make_finetune_step(config: RecformerConfig, model, optimizer):
    """step(seed, table, item_ids, seq_lens, item_embeddings) -> {loss}: a
    target per row over the whole sequence, the prefix batch on the device,
    the sequence tower with dropout, the loss against the frozen catalog
    ``item_embeddings``, its backward and one optimizer micro-step.

    Every draw of the step (targets, dropout, negatives) comes from a
    :class:`StepRNG` seeded with ``fold_in(seed, micro-step)``, as JAX folds
    ``state.step`` into its key: a run resumed from a saved train state
    draws what the uninterrupted run drew."""

    def step(seed, table, item_ids, seq_lens, item_embeddings) -> Dict[str, torch.Tensor]:
        rng = StepRNG(fold_in(seed, optimizer.micro_steps), item_ids.device)
        batch, labels = make_finetune_batch(rng.device, table, item_ids, seq_lens, config)
        pooled = model(batch, deterministic=False, rng=rng)
        loss = finetune_loss(config, pooled, item_embeddings, labels, rng.device)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_eval_step(config: RecformerConfig, model, ks: Sequence[int] = (10, 50)):
    """step(table, item_ids, seq_lens, labels, valid, item_embeddings) ->
    per-metric *sums* over valid rows plus the valid ``count``: encode the
    history, score it against every item, rank the label."""
    ks = tuple(ks)

    @torch.inference_mode()
    def step(table, item_ids, seq_lens, labels, valid, item_embeddings):
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        pooled = model(batch)
        scores = similarity_scores(pooled.float(), item_embeddings.float(), config.temp)
        w = valid.float()
        rank = rank_from_scores(scores, labels)
        valid_length = (scores > -MAX_VAL).float().sum(dim=-1)
        out = {}
        for k in ks:
            ind = (rank < k).float()
            out[f"NDCG@{k}"] = (w * ind / torch.log2(rank + 2.0)).sum()
            out[f"Recall@{k}"] = (w * ind).sum()
        out["MRR"] = (w / (rank + 1.0)).sum()
        out["AUC"] = (w * (1.0 - rank / valid_length.clamp_min(1.0))).sum()
        out["count"] = w.sum()
        return out

    return step


def make_encode_items_step(config: RecformerConfig, model):
    """step(table, item_id_chunk) -> pooled ``(C, H)``: each item is a
    one-item sequence at the short static ``item_seq_len``."""

    @torch.inference_mode()
    def step(table, item_id_chunk):
        ids = item_id_chunk[:, None]
        lens = torch.ones_like(item_id_chunk)
        batch = assemble_for_config(table, ids, lens, config, out_len=config.item_seq_len)
        return model(batch)

    return step


def fraud_loss(config: RecformerConfig, logits, labels, valid) -> torch.Tensor:
    """BCE with ``config.pos_weight`` over the valid rows: the weighted sum
    over ``max(sum(valid), 1)``."""
    w = valid.float()
    per = losses.bce_with_logits_terms(logits, labels, config.pos_weight)
    return (per * w).sum() / w.sum().clamp_min(1.0)


def make_fraud_train_step(config: RecformerConfig, model, optimizer):
    """step(seed, table, item_ids, seq_lens, labels, valid) -> {loss}: the
    batch on the device, the fraud model with dropout (the backbone's and
    the head's), :func:`fraud_loss`, its backward and one optimizer
    micro-step. The draws come from ``fold_in(seed, micro-step)``, as in
    :func:`make_finetune_step`."""

    def step(seed, table, item_ids, seq_lens, labels, valid) -> Dict[str, torch.Tensor]:
        rng = StepRNG(fold_in(seed, optimizer.micro_steps), item_ids.device)
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        loss = fraud_loss(config, model(batch, deterministic=False, rng=rng), labels, valid)
        loss.backward()
        optimizer.step()
        return {"loss": loss.detach()}

    return step


def make_fraud_eval_step(config: RecformerConfig, model):
    """step(table, item_ids, seq_lens) -> the float32 fraud probability of
    each row (a deterministic forward)."""

    @torch.inference_mode()
    def step(table, item_ids, seq_lens):
        batch = assemble_for_config(table, item_ids, seq_lens, config)
        return torch.sigmoid(model(batch).float())

    return step
