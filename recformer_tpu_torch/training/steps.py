"""Training and serving steps: pretraining, seq-rec finetuning, ranked
evaluation, item encoding, fraud classification.

Counterparts of ``make_pretrain_step``, ``make_pretrain_eval_step``,
``make_finetune_step``, ``make_eval_step``, ``make_encode_items_step``,
``make_fraud_train_step`` and ``make_fraud_eval_step`` in
``recformer_tpu/training/steps.py``, as plain functions over a model that
holds its parameters. Batch construction runs on the model's device inside
the step; the host ships item-id arrays only. Metrics come back as device
tensors, so a step never waits on the host: the caller converts them when
it logs.

Given a mesh (``parallel/mesh.py``; one process per rank), the pretraining
and finetune steps run data-parallel over its ``data_group``, each rank
handed the same global batch of item ids:

- ``contrastive_gradient='full'`` (the JAX package's GSPMD step): every
  rank draws the global batch's pairs and MLM masks (finetune: targets and
  negatives) from the step's seed and keeps its data rank's rows, so a
  step equals the one-device step on the global batch given the same
  draws; each rank's dropout comes from ``fold_in(seed, data_rank)``. The
  contrastive negatives are all-gathered, each rank backpropagates its
  share of the global loss (the replicated contrastive term over the data
  size, its MLM terms over the global count of valid positions) and the
  gradients are summed over the data group;
- ``'local'`` (the JAX package's ``_local_grad_pretrain_step``, the
  reference's DDP): each rank draws from ``fold_in(seed, data_rank)`` for
  its own rows, the remote contrastive rows are detached, and the
  gradients and metrics are averaged over the data group.

Under tensor parallelism the model's sharded modules run their own
collectives over the ``model_group``; the finetune step scores against a
catalog row-sharded over it (``parallel/catalog.py``).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.distributed as dist

from ..config import RecformerConfig
from ..data.device_pipeline import assemble_for_config, make_finetune_batch, make_pretrain_batch
from ..models.heads import similarity_scores
from ..parallel.catalog import sharded_full_softmax_loss, sharded_take
from ..parallel.collectives import all_reduce_, psum
from ..utils.rng import StepRNG, fold_in
from . import losses
from .metrics import MAX_VAL, rank_from_scores


def pretrain_loss(config: RecformerConfig, out, batch_a, batch_b, group=None,
                  grad_mode: str = "full"):
    """InfoNCE over the batch plus ``mlm_weight`` times the MLM loss of each
    view. Returns (loss, metrics).

    With a data ``group``: the contrastive batch is gathered from every rank
    (``grad_mode`` as in ``losses.gather_embeddings``). In ``'full'`` mode
    the returned loss is this rank's share of the global loss, whose sum
    over the group is the one-device loss of the whole batch (the
    contrastive term, the same on every rank, over the group's size; the
    MLM means over the group's valid positions), and the metrics are the
    global values; in ``'local'`` mode both are this rank's."""
    cl_loss, correct, total = losses.info_nce_loss(out.z1, out.z2, config.temp, group,
                                                   grad_mode)
    mlm_group = group if grad_mode == "full" else None
    loss = cl_loss if mlm_group is None else cl_loss / dist.get_world_size(group)
    metrics = {"cl_loss": cl_loss, "cl_correct": correct, "cl_total": total}
    mlm_total = 0.0
    for view, logits, batch in (("a", out.mlm_logits_a, batch_a), ("b", out.mlm_logits_b, batch_b)):
        if logits is None:
            continue
        mlm = losses.mlm_loss(logits, batch["mlm_labels"], mlm_group)
        loss = loss + config.mlm_weight * mlm
        if mlm_group is not None:
            mlm = psum(mlm.detach(), mlm_group)
        metrics[f"mlm_loss_{view}"] = mlm
        mlm_total = mlm_total + config.mlm_weight * mlm
    metrics["loss"] = cl_loss + mlm_total if mlm_group is not None else loss
    metrics["accuracy"] = correct / total.clamp_min(1e-5)
    return loss, metrics


def take_rows(x, mesh):
    """This data rank's rows of a global batch (a tensor or a dict of
    them)."""
    if isinstance(x, dict):
        return {k: take_rows(v, mesh) for k, v in x.items()}
    if x.shape[0] % mesh.n_data:
        raise ValueError(f"global batch {x.shape[0]} not divisible by data size {mesh.n_data}")
    b = x.shape[0] // mesh.n_data
    return x[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def _trained(model):
    """Every trained parameter's gradient (zeros where backward left none),
    in a fixed order, as the gradient reduction needs them on every rank."""
    grads = []
    for p in model.parameters():
        if p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            grads.append(p.grad)
    return grads


def pretrain_backward(config: RecformerConfig, model, batch_a, batch_b, rng, mesh=None):
    """The towers with dropout from ``rng`` on this rank's batch, the loss
    and its backward; under a mesh, the gradients reduced over the data
    group (summed in ``'full'`` mode, averaged in ``'local'``). Returns the
    detached metrics."""
    out = model(batch_a, batch_b, deterministic=False, rng=rng)
    if mesh is None:
        loss, metrics = pretrain_loss(config, out, batch_a, batch_b)
        loss.backward()
        return {k: v.detach() for k, v in metrics.items()}
    mode = config.contrastive_gradient
    loss, metrics = pretrain_loss(config, out, batch_a, batch_b, mesh.data_group, mode)
    loss.backward()
    all_reduce_(_trained(model), mesh.data_group, mean=(mode == "local"))
    metrics = {k: v.detach() for k, v in metrics.items()}
    if mode == "local":
        # the counts are over the gathered batch already: the same on every rank
        metrics = {k: v if k in ("cl_correct", "cl_total")
                   else psum(v, mesh.data_group) / mesh.n_data for k, v in metrics.items()}
    return metrics


def make_pretrain_step(config: RecformerConfig, model, optimizer, mesh=None):
    """step(rng, table, item_ids, seq_lens) -> metrics: device-side pair
    sampling and MLM, the two towers with dropout, the loss, its backward and
    one optimizer micro-step. ``rng`` is a
    :class:`~recformer_tpu_torch.utils.rng.StepRNG`. Under a mesh the ids
    are the global batch's, and ``rng.seed`` is the step's seed (see the
    module's docstring for the two modes)."""

    def step(rng, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        if mesh is None:
            batch_a, batch_b = make_pretrain_batch(rng.device, table, item_ids, seq_lens, config)
            drop = rng
        elif config.contrastive_gradient == "full":
            batch_a, batch_b = (take_rows(b, mesh) for b in make_pretrain_batch(
                rng.device, table, item_ids, seq_lens, config))
            drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
        else:
            drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
            batch_a, batch_b = make_pretrain_batch(drop.device, table, take_rows(item_ids, mesh),
                                                   take_rows(seq_lens, mesh), config)
        metrics = pretrain_backward(config, model, batch_a, batch_b, drop, mesh)
        optimizer.step()
        return metrics

    return step


def make_pretrain_eval_step(config: RecformerConfig, model, mesh=None):
    """step(generator, table, item_ids, seq_lens) -> {val_loss, cl_correct,
    cl_total}: the batch drawn from ``generator``, a deterministic forward.
    Under a mesh the ids are the global batch's, every rank draws the same
    pairs and masks and keeps its data rank's rows, and the contrastive
    negatives are gathered over the data group: the values are the
    one-device ones on the global batch."""

    @torch.no_grad()
    def step(generator, table, item_ids, seq_lens) -> Dict[str, torch.Tensor]:
        batch_a, batch_b = make_pretrain_batch(generator, table, item_ids, seq_lens, config)
        group = None
        if mesh is not None:
            batch_a, batch_b = take_rows(batch_a, mesh), take_rows(batch_b, mesh)
            group = mesh.data_group
        out = model(batch_a, batch_b, deterministic=True)
        _, metrics = pretrain_loss(config, out, batch_a, batch_b, group)
        return {"val_loss": metrics["loss"], "cl_correct": metrics["cl_correct"],
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


def make_finetune_step(config: RecformerConfig, model, optimizer, mesh=None,
                       n_items: int | None = None):
    """step(seed, table, item_ids, seq_lens, item_embeddings) -> {loss}: a
    target per row over the whole sequence, the prefix batch on the device,
    the sequence tower with dropout, the loss against the frozen catalog
    ``item_embeddings``, its backward and one optimizer micro-step.

    Every draw of the step (targets, dropout, negatives) comes from a
    :class:`StepRNG` seeded with ``fold_in(seed, micro-step)``, as JAX folds
    ``state.step`` into its key: a run resumed from a saved train state
    draws what the uninterrupted run drew.

    Under a mesh: the ids are the global batch's, ``item_embeddings`` is
    this rank's rows of the ``n_items``-row catalog, row-sharded over the
    model group (``parallel.catalog.shard_rows``). The targets and negatives
    are drawn for the global batch (in the one-device order) and the rank
    keeps its rows; the dropout comes from ``fold_in(seed', data_rank)``;
    the full softmax runs through ``sharded_full_softmax_loss``, the sampled
    one over candidate rows fetched with ``sharded_take``; the gradients of
    each rank's share of the mean are summed over the data group."""

    def step(seed, table, item_ids, seq_lens, item_embeddings) -> Dict[str, torch.Tensor]:
        rng = StepRNG(fold_in(seed, optimizer.micro_steps), item_ids.device)
        batch, labels = make_finetune_batch(rng.device, table, item_ids, seq_lens, config)
        if mesh is None:
            pooled = model(batch, deterministic=False, rng=rng)
            loss = finetune_loss(config, pooled, item_embeddings, labels, rng.device)
            loss.backward()
            optimizer.step()
            return {"loss": loss.detach()}
        n_neg = config.finetune_negative_sample_size
        negatives = None
        if n_neg > 0:
            negatives = take_rows(torch.randint(0, n_items, (labels.shape[0], n_neg),
                                                generator=rng.device, device=labels.device), mesh)
        batch, labels = take_rows(batch, mesh), take_rows(labels, mesh)
        drop = StepRNG(fold_in(rng.seed, mesh.data_rank), item_ids.device)
        pooled = model(batch, deterministic=False, rng=drop)
        if negatives is None:
            loss = sharded_full_softmax_loss(pooled, item_embeddings, labels, config.temp,
                                             n_items, mesh.model_group)
        else:
            candidates = torch.cat([labels.long()[:, None], negatives.long()], dim=1)
            loss = losses.sampled_softmax_from_candidates(
                pooled, sharded_take(item_embeddings, candidates, mesh.model_group), config.temp)
        (loss / mesh.n_data).backward()
        all_reduce_(_trained(model), mesh.data_group)
        optimizer.step()
        return {"loss": psum(loss.detach(), mesh.data_group) / mesh.n_data}

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
        return rank_sums(rank_from_scores(scores, labels),
                         (scores > -MAX_VAL).float().sum(dim=-1), valid, ks)

    return step


def rank_sums(rank, valid_length, valid, ks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """NDCG@k, Recall@k, MRR and AUC summed over the ``valid`` rows, and
    their ``count``, from each row's rank and count of valid candidates."""
    w = valid.float()
    out = {}
    for k in ks:
        ind = (rank < k).float()
        out[f"NDCG@{k}"] = (w * ind / torch.log2(rank + 2.0)).sum()
        out[f"Recall@{k}"] = (w * ind).sum()
    out["MRR"] = (w / (rank + 1.0)).sum()
    out["AUC"] = (w * (1.0 - rank / valid_length.clamp_min(1.0))).sum()
    out["count"] = w.sum()
    return out


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
