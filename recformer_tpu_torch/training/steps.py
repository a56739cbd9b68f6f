"""Serving steps: ranked evaluation and item encoding.

Counterparts of ``make_eval_step`` and ``make_encode_items_step`` in
``recformer_tpu/training/steps.py``, as plain functions over a model that
holds its parameters. Sequence assembly runs on the model's device inside
the step; the host ships item-id arrays only.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..config import RecformerConfig
from ..data.device_pipeline import assemble_for_config
from ..models.heads import similarity_scores
from .metrics import MAX_VAL, rank_from_scores


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
