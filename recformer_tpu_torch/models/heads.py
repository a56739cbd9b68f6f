"""Serving head: sequence encoder and catalog scoring.

Counterparts of ``cosine_similarity``, ``similarity_scores`` and
``RecformerForSeqRec`` in ``recformer_tpu/models/heads.py``. The item
catalog is not a parameter: the item-encoding service produces it and
scoring takes it as an argument. The pretraining and fraud heads come with
their slices.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ..config import RecformerConfig
from .recformer import RecformerModel


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, dim: int = -1, eps: float = 1e-8):
    """Cosine similarity with ``torch.nn.CosineSimilarity``'s eps clamp on
    each norm."""
    xn = torch.linalg.norm(x, dim=dim, keepdim=True).clamp_min(eps)
    yn = torch.linalg.norm(y, dim=dim, keepdim=True).clamp_min(eps)
    return ((x / xn) * (y / yn)).sum(dim=dim)


def similarity_scores(pooled: torch.Tensor, item_embeddings: torch.Tensor, temp: float):
    """Cosine/temp scores of ``(B, H)`` sequence embeddings against an
    ``(N, H)`` catalog, or ``(B, C, H)`` per-example candidates."""
    p = pooled / torch.linalg.norm(pooled, dim=-1, keepdim=True).clamp_min(1e-8)
    e = item_embeddings / torch.linalg.norm(item_embeddings, dim=-1, keepdim=True).clamp_min(1e-8)
    if item_embeddings.dim() == 2:  # full catalog
        scores = torch.einsum("bh,nh->bn", p.float(), e.float())
    else:  # per-example candidates
        scores = torch.einsum("bh,bch->bc", p.float(), e.float())
    return scores / temp


class RecformerForSeqRec(nn.Module):
    """Sequence encoder for serving; returns the pooled ``(B, H)`` output."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.longformer = RecformerModel(config)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True) -> torch.Tensor:
        _, pooled = self.longformer(
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            global_attention_mask=batch["global_attention_mask"],
            token_type_ids=batch["token_type_ids"],
            item_position_ids=batch["item_position_ids"],
            deterministic=deterministic,
        )
        return pooled
