"""Task heads: pretraining (contrastive + MLM), the sequence encoder and
fraud detection.

Counterparts of ``cosine_similarity``, ``similarity_scores``,
``MLMTransform``, ``RecformerForPretraining``, ``RecformerForSeqRec`` and
``RecformerForFraudDetection`` in ``recformer_tpu/models/heads.py``. The
item catalog is not a parameter: the item-encoding service produces it and
scoring takes it as an argument. The MLM head evaluates logits only at
gathered masked positions, through a decoder tied to the word embeddings.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RecformerConfig
from ..utils.profiling import spanned
from ..utils.rng import dropout
from .encoder import activation, block_layernorm, dense
from .modernbert import ModernBertPredictionHead, backbone_model

# the fraud MLP's dropout rate: a constant of the JAX head, not a config field
FRAUD_MLP_DROPOUT = 0.2


def cosine_similarity(x: torch.Tensor, y: torch.Tensor, dim: int = -1, eps: float = 1e-8):
    """Cosine similarity with ``torch.nn.CosineSimilarity``'s eps clamp on
    each norm."""
    xn = torch.linalg.norm(x, dim=dim, keepdim=True).clamp_min(eps)
    yn = torch.linalg.norm(y, dim=dim, keepdim=True).clamp_min(eps)
    return ((x / xn) * (y / yn)).sum(dim=dim)


@spanned("score")
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
        self.longformer = backbone_model(config)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                rng=None) -> torch.Tensor:
        _, pooled = self.longformer(
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            global_attention_mask=batch["global_attention_mask"],
            token_type_ids=batch["token_type_ids"],
            item_position_ids=batch["item_position_ids"],
            deterministic=deterministic,
            rng=rng,
        )
        return pooled


class RecformerForFraudDetection(nn.Module):
    """Backbone -> dropout(``hidden_dropout_prob``) -> a 3-layer MLP
    (H -> H/2 -> H/4 -> 1, ReLU, dropout 0.2 after each hidden layer) -> a
    scalar logit per row. The dense layers run in the compute type, as flax
    ``Dense(dtype=compute_dtype)`` does; every dropout draws from the step's
    ``rng``."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.longformer = backbone_model(config)
        h, pd = config.hidden_size, config.params_dtype
        self.fc1 = nn.Linear(h, h // 2, dtype=pd)
        self.fc2 = nn.Linear(h // 2, h // 4, dtype=pd)
        self.fc3 = nn.Linear(h // 4, 1, dtype=pd)

    def forward(self, batch: Dict[str, torch.Tensor], deterministic: bool = True,
                rng=None) -> torch.Tensor:
        _, pooled = self.longformer(
            input_ids=batch["input_ids"],
            attention_mask=batch["attention_mask"],
            global_attention_mask=batch["global_attention_mask"],
            token_type_ids=batch["token_type_ids"],
            item_position_ids=batch["item_position_ids"],
            deterministic=deterministic,
            rng=rng,
        )
        rng = None if deterministic else rng
        dt = self.config.compute_dtype
        x = dropout(pooled, self.config.hidden_dropout_prob, rng)
        x = dropout(F.relu(dense(x, self.fc1, dt)), FRAUD_MLP_DROPOUT, rng)
        x = dropout(F.relu(dense(x, self.fc2, dt)), FRAUD_MLP_DROPOUT, rng)
        return dense(x, self.fc3, dt)[..., 0]


class MLMTransform(nn.Module):
    """LM head transform (dense -> activation -> LayerNorm) and the tied
    decoder's bias, with HF ``LongformerLMHead``'s parameter names. Its
    LayerNorm is flax's under every ``ln_impl``, as in the JAX package."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        hs = config.hidden_size
        self.dense = nn.Linear(hs, hs, dtype=config.params_dtype)
        self.layer_norm = nn.LayerNorm(hs, eps=config.layer_norm_eps, dtype=config.params_dtype)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size, dtype=config.params_dtype))
        self.act = activation(config.hidden_act)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype
        return block_layernorm(self.act(dense(hidden, self.dense, dt)), self.layer_norm, dt)


class PretrainForwardOutput(NamedTuple):
    z1: torch.Tensor  # (B, H) pooled sequence-view embeddings
    z2: torch.Tensor  # (B, H) pooled item-view embeddings
    mlm_logits_a: Optional[torch.Tensor]  # (B, P_a, vocab) at masked positions
    mlm_logits_b: Optional[torch.Tensor]  # (B, P_b, vocab)


class DecoderBias(nn.Module):
    """The bias of ModernBERT's tied decoder (``decoder.bias``); the
    decoder's weight is the word table."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(config.vocab_size, dtype=config.params_dtype))


class RecformerForPretraining(nn.Module):
    """Dual-tower forward with MLM towers; the item view (single target
    item) runs at ``config.item_seq_len``. With ``fuse_mlm_pass`` a view's
    clean and MLM-corrupted inputs run as one ``(2B, L)`` forward. The MLM
    head is Longformer's ``lm_head`` or, under the modernbert backbone,
    ModernBERT's ``head`` and ``decoder`` (the decoder's bias)."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.longformer = backbone_model(config)
        if config.backbone == "modernbert":
            self.head = ModernBertPredictionHead(config)
            self.decoder = DecoderBias(config)
        else:
            self.lm_head = MLMTransform(config)

    def _backbone(self, input_ids, batch, deterministic, rng, dup: bool = False):
        def d(x):
            return torch.cat([x, x], dim=0) if dup else x

        return self.longformer(
            input_ids=input_ids,
            attention_mask=d(batch["attention_mask"]),
            global_attention_mask=d(batch["global_attention_mask"]),
            token_type_ids=d(batch["token_type_ids"]),
            item_position_ids=d(batch["item_position_ids"]),
            deterministic=deterministic, rng=rng)

    def encode(self, batch: Dict[str, torch.Tensor], deterministic: bool = True, rng=None):
        return self._backbone(batch["input_ids"], batch, deterministic, rng)[1]

    def _logits(self, hidden: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Logits at ``positions``: the transform, then the decoder tied to
        the word embeddings in the compute type, plus a float32 bias."""
        dt = self.config.compute_dtype
        gathered = torch.gather(hidden, 1, positions.long()[:, :, None].expand(
            -1, -1, hidden.shape[-1]))  # (B, P, H)
        w = self.longformer.embeddings.word_embeddings.weight.to(dt)
        if self.config.backbone == "modernbert":
            return (self.head(gathered).to(dt) @ w.t()).float() + self.decoder.bias.float()
        h = self.lm_head(gathered)
        return (h.to(dt) @ w.t()).float() + self.lm_head.bias.float()

    def mlm_logits(self, mlm_input_ids, batch, mlm_positions, deterministic: bool = True,
                   rng=None) -> torch.Tensor:
        """Encoder pass on corrupted ids; logits only at ``mlm_positions``."""
        hidden, _ = self._backbone(mlm_input_ids, batch, deterministic, rng)
        return self._logits(hidden, mlm_positions)

    def _tower(self, batch: Dict[str, torch.Tensor], deterministic: bool, rng):
        """One view's clean and MLM-corrupted passes: one ``(2B, L)`` forward
        when ``fuse_mlm_pass``, else two."""
        if "mlm_input_ids" not in batch:
            return self.encode(batch, deterministic, rng), None
        if not self.config.fuse_mlm_pass:
            z = self.encode(batch, deterministic, rng)
            return z, self.mlm_logits(batch["mlm_input_ids"], batch, batch["mlm_positions"],
                                      deterministic, rng)
        ids2 = torch.cat([batch["input_ids"], batch["mlm_input_ids"]], dim=0)
        hidden, pooled = self._backbone(ids2, batch, deterministic, rng, dup=True)
        B = batch["input_ids"].shape[0]
        return pooled[:B], self._logits(hidden[B:], batch["mlm_positions"])

    def forward(self, batch_a, batch_b, deterministic: bool = True,
                rng=None) -> PretrainForwardOutput:
        z1, mlm_a = self._tower(batch_a, deterministic, rng)
        z2, mlm_b = self._tower(batch_b, deterministic, rng)
        return PretrainForwardOutput(z1, z2, mlm_a, mlm_b)
