"""Recformer backbone: embeddings -> Longformer encoder -> pooler.

Counterpart of ``recformer_tpu/models/recformer.py``. Batches are padded to
a static length that is a multiple of the attention window; the {0,1} x
{0,1} masks merge into {0 none, 1 local, 2 global}.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import RecformerConfig
from .embeddings import RecformerEmbeddings
from .encoder import LongformerEncoder


def merge_attention_masks(attention_mask: torch.Tensor, global_attention_mask: torch.Tensor):
    """{0,1} local mask x {0,1} global mask -> {0 none, 1 local, 2 global}."""
    return attention_mask * (global_attention_mask + 1)


class RecformerPooler(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.pooler_type = config.pooler_type

    def forward(self, merged_mask: torch.Tensor, hidden: torch.Tensor) -> torch.Tensor:
        if self.pooler_type == "cls":
            return hidden[:, 0]
        # 'avg': the weights are the *merged* mask values, so the global CLS
        # token weighs 2 (the reference's quirk, kept)
        w = merged_mask.to(hidden.dtype)
        return (hidden * w[:, :, None]).sum(1) / w.sum(-1).clamp_min(1e-6)[:, None]


class RecformerModel(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.embeddings = RecformerEmbeddings(config)
        self.encoder = LongformerEncoder(config)
        self.pooler = RecformerPooler(config)

    def forward(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                item_position_ids, position_ids=None, deterministic: bool = True, rng=None):
        """``deterministic=False`` applies dropout, drawn from ``rng`` (a
        :class:`~recformer_tpu_torch.utils.rng.StepRNG`)."""
        if deterministic:
            rng = None
        elif rng is None:
            raise ValueError("deterministic=False needs an rng (utils.rng.StepRNG)")
        mask = merge_attention_masks(attention_mask, global_attention_mask)
        x = self.embeddings(input_ids, token_type_ids, item_position_ids, position_ids, rng)
        x = self.encoder(x, mask, rng)
        return x, self.pooler(mask, x)


@torch.no_grad()
def init_weights(module: nn.Module, config: RecformerConfig, generator: torch.Generator):
    """The JAX package's initialisers from an explicit generator: normal
    (0, initializer_range) for dense kernels and embedding tables, zero
    biases (the MLM decoder bias included), unit LayerNorm scales."""
    std = config.initializer_range
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, std, generator=generator)
            m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, std, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for name, p in module.named_parameters():
        if name == "lm_head.bias":
            p.zero_()
