"""Recformer backbone: embeddings -> Longformer encoder -> pooler.

Counterpart of ``recformer_tpu/models/recformer.py``. :class:`Backbone` holds
what every backbone shares (the serving dispatch below); the ModernBERT
backbone is ``models/modernbert.py``. Batches are padded to
a static length that is a multiple of the attention window; the {0,1} x
{0,1} masks merge into {0 none, 1 local, 2 global}. A call without
gradients and without dropout (serving, evaluation, catalog encoding) goes
through the model's :class:`~recformer_tpu_torch.utils.graphs.Graphs`, which
replays a CUDA graph of the same forward where the call allows it.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import RecformerConfig
from ..utils.graphs import Graphs
from ..utils.profiling import spanned
from .embeddings import RecformerEmbeddings
from .encoder import LongformerEncoder


def merge_attention_masks(attention_mask: torch.Tensor, global_attention_mask: torch.Tensor):
    """{0,1} local mask x {0,1} global mask -> {0 none, 1 local, 2 global}."""
    return attention_mask * (global_attention_mask + 1)


def last_token(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The last valid token's ``(B, H)`` state: padding trails, so it is at
    the number of nonzero ``mask`` entries less one (position 0 for a row
    with none)."""
    last = ((mask != 0).sum(1) - 1).clamp_min(0)
    return hidden.gather(1, last[:, None, None].expand(-1, 1, hidden.shape[-1]))[:, 0]


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


class Backbone(nn.Module):
    """What every backbone shares: the forward's dispatch between
    :meth:`forward_eager`, which each backbone defines, and its
    :class:`~recformer_tpu_torch.utils.graphs.Graphs`."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.serve_graphs = Graphs("serve_graph")

    @spanned("forward.encoder")
    def forward(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                item_position_ids, position_ids=None, deterministic: bool = True, rng=None):
        """(hidden, pooled). ``deterministic=False`` applies dropout, drawn
        from ``rng`` (a :class:`~recformer_tpu_torch.utils.rng.StepRNG`).
        With gradients off and no dropout, :attr:`serve_graphs` runs
        :meth:`forward_eager` or replays a CUDA graph of it."""
        inputs = (input_ids, attention_mask, global_attention_mask, token_type_ids,
                  item_position_ids, position_ids)
        if not deterministic:
            if rng is None:
                raise ValueError("deterministic=False needs an rng (utils.rng.StepRNG)")
            return self.forward_eager(*inputs, rng=rng)
        if torch.is_grad_enabled():
            return self.forward_eager(*inputs)
        return self.serve_graphs(self, self.forward_eager, inputs)

    def forward_eager(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                      item_position_ids, position_ids=None, rng=None):
        raise NotImplementedError


class RecformerModel(Backbone):
    """The Longformer backbone: embeddings, encoder, pooler."""

    def __init__(self, config: RecformerConfig):
        super().__init__(config)
        self.embeddings = RecformerEmbeddings(config)
        self.encoder = LongformerEncoder(config)
        self.pooler = RecformerPooler(config)

    def forward_eager(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                      item_position_ids, position_ids=None, rng=None):
        """The forward, launched from Python op by op; dropout when ``rng``
        is given."""
        mask = merge_attention_masks(attention_mask, global_attention_mask)
        x = self.embeddings(input_ids, token_type_ids, item_position_ids, position_ids, rng)
        x = self.encoder(x, mask, rng)
        return x, self.pooler(mask, x)


@torch.no_grad()
def init_weights(module: nn.Module, config: RecformerConfig, generator: torch.Generator):
    """The JAX package's initialisers from an explicit generator: normal
    (0, initializer_range) for dense kernels and embedding tables, zero
    biases (the MLM decoder bias included), unit LayerNorm scales. Layers
    without a bias keep none; a module with its own ``init_weights(std,
    generator)`` (stacked experts) draws its parameters there."""
    std = config.initializer_range
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.normal_(0.0, std, generator=generator)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, std, generator=generator)
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
        elif hasattr(m, "init_weights"):
            m.init_weights(std, generator)
        if isinstance(m, (nn.Linear, nn.LayerNorm)) and m.bias is not None:
            m.bias.zero_()
    for name, p in module.named_parameters():
        if name in ("lm_head.bias", "decoder.bias"):
            p.zero_()
