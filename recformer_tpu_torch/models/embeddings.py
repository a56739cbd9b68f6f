"""Recformer embeddings: word + token-position + token-type + item-position.

Counterpart of ``recformer_tpu/models/embeddings.py``:

- token-position ids are padding-aware: the cumulative count of non-pad
  tokens, offset by ``pad_token_id`` (pad tokens sit at ``pad_token_id``);
- ``embed_ln_impl='xla'``: the four lookups are summed in the compute type,
  then LayerNormed in float32 with the two-pass variance, then cast back to
  the compute type;
- ``embed_ln_impl='pallas'``: the four lookups go to
  :func:`~recformer_tpu_torch.ops.embed_layernorm.fused_embed_layernorm`
  (the hand-written kernels on the card), which sums them in float32;
- training applies hidden dropout to the result, outside the kernel.

Tables are plain ``nn.Embedding``s in the parameter type; a lookup casts
the gathered rows to the compute type, which gives the same values as the
JAX package's cast-then-gather.
"""

from __future__ import annotations

import torch
from torch import nn

from ..config import RecformerConfig
from ..ops.embed_layernorm import fused_embed_layernorm
from ..utils.rng import dropout


def create_position_ids_from_input_ids(input_ids: torch.Tensor, padding_idx: int) -> torch.Tensor:
    mask = (input_ids != padding_idx).to(torch.int32)
    incremental = torch.cumsum(mask, dim=1, dtype=torch.int32) * mask
    return incremental + padding_idx


class RecformerEmbeddings(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        kw = dict(dtype=config.params_dtype)
        hs = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, hs, **kw)
        self.position_embeddings = nn.Embedding(config.max_position_embeddings, hs, **kw)
        self.token_type_embeddings = nn.Embedding(config.token_type_size, hs, **kw)
        self.item_position_embeddings = nn.Embedding(config.max_item_embeddings, hs, **kw)
        self.LayerNorm = nn.LayerNorm(hs, eps=config.layer_norm_eps, **kw)

    def forward(self, input_ids, token_type_ids, item_position_ids, position_ids=None,
                rng=None):
        cfg = self.config
        dt = cfg.compute_dtype
        if position_ids is None:
            position_ids = create_position_ids_from_input_ids(input_ids, cfg.pad_token_id)
        word = self.word_embeddings(input_ids).to(dt)
        pos = self.position_embeddings(position_ids).to(dt)
        typ = self.token_type_embeddings(token_type_ids).to(dt)
        item = self.item_position_embeddings(item_position_ids).to(dt)
        ln = self.LayerNorm
        if cfg.embed_ln_impl == "pallas":
            x = fused_embed_layernorm(word, pos, typ, item, ln.weight, ln.bias,
                                      cfg.layer_norm_eps)
            return dropout(x.to(dt), cfg.hidden_dropout_prob, rng)
        x = (word + pos + typ + item).float()
        mu = x.mean(dim=-1, keepdim=True)
        xc = x - mu
        var = (xc * xc).mean(dim=-1, keepdim=True)
        x = xc * torch.rsqrt(var + cfg.layer_norm_eps)
        x = x * ln.weight.float() + ln.bias.float()
        return dropout(x.to(dt), cfg.hidden_dropout_prob, rng)
