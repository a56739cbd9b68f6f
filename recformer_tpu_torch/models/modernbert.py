"""ModernBERT as RecFormer's backbone (``config.backbone == 'modernbert'``).

The block of ModernBERT (Warner et al., arXiv:2412.13663;
answerdotai/ModernBERT-large), which the JAX package does not have:

- embeddings: the word embedding plus RecFormer's token-type and
  item-position embeddings (no position table), then ``embeddings.norm``;
- each pre-LayerNorm layer: ``x + Wo(attention(attn_norm(x)))`` (layer 0
  has no ``attn_norm``), then ``x + mlp.Wo(gelu(a) * g)`` with ``a, g`` the
  two halves of ``mlp.Wi(mlp_norm(x))`` (GeGLU); ``Wqkv`` is one fused
  projection; q and k are rotated by RoPE at positions ``0 .. L-1``;
- attention: every ``global_attn_every_n_layers``-th layer, from layer 0,
  attends to every non-padding key (RoPE theta ``global_rope_theta``,
  ``ops/full_attention.py``); the others to the non-padding keys within
  ``local_attention // 2`` (RoPE theta ``local_rope_theta``, kernel 1 with no
  global column, ``ops/window_attention.local_window_attention``, under
  ``attention_impl='pallas'``; the plain masked softmax under ``'dense'`` or
  ``'chunked'``);
- ``final_norm`` after the last layer; the pooled output is the first
  token's (``<s>``, ModernBERT's CLS) state;
- no LayerNorm or projection carries a bias (ModernBERT's ``norm_bias``,
  ``attention_bias``, ``mlp_bias`` and ``classifier_bias`` are false).

Parameters take Hugging Face ModernBERT's names below the backbone
(``embeddings.tok_embeddings``, ``embeddings.norm``, ``layers.N.attn_norm``,
``layers.N.attn.Wqkv``, ``layers.N.attn.Wo``, ``layers.N.mlp_norm``,
``layers.N.mlp.Wi``, ``layers.N.mlp.Wo``, ``final_norm``), so a published
checkpoint loads by name with its ``model.`` prefix read as the heads'
``longformer.``.

Numerics follow ``models/encoder.py``'s: a dense layer casts its input,
kernel and bias to the compute type; residual sums are taken in the compute
type; every LayerNorm takes float32 two-pass statistics and returns the
compute type; RoPE multiplies in the compute type, as ModernBERT does, from
float32 tables cast once. The tables are built once per (length, theta,
device, dtype) and kept on the module, outside any CUDA-graph capture (a
signature's first call runs eagerly, ``utils/graphs.py``).

Every LayerNorm, and ``mlp_norm`` with the attention block's residual sum
in front of it, is one call of ``ops/add_layernorm.py``: one hand-written
kernel on the card, whose sum is bitwise the plain one and whose output
differs from the plain chain only by the order of the row sums; on the CPU
the plain chain itself. The layer's output sum ``x + mlp(...)`` stays a
plain add, so a layer's input and output (``remat_layer``'s checkpoint)
are the residual stream alone.

No dropout (ModernBERT's are 0; the config refuses others) and no tensor,
sequence or pipeline parallelism. Under ``remat`` each layer runs under
``encoder.remat_layer``; the tape keeps the dense products under the
``dots`` policies.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..config import RecformerConfig
from ..ops.add_layernorm import add_layernorm
from ..ops.full_attention import full_attention, full_attention_plain
from ..ops.window_attention import local_window_attention
from .encoder import LayerTape, activation, dense, remat_layer
from .recformer import Backbone, RecformerModel


def rope_tables(length: int, head_dim: int, theta: float, device, dtype):
    """(cos, sin) of shape ``(length, head_dim)``: angle ``p / theta^(2i/D)``
    at position p for the pair ``(i, i + D/2)``, computed in float32 and
    cast to ``dtype``."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                           / head_dim))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos().to(dtype), ang.sin().to(dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``x * cos + rotate_half(x) * sin`` over ``(B, L, ..., D)`` with
    ``(L, D)`` tables; ``rotate_half(x) = cat(-x[D/2:], x[:D/2])``."""
    shape = (1, x.shape[1]) + (1,) * (x.dim() - 3) + (x.shape[-1],)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos.view(shape) + rot * sin.view(shape)


def _linear(config: RecformerConfig, n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=config.params_dtype)


def _norm(config: RecformerConfig) -> nn.LayerNorm:
    return nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps, bias=False,
                        dtype=config.params_dtype)


def _dense(x, layer: nn.Linear, dtype, tape=None):
    return dense(x, layer, dtype, tape, bias=False)


class ModernBertEmbeddings(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        hs, kw = config.hidden_size, dict(dtype=config.params_dtype)
        self.tok_embeddings = nn.Embedding(config.vocab_size, hs, **kw)
        self.token_type_embeddings = nn.Embedding(config.token_type_size, hs, **kw)
        self.item_position_embeddings = nn.Embedding(config.max_item_embeddings, hs, **kw)
        self.norm = _norm(config)

    @property
    def word_embeddings(self) -> nn.Embedding:
        """The word table under the name the heads and CLIs use for it."""
        return self.tok_embeddings

    def forward(self, input_ids, token_type_ids, item_position_ids):
        dt = self.config.compute_dtype
        x = (self.tok_embeddings(input_ids).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt)
             + self.item_position_embeddings(item_position_ids).to(dt))
        return add_layernorm(x, None, self.norm.weight, self.norm.eps)


class ModernBertAttention(nn.Module):
    def __init__(self, config: RecformerConfig, layer_id: int):
        super().__init__()
        self.config = config
        self.is_global = config.is_global_layer(layer_id)
        self.window = config.local_attention
        hs = config.hidden_size
        self.Wqkv = _linear(config, hs, 3 * hs)
        self.Wo = _linear(config, hs, hs)

    def forward(self, x, mask, rope, tape=None):
        cfg = self.config
        B, L, hs = x.shape
        H, D, dt = cfg.num_attention_heads, cfg.head_dim, cfg.compute_dtype
        qkv = _dense(x, self.Wqkv, dt, tape).view(B, L, 3, H, D)
        qk = apply_rope(qkv[:, :, :2], *rope)
        q, k, v = qk[:, :, 0], qk[:, :, 1], qkv[:, :, 2]
        if self.is_global:
            out = full_attention(q, k, v, mask)
        elif cfg.attention_impl == "pallas":
            out = local_window_attention(q, k, v, mask, self.window)
        else:
            near = (torch.arange(L, device=x.device)[:, None]
                    - torch.arange(L, device=x.device)[None, :]).abs() <= self.window // 2
            out = full_attention_plain(q, k, v, (mask != 0)[:, None, :] & near[None])
        return _dense(out.reshape(B, L, hs), self.Wo, dt, tape)


class ModernBertMLP(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.Wi = _linear(config, config.hidden_size, 2 * config.intermediate_size)
        self.Wo = _linear(config, config.intermediate_size, config.hidden_size)
        self.act = activation(config.hidden_act)

    def forward(self, x, tape=None):
        dt = self.config.compute_dtype
        a, g = _dense(x, self.Wi, dt, tape).chunk(2, dim=-1)
        return _dense(self.act(a) * g, self.Wo, dt, tape)


class ModernBertLayer(nn.Module):
    def __init__(self, config: RecformerConfig, layer_id: int):
        super().__init__()
        self.config = config
        self.attn_norm = nn.Identity() if layer_id == 0 else _norm(config)
        self.attn = ModernBertAttention(config, layer_id)
        self.mlp_norm = _norm(config)
        self.mlp = ModernBertMLP(config)

    def forward(self, x, ctx, rng=None, tape: LayerTape | None = None):
        """``ctx``: (key mask, this layer's RoPE tables); no dropout, so
        ``rng`` is not read."""
        mask, rope = ctx
        a, m = self.attn_norm, self.mlp_norm
        h = x if isinstance(a, nn.Identity) else add_layernorm(x, None, a.weight, a.eps)
        x, h = add_layernorm(x, self.attn(h, mask, rope, tape), m.weight, m.eps)
        return x + self.mlp(h, tape)


class ModernBertPredictionHead(nn.Module):
    """ModernBERT's MLM head before the tied decoder: ``dense``, the
    activation, ``norm``."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.dense = _linear(config, config.hidden_size, config.hidden_size)
        self.act = activation(config.hidden_act)
        self.norm = _norm(config)

    def forward(self, x):
        h = self.act(_dense(x, self.dense, self.config.compute_dtype))
        return add_layernorm(h, None, self.norm.weight, self.norm.eps)


class ModernBertModel(Backbone):
    """The backbone: embeddings, the layers and ``final_norm``; the pooled
    output is the first token's state. The RoPE tables of both kinds of
    layer are kept per (length, device, dtype)."""

    def __init__(self, config: RecformerConfig):
        super().__init__(config)
        self.embeddings = ModernBertEmbeddings(config)
        self.layers = nn.ModuleList(ModernBertLayer(config, i)
                                    for i in range(config.num_hidden_layers))
        self.final_norm = _norm(config)
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, length: int, is_global: bool, device, dtype):
        cfg = self.config
        theta = cfg.global_rope_theta if is_global else cfg.local_rope_theta
        key = (length, theta, device, dtype)
        if key not in self._rope:
            self._rope[key] = rope_tables(length, cfg.head_dim, theta, device, dtype)
        return self._rope[key]

    def forward_eager(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                      item_position_ids, position_ids=None, rng=None):
        """(hidden, pooled). ``global_attention_mask`` is not read: the global
        layers attend everywhere. Positions are ``0 .. L-1``."""
        if position_ids is not None:
            raise ValueError("the modernbert backbone takes its positions from RoPE, 0 .. L-1")
        cfg = self.config
        dt = cfg.compute_dtype
        x = self.embeddings(input_ids, token_type_ids, item_position_ids)
        L = x.shape[1]
        remat = cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            ctx = (attention_mask, self.rope(L, layer.attn.is_global, x.device, dt))
            if remat:
                x = remat_layer(layer, x, ctx, None, cfg.remat_policy)
            else:
                x = layer(x, ctx)
        x = add_layernorm(x, None, self.final_norm.weight, self.final_norm.eps)
        return x, x[:, 0]


def backbone_model(config: RecformerConfig) -> Backbone:
    """The backbone ``config.backbone`` names."""
    return ModernBertModel(config) if config.backbone == "modernbert" else RecformerModel(config)
