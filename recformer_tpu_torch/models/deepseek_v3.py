"""DeepSeek-V3's decoder as RecFormer's user encoder
(``config.backbone == 'deepseek_v3'``; Moonlight-16B-A3B's settings are
``RecformerConfig.moonlight_16b_a3b()``).

The block (DeepSeek-AI, arXiv:2412.19437; Hugging Face ``DeepseekV3Model``),
which the JAX package does not have:

- embeddings: ``embed_tokens`` plus RecFormer's token-type and
  item-position embeddings, summed in the compute type (no norm after);
- each pre-RMSNorm layer: ``x + o_proj(attention(input_layernorm(x)))``,
  then ``x + mlp(post_attention_layernorm(x))``;
- latent attention (MLA, ``q_lora_rank`` None): ``q_proj`` gives each head
  ``q_nope`` (``qk_nope_head_dim``) and ``q_rot`` (``qk_rope_head_dim``);
  ``kv_a_proj_with_mqa`` gives the latent ``c`` (``kv_lora_rank``) and one
  ``k_rot`` that every head shares; ``kv_b_proj(kv_a_layernorm(c))`` gives
  each head ``k_nope`` and ``v`` (``v_head_dim``); RoPE at ``rope_theta``
  rotates ``q_rot`` and ``k_rot`` over adjacent pairs ``(2i, 2i + 1)``
  (DeepSeek's interleaved layout), its output written with the pairs'
  first members first, as Hugging Face's ``apply_rotary_pos_emb_interleave``
  writes it (query and key alike, so the scores are those of the rotation
  in place); scores ``[q_nope, q_rot] . [k_nope, k_rot] / sqrt(qk_head_dim)``
  under a causal mask, softmax in float32 (``ops/full_attention.py``,
  ``causal=True``);
- layers ``< first_k_dense_replace``: a SwiGLU MLP,
  ``down_proj(silu(gate_proj(x)) * up_proj(x))`` of width
  ``intermediate_size``; the others: the routed experts
  (``ops/moe.py``: sigmoid router ``mlp.gate``, ``num_experts_per_tok`` of
  ``n_routed_experts`` SwiGLU experts of width ``moe_intermediate_size``,
  their weighted sum in float32) plus the shared experts, one SwiGLU MLP of
  width ``n_shared_experts * moe_intermediate_size`` on every token;
- ``norm`` after the last layer; the pooled output is the last valid
  token's state (``pooler_type='last'``, ``recformer.last_token``).

Parameters take Hugging Face's names below the backbone (``embed_tokens``,
``layers.N.input_layernorm``, ``layers.N.self_attn.{q_proj,
kv_a_proj_with_mqa, kv_a_layernorm, kv_b_proj, o_proj}``,
``layers.N.post_attention_layernorm``, ``layers.N.mlp.{gate_proj, up_proj,
down_proj}`` on the dense layers, ``layers.N.mlp.gate.weight``,
``layers.N.mlp.gate.e_score_correction_bias``,
``layers.N.mlp.shared_experts.*``, ``norm``); the routed experts are
stacked, ``layers.N.mlp.experts.gate_up_proj`` ``(E, 2I, hs)`` (each
expert's ``gate_proj`` rows, then its ``up_proj`` rows) and
``layers.N.mlp.experts.down_proj`` ``(E, hs, I)``;
``weights.deepseek_v3_from_hf`` maps a published state dict's per-expert
names onto them.

Numerics as Hugging Face's in bf16: dense layers in the compute type;
residual sums in the compute type; RMSNorm ``w * (x * rsqrt(mean(x^2) +
eps))`` with float32 statistics, rounded to the compute type before the
weight; RoPE multiplies in the compute type from float32 tables cast once;
the router's logits and scores and the routed sum in float32. The RoPE
tables are built once per (length, device, dtype) and kept on the module,
outside any CUDA-graph capture (a signature's first call runs eagerly,
``utils/graphs.py``). ``e_score_correction_bias`` is a float32 buffer, as
Hugging Face keeps it.

Inference only: no dropout, no remat, one device (the config refuses the
rest), and no pretraining or fraud head.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RecformerConfig
from ..ops.full_attention import full_attention
from ..ops.moe import route, routed_experts
from .encoder import dense
from .recformer import Backbone, last_token


def rope_tables(length: int, dim: int, theta: float, device, dtype):
    """(cos, sin) of shape ``(length, dim / 2)``: angle ``p / theta^(2i/dim)``
    at position p for the pair ``(2i, 2i + 1)``, computed in float32 and
    cast to ``dtype``."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim))
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return ang.cos().to(dtype), ang.sin().to(dtype)


def rope_pairs(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """``(B, L, heads, dim)`` rotated over adjacent pairs ``(a, b) =
    (x[2i], x[2i+1])`` by the ``(L, dim / 2)`` tables: ``[a cos - b sin,
    b cos + a sin]``, the first members' results first."""
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([a * c - b * s, b * c + a * s], dim=-1)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Hugging Face's ``DeepseekV3RMSNorm``: float32 statistics, the
    normalised row rounded to ``x``'s type, then times the weight."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + eps)
    return weight.to(x.dtype) * y.to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float, dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width, dtype=dtype))
        self.eps = eps

    def forward(self, x):
        return rms_norm(x, self.weight, self.eps)


def _linear(config: RecformerConfig, n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False, dtype=config.params_dtype)


def _dense(x, layer: nn.Linear, dtype):
    return dense(x, layer, dtype, bias=False)


class DeepseekV3Attention(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        c, hs, H = config, config.hidden_size, config.num_attention_heads
        self.q_proj = _linear(c, hs, H * c.qk_head_dim)
        self.kv_a_proj_with_mqa = _linear(c, hs, c.kv_lora_rank + c.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps, c.params_dtype)
        self.kv_b_proj = _linear(c, c.kv_lora_rank, H * (c.qk_nope_head_dim + c.v_head_dim))
        self.o_proj = _linear(c, H * c.v_head_dim, hs)

    def forward(self, x, mask, rope):
        c = self.config
        B, L, _ = x.shape
        H, dt = c.num_attention_heads, c.compute_dtype
        q = _dense(x, self.q_proj, dt).view(B, L, H, c.qk_head_dim)
        q_nope, q_rot = q.split([c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)
        latent, k_rot = _dense(x, self.kv_a_proj_with_mqa, dt).split(
            [c.kv_lora_rank, c.qk_rope_head_dim], dim=-1)
        kv = _dense(self.kv_a_layernorm(latent), self.kv_b_proj, dt).view(
            B, L, H, c.qk_nope_head_dim + c.v_head_dim)
        k_nope, v = kv.split([c.qk_nope_head_dim, c.v_head_dim], dim=-1)
        q = torch.cat([q_nope, rope_pairs(q_rot, *rope)], dim=-1)
        k_rot = rope_pairs(k_rot[:, :, None], *rope).expand(B, L, H, c.qk_rope_head_dim)
        k = torch.cat([k_nope, k_rot], dim=-1)
        out = full_attention(q, k, v, mask, causal=True)
        return _dense(out.reshape(B, L, H * c.v_head_dim), self.o_proj, dt)


class DeepseekV3MLP(nn.Module):
    """SwiGLU: ``down_proj(silu(gate_proj(x)) * up_proj(x))``."""

    def __init__(self, config: RecformerConfig, width: int):
        super().__init__()
        self.config = config
        hs = config.hidden_size
        self.gate_proj = _linear(config, hs, width)
        self.up_proj = _linear(config, hs, width)
        self.down_proj = _linear(config, width, hs)

    def forward(self, x, mask=None):
        dt = self.config.compute_dtype
        h = F.silu(_dense(x, self.gate_proj, dt)) * _dense(x, self.up_proj, dt)
        return _dense(h, self.down_proj, dt)


class DeepseekV3Router(nn.Linear):
    """``mlp.gate``: the router's ``(E, hs)`` weight and the float32
    ``e_score_correction_bias`` that moves the choice of experts."""

    def __init__(self, config: RecformerConfig):
        super().__init__(config.hidden_size, config.n_routed_experts, bias=False,
                         dtype=config.params_dtype)
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(config.n_routed_experts, dtype=torch.float32))


class DeepseekV3Experts(nn.Module):
    """The routed experts' stacked weights: ``gate_up_proj`` ``(E, 2I, hs)``
    and ``down_proj`` ``(E, hs, I)``."""

    def __init__(self, config: RecformerConfig):
        super().__init__()
        E, hs, inter = config.n_routed_experts, config.hidden_size, config.moe_intermediate_size
        kw = dict(dtype=config.params_dtype)
        self.gate_up_proj = nn.Parameter(torch.empty(E, 2 * inter, hs, **kw))
        self.down_proj = nn.Parameter(torch.empty(E, hs, inter, **kw))

    @torch.no_grad()
    def init_weights(self, std: float, generator: torch.Generator):
        for p in (self.gate_up_proj, self.down_proj):
            p.normal_(0.0, std, generator=generator)


class DeepseekV3MoE(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.gate = DeepseekV3Router(config)
        self.experts = DeepseekV3Experts(config)
        self.shared_experts = DeepseekV3MLP(
            config, config.n_shared_experts * config.moe_intermediate_size)

    def forward(self, x, mask):
        c, dt = self.config, self.config.compute_dtype
        shape = x.shape
        flat = x.reshape(-1, shape[-1])
        experts, weights = route(flat, self.gate.weight, self.gate.e_score_correction_bias,
                                 c.num_experts_per_tok, c.routed_scaling_factor,
                                 c.norm_topk_prob)
        routed = routed_experts(flat, mask.reshape(-1) != 0, experts, weights,
                                self.experts.gate_up_proj.to(dt),
                                self.experts.down_proj.to(dt))
        return routed.view(shape) + self.shared_experts(x)


class DeepseekV3Layer(nn.Module):
    def __init__(self, config: RecformerConfig, layer_id: int):
        super().__init__()
        c = config
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.params_dtype)
        self.self_attn = DeepseekV3Attention(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.params_dtype)
        self.mlp = (DeepseekV3MoE(c) if c.is_moe_layer(layer_id)
                    else DeepseekV3MLP(c, c.intermediate_size))

    def forward(self, x, mask, rope):
        x = x + self.self_attn(self.input_layernorm(x), mask, rope)
        return x + self.mlp(self.post_attention_layernorm(x), mask)


class DeepseekV3Model(Backbone):
    """The backbone: the embeddings, the layers and ``norm``; the pooled
    output is the last valid token's state. The RoPE tables are kept per
    (length, device, dtype)."""

    def __init__(self, config: RecformerConfig):
        super().__init__(config)
        c, kw = config, dict(dtype=config.params_dtype)
        self.embed_tokens = nn.Embedding(c.vocab_size, c.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(c.token_type_size, c.hidden_size, **kw)
        self.item_position_embeddings = nn.Embedding(c.max_item_embeddings, c.hidden_size, **kw)
        self.layers = nn.ModuleList(DeepseekV3Layer(c, i) for i in range(c.num_hidden_layers))
        self.norm = RMSNorm(c.hidden_size, c.rms_norm_eps, c.params_dtype)
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, length: int, device, dtype):
        key = (length, device, dtype)
        if key not in self._rope:
            c = self.config
            self._rope[key] = rope_tables(length, c.qk_rope_head_dim, c.rope_theta, device, dtype)
        return self._rope[key]

    def forward_eager(self, input_ids, attention_mask, global_attention_mask, token_type_ids,
                      item_position_ids, position_ids=None, rng=None):
        """(hidden, pooled). ``global_attention_mask`` is not read: every
        layer is causal. Positions are ``0 .. L-1``."""
        if position_ids is not None:
            raise ValueError("the deepseek_v3 backbone takes its positions from RoPE, 0 .. L-1")
        if rng is not None:
            raise ValueError("the deepseek_v3 backbone runs without dropout")
        dt = self.config.compute_dtype
        x = (self.embed_tokens(input_ids).to(dt)
             + self.token_type_embeddings(token_type_ids).to(dt)
             + self.item_position_embeddings(item_position_ids).to(dt))
        rope = self.rope(x.shape[1], x.device, dt)
        for layer in self.layers:
            x = layer(x, attention_mask, rope)
        x = self.norm(x)
        return x, last_token(x, attention_mask)
