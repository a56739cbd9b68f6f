"""Longformer-style transformer encoder (forward), PyTorch side.

Counterpart of ``recformer_tpu/models/encoder.py``: post-LayerNorm blocks
whose self-attention is windowed + global, with dedicated global
projections, per-layer windows and a float32 softmax. Parameters carry HF
Longformer's names (``attention.self.query``, ``attention.output.dense``,
``intermediate.dense``, ``output.LayerNorm`` ...), the names the JAX
package's checkpoint importer maps, so one state dict loads into both.

Numerics follow flax: a dense layer casts its input, kernel and bias to the
compute type; the residual sum is taken in the compute type. ``ln_impl``
selects the block LayerNorm, as the JAX package's ``_block_layernorm``
does: ``'xla'`` is flax's ``nn.LayerNorm`` (float32 statistics with the
fast variance ``E[x^2] - E[x]^2``), ``'pallas_bwd'`` the two-pass forward
with the hand-written backward kernel (``ops/layernorm.py``) and
``'split_bwd'`` the same forward with its plain split backward; the
parameters are the same under all three. ``attention_impl`` selects the attention core:
``'pallas'`` the fused kernel (``ops/window_attention.py``), ``'dense'`` and
``'chunked'`` the plain twins. ``scan_layers`` and ``remat`` do not change
the forward math, so the encoder runs the same layer loop under any value.

Training passes a :class:`~recformer_tpu_torch.utils.rng.StepRNG`: attention
probabilities take ``attention_probs_dropout_prob`` (in the kernel, or in the
plain twins), the two block outputs take ``hidden_dropout_prob`` before their
residual sums. Without one the forward is deterministic.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import RecformerConfig
from ..ops.attention import (_batch_index, chunked_attention, dense_attention,
                             global_prefix_indices, global_rows_thin)
from ..ops.layernorm import fused_bwd_layernorm, split_layernorm
from ..ops.window_attention import window_attention
from ..utils.rng import dropout

# The data contract has exactly one global token per sequence (the <s> row).
_MAX_GLOBALS = 1


def activation(hidden_act: str):
    """Activation selected by ``config.hidden_act``: 'gelu' is the exact erf
    GELU, 'gelu_tanh' the tanh approximation."""
    if hidden_act == "gelu":
        return lambda x: F.gelu(x, approximate="none")
    if hidden_act == "gelu_tanh":
        return lambda x: F.gelu(x, approximate="tanh")
    if hidden_act == "relu":
        return F.relu
    raise ValueError(f"unknown hidden_act {hidden_act!r}")


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias in the compute type."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def block_layernorm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm``: float32 statistics with the fast variance,
    output in the compute type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    mu2 = (xf * xf).mean(dim=-1, keepdim=True)
    var = (mu2 - mu * mu).clamp_min(0.0)
    mul = torch.rsqrt(var + ln.eps) * ln.weight.float()
    return ((xf - mu) * mul + ln.bias.float()).to(dtype)


def _linear(config: RecformerConfig, n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, dtype=config.params_dtype)


class LongformerSelfAttention(nn.Module):
    def __init__(self, config: RecformerConfig, window: int):
        super().__init__()
        self.config = config
        self.window = window
        hs = config.hidden_size
        for name in ("query", "key", "value", "query_global", "key_global", "value_global"):
            setattr(self, name, _linear(config, hs, hs))

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor, rng=None) -> torch.Tensor:
        cfg = self.config
        B, L, hs = hidden.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        dt = cfg.compute_dtype
        if cfg.attention_impl == "sequence_parallel":
            raise NotImplementedError("sequence_parallel attention arrives with the parallel slice")

        def heads(x):
            return x.reshape(B, -1, H, D)

        q = heads(dense(hidden, self.query, dt))
        k = heads(dense(hidden, self.key, dt))
        v = heads(dense(hidden, self.value, dt))
        # query_global projects only the gathered global row
        gidx, _ = global_prefix_indices(mask, _MAX_GLOBALS)
        hid_g = hidden[_batch_index(gidx), gidx]  # (B, G, hs)
        q_g = heads(dense(hid_g, self.query_global, dt))

        rate = cfg.attention_probs_dropout_prob if rng is not None else 0.0
        gen = rng.device if rng is not None else None
        g_out = k_g = v_g = None
        if cfg.global_kv_mode == "thin":
            # x @ (W_kg^T q_g) instead of (x @ W_kg) q_g: the full-length
            # global key/value projections are never materialised
            g_out = global_rows_thin(
                hidden, q_g, self.key_global.weight.t(), self.key_global.bias,
                self.value_global.weight.t(), self.value_global.bias, mask, dt,
                _MAX_GLOBALS, rate, gen, compact=(cfg.attention_impl == "pallas"))
        else:
            k_g = heads(dense(hidden, self.key_global, dt))
            v_g = heads(dense(hidden, self.value_global, dt))

        if cfg.attention_impl == "dense":
            out = dense_attention(q, k, v, q_g, k_g, v_g, mask, self.window, rate, gen,
                                  g_out=g_out)
        elif cfg.attention_impl == "chunked":
            out = chunked_attention(q, k, v, q_g, k_g, v_g, mask, self.window,
                                    block=min(128, L), dropout_rate=rate, generator=gen,
                                    g_out=g_out)
        else:  # 'pallas'
            out = window_attention(q, k, v, q_g, k_g, v_g, mask, self.window,
                                   dropout_rate=rate, generator=gen,
                                   host_generator=rng.host if rng is not None else None,
                                   g_out=g_out)
        return out.reshape(B, L, hs)


_BLOCK_LAYERNORMS = {"pallas_bwd": fused_bwd_layernorm, "split_bwd": split_layernorm}


class BlockOutput(nn.Module):
    """Dense projection, hidden dropout, residual sum in the compute type,
    then the LayerNorm ``ln_impl`` selects — the tail of both post-LayerNorm
    blocks."""

    def __init__(self, config: RecformerConfig, n_in: int):
        super().__init__()
        self.config = config
        self.dense = _linear(config, n_in, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps,
                                      dtype=config.params_dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, rng=None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        x = dropout(dense(x, self.dense, dt), cfg.hidden_dropout_prob, rng)
        x = x + residual.to(dt)
        ln = self.LayerNorm
        if cfg.ln_impl in _BLOCK_LAYERNORMS:
            return _BLOCK_LAYERNORMS[cfg.ln_impl](x, ln.weight, ln.bias, ln.eps)
        return block_layernorm(x, ln, dt)


class AttentionBlock(nn.Module):
    def __init__(self, config: RecformerConfig, window: int):
        super().__init__()
        # ``self`` is HF Longformer's parameter name for the attention core
        self.self = LongformerSelfAttention(config, window)
        self.output = BlockOutput(config, config.hidden_size)

    def forward(self, hidden, mask, rng=None):
        return self.output(self.self(hidden, mask, rng), hidden, rng)


class Intermediate(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.dense = _linear(config, config.hidden_size, config.intermediate_size)
        self.act = activation(config.hidden_act)

    def forward(self, hidden):
        return self.act(dense(hidden, self.dense, self.config.compute_dtype))


class EncoderLayer(nn.Module):
    """Attention block, then the feed-forward block (``intermediate`` +
    ``output``, the JAX package's ``FeedForwardBlock``), both post-LN."""

    def __init__(self, config: RecformerConfig, window: int):
        super().__init__()
        self.attention = AttentionBlock(config, window)
        self.intermediate = Intermediate(config)
        self.output = BlockOutput(config, config.intermediate_size)

    def forward(self, hidden, mask, rng=None):
        hidden = self.attention(hidden, mask, rng)
        return self.output(self.intermediate(hidden), hidden, rng)


class LongformerEncoder(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.layer = nn.ModuleList(EncoderLayer(config, w) for w in config.attention_window)

    def forward(self, hidden, mask, rng=None):
        for layer in self.layer:
            hidden = layer(hidden, mask, rng)
        return hidden
