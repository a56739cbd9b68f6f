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
``'chunked'`` the plain twins, ``'sequence_parallel'`` the op of
``parallel/sequence.py`` on this rank's slice of the tokens (the mesh
carried on the module as ``sp``; the global keys and values are projected
over the slice, never reassociated, as the op shards them).
``scan_layers`` does not change the forward math, so the encoder runs the
same layer loop under either value (``parallel/pipeline.py`` runs a
stage's slice of it).

Activation recomputation (``remat``, the counterpart of the JAX package's
``nn.remat`` around each layer with ``_remat_policy``): when grad is enabled
each layer runs under non-reentrant ``torch.utils.checkpoint``, which keeps
the layer's input and recomputes the rest in the backward; under
``torch.no_grad()`` nothing is checkpointed. ``remat_policy`` says what a
layer keeps besides its input, in a :class:`LayerTape`: ``'full'`` nothing;
``'save_attention'`` the attention core's output, so that the recomputation
rebuilds only the projections the backward kernel takes as inputs and never
launches the forward kernel again; ``'dots'`` the output of every
``dense()`` product (JAX's ``dots_with_no_batch_dims_saveable``; the batched
products of the global rows and the attention core are recomputed);
``'dots_attn'`` both. The kernels launch through ctypes, below the
dispatcher, so the tape keeps their outputs by hand instead of a
selective-checkpoint policy over dispatcher ops. Under the plain attention
twins (``'dense'``, ``'chunked'``) the core's backward needs its
probabilities, so ``'save_attention'`` recomputes it, as JAX's remat does.
The recomputation draws what the first run drew
(``utils.rng.capture``/``replay``: dropout masks and the kernel's seed come
from a :class:`~recformer_tpu_torch.utils.rng.StepRNG`'s own generators,
which ``torch.utils.checkpoint`` does not restore) and leaves both
generators where the first run left them.

Training passes a :class:`~recformer_tpu_torch.utils.rng.StepRNG`: attention
probabilities take ``attention_probs_dropout_prob`` (in the kernel, or in the
plain twins), the two block outputs take ``hidden_dropout_prob`` before their
residual sums. Without one the forward is deterministic.

Tensor parallelism (``parallel/tensor.py``'s ``shard_model_tp`` sets ``tp``,
the mesh, on the attention core, the intermediate projection and both block
outputs): each rank holds ``H / n`` heads of the attention projections and
``FFN / n`` columns of the intermediate one, so kernels 1 and 2 run at
``num_heads = H / n``; the replicated hidden state enters each of those
through ``copy_to`` (whose backward sums the cotangents over the model
group) and each row-parallel output projection's partial product is summed
in float32 by ``psum`` before its bias is added once. The thin global rows
reassociate per local head as they do over all heads. The attention
probabilities' dropout (the kernel's seed and the plain draws) comes from
``utils.rng.head_group_rng``, folded by the model rank, so head groups draw
differently while the hidden dropout, drawn from the step's generators,
stays the same on every rank of the group. Under ``remat`` the
recomputation runs the layer's collectives again, in the same order on
every rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..config import RecformerConfig
from ..ops.attention import (_batch_index, chunked_attention, dense_attention,
                             global_prefix_indices, global_rows_thin)
from ..ops.layernorm import fused_bwd_layernorm, split_layernorm
from ..ops.window_attention import window_attention
from ..parallel.collectives import copy_to, psum
from ..parallel.sequence import sequence_parallel_attention
from ..utils.rng import capture, dropout, head_group_rng, replay

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


REMAT_POLICIES = ("full", "save_attention", "dots", "dots_attn")


class LayerTape:
    """What one checkpointed layer keeps for its recomputation under
    ``policy``: the attention core's output (``attention``), the dense
    products' (``dots``). :meth:`keep` records each such value in the first
    run and hands it back, in the same order, in the recomputation."""

    def __init__(self, policy: str):
        if policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {policy!r}")
        self.attention = policy in ("save_attention", "dots_attn")
        self.dots = policy in ("dots", "dots_attn")
        self._runs = 0
        self._kept = []
        self._next = 0

    def start(self) -> bool:
        """Begin a run of the layer; True for the first (which records)."""
        self._runs += 1
        self._next = 0
        return self._runs == 1

    def keep(self, compute):
        """``compute(None)`` in the first run, whose result is kept;
        ``compute(kept)`` in the recomputation."""
        if self._runs == 1:
            out = compute(None)
            self._kept.append(out.detach())
            return out
        out = compute(self._kept[self._next])
        self._next += 1
        return out


class _Dense(torch.autograd.Function):
    """``F.linear`` that returns ``out`` when given one (a product kept by a
    :class:`LayerTape`), with autograd's own backward of ``F.linear`` on a
    contiguous input (its ``addmm``: the same products in the same layout),
    so kept and recomputed products give the same gradients."""

    @staticmethod
    def forward(ctx, x, w, b, out):
        ctx.save_for_backward(x, w)
        return F.linear(x, w, b) if out is None else out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = g2.mm(w).view(x.shape) if ctx.needs_input_grad[0] else None
        gw = g2.t().mm(x.reshape(-1, x.shape[-1])) if ctx.needs_input_grad[1] else None
        gb = g2.sum(0) if ctx.needs_input_grad[2] else None
        return gx, gw, gb, None


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
          tape: LayerTape | None = None, bias: bool = True) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, kernel and bias (unless
    ``bias`` is False) in the compute type; its output kept by ``tape`` when
    the policy keeps products."""
    args = (x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype) if bias else None)
    if tape is None or not tape.dots:
        return F.linear(*args)
    return tape.keep(lambda kept: _Dense.apply(*args, kept))


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
        self.tp = None  # the mesh, under tensor parallelism
        self.sp = None  # the mesh, under sequence parallelism
        hs = config.hidden_size
        for name in ("query", "key", "value", "query_global", "key_global", "value_global"):
            setattr(self, name, _linear(config, hs, hs))

    def forward(self, hidden: torch.Tensor, mask: torch.Tensor, rng=None,
                tape: LayerTape | None = None) -> torch.Tensor:
        cfg = self.config
        B, L, _ = hidden.shape
        H, D = cfg.num_attention_heads, cfg.head_dim
        dt = cfg.compute_dtype
        sequence_parallel = cfg.attention_impl == "sequence_parallel"
        if sequence_parallel and self.sp is None:
            raise ValueError("attention_impl='sequence_parallel' runs on a rank's slice of the "
                             "tokens: build it with parallel.sequence's make_* functions")
        if self.tp is not None:
            hidden = copy_to(hidden, self.tp.model_group)
            H //= self.tp.n_model
            if rng is not None and cfg.attention_probs_dropout_prob > 0.0:
                rng = head_group_rng(rng, self.tp.model_rank)

        def heads(x):
            return x.reshape(B, -1, H, D)

        q = heads(dense(hidden, self.query, dt, tape))
        k = heads(dense(hidden, self.key, dt, tape))
        v = heads(dense(hidden, self.value, dt, tape))
        # query_global projects only the gathered global row
        gidx, _ = global_prefix_indices(mask, _MAX_GLOBALS)
        hid_g = hidden[_batch_index(gidx), gidx]  # (B, G, hs)
        q_g = heads(dense(hid_g, self.query_global, dt, tape))

        rate = cfg.attention_probs_dropout_prob if rng is not None else 0.0
        gen = rng.device if rng is not None else None
        g_out = k_g = v_g = None
        if cfg.global_kv_mode == "thin" and not sequence_parallel:
            # x @ (W_kg^T q_g) instead of (x @ W_kg) q_g: the full-length
            # global key/value projections are never materialised
            g_out = global_rows_thin(
                hidden, q_g, self.key_global.weight.t(), self.key_global.bias,
                self.value_global.weight.t(), self.value_global.bias, mask, dt,
                _MAX_GLOBALS, rate, gen, compact=(cfg.attention_impl == "pallas"))
        else:
            k_g = heads(dense(hidden, self.key_global, dt, tape))
            v_g = heads(dense(hidden, self.value_global, dt, tape))

        if cfg.attention_impl == "dense":
            out = dense_attention(q, k, v, q_g, k_g, v_g, mask, self.window, rate, gen,
                                  g_out=g_out)
        elif sequence_parallel:
            out = sequence_parallel_attention(q, k, v, q_g, k_g, v_g, mask, self.window,
                                              self.sp.model_group, _MAX_GLOBALS, rate, gen)
        elif cfg.attention_impl == "chunked":
            out = chunked_attention(q, k, v, q_g, k_g, v_g, mask, self.window,
                                    block=min(128, L), dropout_rate=rate, generator=gen,
                                    g_out=g_out)
        else:  # 'pallas'
            out = window_attention(q, k, v, q_g, k_g, v_g, mask, self.window,
                                   dropout_rate=rate, generator=gen,
                                   host_generator=rng.host if rng is not None else None,
                                   g_out=g_out,
                                   tape=tape if tape is not None and tape.attention else None)
        return out.reshape(B, L, H * D)


_BLOCK_LAYERNORMS = {"pallas_bwd": fused_bwd_layernorm, "split_bwd": split_layernorm}


class BlockOutput(nn.Module):
    """Dense projection, hidden dropout, residual sum in the compute type,
    then the LayerNorm ``ln_impl`` selects — the tail of both post-LayerNorm
    blocks."""

    def __init__(self, config: RecformerConfig, n_in: int):
        super().__init__()
        self.config = config
        self.tp = None  # the mesh, under tensor parallelism (row-parallel dense)
        self.dense = _linear(config, n_in, config.hidden_size)
        self.LayerNorm = nn.LayerNorm(config.hidden_size, eps=config.layer_norm_eps,
                                      dtype=config.params_dtype)

    def forward(self, x: torch.Tensor, residual: torch.Tensor, rng=None,
                tape: LayerTape | None = None) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        if self.tp is None:
            x = dense(x, self.dense, dt, tape)
        else:
            x = dense(x, self.dense, dt, tape, bias=False)
            x = psum(x.float(), self.tp.model_group).to(dt) + self.dense.bias.to(dt)
        x = dropout(x, cfg.hidden_dropout_prob, rng)
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

    def forward(self, hidden, mask, rng=None, tape=None):
        return self.output(self.self(hidden, mask, rng, tape), hidden, rng, tape)


class Intermediate(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.tp = None  # the mesh, under tensor parallelism (column-parallel dense)
        self.dense = _linear(config, config.hidden_size, config.intermediate_size)
        self.act = activation(config.hidden_act)

    def forward(self, hidden, tape=None):
        if self.tp is not None:
            hidden = copy_to(hidden, self.tp.model_group)
        return self.act(dense(hidden, self.dense, self.config.compute_dtype, tape))


class EncoderLayer(nn.Module):
    """Attention block, then the feed-forward block (``intermediate`` +
    ``output``, the JAX package's ``FeedForwardBlock``), both post-LN."""

    def __init__(self, config: RecformerConfig, window: int):
        super().__init__()
        self.attention = AttentionBlock(config, window)
        self.intermediate = Intermediate(config)
        self.output = BlockOutput(config, config.intermediate_size)

    def forward(self, hidden, mask, rng=None, tape=None):
        hidden = self.attention(hidden, mask, rng, tape)
        return self.output(self.intermediate(hidden, tape), hidden, rng, tape)


def remat_layer(layer: EncoderLayer, hidden, mask, rng, policy: str):
    """``layer(hidden, mask, rng)`` under non-reentrant
    ``torch.utils.checkpoint``, keeping what ``policy`` says (a
    :class:`LayerTape`). The recomputation replays the generators of ``rng``
    from where the first run found them."""
    tape = LayerTape(policy)
    drawn = capture(rng)

    def run(h):
        if tape.start():
            return layer(h, mask, rng, tape)
        return replay(drawn, layer, h, mask, rng, tape)

    return checkpoint(run, hidden, use_reentrant=False)


class LongformerEncoder(nn.Module):
    def __init__(self, config: RecformerConfig):
        super().__init__()
        self.config = config
        self.layer = nn.ModuleList(EncoderLayer(config, w) for w in config.attention_window)

    def forward(self, hidden, mask, rng=None):
        remat = self.config.remat and torch.is_grad_enabled()
        for layer in self.layer:
            if remat:
                hidden = remat_layer(layer, hidden, mask, rng, self.config.remat_policy)
            else:
                hidden = layer(hidden, mask, rng)
        return hidden
