"""Weights of RecFormer on the deepseek_v3 backbone from the run's seed, made
on the device tensor by tensor straight in the parameters' type (bf16 for
Moonlight: one float32 draw of its 15.6 B values would need 62.5 GB):
dense kernels, the stacked experts and the embedding tables
normal(0, initializer_range), RMSNorm scales one, and each router's
``e_score_correction_bias`` normal(0, :data:`BIAS_STD`) in float32, so that
the bias moves the choice of experts as a trained checkpoint's does. Named
as the program names them (Hugging Face's ``DeepseekV3Model`` names under
the heads' ``longformer.`` prefix, the routed experts stacked). Only the
``seqrec`` head: the backbone runs for inference only."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

HEADS = ("seqrec",)
BIAS_STD = 0.1


def parameter_shapes(cfg, head: str = "seqrec") -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter and buffer, init one of
    'normal', 'ones', 'bias'."""
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}")
    hs, H = cfg.hidden_size, cfg.num_attention_heads
    E, inter = cfg.n_routed_experts, cfg.moe_intermediate_size
    out = []

    def dense(name, n_in, n_out):
        out.append((name + ".weight", (n_out, n_in), "normal"))

    def mlp(pre, width):
        dense(pre + "gate_proj", hs, width)
        dense(pre + "up_proj", hs, width)
        dense(pre + "down_proj", width, hs)

    p = "longformer."
    out += [(p + "embed_tokens.weight", (cfg.vocab_size, hs), "normal"),
            (p + "token_type_embeddings.weight", (cfg.token_type_size, hs), "normal"),
            (p + "item_position_embeddings.weight", (cfg.max_item_embeddings, hs), "normal")]
    for i in range(cfg.num_hidden_layers):
        pre = f"{p}layers.{i}."
        a = pre + "self_attn."
        out.append((pre + "input_layernorm.weight", (hs,), "ones"))
        dense(a + "q_proj", hs, H * (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim))
        dense(a + "kv_a_proj_with_mqa", hs, cfg.kv_lora_rank + cfg.qk_rope_head_dim)
        out.append((a + "kv_a_layernorm.weight", (cfg.kv_lora_rank,), "ones"))
        dense(a + "kv_b_proj", cfg.kv_lora_rank, H * (cfg.qk_nope_head_dim + cfg.v_head_dim))
        dense(a + "o_proj", H * cfg.v_head_dim, hs)
        out.append((pre + "post_attention_layernorm.weight", (hs,), "ones"))
        if i < cfg.first_k_dense_replace:
            mlp(pre + "mlp.", cfg.intermediate_size)
        else:
            dense(pre + "mlp.gate", hs, E)
            out.append((pre + "mlp.gate.e_score_correction_bias", (E,), "bias"))
            out.append((pre + "mlp.experts.gate_up_proj", (E, 2 * inter, hs), "normal"))
            out.append((pre + "mlp.experts.down_proj", (E, hs, inter), "normal"))
            mlp(pre + "mlp.shared_experts.", cfg.n_shared_experts * inter)
    out.append((p + "norm.weight", (hs,), "ones"))
    return out


def make_weights(cfg, head: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in the config's parameter type (the correction bias
    in float32) on ``device`` from ``seed``, drawn in order of
    :func:`parameter_shapes` from one generator."""
    g = torch.Generator(torch.device(device)).manual_seed(int(seed) & ((1 << 63) - 1))
    dt = getattr(torch, cfg.param_dtype)
    out = {}
    for name, shape, init in parameter_shapes(cfg, head):
        if init == "ones":
            out[name] = torch.ones(shape, dtype=dt, device=device)
        elif init == "bias":
            out[name] = torch.randn(shape, generator=g, device=device).mul_(BIAS_STD)
        else:
            out[name] = torch.randn(shape, generator=g, dtype=dt, device=device).mul_(
                cfg.initializer_range)
    return out
