"""Weights from the run's seed, made on the device in one large draw: dense
kernels and embedding tables normal(0, initializer_range), biases zero,
LayerNorm scales one (the initialisers of the JAX package and of HF
Longformer). Named as HF Longformer names its parameters, which is how the
program's models and the reference both take them.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

HEADS = ("pretrain", "seqrec", "fraud")


def parameter_shapes(cfg, head: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, init one of 'normal',
    'zeros', 'ones'."""
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}")
    hs, ff = cfg.hidden_size, cfg.intermediate_size
    e = "longformer.embeddings."
    out = [(e + "word_embeddings.weight", (cfg.vocab_size, hs), "normal"),
           (e + "position_embeddings.weight", (cfg.max_position_embeddings, hs), "normal"),
           (e + "token_type_embeddings.weight", (cfg.token_type_size, hs), "normal"),
           (e + "item_position_embeddings.weight", (cfg.max_item_embeddings, hs), "normal"),
           (e + "LayerNorm.weight", (hs,), "ones"), (e + "LayerNorm.bias", (hs,), "zeros")]

    def dense(name, n_in, n_out):
        out.extend([(name + ".weight", (n_out, n_in), "normal"), (name + ".bias", (n_out,), "zeros")])

    def ln(name):
        out.extend([(name + ".weight", (hs,), "ones"), (name + ".bias", (hs,), "zeros")])

    for i in range(cfg.num_hidden_layers):
        p = f"longformer.encoder.layer.{i}."
        for n in ("query", "key", "value", "query_global", "key_global", "value_global"):
            dense(p + "attention.self." + n, hs, hs)
        dense(p + "attention.output.dense", hs, hs)
        ln(p + "attention.output.LayerNorm")
        dense(p + "intermediate.dense", hs, ff)
        dense(p + "output.dense", ff, hs)
        ln(p + "output.LayerNorm")
    if head == "pretrain":
        dense("lm_head.dense", hs, hs)
        ln("lm_head.layer_norm")
        out.append(("lm_head.bias", (cfg.vocab_size,), "zeros"))
    elif head == "fraud":
        dense("fc1", hs, hs // 2)
        dense("fc2", hs // 2, hs // 4)
        dense("fc3", hs // 4, 1)
    return out


def make_weights(cfg, head: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every parameter in float32 on ``device`` from ``seed``."""
    spec = parameter_shapes(cfg, head)
    numel = [int(torch.Size(s).numel()) for _, s, _ in spec]
    n_normal = sum(n for n, (_, _, init) in zip(numel, spec) if init == "normal")
    g = torch.Generator(torch.device(device)).manual_seed(int(seed) & ((1 << 63) - 1))
    flat = torch.randn(n_normal, generator=g, device=device).mul_(cfg.initializer_range)
    out, at = {}, 0
    for (name, shape, init), n in zip(spec, numel):
        if init == "normal":
            out[name] = flat[at:at + n].view(shape)
            at += n
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return out
