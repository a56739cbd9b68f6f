"""Weights of RecFormer on the ModernBERT backbone from the run's seed, made
on the device in one large draw as ``weights.py`` makes Longformer's: dense
kernels and embedding tables normal(0, initializer_range), LayerNorm scales
one, the decoder's bias zero; named as the program names them (Hugging Face
ModernBERT's names under the heads' ``longformer.`` prefix). No LayerNorm or
projection has a bias, as in ModernBERT."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

HEADS = ("pretrain", "seqrec")


def parameter_shapes(cfg, head: str) -> List[Tuple[str, tuple, str]]:
    """(name, shape, init) of every parameter, init one of 'normal',
    'zeros', 'ones'."""
    if head not in HEADS:
        raise ValueError(f"unknown head {head!r}")
    hs, ff = cfg.hidden_size, cfg.intermediate_size
    out = []

    def dense(name, n_in, n_out):
        out.append((name + ".weight", (n_out, n_in), "normal"))

    def norm(name):
        out.append((name + ".weight", (hs,), "ones"))

    e = "longformer.embeddings."
    out += [(e + "tok_embeddings.weight", (cfg.vocab_size, hs), "normal"),
            (e + "token_type_embeddings.weight", (cfg.token_type_size, hs), "normal"),
            (e + "item_position_embeddings.weight", (cfg.max_item_embeddings, hs), "normal")]
    norm(e + "norm")
    for i in range(cfg.num_hidden_layers):
        p = f"longformer.layers.{i}."
        if i:
            norm(p + "attn_norm")
        dense(p + "attn.Wqkv", hs, 3 * hs)
        dense(p + "attn.Wo", hs, hs)
        norm(p + "mlp_norm")
        dense(p + "mlp.Wi", hs, 2 * ff)
        dense(p + "mlp.Wo", ff, hs)
    norm("longformer.final_norm")
    if head == "pretrain":
        dense("head.dense", hs, hs)
        norm("head.norm")
        out.append(("decoder.bias", (cfg.vocab_size,), "zeros"))
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
