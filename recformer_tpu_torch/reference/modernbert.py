"""RecFormer on ModernBERT, plainly: the reference the port's ModernBERT
backbone (``models/modernbert.py``) is held to. The backbone, its MLM head,
the pretraining loss and the ranking scores in float32 (TF32 off, set by
the caller) from a dict of parameters named as the port names them (Hugging
Face ModernBERT's names under the heads' ``longformer.`` prefix). Plain
PyTorch: it imports none of the port's modules and none of its kernels.

The equations (ModernBERT, Warner et al., arXiv:2412.13663, and
answerdotai/ModernBERT-large's config.json; RecFormer, arXiv:2305.13731):

- embeddings: ``tok_embeddings`` plus the token-type and item-position
  embeddings, then ``embeddings.norm``;
- each pre-LayerNorm layer: ``x + Wo(attention(attn_norm(x)))`` (layer 0:
  no ``attn_norm``), then ``x + mlp.Wo(gelu(a) * g)``, ``a, g`` the halves
  of ``mlp.Wi(mlp_norm(x))``; the fused ``Wqkv`` gives q, k and v; q and k
  are rotated by RoPE at positions ``0 .. L-1`` (theta ``global_rope_theta``
  on layers ``i % global_attn_every_n_layers == 0``, ``local_rope_theta`` on
  the others); a global layer's query attends to every non-padding key, a
  local layer's to those with ``|i - j| <= local_attention / 2``; scores
  scaled by ``1/sqrt(D)``;
- ``final_norm``; the pooled output is the first token's state;
- MLM head: ``head.dense``, GELU, ``head.norm``, the decoder tied to
  ``tok_embeddings`` with ``decoder.bias``;
- LayerNorms and projections have a bias only where the parameters hold
  one (none in ModernBERT-large but the decoder's); no dropout.

Departures from the published model, RecFormer's: the token-type and
item-position embeddings added to the word embedding before
``embeddings.norm``; pooling by the first token's state (RecFormer's CLS).

The attention runs in blocks of query rows against the keys they may see,
and under gradients each block and each layer is recomputed in the
backward (``torch.utils.checkpoint``), so that 8,192-token rows fit in
float32. The benchmark keeps a copy (``portbench/reference/modernbert.py``)
that adds an fp8 control.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

NEG = -1e30


class Numerics:
    """Float32 throughout: the hooks where the benchmark's copy rounds."""

    def q(self, x):
        return x

    def linear(self, x, w, b=None):
        y = x @ w.t()
        return y if b is None else y + b

    def einsum(self, eq, a, b):
        return torch.einsum(eq, a, b)


def normalize(z):
    return z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-8)


def info_nce(z1, z2, temp):
    sim = normalize(z1) @ normalize(z2).t() / temp
    return -torch.log_softmax(sim, dim=-1).diagonal().mean()


def masked_ce(logits, labels):
    return F.cross_entropy(logits, labels, reduction="mean")

BLOCK = 512  # query rows a block


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    y = (x - mu) / torch.sqrt(((x - mu) ** 2).mean(-1, keepdim=True) + eps) * w
    return y if b is None else y + b


def linear(P, name, x, num: Numerics):
    return num.linear(x, P[name + ".weight"], P.get(name + ".bias"))


def norm(P, name, cfg, x):
    return layer_norm(x, P[name + ".weight"], P.get(name + ".bias"), cfg.layer_norm_eps)


def rope(length, head_dim, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                          / head_dim)
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate(x, cos, sin):
    """(R, L, H, D) rotated by the (L, D) tables."""
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def _maybe_checkpoint(fn, *args):
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def attention(P, pre, cfg, x, mask, is_global, num: Numerics):
    """One layer's attention over (R, L, hs) rows with the (R, L) {0, 1}
    key mask; a padding row's output is never read by a valid one."""
    R, L, hs = x.shape
    H = cfg.num_attention_heads
    D = hs // H
    qkv = linear(P, pre + "attn.Wqkv", x, num).view(R, L, 3, H, D)
    theta = cfg.global_rope_theta if is_global else cfg.local_rope_theta
    cos, sin = rope(L, D, theta, x.device)
    q = num.q(rotate(qkv[:, :, 0], cos, sin)) / math.sqrt(D)
    k = num.q(rotate(qkv[:, :, 1], cos, sin))
    v = qkv[:, :, 2]
    half = cfg.local_attention // 2
    blk = min(BLOCK, L)

    def block(s0, qb, kb, vb, mb):
        k0 = 0 if is_global else max(s0 - half, 0)
        i = torch.arange(s0, s0 + qb.shape[1], device=x.device)[:, None]
        j = torch.arange(k0, k0 + kb.shape[1], device=x.device)[None, :]
        allowed = (mb != 0)[:, None, None, :]
        if not is_global:
            allowed = allowed & ((i - j).abs() <= half)[None, None]
        s = num.einsum("rthd,ruhd->rhtu", qb, kb)
        p = torch.softmax(torch.where(allowed, s, NEG), dim=-1)
        return num.einsum("rhtu,ruhd->rthd", p, vb)

    out = []
    for s0 in range(0, L, blk):
        k0, k1 = (0, L) if is_global else (max(s0 - half, 0), min(s0 + blk + half, L))
        out.append(_maybe_checkpoint(lambda *a, s0=s0: block(s0, *a), q[:, s0:s0 + blk],
                                     k[:, k0:k1], v[:, k0:k1], mask[:, k0:k1]))
    out = num.q(torch.cat(out, dim=1).reshape(R, L, hs))
    return linear(P, pre + "attn.Wo", out, num)


def layer(P, i, cfg, x, mask, num: Numerics):
    pre = f"longformer.layers.{i}."
    h = x if i == 0 else num.q(norm(P, pre + "attn_norm", cfg, x))
    x = num.q(x + attention(P, pre, cfg, h, mask, i % cfg.global_attn_every_n_layers == 0, num))
    a, g = linear(P, pre + "mlp.Wi", num.q(norm(P, pre + "mlp_norm", cfg, x)), num).chunk(2, -1)
    return num.q(x + linear(P, pre + "mlp.Wo", num.q(F.gelu(a) * g), num))


def encode(P, cfg, batch, ids, num: Numerics = Numerics()):
    """Hidden states (R, L, hs) of the backbone."""
    e = "longformer.embeddings."
    x = (P[e + "tok_embeddings.weight"][ids]
         + P[e + "token_type_embeddings.weight"][batch["token_type_ids"]]
         + P[e + "item_position_embeddings.weight"][batch["item_position_ids"]])
    x = num.q(norm(P, e + "norm", cfg, num.q(x)))
    mask = batch["attention_mask"]
    for i in range(cfg.num_hidden_layers):
        x = _maybe_checkpoint(lambda h, i=i: layer(P, i, cfg, h, mask, num), x)
    return num.q(norm(P, "longformer.final_norm", cfg, x))


def mlm_logits(P, cfg, hidden, num: Numerics):
    h = num.q(F.gelu(linear(P, "head.dense", hidden, num)))
    h = num.q(norm(P, "head.norm", cfg, h))
    return num.linear(h, P["longformer.embeddings.tok_embeddings.weight"], P.get("decoder.bias"))


def pretrain_loss(P, cfg, views, num: Numerics = Numerics()):
    """InfoNCE of the two views' pooled outputs plus ``mlm_weight`` times
    each view's MLM loss. ``views``: two (batch, corrupted ids, masked)
    triples; each view's clean and corrupted rows run as one forward."""
    pooled, mlm = [], 0.0
    for batch, corrupted, masked in views:
        B = batch["input_ids"].shape[0]
        both = {k: torch.cat([v, v]) for k, v in batch.items()}
        hidden = encode(P, cfg, both, torch.cat([batch["input_ids"], corrupted]), num)
        pooled.append(hidden[:B, 0])
        labels = batch["input_ids"][masked]
        mlm = mlm + cfg.mlm_weight * masked_ce(mlm_logits(P, cfg, hidden[B:][masked], num), labels)
    return info_nce(pooled[0], pooled[1], cfg.temp) + mlm


def scores(user, items, temp):
    return normalize(user) @ normalize(items).t() / temp
