"""RecFormer, plainly: the Longformer encoder with windowed and global
attention, its embeddings, the CLS pooler, the MLM head, the contrastive,
MLM and fraud losses, in float32 (TF32 off) from a dict of parameters
named as HF Longformer names them.

The equations (Beltagy et al., arXiv:2004.05150; RecFormer, arXiv:2305.13731):

- embeddings: word + position + token type + item position, LayerNorm,
  dropout; positions count the non-pad tokens from ``pad_id + 1``;
- each post-LayerNorm layer: a local token i attends, with the ``query``,
  ``key`` and ``value`` projections, to the local tokens j with
  ``|i - j| <= window / 2`` and to the global tokens; a global token
  attends to every token with the ``*_global`` projections; padding
  attends to nothing and gives 0; scores are scaled by ``1/sqrt(D)``;
  dropout on the probabilities; then the output projection, dropout, the
  residual and LayerNorm; the feed-forward block (tanh GELU) likewise;
- pooled output: the ``<s>`` token's hidden state.

Dropout draws come from :class:`~.rng.StepDraws` in the program's order
(``None``: no dropout). ``precision='fp8'`` rounds both operands of every
product to float8 e4m3 with one scale a tensor: the control that has to
fail the comparison.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .rng import StepDraws, attention_keep

NEG = -1e30


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one scale for the tensor (its largest
    magnitude at e4m3's largest finite value, 448)."""
    s = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class _RoundFP8(torch.autograd.Function):
    """fp8 rounding of a value in the forward and of its gradient in the
    backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


class Numerics:
    """Where the program holds a value in its compute type, the reference
    holds it in float32 (``'fp32'``), or rounds it, and its gradient, to
    fp8 (``'fp8'``, the control): every product's operands and output, the
    embeddings, the residual sums, the LayerNorms' and GELUs' outputs, the
    attention's output."""

    def __init__(self, precision: str = "fp32"):
        if precision not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _RoundFP8.apply(x) if self.fp8 else x

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).t()
        return self.q(y if b is None else y + b)

    def einsum(self, eq, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))


def layer_norm(x, w, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def dropout(x, rate, draws: Optional[StepDraws]):
    if draws is None or rate <= 0.0:
        return x
    u = draws.rand(*x.shape)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate), 0.0)


def gelu(x, act):
    if act == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if act == "gelu":
        return F.gelu(x)
    return F.relu(x)


def embed(P, cfg, batch, ids, draws, num: Numerics):
    e = "longformer.embeddings."
    mask = (ids != cfg.pad_token_id).long()
    pos = torch.cumsum(mask, 1) * mask + cfg.pad_token_id
    x = (P[e + "word_embeddings.weight"][ids] + P[e + "position_embeddings.weight"][pos]
         + P[e + "token_type_embeddings.weight"][batch["token_type_ids"]]
         + P[e + "item_position_embeddings.weight"][batch["item_position_ids"]])
    x = num.q(layer_norm(num.q(x), P[e + "LayerNorm.weight"], P[e + "LayerNorm.bias"],
                         cfg.layer_norm_eps))
    return num.q(dropout(x, cfg.hidden_dropout_prob, draws))


def attention(P, pre, cfg, x, mask, window, draws, num: Numerics):
    """One layer's self-attention over (R, L, hs) with the {0, 1, 2} mask;
    the one global token is ``<s>`` at position 0."""
    R, L, hs = x.shape
    H = cfg.num_attention_heads
    D = hs // H
    s = pre + "attention.self."
    rate = cfg.attention_probs_dropout_prob if draws is not None else 0.0
    scale = 1.0 / math.sqrt(D)

    def proj(name, inp):
        return num.linear(inp, P[s + name + ".weight"], P[s + name + ".bias"])

    q = proj("query", x).view(R, L, H, D) * scale
    k = proj("key", x).view(R, L, H, D)
    v = proj("value", x).view(R, L, H, D)

    # the global row: attends to every non-padding token
    qg = proj("query_global", x[:, 0]).view(R, H, D) * scale
    kg = proj("key_global", x).view(R, L, H, D)
    vg = proj("value_global", x).view(R, L, H, D)
    sg = num.einsum("rhd,rlhd->rhl", qg, kg)
    sg = torch.where((mask == 0)[:, None, :], NEG, sg)
    pg = torch.softmax(sg, dim=-1)
    if rate > 0.0:
        pg = dropout(pg[:, :, None, :], rate, draws)[:, :, 0, :]
    out_g = num.einsum("rhl,rlhd->rhd", pg, vg)

    # local rows: blocks of ``blk`` queries against their band of keys,
    # plus the global key (the local projections at position 0)
    half = window // 2
    blk = min(64, L)
    nb = L // blk
    band = blk + 2 * half
    kpos = (torch.arange(nb, device=x.device)[:, None] * blk
            + torch.arange(band, device=x.device)[None, :] - half)  # (nb, band)
    kin = (kpos >= 0) & (kpos < L)
    kc = kpos.clamp(0, L - 1)
    qpos = torch.arange(L, device=x.device).view(nb, blk)
    near = (qpos[:, :, None] - kpos[:, None, :]).abs() <= half  # (nb, blk, band)
    key_local = (mask[:, kc] == 1) & kin[None]  # (R, nb, band)
    allowed = near[None] & key_local[:, :, None, :]  # (R, nb, blk, band)
    qb = q.view(R, nb, blk, H, D)
    s_band = num.einsum("rnthd,rnuhd->rnhtu", qb, k[:, kc])
    s_band = torch.where(allowed[:, :, None], s_band, NEG)
    s_glob = num.einsum("rnthd,rhd->rnht", qb, k[:, 0])[..., None]
    s_glob = torch.where((mask[:, 0] == 2)[:, None, None, None, None], s_glob, NEG)
    p = torch.softmax(torch.cat([s_band, s_glob], dim=-1), dim=-1)
    if rate > 0.0:
        seed = draws.kernel_seed()
        dv = x.device
        bi = torch.arange(R, device=dv).view(R, 1, 1, 1, 1)
        hi = torch.arange(H, device=dv).view(1, 1, H, 1, 1)
        ii = qpos.view(1, nb, 1, blk, 1).to(torch.int64)
        cols = torch.cat([kc, torch.full((nb, 1), L, device=dv)], dim=1)
        ci = cols.view(1, nb, 1, 1, band + 1).to(torch.int64)
        keep = attention_keep(seed, rate, bi, hi, ii, ci)
        p = torch.where(keep, p / (1.0 - rate), 0.0)
    out = (num.einsum("rnhtu,rnuhd->rnthd", p[..., :band], v[:, kc])
           + num.einsum("rnht,rhd->rnthd", p[..., band], v[:, 0]))
    out = out.reshape(R, L, H, D)
    out = torch.where((mask == 2)[:, :, None, None], out_g[:, None], out)
    out = torch.where((mask == 0)[:, :, None, None], 0.0, out)
    return num.q(out.reshape(R, L, hs))


def block_out(P, name, cfg, h, residual, draws, num):
    y = num.linear(h, P[name + "dense.weight"], P[name + "dense.bias"])
    y = num.q(dropout(y, cfg.hidden_dropout_prob, draws) + residual)
    return num.q(layer_norm(y, P[name + "LayerNorm.weight"], P[name + "LayerNorm.bias"],
                            cfg.layer_norm_eps))


def encode(P, cfg, batch, ids, draws=None, num: Numerics = Numerics()):
    """Hidden states (R, L, hs) of the backbone."""
    mask = batch["attention_mask"] * (batch["global_attention_mask"] + 1)
    x = embed(P, cfg, batch, ids, draws, num)
    for i, w in enumerate(cfg.attention_window):
        pre = f"longformer.encoder.layer.{i}."
        a = attention(P, pre, cfg, x, mask, w, draws, num)
        x = block_out(P, pre + "attention.output.", cfg, a, x, draws, num)
        f = num.q(gelu(num.linear(x, P[pre + "intermediate.dense.weight"],
                                  P[pre + "intermediate.dense.bias"]), cfg.hidden_act))
        x = block_out(P, pre + "output.", cfg, f, x, draws, num)
    return x


def mlm_logits(P, cfg, hidden, num: Numerics):
    h = num.linear(hidden, P["lm_head.dense.weight"], P["lm_head.dense.bias"])
    h = num.q(layer_norm(num.q(gelu(h, cfg.hidden_act)), P["lm_head.layer_norm.weight"],
                         P["lm_head.layer_norm.bias"], cfg.layer_norm_eps))
    return num.linear(h, P["longformer.embeddings.word_embeddings.weight"], P["lm_head.bias"])


def normalize(z):
    return z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-8)


def info_nce(z1, z2, temp):
    sim = normalize(z1) @ normalize(z2).t() / temp
    return -torch.log_softmax(sim, dim=-1).diagonal().mean()


def masked_ce(logits, labels):
    return F.cross_entropy(logits, labels, reduction="mean")


def pretrain_loss(P, cfg, views, draws, num: Numerics):
    """InfoNCE of the two views' pooled outputs plus ``mlm_weight`` times
    each view's MLM loss. ``views``: two (batch, corrupted ids, masked)
    triples; each view's clean and corrupted rows run as one forward."""
    pooled, mlm = [], 0.0
    for batch, corrupted, masked in views:
        B = batch["input_ids"].shape[0]
        both = {k: torch.cat([v, v]) for k, v in batch.items()}
        hidden = encode(P, cfg, both, torch.cat([batch["input_ids"], corrupted]), draws, num)
        pooled.append(hidden[:B, 0])
        hm = hidden[B:][masked]
        labels = batch["input_ids"][masked]
        mlm = mlm + cfg.mlm_weight * masked_ce(mlm_logits(P, cfg, hm, num), labels)
    return info_nce(pooled[0], pooled[1], cfg.temp) + mlm


FRAUD_DROPOUT = 0.2


def fraud_logits(P, cfg, batch, draws, num: Numerics):
    z = encode(P, cfg, batch, batch["input_ids"], draws, num)[:, 0]
    z = dropout(z, cfg.hidden_dropout_prob, draws)
    z = dropout(F.relu(num.linear(z, P["fc1.weight"], P["fc1.bias"])), FRAUD_DROPOUT, draws)
    z = dropout(F.relu(num.linear(z, P["fc2.weight"], P["fc2.bias"])), FRAUD_DROPOUT, draws)
    return num.linear(z, P["fc3.weight"], P["fc3.bias"])[:, 0]


def fraud_loss(logits, labels, valid, pos_weight):
    """BCE with ``pos_weight`` over the valid rows."""
    per = F.binary_cross_entropy_with_logits(
        logits, labels, pos_weight=torch.tensor(pos_weight, device=logits.device),
        reduction="none")
    w = valid.float()
    return (per * w).sum() / w.sum().clamp_min(1.0)


def scores(user, items, temp):
    return normalize(user) @ normalize(items).t() / temp


def as_params(weights: Dict[str, torch.Tensor], grad: bool) -> Dict[str, torch.Tensor]:
    return {k: v.detach().float().clone().requires_grad_(grad) for k, v in weights.items()}
