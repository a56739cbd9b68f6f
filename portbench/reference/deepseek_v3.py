"""RecFormer on DeepSeek-V3's decoder, plainly: the backbone, its last-token
pooling and the ranking scores, in float32 (TF32 off) from a dict of
parameters named as the program names them (Hugging Face's names under the
heads' ``longformer.`` prefix, the routed experts stacked).
The equations (DeepSeek-AI, arXiv:2412.19437; moonshotai/Moonlight-16B-A3B's
config.json; Hugging Face ``DeepseekV3Model``):

- embeddings: ``embed_tokens`` (no norm after);
- each pre-RMSNorm layer: ``x + o_proj(attn(input_layernorm(x)))``, then
  ``x + mlp(post_attention_layernorm(x))``; RMSNorm
  ``w * x / sqrt(mean(x^2) + eps)``;
- latent attention: ``q_proj`` gives each head ``[q_nope, q_rot]``;
  ``kv_a_proj_with_mqa`` gives ``[c, k_rot]`` (``k_rot`` one for all
  heads); ``kv_b_proj(kv_a_layernorm(c))`` gives each head
  ``[k_nope, v]``; ``q_rot`` and ``k_rot`` are read as adjacent pairs
  ``(2i, 2i + 1)``, laid out with the pairs' first members first and
  rotated by RoPE at positions ``0 .. L-1`` (theta ``rope_theta``,
  ``rotate_half`` over that layout); a query ``i`` sees the keys ``j <= i``
  (an explicit causal mask) that are not padding; scores
  ``[q_nope, q_rot] . [k_nope, k_rot] / sqrt(qk_nope + qk_rope)``;
- layers ``< first_k_dense_replace``: ``down(silu(gate(x)) * up(x))``;
  the others: router scores ``sigmoid(x @ gate^T)``, the ``top_k`` experts
  by score plus ``e_score_correction_bias``, weights the chosen scores over
  their sum times ``routed_scaling_factor``, each chosen expert's SwiGLU
  output times its weight summed (a loop over the experts), plus the
  shared SwiGLU MLP;
- ``norm``; the pooled output is the last valid token's state.

Departures from the published model, RecFormer's: the token-type and
item-position embeddings added to ``embed_tokens``; the pooled output of a
causal decoder read at the last valid token (as HLLM, arXiv:2409.12740,
pools its user LLM).

The parameters come as the program holds them (bf16 values of the
published precision); each layer's are upcast to float32 when the layer
runs and dropped after, so the model fits on one card in its bf16 form.
A row's states depend only on the rows before it, and padding trails, so
:func:`encode` runs each group of rows cut to its longest valid length;
the attention runs in blocks of query rows. ``Numerics('fp8')`` is the
control (``model.Numerics``). :func:`embed`, :func:`layer` and
:func:`final_norm` are also called one at a time, on the program's own
states, by the Moonlight cell's layer-by-layer check.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .model import NEG, Numerics, normalize

BLOCK = 512  # query rows a block


def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def rope(length, dim, theta, device):
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim)
    ang = torch.arange(length, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate(x, cos, sin):
    """(R, L, H, D) adjacent pairs, de-interleaved and rotated by the
    (L, D) tables."""
    R, L, H, D = x.shape
    x = x.view(R, L, H, D // 2, 2).transpose(-1, -2).reshape(R, L, H, D)
    rot = torch.cat([-x[..., D // 2:], x[..., :D // 2]], dim=-1)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def swiglu(W, pre, x, num: Numerics):
    h = num.q(F.silu(num.linear(x, W[pre + "gate_proj.weight"]))
              * num.linear(x, W[pre + "up_proj.weight"]))
    return num.linear(h, W[pre + "down_proj.weight"])


def attention(W, cfg, x, mask, num: Numerics):
    """One layer's latent attention over (R, L, hs) rows with the (R, L)
    {0, 1} key mask."""
    R, L, _ = x.shape
    H, dn, dr, dv = (cfg.num_attention_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                     cfg.v_head_dim)
    q = num.linear(x, W["self_attn.q_proj.weight"]).view(R, L, H, dn + dr)
    ckv = num.linear(x, W["self_attn.kv_a_proj_with_mqa.weight"])
    c, k_rot = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    c = num.q(rms_norm(c, W["self_attn.kv_a_layernorm.weight"], cfg.rms_norm_eps))
    kv = num.linear(c, W["self_attn.kv_b_proj.weight"]).view(R, L, H, dn + dv)
    cos, sin = rope(L, dr, cfg.rope_theta, x.device)
    q_rot = rotate(q[..., dn:], cos, sin)
    k_rot = rotate(k_rot.view(R, L, 1, dr), cos, sin).expand(R, L, H, dr)
    q = num.q(torch.cat([q[..., :dn], q_rot], dim=-1)) / math.sqrt(dn + dr)
    k = num.q(torch.cat([kv[..., :dn], k_rot], dim=-1))
    v = kv[..., dn:]
    out = []
    for s0 in range(0, L, BLOCK):
        i = torch.arange(s0, min(s0 + BLOCK, L), device=x.device)[:, None]
        j = torch.arange(L, device=x.device)[None, :]
        allowed = (mask != 0)[:, None, None, :] & (j <= i)[None, None]
        s = num.einsum("rthd,ruhd->rhtu", q[:, s0:s0 + BLOCK], k)
        p = torch.softmax(torch.where(allowed, s, NEG), dim=-1)
        out.append(num.einsum("rhtu,ruhd->rthd", p, v))
    out = num.q(torch.cat(out, dim=1).reshape(R, L, H * dv))
    return num.linear(out, W["self_attn.o_proj.weight"])


def route(W, cfg, x):
    """(experts (T, top_k), weights (T, top_k)) of rows ``x`` (T, hs)."""
    s = torch.sigmoid(x @ W["mlp.gate.weight"].t())
    idx = torch.topk(s + W["mlp.gate.e_score_correction_bias"], cfg.num_experts_per_tok,
                     dim=-1).indices
    w = s.gather(1, idx)
    if cfg.norm_topk_prob:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    return idx, w * cfg.routed_scaling_factor


def moe(W, cfg, x, num: Numerics):
    """The routed experts, one at a time over the rows that chose them,
    plus the shared experts."""
    shape = x.shape
    x = x.reshape(-1, shape[-1])
    idx, w = route(W, cfg, x)
    out = torch.zeros_like(x)
    inter = cfg.moe_intermediate_size
    for e in range(cfg.n_routed_experts):
        tok, slot = torch.where(idx == e)
        if tok.numel() == 0:
            continue
        gate_up = W["mlp.experts.gate_up_proj"][e]
        xe = x[tok]
        h = num.q(F.silu(num.linear(xe, gate_up[:inter])) * num.linear(xe, gate_up[inter:]))
        y = num.linear(h, W["mlp.experts.down_proj"][e])
        out.index_add_(0, tok, y * w[tok, slot, None])
    out = num.q(out) + swiglu(W, "mlp.shared_experts.", x, num)
    return out.view(shape)


def layer_params(P, i):
    """Layer ``i``'s parameters, upcast to float32, named below the layer."""
    pre = f"longformer.layers.{i}."
    return {k[len(pre):]: v.float() for k, v in P.items() if k.startswith(pre)}


def layer(P, i, cfg, x, mask, num: Numerics):
    W = layer_params(P, i)
    h = num.q(rms_norm(x, W["input_layernorm.weight"], cfg.rms_norm_eps))
    x = num.q(x + attention(W, cfg, h, mask, num))
    h = num.q(rms_norm(x, W["post_attention_layernorm.weight"], cfg.rms_norm_eps))
    if i < cfg.first_k_dense_replace:
        return num.q(x + swiglu(W, "mlp.", h, num))
    return num.q(x + moe(W, cfg, h, num))


def embed(P, batch, n, num: Numerics = Numerics()):
    """(R, n, hs) embeddings of ``batch``'s rows cut to ``n``: the three
    tables' rows summed."""
    e = "longformer."

    def table(name, ids):
        return P[e + name + ".weight"][ids[:, :n]].float()

    return num.q(table("embed_tokens", batch["input_ids"])
                 + table("token_type_embeddings", batch["token_type_ids"])
                 + table("item_position_embeddings", batch["item_position_ids"]))


def final_norm(P, cfg, x, num: Numerics = Numerics()):
    return num.q(rms_norm(x, P["longformer.norm.weight"].float(), cfg.rms_norm_eps))


@torch.no_grad()
def encode(P, cfg, batch, num: Numerics = Numerics(), states=None):
    """(hidden (R, n, hs), pooled (R, hs)) of the backbone over the rows of
    ``batch``, cut to ``n``, the longest valid length among them. A list
    ``states`` receives the embeddings and each layer's output."""
    mask = batch["attention_mask"]
    n = max(int(mask.sum(1).max()), 1)
    x = embed(P, batch, n, num)
    mask = mask[:, :n]
    if states is not None:
        states.append(x)
    for i in range(cfg.num_hidden_layers):
        x = layer(P, i, cfg, x, mask, num)
        if states is not None:
            states.append(x)
    x = final_norm(P, cfg, x, num)
    last = (mask.sum(1) - 1).clamp_min(0)
    return x, x[torch.arange(x.shape[0], device=x.device), last]


def scores(user, items, temp):
    return normalize(user) @ normalize(items).t() / temp
