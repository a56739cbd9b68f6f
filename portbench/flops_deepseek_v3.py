"""Operations and bytes of RecFormer on the deepseek_v3 backbone, from shapes
and valid-token counts: the yardstick of the ``moe8k`` cell's ``mfu`` and
roofline shares (``flops.py``'s conventions: valid tokens only, a
multiply-add two operations, a kernel's least time the larger of its
products over the bf16 peak and its bytes over HBM's rate).

- Projections per layer and valid token: ``q_proj`` (hs to H (dn + dr)),
  ``kv_a_proj_with_mqa`` (hs to latent + dr), ``kv_b_proj`` (latent to
  H (dn + dv)) and ``o_proj`` (H dv to hs).
- MLPs per valid token: ``2 * 3 * hs * w`` for each SwiGLU MLP the token
  passes: the dense layers' (w = ``intermediate_size``); on a routed layer
  its ``top_k`` experts (w = ``moe_intermediate_size``), the shared experts
  (w = ``n_shared_experts * moe_intermediate_size``) and the router
  (``2 * hs * E``).
- Causal attention per layer and sequence of ``n`` valid tokens: the
  scores and the weighted sum over the ``n (n + 1) / 2`` (query, key)
  pairs with ``j <= i``, ``2 H (dn + dr + dv)`` each.
- The grouped GEMMs of a routed layer over ``T`` valid tokens: the
  ``T * top_k`` rows' products (``2 * rows * 3 * hs * I``); as bytes, each
  expert's three matrices read once, and each row's input (hs), the first
  GEMM's output (2I), the second's input (I) and output (hs) read or
  written once.
- The causal attention kernel: its products; q and k (dn + dr), v and the
  output (dv) of each head of each valid token read or written once.
"""

from __future__ import annotations

import numpy as np

from .flops import ESIZE


def _projections(cfg) -> int:
    hs, H = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv, c = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    return 2 * (hs * H * (dn + dr) + hs * (c + dr) + c * H * (dn + dv) + H * dv * hs)


def _mlps(cfg, layer: int) -> int:
    hs, inter = cfg.hidden_size, cfg.moe_intermediate_size
    if layer < cfg.first_k_dense_replace:
        return 2 * 3 * hs * cfg.intermediate_size
    return (2 * 3 * hs * inter * cfg.num_experts_per_tok
            + 2 * 3 * hs * inter * cfg.n_shared_experts + 2 * hs * cfg.n_routed_experts)


def causal_pairs(n: np.ndarray) -> np.ndarray:
    n = np.asarray(n, np.int64)
    return n * (n + 1) // 2


def encoder_forward(cfg, n: np.ndarray) -> float:
    """Forward operations of the backbone over rows of ``n`` valid tokens."""
    n = np.asarray(n, np.int64)
    per_token = sum(_projections(cfg) + _mlps(cfg, i) for i in range(cfg.num_hidden_layers))
    return float(n.sum()) * per_token + cfg.num_hidden_layers * attn_work(cfg, n)[0]


def attn_work(cfg, n: np.ndarray):
    """(operations, bytes) of one layer's causal attention."""
    n = np.asarray(n, np.int64)
    H, es = cfg.num_attention_heads, ESIZE[cfg.dtype]
    dqk, dv = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim, cfg.v_head_dim
    ops = 2.0 * H * (dqk + dv) * float(causal_pairs(n).sum())
    return ops, float(es * H * (2 * dqk + 2 * dv) * n.sum())


def moe_gemm_work(cfg, n: np.ndarray):
    """(operations, bytes) of one routed layer's grouped GEMMs over rows of
    ``n`` valid tokens."""
    hs, inter, es = cfg.hidden_size, cfg.moe_intermediate_size, ESIZE[cfg.dtype]
    rows = float(np.asarray(n, np.int64).sum()) * cfg.num_experts_per_tok
    ops = 2.0 * rows * 3 * hs * inter
    weights = cfg.n_routed_experts * 3 * hs * inter
    return ops, float(es * (weights + rows * (2 * hs + 3 * inter)))
