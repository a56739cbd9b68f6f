"""Operations and bytes that the inputs need, from shapes and valid-token
counts: the yardstick of the ``mfu.*`` and ``*_roofline_pct.*`` metrics.

Everything is counted over valid tokens only (a sequence of ``n`` valid
tokens: ``<s>``, the one global token, at position 0 and ``n - 1`` local
ones after it), so a program that stops computing padding is judged against
the same work. A multiply-add is two operations.

- Dense products per layer and valid token: the four attention projections
  and the feed-forward block, ``8 hs^2 + 4 hs ff``.
- Global attention per layer, in the reassociated ("thin") form, the least
  the layer's function needs: per sequence the global query, ``W_kg^T q_g``
  and the output projection (``6 hs^2``); per valid token the global
  scores and the probability-weighted sum (``4 hs nh``).
- Local attention per layer: ``4 D`` per head for each (local query,
  attended key) pair: the valid local keys within ``window / 2`` and the
  global key.
- MLM head at each masked position: the transform and the tied decoder,
  ``2 hs^2 + 2 hs V``; the contrastive and scoring products; the fraud MLP.
- Training counts three times the forward; recomputation is not counted.

The attention kernels' least time: each input byte read once and each
output byte written once, for valid rows and keys only, over 3.35 TB/s,
against the products over 989 TFLOP/s; the larger of the two.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM5 data sheet, dense (no sparsity)
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
ESIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def valid_tokens(table_lengths: np.ndarray, item_ids: np.ndarray, seq_lens: np.ndarray,
                 out_len: int, max_items: int) -> np.ndarray:
    """Valid tokens of each assembled row: ``<s>`` and the newest
    ``max_items`` items' tokens, cut at ``out_len``."""
    S = item_ids.shape[1]
    slot = np.arange(max_items)[None, :]
    src = seq_lens[:, None].astype(np.int64) - 1 - slot
    ok = src >= 0
    ids = np.take_along_axis(item_ids, np.clip(src, 0, S - 1), axis=1)
    lens = np.where(ok, table_lengths[ids], 0).sum(axis=1)
    return np.minimum(1 + lens, out_len).astype(np.int64)


def local_pairs(n: np.ndarray, window: int) -> np.ndarray:
    """(local query, attended key) pairs of sequences of ``n`` valid
    tokens: each local query i in [1, n) takes the local keys j in [1, n)
    with |i - j| <= window / 2, and the global key."""
    c = np.maximum(np.asarray(n, np.int64) - 1, 0)  # local tokens
    d = np.minimum(window // 2, np.maximum(c - 1, 0))
    band = c + 2 * (d * c - d * (d + 1) // 2)  # ordered pairs |i - j| <= window / 2
    return band + c


def encoder_forward(cfg, n: np.ndarray) -> float:
    """Forward operations of the backbone over rows of ``n`` valid tokens."""
    n = np.asarray(n, np.int64)
    hs, ff, nh = cfg.hidden_size, cfg.intermediate_size, cfg.num_attention_heads
    layers = len(cfg.attention_window)
    total = layers * (float(n.sum()) * (8 * hs * hs + 4 * hs * ff + 4 * hs * nh)
                      + float(n.size) * 6 * hs * hs)
    for w in cfg.attention_window:
        total += 4.0 * hs * float(local_pairs(n, w).sum())
    return total


def mlm_head_forward(cfg, n_masked: int) -> float:
    hs = cfg.hidden_size
    return float(n_masked) * (2 * hs * hs + 2 * hs * cfg.vocab_size)


def contrastive_forward(cfg, batch: int) -> float:
    return 2.0 * batch * batch * cfg.hidden_size


def fraud_head_forward(cfg, batch: int) -> float:
    hs = cfg.hidden_size
    return 2.0 * batch * (hs * (hs // 2) + (hs // 2) * (hs // 4) + hs // 4)


def scoring_forward(cfg, users: int, items: int) -> float:
    return 2.0 * users * items * cfg.hidden_size


TRAIN_FACTOR = 3.0


def attn_fwd_work(cfg, n: np.ndarray, window: int):
    """(operations, bytes) of one forward-kernel launch over rows of ``n``
    valid tokens: q, k, v of the local rows, the global key, value and
    row, the two int32 masks and the global flag read; every valid row's
    output written."""
    n = np.asarray(n, np.int64)
    hs, es = cfg.hidden_size, ESIZE[cfg.dtype]
    ops = 4.0 * hs * float(local_pairs(n, window).sum())
    nbytes = float((es * hs * (3 * (n - 1) + n + 3) + 4 * 2 * n + 4).sum())
    return ops, nbytes


def attn_bwd_work(cfg, n: np.ndarray, window: int):
    """(operations, bytes) of one backward-kernel launch: q, k, v and the
    masks of the valid rows, the output gradient of every valid row, the
    global key, value and row read; dq, dk, dv of the local rows and the
    float32 global gradients written. Five products a pair: the scores
    again, dP, dV, dQ, dK."""
    n = np.asarray(n, np.int64)
    hs, es = cfg.hidden_size, ESIZE[cfg.dtype]
    ops = 10.0 * hs * float(local_pairs(n, window).sum())
    nbytes = float((es * hs * (3 * (n - 1) + n + 3 + 3 * (n - 1)) + 4 * 3 * hs
                    + 4 * 2 * n + 4).sum())
    return ops, nbytes


def least_seconds(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16_FLOPS, nbytes / HBM_BYTES_PER_S)
