"""Operations and bytes of RecFormer on the ModernBERT backbone, from shapes
and valid-token counts: the yardstick of the ``rank8k`` cell's ``mfu`` and
roofline shares (``flops.py``'s conventions: valid tokens only, a
multiply-add two operations, the attention kernels' least time the larger
of their products over the bf16 peak and their bytes over HBM's rate).

- Dense products per layer and valid token: ``Wqkv`` (3 hs^2), ``Wo``
  (hs^2), GeGLU's ``Wi`` (2 hs ff) and ``mlp.Wo`` (hs ff):
  ``2 (4 hs^2 + 3 hs ff)``.
- A global layer's attention per sequence of ``n`` valid tokens: the
  scores and the weighted sum over every pair, ``4 n^2 hs``.
- A local layer's attention: ``4 hs`` for each (query, key) pair of valid
  tokens with ``|i - j| <= local_attention / 2``.
- Kernel 1 at a local layer (no global column) reads q, k and v of every
  valid row, writes its output and reads two int32 masks a token; the
  global op reads q, k, v, writes its output and reads the key mask.
"""

from __future__ import annotations

import numpy as np

from .flops import ESIZE


def band_pairs(n: np.ndarray, window: int) -> np.ndarray:
    """Ordered (query, key) pairs of ``n`` valid tokens with
    ``|i - j| <= window / 2``."""
    n = np.asarray(n, np.int64)
    d = np.minimum(window // 2, np.maximum(n - 1, 0))
    return n + 2 * (d * n - d * (d + 1) // 2)


def encoder_forward(cfg, n: np.ndarray) -> float:
    """Forward operations of the backbone over rows of ``n`` valid tokens."""
    n = np.asarray(n, np.int64)
    hs, ff = cfg.hidden_size, cfg.intermediate_size
    layers = cfg.num_hidden_layers
    n_global = sum(1 for i in range(layers) if i % cfg.global_attn_every_n_layers == 0)
    total = layers * float(n.sum()) * 2 * (4 * hs * hs + 3 * hs * ff)
    total += n_global * 4.0 * hs * float((n * n).sum())
    total += (layers - n_global) * 4.0 * hs * float(band_pairs(n, cfg.local_attention).sum())
    return total


def local_attn_work(cfg, n: np.ndarray):
    """(operations, bytes) of one kernel-1 launch at a local layer."""
    n = np.asarray(n, np.int64)
    hs, es = cfg.hidden_size, ESIZE[cfg.dtype]
    ops = 4.0 * hs * float(band_pairs(n, cfg.local_attention).sum())
    return ops, float((es * hs * 4 * n + 4 * 2 * n).sum())


def global_attn_work(cfg, n: np.ndarray):
    """(operations, bytes) of one global layer's attention."""
    n = np.asarray(n, np.int64)
    hs, es = cfg.hidden_size, ESIZE[cfg.dtype]
    return 4.0 * hs * float((n * n).sum()), float((es * hs * 4 * n + n).sum())
