"""Full bidirectional attention with key padding: ModernBERT's global layers.

Every query attends to every key whose ``key_mask`` is nonzero; scores are
scaled by ``1/sqrt(D)`` and softmaxed in float32. Layout as the band op's:
q, k, v ``(B, L, H, D)`` in the compute type (q and k already rotated by
RoPE), ``key_mask`` ``(B, L)``, output ``(B, L, H, D)``. A padding query
attends like any other (its row is never read by a valid one).

On CUDA tensors the op is ``F.scaled_dot_product_attention`` with the
padding as a boolean ``(B, 1, 1, L)`` mask, restricted to the fused
backends that take such a mask (cuDNN's and the memory-efficient one):
neither materialises the ``(B, H, L, L)`` scores, and the math backend,
which would (about 69 GB at (32, 8,192)), is never chosen; a shape neither
fused backend takes raises instead. Its backward is the fused backend's.
On CPU tensors the op is the plain masked softmax,
:func:`full_attention_plain`, differentiated by autograd.

Counters (``utils/profiling.py``): ``global_attn.launches`` counts the CUDA
calls and ``global_attn.fused`` those for which PyTorch's backend choice,
asked under the same restriction, names a fused backend; a replayed CUDA
graph adds the counts its capture recorded (``utils/graphs.py``). The
span ``launch.global_attn`` covers the wrapper in eager and capturing calls.
A hand-written Hopper kernel for this op is left for later work.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..utils.profiling import count, spanned
from .attention import NEG_INF, attention_scale


def full_attention_plain(q, k, v, key_mask):
    """The masked softmax in plain PyTorch: float32 scores of the scaled
    queries (``q * scale`` in the compute type), float32 softmax, the
    probabilities in the compute type against V with float32 sums.
    ``key_mask`` is ``(B, L)`` over the keys, or ``(B, L, L)`` over (query,
    key) pairs (a band)."""
    dt = q.dtype
    scale = attention_scale(q.shape[-1], dt, q.device)
    allowed = key_mask != 0
    allowed = allowed[:, None, None, :] if allowed.dim() == 2 else allowed[:, None]
    scores = torch.einsum("blhd,bmhd->bhlm", (q * scale).float(), k.float())
    scores = torch.where(allowed, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhlm,bmhd->blhd", probs.to(dt).float(), v.float()).to(dt)


@spanned("launch.global_attn")
def _launch(q, k, v, key_mask):
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, L, D)
    mask = (key_mask != 0)[:, None, None, :]
    with sdpa_kernel([SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION]):
        choice = torch._fused_sdp_choice(qt, kt, vt, mask, 0.0, False)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    count("global_attn.launches")
    count("global_attn.fused", int(choice not in (SDPBackend.MATH.value, SDPBackend.ERROR.value)))
    return out.transpose(1, 2)


def full_attention(q, k, v, key_mask):
    """Full attention over the keys with ``key_mask`` nonzero (see the
    module's docstring): the fused backends on CUDA, the plain twin on the
    CPU."""
    if q.is_cuda:
        return _launch(q, k, v, key_mask)
    if q.device.type != "cpu":
        raise ValueError(f"full attention runs on CUDA or CPU tensors, got {q.device}")
    return full_attention_plain(q, k, v, key_mask)
