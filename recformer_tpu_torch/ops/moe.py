"""Token routing to sparse experts: DeepSeek-V3's sigmoid router and a
dropless dispatch through grouped GEMMs.

:func:`route` takes the router's logits ``x @ gate.weight^T`` in float32,
the scores ``s = sigmoid(logits)``, chooses each token's ``top_k`` experts
by ``s + e_score_correction_bias`` (``n_group = topk_group = 1``: one
group), and weighs them by the chosen ``s`` over their sum (when
``norm_topk_prob``) times ``routed_scaling_factor``, as Hugging Face's
``DeepseekV3TopkRouter`` does. The bias moves the choice only, never the
weights.

:func:`routed_experts` then runs every token through all of its experts
(dropless: no capacity, no token dropped), with static shapes and no host
synchronisation, so that a CUDA graph captures it:

1. dispatch: the ``T * top_k`` (token, expert) rows sorted by expert
   (a stable sort on the device); the group ends (``offs``, int32, one per
   expert, cumulative) are ``searchsorted`` of the sorted ids, so an expert
   that gets no token has an empty group and nothing is counted on the
   host;
2. the expert GEMMs: the sorted rows' inputs gathered, then two grouped
   GEMMs over the stacked expert weights, ``gate_up_proj`` ``(E, 2I, hs)``
   and ``down_proj`` ``(E, hs, I)``, each reading ``offs`` on the device
   (:func:`grouped_mm`), with SwiGLU ``silu(g) * u`` between;
3. combine: each row's output back in (token, slot) order, times its
   weight and summed over the slots in float32, then cast to the compute
   type.

Padding rows are left out of the expert GEMMs: a padding token's rows get
the expert id ``E``, one past the last, so they sort after every valid row
and lie beyond ``offs[-1]``, where the grouped GEMM computes nothing. Their
outputs are never read (the combine writes 0 for a padding token, through
``torch.where``, so whatever the unwritten rows hold cannot leak), and no
valid token reads a padding token's state: padding trails, and the
attention is causal.

A batch of more than :data:`BLOCK_TOKENS` tokens runs in blocks of that
many, one after another, so that a request's routed rows fit beside the
weights: at (32, 8,192) four blocks of 65,536 tokens, each about 11 GB of
rows, intermediates and the float32 products.

On CUDA tensors :func:`grouped_mm` is PyTorch's grouped GEMM
(``F.grouped_mm``, or ``torch._grouped_mm`` where the public name is
missing; bf16 on sm_90), each call counted in ``moe.grouped_gemm``; on CPU
tensors its twin, :func:`grouped_mm_plain`, a loop over the experts'
slices of rows. Counters (``utils/profiling.py``): ``moe.launches`` (the
MoE layers' calls on CUDA tensors) and ``moe.grouped_gemm``; a replayed
CUDA graph adds the counts its capture recorded (``utils/graphs.py``).
Spans ``launch.moe`` (the routed experts' wrapper) and ``moe.route`` (the
router) record in eager and capturing calls.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import count, span, spanned

BLOCK_TOKENS = 65536


def route(x: torch.Tensor, gate_weight: torch.Tensor, correction_bias: torch.Tensor,
          top_k: int, scaling: float, norm_topk_prob: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(experts ``(T, top_k)`` int64, weights ``(T, top_k)`` float32) of the
    ``(T, hs)`` tokens ``x``; see the module's docstring."""
    with span("moe.route"):
        scores = F.linear(x.float(), gate_weight.float()).sigmoid()
        experts = torch.topk(scores + correction_bias.float(), top_k, dim=-1,
                             sorted=False).indices
        weights = scores.gather(1, experts)
        if norm_topk_prob:
            weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
        return experts, weights * scaling


def expert_offsets(experts: torch.Tensor, n_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, offs) of flat expert ids (values in ``[0, n_experts]``,
    ``n_experts`` marking a row to leave out): ``order`` sorts the rows by
    expert, stably; ``offs[e]`` (int32) is the end of expert ``e``'s group
    in that order. Everything stays on the device."""
    ids, order = torch.sort(experts, stable=True)
    bounds = torch.arange(1, n_experts + 1, device=experts.device, dtype=ids.dtype)
    return order, torch.searchsorted(ids, bounds).to(torch.int32)


def grouped_mm_plain(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``a[rows of group e] @ b[e]`` for each group, the rows past
    ``offs[-1]`` zero: the grouped GEMM as a loop over the experts."""
    out = a.new_zeros(a.shape[0], b.shape[-1])
    start = 0
    for e, end in enumerate(offs.tolist()):
        if end > start:
            out[start:end] = a[start:end] @ b[e]
        start = end
    return out


def grouped_mm(a: torch.Tensor, b: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """``(rows, K) x (E, K, N) -> (rows, N)``: each group of rows (ends
    ``offs``) times its expert's matrix. One grouped-GEMM launch on CUDA
    tensors (rows past ``offs[-1]`` are not computed), the plain loop on
    CPU tensors."""
    if not a.is_cuda:
        return grouped_mm_plain(a, b, offs)
    fn = getattr(F, "grouped_mm", None) or torch._grouped_mm
    count("moe.grouped_gemm")
    return fn(a, b, offs=offs)


def _block(x, valid, experts, weights, gate_up, down):
    T, K = experts.shape
    E, two_i, _ = gate_up.shape
    flat = torch.where(valid[:, None], experts, E).reshape(-1)
    order, offs = expert_offsets(flat, E)
    rows = x.index_select(0, torch.div(order, K, rounding_mode="floor"))
    h = grouped_mm(rows, gate_up.transpose(1, 2), offs)
    g, u = h.split(two_i // 2, dim=-1)
    y = grouped_mm(F.silu(g) * u, down.transpose(1, 2), offs)
    back = torch.empty_like(y).index_copy_(0, order, y).view(T, K, -1)
    out = (back * weights[..., None]).sum(1)  # bf16 rows times float32 weights: float32
    return torch.where(valid[:, None], out, 0.0).to(x.dtype)


@spanned("launch.moe")
def routed_experts(x: torch.Tensor, valid: torch.Tensor, experts: torch.Tensor,
                   weights: torch.Tensor, gate_up: torch.Tensor, down: torch.Tensor
                   ) -> torch.Tensor:
    """The routed experts' weighted sum ``(T, hs)`` in ``x``'s type for
    tokens ``x`` ``(T, hs)`` in the compute type, ``valid`` ``(T,)`` bool
    (False: padding, left out), their ``experts`` and ``weights`` from
    :func:`route`, and the stacked ``gate_up`` ``(E, 2I, hs)`` and ``down``
    ``(E, hs, I)`` weights in the compute type."""
    if x.is_cuda:
        count("moe.launches")
    T = x.shape[0]
    if T <= BLOCK_TOKENS:
        return _block(x, valid, experts, weights, gate_up, down)
    return torch.cat([_block(x[s:s + BLOCK_TOKENS], valid[s:s + BLOCK_TOKENS],
                             experts[s:s + BLOCK_TOKENS], weights[s:s + BLOCK_TOKENS],
                             gate_up, down)
                      for s in range(0, T, BLOCK_TOKENS)])
