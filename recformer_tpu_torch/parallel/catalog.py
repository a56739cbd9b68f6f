"""Row-sharded item catalog: exact ranks, top-k and the full-softmax loss.

Counterpart of ``recformer_tpu/parallel/catalog.py``. The ``(N, H)``
catalog is split by rows over a process group (the mesh's ``model_group``):
it is padded to a multiple of the group's size and rank ``m`` holds rows
``[m * n_local, (m + 1) * n_local)`` (:func:`shard_rows`). Every function
takes the true catalog size ``n_items`` and masks the padding rows
everywhere: ``-inf`` in the top-k and in the loss's log-sum-exp, and left
out of the greater-than count and of ``valid_length``. So the results equal
the dense ones at any catalog size, where the JAX package's top-k returns a
padding row (score 0) ahead of real items whose scores are all negative.

- :func:`sharded_rank`: each rank counts its valid scores strictly above
  the label's (found on its owner rank and summed in), counts are summed;
- :func:`sharded_topk`: a top-k on each rank, an all-gather of the
  ``k * n_ranks`` candidates and a final top-k (exact for any k);
- :func:`sharded_full_softmax_loss`: a log-sum-exp combined over ranks with
  a global stability max (taken without a gradient), the label's logit from
  its owner; differentiable in ``pooled`` (replicated: its cotangent is
  summed over the group) and in the shard;
- :func:`sharded_take`: catalog rows by global id (sampled negatives).
"""

from __future__ import annotations

import torch

from ..models.heads import similarity_scores
from ..training.metrics import MAX_VAL
from .collectives import copy_to, gather_list, group_rank, group_size, pmax, psum


def shard_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's rows of ``x`` after zero-padding its rows to a multiple
    of the group's size."""
    n, m = group_size(group), group_rank(group)
    n_local = -(-x.shape[0] // n)
    own = x[m * n_local:(m + 1) * n_local]
    if own.shape[0] == n_local:
        return own.contiguous()
    pad = torch.zeros((n_local - own.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([own, pad])


def _local(emb_shard, n_items, group):
    """(offset of this rank's first row, (n_local,) mask of its real rows)."""
    n_local = emb_shard.shape[0]
    offset = group_rank(group) * n_local
    real = torch.arange(offset, offset + n_local, device=emb_shard.device) < n_items
    return offset, real


def _owned(values, labels, offset):
    """``values[b, labels[b] - offset]`` where this rank owns the label,
    else 0."""
    n_local = values.shape[1]
    local = labels.long() - offset
    owns = (local >= 0) & (local < n_local)
    picked = torch.gather(values, 1, local.clamp(0, n_local - 1)[:, None])[:, 0]
    return torch.where(owns, picked, 0.0)


@torch.no_grad()
def sharded_rank(pooled, emb_shard, labels, temp: float, n_items: int, group):
    """(rank, valid_length), each ``(B,)`` float32: the label's exact rank
    over the whole catalog (0 = top-1) and the count of valid scores."""
    offset, real = _local(emb_shard, n_items, group)
    scores = similarity_scores(pooled.float(), emb_shard.float(), temp)  # (B, n_local)
    label_score = psum(_owned(scores, labels, offset), group)
    greater = ((scores > label_score[:, None]) & real).float().sum(1)
    valid = ((scores > -MAX_VAL) & real).float().sum(1)
    return psum(greater, group), psum(valid, group)


@torch.no_grad()
def sharded_topk(pooled, emb_shard, k: int, temp: float, n_items: int, group):
    """(scores ``(B, k)``, global ids ``(B, k)``) of the k best real items."""
    offset, real = _local(emb_shard, n_items, group)
    scores = similarity_scores(pooled.float(), emb_shard.float(), temp)
    scores = torch.where(real, scores, -torch.inf)
    # a shard may hold fewer than k rows; exactness only needs the pooled
    # candidates (n_ranks * k_local) to reach k
    local_scores, local_ids = torch.topk(scores, min(k, scores.shape[1]), dim=1)
    all_scores = torch.cat(gather_list(local_scores, group), dim=1)
    all_ids = torch.cat(gather_list(local_ids + offset, group), dim=1)
    best, pos = torch.topk(all_scores, k, dim=1)
    return best, torch.gather(all_ids, 1, pos)


def sharded_full_softmax_loss(pooled, emb_shard, labels, temp: float, n_items: int,
                              group) -> torch.Tensor:
    """Mean cross-entropy of the labels over the whole catalog."""
    offset, real = _local(emb_shard, n_items, group)
    logits = similarity_scores(copy_to(pooled, group).float(), emb_shard.float(), temp)
    logits = torch.where(real, logits, -torch.inf)
    # a stability shift only: its gradient contributions cancel in Z - label
    global_max = pmax(logits.max(dim=1).values, group)
    sumexp = torch.exp(logits - global_max[:, None]).sum(dim=1)
    z = torch.log(psum(sumexp, group)) + global_max
    return (z - psum(_owned(logits, labels, offset), group)).mean()


@torch.no_grad()
def sharded_take(emb_shard, ids, group) -> torch.Tensor:
    """Catalog rows ``ids`` (any shape of global ids), ``(*ids.shape, H)``:
    each owner contributes its rows and the rest zeros, summed over the
    group."""
    n_local = emb_shard.shape[0]
    local = ids.long() - group_rank(group) * n_local
    owns = (local >= 0) & (local < n_local)
    rows = emb_shard[local.clamp(0, n_local - 1)].float()
    return psum(torch.where(owns[..., None], rows, 0.0), group).to(emb_shard.dtype)
