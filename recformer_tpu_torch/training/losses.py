"""Pretraining, sequential-recommendation and fraud losses, in float32
whatever the compute type.

Counterparts of ``IGNORE_INDEX``, ``info_nce_loss``, ``mlm_loss``,
``seqrec_full_softmax_loss``, ``seqrec_sampled_softmax_loss``,
``bce_with_logits_loss`` and ``focal_loss`` in
``recformer_tpu/training/losses.py``, and ``gather_embeddings``. Given a
process group (the mesh's ``data_group``), :func:`info_nce_loss` takes its
negatives from every rank's rows (``gather_embeddings``): ``'full'``
through an all-gather whose backward is ``psum_scatter``, ``'local'`` with
the remote rows detached (the reference's ``models.py:475-490``), and
:func:`mlm_loss` divides by the group's total count of valid positions, so
that the per-rank terms sum to the one-device loss of the whole batch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..data.device_pipeline import IGNORE_INDEX
from ..models.heads import similarity_scores
from ..parallel.collectives import all_gather, all_gather_local, psum

__all__ = ["IGNORE_INDEX", "gather_embeddings", "info_nce_loss", "mlm_loss", "seqrec_full_softmax_loss",
           "seqrec_sampled_softmax_loss", "seqrec_sampled_softmax_loss_from_negatives",
           "sampled_softmax_from_candidates",
           "bce_with_logits_terms", "bce_with_logits_loss", "focal_loss"]


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def gather_embeddings(z: torch.Tensor, group=None, grad_mode: str = "full") -> torch.Tensor:
    """Every rank's rows of ``z`` in rank order (``z`` itself without a
    group): ``grad_mode='full'`` differentiable to every rank, ``'local'``
    differentiable only in this rank's rows."""
    if group is None:
        return z
    if grad_mode == "full":
        return all_gather(z, group)
    if grad_mode == "local":
        return all_gather_local(z, group)
    raise ValueError(f"unknown grad_mode {grad_mode!r}")


def info_nce_loss(z1: torch.Tensor, z2: torch.Tensor, temp: float, group=None,
                  grad_mode: str = "full") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-batch contrastive loss with diagonal labels over the gathered batch
    (:func:`gather_embeddings`). Returns (loss, correct count, total count),
    the counts for the contrastive accuracy, over the gathered batch."""
    z1 = gather_embeddings(z1.float(), group, grad_mode)
    z2 = gather_embeddings(z2.float(), group, grad_mode)
    sim = _l2norm(z1) @ _l2norm(z2).t() / temp  # (N, N)
    labels = torch.arange(sim.shape[0], device=sim.device)
    logp = torch.log_softmax(sim, dim=-1)
    loss = -logp.diagonal().mean()
    correct = (sim.argmax(dim=1) == labels).sum().float()
    total = sim.new_full((), float(sim.shape[0]))  # filled on the device: no copy to capture
    return loss, correct, total


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor, group=None) -> torch.Tensor:
    """Masked-LM cross-entropy at gathered positions; ``IGNORE_INDEX`` slots
    are excluded and the mean is over valid slots (over the whole group's
    valid slots when a group is given: this rank's share of the group's
    mean). The logsumexp-gather form (``gather(logits) - logsumexp(logits)``)
    keeps no second (B, P, vocab) tensor."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    count = valid.sum()
    if group is not None:
        count = psum(count, group)
    return nll.sum() / count.clamp_min(1)


def seqrec_full_softmax_loss(pooled: torch.Tensor, item_embeddings: torch.Tensor,
                             labels: torch.Tensor, temp: float) -> torch.Tensor:
    """Cross-entropy of the label over the whole ``(N, H)`` catalog, in the
    logsumexp-gather form."""
    logits = similarity_scores(pooled.float(), item_embeddings.float(), temp)
    picked = torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    return (torch.logsumexp(logits, dim=-1) - picked).mean()


def seqrec_sampled_softmax_loss_from_negatives(pooled: torch.Tensor,
                                               item_embeddings: torch.Tensor,
                                               labels: torch.Tensor, temp: float,
                                               negatives: torch.Tensor) -> torch.Tensor:
    """Sampled softmax given the negatives ``(B, n)``: the label is candidate
    0, the negatives follow; a negative may equal the label."""
    candidates = torch.cat([labels.long()[:, None], negatives.long()], dim=1)  # (B, 1+n)
    return sampled_softmax_from_candidates(pooled, item_embeddings[candidates], temp)


def sampled_softmax_from_candidates(pooled: torch.Tensor, candidate_embeddings: torch.Tensor,
                                    temp: float) -> torch.Tensor:
    """Sampled softmax over per-row candidates ``(B, 1+n, H)``, the label
    first."""
    logits = similarity_scores(pooled.float(), candidate_embeddings.float(), temp)
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def seqrec_sampled_softmax_loss(pooled, item_embeddings, labels, temp: float,
                                num_negatives: int, generator: torch.Generator):
    """Sampled softmax with ``num_negatives`` negatives drawn uniformly over
    the catalog from ``generator``: collisions with the label are kept, as
    the reference keeps them."""
    negatives = torch.randint(0, item_embeddings.shape[0], (labels.shape[0], num_negatives),
                              generator=generator, device=labels.device)
    return seqrec_sampled_softmax_loss_from_negatives(pooled, item_embeddings, labels, temp,
                                                      negatives)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it (no linear
    cut-off above a threshold, unlike ``F.softplus``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def bce_with_logits_terms(logits: torch.Tensor, labels: torch.Tensor,
                          pos_weight: float = 1.0) -> torch.Tensor:
    """Per-row ``BCEWithLogitsLoss(pos_weight)`` terms in float32."""
    x, y = logits.float(), labels.float()
    return pos_weight * y * softplus(-x) + (1.0 - y) * softplus(x)


def bce_with_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                         pos_weight: float = 1.0) -> torch.Tensor:
    """The mean of :func:`bce_with_logits_terms`."""
    return bce_with_logits_terms(logits, labels, pos_weight).mean()


def focal_loss(logits: torch.Tensor, labels: torch.Tensor, alpha: Optional[float] = 1.0,
               gamma: float = 2.0, pos_weight: Optional[float] = None) -> torch.Tensor:
    """Focal loss over the (``pos_weight``-weighted) BCE terms: each term
    times ``(1 - p_t) ** gamma`` and, unless ``alpha`` is None, the class
    weight ``alpha`` / ``1 - alpha``. The fraud CLI trains with BCE."""
    x, y = logits.float(), labels.float()
    ce = bce_with_logits_terms(x, y, 1.0 if pos_weight is None else pos_weight)
    p = torch.sigmoid(x)
    w = (1.0 - (p * y + (1.0 - p) * (1.0 - y))) ** gamma
    if alpha is not None:
        w = (alpha * y + (1.0 - alpha) * (1.0 - y)) * w
    return (w * ce).mean()
