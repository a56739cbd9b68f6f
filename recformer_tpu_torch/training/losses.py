"""Pretraining losses, in float32 whatever the compute type.

Counterparts of ``IGNORE_INDEX``, ``info_nce_loss`` and ``mlm_loss`` in
``recformer_tpu/training/losses.py``, on one device (the JAX package's
``axis_name=None``): the cross-device gather of the contrastive negatives
comes with the parallel slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..data.device_pipeline import IGNORE_INDEX

__all__ = ["IGNORE_INDEX", "info_nce_loss", "mlm_loss"]


def _l2norm(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def info_nce_loss(z1: torch.Tensor, z2: torch.Tensor, temp: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """In-batch contrastive loss with diagonal labels. Returns (loss,
    correct count, total count), the counts for the contrastive accuracy."""
    sim = _l2norm(z1.float()) @ _l2norm(z2.float()).t() / temp  # (N, N)
    labels = torch.arange(sim.shape[0], device=sim.device)
    logp = torch.log_softmax(sim, dim=-1)
    loss = -logp.diagonal().mean()
    correct = (sim.argmax(dim=1) == labels).sum().float()
    total = torch.tensor(float(sim.shape[0]), device=sim.device)
    return loss, correct, total


def mlm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Masked-LM cross-entropy at gathered positions; ``IGNORE_INDEX`` slots
    are excluded and the mean is over valid slots. The logsumexp-gather form
    (``gather(logits) - logsumexp(logits)``) keeps no second (B, P, vocab)
    tensor."""
    valid = labels != IGNORE_INDEX
    safe = torch.where(valid, labels, 0).long()
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    return nll.sum() / valid.sum().clamp_min(1)
