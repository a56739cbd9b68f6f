"""The finetuning step, plainly: the target drawn over the whole history,
the history before it as the sequence view, the sampled-softmax loss of its
pooled output against the label and the negatives drawn uniformly over the
catalog (collisions with the label kept), as RecFormer's two-stage loop
computes it in stage two, against a frozen catalog (arXiv:2305.13731).
Draws come from :class:`~.rng.StepDraws` in the program's order: the
targets, then the backbone's dropout (``model.encode``), then the
negatives."""

from __future__ import annotations

import numpy as np
import torch

from . import batches as rb
from . import model as rm


def targets(u: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """The target position from a uniform ``u`` per row: uniform over
    ``[0, len - 1]``, in float32 as drawn."""
    lens = seq_lens.to(torch.int32)
    t = torch.floor(u.float() * lens.float()).to(torch.int32)
    return torch.minimum(t, lens - 1)


def sampled_softmax(user, items, labels, negatives, temp):
    """Cosine over ``temp`` of each row against its label (first) and its
    negatives; the mean of the label's negative log-probability."""
    cand = torch.cat([labels[:, None], negatives], dim=1)
    logits = (rm.normalize(user)[:, None, :] * rm.normalize(items[cand])).sum(-1) / temp
    return -torch.log_softmax(logits, dim=-1)[:, 0].mean()


def step_loss(P, cfg, table_np, item_ids: np.ndarray, seq_lens: np.ndarray, items, n_negatives,
              draws, num: rm.Numerics, rows: int | None = None):
    """One micro-step's loss over the batch (its first ``rows`` rows, for a
    fault) given the step's draws; ``items`` is the frozen catalog."""
    B = item_ids.shape[0]
    u = draws.rand(B)
    t = targets(u, torch.from_numpy(seq_lens).to(u.device)).cpu().numpy()
    labels = torch.from_numpy(item_ids[np.arange(B), t].astype(np.int64)).to(u.device)
    batch = rb.assemble(table_np, item_ids, t, cfg.max_token_num, cfg, u.device)
    user = rm.encode(P, cfg, batch, batch["input_ids"], draws, num)[:, 0]
    negatives = draws.randint(items.shape[0], B, n_negatives)
    r = B if rows is None else rows
    return sampled_softmax(user[:r], items, labels[:r], negatives[:r], cfg.temp)
