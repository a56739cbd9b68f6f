"""Ranking metrics and streaming averages.

Counterpart of ``recformer_tpu/training/metrics.py``: NDCG@k / Recall@k /
MRR / AUC from a rank taken as the count of strictly greater scores (the
reference ``Ranker.forward``). ``valid_length`` counts scores above the
``-MAX_VAL`` sentinel used to mask candidates.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch

MAX_VAL = 1e4


def rank_from_scores(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """rank[i] = #{j : scores[i, j] > scores[i, labels[i]]} (0 = top-1)."""
    predicted = torch.gather(scores, 1, labels.long()[:, None])  # (B, 1)
    return (predicted < scores).float().sum(dim=-1)


def rank_metrics(scores: torch.Tensor, labels: torch.Tensor,
                 ks: Sequence[int] = (10, 50)) -> Dict[str, torch.Tensor]:
    """Per-batch mean metrics. ``scores``: (B, N) float; ``labels``: (B,) int."""
    scores = scores.float()
    rank = rank_from_scores(scores, labels)
    valid_length = (scores > -MAX_VAL).float().sum(dim=-1)
    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        indicator = (rank < k).float()
        out[f"NDCG@{k}"] = (indicator / torch.log2(rank + 2.0)).mean()
        out[f"Recall@{k}"] = indicator.mean()
    out["MRR"] = (1.0 / (rank + 1.0)).mean()
    out["AUC"] = (1.0 - rank / valid_length.clamp_min(1.0)).mean()
    # CE loss over the candidate set (the reference returns it beside the metrics)
    logp = torch.log_softmax(scores, dim=-1)
    out["loss"] = -torch.gather(logp, 1, labels.long()[:, None]).mean()
    return out


class AverageMeterSet:
    """Streaming named averages (host side), reference ``utils.py:43-73``."""

    def __init__(self):
        self._sum: Dict[str, float] = {}
        self._count: Dict[str, int] = {}
        self._val: Dict[str, float] = {}

    def update(self, name: str, value: float, n: int = 1) -> None:
        self._sum[name] = self._sum.get(name, 0.0) + float(value) * n
        self._count[name] = self._count.get(name, 0) + n
        self._val[name] = float(value)

    def update_dict(self, metrics: Dict[str, torch.Tensor], n: int = 1) -> None:
        for k, v in metrics.items():
            self.update(k, float(v), n)

    def averages(self, fmt: str = "{}") -> Dict[str, float]:
        return {fmt.format(k): self._sum[k] / max(1, self._count[k]) for k in self._sum}

    def values(self, fmt: str = "{}") -> Dict[str, float]:
        return {fmt.format(k): v for k, v in self._val.items()}

    def reset(self) -> None:
        self._sum.clear()
        self._count.clear()
        self._val.clear()
