"""AdamW (Loshchilov & Hutter) with global-norm clipping, gradient
accumulation by a running mean, and linear warmup then linear decay
anchored at 0 (update t from 0 runs at ``lr * t / warmup`` below the
warmup, ``lr * max(0, 1 - t / total)`` after): the training recipe of the
benchmark's training cells, written from those definitions."""

from __future__ import annotations

from typing import Dict

import torch


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, warmup: int, total: int,
                 clip: float = 1.0, accum: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, decay=lambda name: True):
        self.p, self.lr, self.warmup, self.total = params, lr, warmup, total
        self.clip, self.accum, self.b1, self.b2, self.eps = clip, accum, b1, b2, eps
        self.wd, self.decay = weight_decay, decay
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.acc = {k: torch.zeros_like(v) for k, v in params.items()}
        self.n = 0
        self.updates = 0
        self.first_grad: Dict[str, torch.Tensor] | None = None

    def rate(self, t: int) -> float:
        if t < self.warmup:
            return self.lr * t / max(1, self.warmup)
        return self.lr * max(0.0, 1.0 - t / max(1, self.total))

    @torch.no_grad()
    def step(self) -> bool:
        """After a micro-step's backward: accumulate; every ``accum``-th
        call, clip and update. Returns True on an update."""
        for k, p in self.p.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            self.acc[k] += (g - self.acc[k]) / (self.n + 1)
            p.grad = None
        self.n += 1
        if self.n < self.accum:
            return False
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in self.acc.values())).float()
        f = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
        grads = {k: a * f for k, a in self.acc.items()}
        if self.first_grad is None:
            self.first_grad = {k: g.clone() for k, g in grads.items()}
        t = self.updates + 1
        lr = self.rate(self.updates)
        for k, p in self.p.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            mh = self.m[k] / (1 - self.b1 ** t)
            vh = self.v[k] / (1 - self.b2 ** t)
            if self.wd and self.decay(k):
                p.mul_(1 - lr * self.wd)
            p.sub_(lr * mh / (vh.sqrt() + self.eps))
        for a in self.acc.values():
            a.zero_()
        self.n = 0
        self.updates += 1
        return True
