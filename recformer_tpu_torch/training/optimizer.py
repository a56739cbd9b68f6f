"""AdamW with linear warmup and decay, global-norm clipping and gradient
accumulation: the JAX package's optax chain in PyTorch.

Counterpart of ``recformer_tpu/training/optimizer.py``, matched term by term:

- the schedule gives update t (from 0) the rate ``base * t / warmup`` below
  ``warmup`` and ``base * max(0, 1 - t / total)`` after, so the first update
  runs at rate 0, like optax's;
- weight decay is ``lr * wd * p`` added to the Adam step (``torch.optim.AdamW``
  takes the same step), off for biases and LayerNorm weights (flax's
  ``scale``);
- the gradient is clipped to global norm ``grad_clip`` over all trained
  parameters before the groups split, as ``optax.clip_by_global_norm`` does
  (``g * clip / norm`` when ``norm >= clip``);
- with ``grad_accum_steps = k`` the gradients of k micro-steps are averaged
  with ``optax.MultiSteps``' running mean and one update is taken;
- ``head_lr`` puts the parameters outside the backbone (``longformer.*``) in
  groups of their own at that rate, with the same schedule shape;
- :meth:`AdamWSchedule.state_dict` holds everything a restore needs to go on
  exactly, in the middle of an accumulation cycle too: the Adam moments,
  the schedule's position, the accumulated gradient and the counters.

The clip factor stays a device tensor, so a step does not wait on the host.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn


def linear_warmup_linear_decay(warmup_steps: int, total_steps: int) -> Callable[[int], float]:
    """The schedule's factor of the base rate at update ``step``; the decay
    is anchored at 0, not at the end of the warmup."""

    def factor(step: int) -> float:
        if step < warmup_steps:
            return step / max(1, warmup_steps)
        return max(0.0, 1.0 - step / max(1, total_steps))

    return factor


def decay_mask(model: nn.Module) -> Dict[str, bool]:
    """True for parameters that take weight decay: all but biases and
    LayerNorm weights."""
    no_decay = {f"{mod_name}.weight" if mod_name else "weight"
                for mod_name, mod in model.named_modules() if isinstance(mod, nn.LayerNorm)}
    return {name: not (name.endswith("bias") or name in no_decay)
            for name, _ in model.named_parameters()}


def head_label(name: str) -> str:
    """'encoder' for the backbone's parameters, 'head' for the rest."""
    return "encoder" if name.split(".")[0] == "longformer" else "head"


class AdamWSchedule:
    """The optimizer of a training loop: call :meth:`step` after each
    micro-step's ``backward()``; it returns True when it took an update."""

    def __init__(self, model: nn.Module, learning_rate: float = 5e-5,
                 weight_decay: float = 0.0, warmup_steps: int = 100,
                 total_steps: int = 10_000, grad_clip: float = 1.0,
                 grad_accum_steps: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, head_lr: float | None = None):
        decay = decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params: List[nn.Parameter] = [p for _, p in named]
        groups = []
        labels = ("encoder", "head") if head_lr is not None else (None,)
        for label in labels:
            lr = learning_rate if label != "head" else head_lr
            for decayed in (True, False):
                ps = [p for n, p in named
                      if decay[n] == decayed and (label is None or head_label(n) == label)]
                if ps:
                    groups.append({"params": ps, "lr": lr,
                                   "weight_decay": weight_decay if decayed else 0.0})
        self.optimizer = torch.optim.AdamW(groups, lr=learning_rate, betas=(b1, b2), eps=eps,
                                           weight_decay=weight_decay)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, linear_warmup_linear_decay(warmup_steps, total_steps))
        self.grad_clip = grad_clip
        self.k = grad_accum_steps
        self.mini_step = 0
        self.updates = 0
        self._acc: List[torch.Tensor] | None = None

    @property
    def micro_steps(self) -> int:
        """Calls of :meth:`step` so far: the JAX TrainState's ``step``."""
        return self.updates * self.k + self.mini_step

    def state_dict(self) -> dict:
        return {"optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(),
                "acc": None if self._acc is None else [a.detach().clone() for a in self._acc],
                "mini_step": self.mini_step, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        acc = state["acc"]
        self._acc = None if acc is None else [a.to(p.device, p.dtype).clone()
                                              for a, p in zip(acc, self.params)]
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def step(self) -> bool:
        grads = self._grads()
        if self.k > 1:
            if self._acc is None:
                self._acc = [torch.zeros_like(g) for g in grads]
            # running mean: acc += (g - acc) / (n + 1)
            diff = torch._foreach_sub(grads, self._acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self._acc, diff)
            self.mini_step = (self.mini_step + 1) % self.k
            self.optimizer.zero_grad(set_to_none=True)
            if self.mini_step:
                return False
            for p, a in zip(self.params, self._acc):
                p.grad = a.clone()
            torch._foreach_zero_(self._acc)
            grads = self._grads()
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.updates += 1
        return True


def create_optimizer(model: nn.Module, **kw) -> AdamWSchedule:
    """The JAX package's ``create_optimizer`` (same keywords) over
    ``model``'s trainable parameters."""
    return AdamWSchedule(model, **kw)
