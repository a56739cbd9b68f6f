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

Given a mesh (``parallel/mesh.py``), the optimizer works on the rank's
parameters, whose gradients the training step has already reduced over the
data group:

- under tensor parallelism (``mesh.tensor_parallel``) the parameters that
  ``parallel.tensor.tp_split_dim`` names are this rank's slices: the global
  norm sums their squares over the model group, the replicated ones once;
  under pipeline and sequence parallelism every rank holds every parameter
  and its gradient whole, so nothing is split;
- ``zero=True`` is ZeRO-1 over the data group (the JAX package's
  ``shard_optimizer_state``): for each parameter whose leading dim divides
  by the data size and that holds at least 1,024 elements, this rank keeps
  the AdamW moments of its rows only and updates those rows, then the
  updated rows are all-gathered, so the parameters stay replicated. Only the
  layout differs from the replicated update: the result is the same, bit for
  bit.

In both, :meth:`AdamWSchedule.state_dict` gathers the whole state (every
rank of the mesh must call it) in the one-device layout, and
:meth:`AdamWSchedule.load_state_dict` takes that layout and keeps the
rank's share, so a state saved by any layout restores into any other.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
import torch.distributed as dist
from torch import nn

from ..utils.profiling import spanned


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
                 eps: float = 1e-8, head_lr: float | None = None, mesh=None,
                 zero: bool = False):
        decay = decay_mask(model)
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.params: List[nn.Parameter] = [p for _, p in named]
        self.mesh = mesh
        # parameter index -> the dim it is split on over the model group
        self._tp_dims: Dict[int, int] = {}
        if mesh is not None and mesh.tensor_parallel:
            from ..parallel.tensor import tp_split_dim

            self._tp_dims = {i: d for i, (n, _) in enumerate(named)
                             if (d := tp_split_dim(n)) is not None}
        # parameter index -> this data rank's rows of it (a view), under ZeRO
        self._zero: Dict[int, torch.Tensor] = {}
        if zero:
            from ..parallel.mesh import zero_shardable

            if mesh is None or mesh.n_model > 1:
                raise ValueError("zero=True composes with plain data parallelism only")
            n, r = mesh.n_data, mesh.data_rank
            self._zero = {i: p.detach().narrow(0, r * (p.shape[0] // n), p.shape[0] // n)
                          for i, p in enumerate(self.params) if zero_shardable(p, n)}
        index = {id(p): i for i, p in enumerate(self.params)}
        self._order: List[int] = []  # parameter index of each optimizer slot
        groups = []
        labels = ("encoder", "head") if head_lr is not None else (None,)
        for label in labels:
            lr = learning_rate if label != "head" else head_lr
            for decayed in (True, False):
                idx = [index[id(p)] for n, p in named
                       if decay[n] == decayed and (label is None or head_label(n) == label)]
                if idx:
                    self._order += idx
                    groups.append({"params": [self._zero.get(i, self.params[i]) for i in idx],
                                   "lr": lr, "weight_decay": weight_decay if decayed else 0.0})
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

    def _split(self, i: int):
        """(dim, rank, group) of parameter ``i``'s share on this rank, or
        None for a parameter this rank holds whole, with its whole state."""
        if i in self._tp_dims:
            return self._tp_dims[i], self.mesh.model_rank, self.mesh.model_group
        if i in self._zero:
            return 0, self.mesh.data_rank, self.mesh.data_group
        return None

    def _gather(self, i: int, t: torch.Tensor) -> torch.Tensor:
        from ..parallel.collectives import gather_list

        split = self._split(i)
        if split is None or t.dim() == 0:
            return t.detach().clone()
        return torch.cat(gather_list(t, split[2]), dim=split[0])

    def _keep(self, i: int, t: torch.Tensor) -> torch.Tensor:
        split = self._split(i)
        if split is None or t.dim() == 0:
            return t
        dim, rank, group = split
        size = t.shape[dim] // dist.get_world_size(group)
        return t.narrow(dim, rank * size, size).clone()

    def state_dict(self) -> dict:
        """The whole state in the one-device layout (a collective under
        tensor parallelism or ZeRO: every rank calls it)."""
        opt = self.optimizer.state_dict()
        opt["state"] = {j: {k: self._gather(self._order[j], v) for k, v in st.items()}
                        for j, st in sorted(opt["state"].items())}
        acc = None
        if self._acc is not None:
            acc = [a.detach().clone() if i in self._zero else self._gather(i, a)
                   for i, a in enumerate(self._acc)]
        return {"optimizer": opt, "scheduler": self.scheduler.state_dict(), "acc": acc,
                "mini_step": self.mini_step, "updates": self.updates}

    def load_state_dict(self, state: dict) -> None:
        """Restore from the one-device layout, keeping this rank's share."""
        opt = dict(state["optimizer"])
        opt["state"] = {j: {k: self._keep(self._order[j], v) for k, v in st.items()}
                        for j, st in opt["state"].items()}
        self.optimizer.load_state_dict(opt)
        self.scheduler.load_state_dict(state["scheduler"])
        acc = state["acc"]
        self._acc = None if acc is None else [
            (a if i in self._zero else self._keep(i, a)).to(p.device, p.dtype).clone()
            for i, (a, p) in enumerate(zip(acc, self.params))]
        self.mini_step = int(state["mini_step"])
        self.updates = int(state["updates"])

    def state_bytes(self) -> int:
        """Bytes of optimizer state (the AdamW moments) this rank holds."""
        return sum(v.numel() * v.element_size() for st in self.optimizer.state.values()
                   for v in st.values() if torch.is_tensor(v))

    def _zero_grad(self) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params:
            p.grad = None

    def _grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def _global_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        norms = torch._foreach_norm(grads)
        if not self._tp_dims:
            return torch.linalg.vector_norm(torch.stack(norms))
        from ..parallel.collectives import psum

        sq = torch.stack(norms) ** 2
        split = torch.zeros(len(grads), dtype=torch.bool, device=sq.device)
        split[list(self._tp_dims)] = True
        return torch.sqrt(sq[~split].sum() + psum(sq[split].sum(), self.mesh.model_group))

    @spanned("optimizer")
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
            self._zero_grad()
            if self.mini_step:
                return False
            for p, a in zip(self.params, self._acc):
                p.grad = a.clone()
            torch._foreach_zero_(self._acc)
            grads = self._grads()
        norm = self._global_norm(grads)
        factor = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, factor)
        for i, (p, g) in enumerate(zip(self.params, grads)):
            p.grad = g
            if i in self._zero:
                rows = self._zero[i]
                rows.grad = g.narrow(0, self.mesh.data_rank * rows.shape[0], rows.shape[0])
        self.optimizer.step()
        self.scheduler.step()
        self._zero_grad()
        if self._zero:
            from ..parallel.collectives import gather_list

            for i, rows in self._zero.items():
                self.params[i].data.copy_(torch.cat(gather_list(rows, self.mesh.data_group)))
        self.updates += 1
        return True


def create_optimizer(model: nn.Module, **kw) -> AdamWSchedule:
    """The JAX package's ``create_optimizer`` (same keywords) over
    ``model``'s trainable parameters."""
    return AdamWSchedule(model, **kw)
