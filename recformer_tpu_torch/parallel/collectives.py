"""Differentiable collectives over a process group.

JAX takes these from ``lax`` inside ``shard_map``; here each is a
``torch.autograd.Function`` (or a plain call where no gradient flows) over
a ``torch.distributed`` process group. Only all-reduce, list-form
``all_gather`` and ``broadcast`` are used: ``ProcessGroupGloo`` runs those
on CUDA tensors too, which lets several ranks share one card over gloo
(it has no ``reduce_scatter`` or ``all_gather_into_tensor`` for them).

- :func:`all_gather` concatenates every rank's ``x`` along a dim; its
  backward is JAX's transpose, ``psum_scatter``: the cotangents are
  all-reduced and each rank keeps its own slice.
- :func:`all_gather_local` is the reference's contrastive gather
  (``losses.py:41-44`` in the JAX package): the remote rows are detached
  and the local rows are put back with their gradient.
- :func:`psum` / :func:`pmean` reduce in the forward and pass the cotangent
  through unchanged (the output is replicated and counted once): Megatron's
  ``g`` at a row-parallel output. :func:`copy_to` is its ``f``: the identity
  forward at a column-parallel input whose backward all-reduces.
- :func:`pmax` takes no gradient: the input is detached *before* the
  collective, as ``catalog.py``'s stability max needs.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

# coalesced all-reduce: at most this many elements per collective call
_BUCKET = 1 << 25


def group_size(group) -> int:
    return dist.get_world_size(group)


def group_rank(group) -> int:
    return dist.get_rank(group)


def gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``x`` (same shape on all), in group-rank order; no
    gradient."""
    x = x.detach().contiguous()
    parts = [torch.empty_like(x) for _ in range(group_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.size = group, dim, x.shape[dim]
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, group_rank(ctx.group) * ctx.size, ctx.size), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; differentiable (the
    backward is ``psum_scatter``)."""
    return _AllGather.apply(x, group, dim)


def all_gather_local(x: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather` along dim 0 whose remote rows carry no gradient:
    only this rank's rows, put back in their place, are differentiable."""
    parts = gather_list(x, group)
    parts[group_rank(group)] = x
    return torch.cat(parts, dim=0)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the cotangent passes through (the replicated
    result is counted once)."""
    return _Psum.apply(x, group)


def pmean(x: torch.Tensor, group) -> torch.Tensor:
    return psum(x, group) / group_size(group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the cotangents over the group: a
    replicated input feeding rank-local (column-parallel) work."""
    return _CopyTo.apply(x, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max over the group, without a gradient."""
    y = x.detach().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def broadcast(x: torch.Tensor, src: int, group) -> torch.Tensor:
    """Group rank ``src``'s ``x`` on every rank (a new tensor)."""
    y = x.detach().contiguous().clone()
    dist.broadcast(y, src=dist.get_global_rank(group, src), group=group)
    return y


def all_reduce_(tensors: Sequence[torch.Tensor], group, mean: bool = False) -> None:
    """Sum (or average) ``tensors`` in place over the group, a few large
    collectives instead of one per tensor: tensors of one dtype and device
    are packed into buckets of at most ``_BUCKET`` elements."""
    by_kind = {}
    for t in tensors:
        by_kind.setdefault((t.dtype, t.device), []).append(t)
    n = group_size(group)
    for ts in by_kind.values():
        start = 0
        while start < len(ts):
            stop, count = start, 0
            while stop < len(ts) and (stop == start or count + ts[stop].numel() <= _BUCKET):
                count += ts[stop].numel()
                stop += 1
            chunk = ts[start:stop]
            flat = torch.cat([t.reshape(-1) for t in chunk])
            dist.all_reduce(flat, group=group)
            if mean:
                flat /= n
            offset = 0
            for t in chunk:
                t.copy_(flat[offset:offset + t.numel()].view_as(t))
                offset += t.numel()
            start = stop
