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
- :func:`ppermute` sends ``x`` along ``(source, destination)`` pairs of
  group ranks; a rank that no pair names as a destination receives zeros,
  as in JAX. Its backward sends the cotangents along the reversed pairs.
  On ``nccl`` each rank posts its send and its receive together
  (``batch_isend_irecv``); ``gloo`` sends and receives CPU tensors only, so
  a CUDA tensor is copied to host memory, sent, received there and copied
  back (:func:`p2p_transport` names the transport). :func:`isend` and
  :func:`recv` are the one-way halves, for a schedule that posts them
  itself (the pipeline's stage hand-off).
- :func:`shard` is this rank's slice of a replicated tensor along a dim
  (its backward gathers every rank's slice of the cotangent), the input
  side of JAX's ``shard_map`` over a sharded dim; :func:`all_gather_local`
  along that dim is the output side, for a consumer that every rank
  computes alike.
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


def all_gather_local(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """:func:`all_gather` along ``dim`` whose remote rows carry no gradient:
    only this rank's rows, put back in their place, are differentiable."""
    parts = gather_list(x, group)
    parts[group_rank(group)] = x
    return torch.cat(parts, dim=dim)


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        n = group_size(group)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {x.shape[dim]} not divisible by {n} ranks")
        size = x.shape[dim] // n
        return x.narrow(dim, group_rank(group) * size, size).clone()

    @staticmethod
    def backward(ctx, g):
        return torch.cat(gather_list(g, ctx.group), dim=ctx.dim), None, None


def shard(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` (the same on every rank) along
    ``dim``; the backward gathers every rank's cotangent slice, so each rank
    gets the whole gradient."""
    return _Shard.apply(x, group, dim)


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


def p2p_transport(group, device: torch.device) -> str:
    """How :func:`ppermute`, :func:`isend` and :func:`recv` move tensors of
    ``device`` over ``group``'s backend."""
    backend = dist.get_backend(group)
    if backend == "nccl":
        return "nccl batch_isend_irecv"
    if device.type == "cuda":
        return f"{backend} send/recv staged through host memory"
    return f"{backend} send/recv"


def _staged(group, x: torch.Tensor) -> bool:
    """Whether ``x`` goes through host memory: gloo sends CPU tensors only."""
    return x.is_cuda and dist.get_backend(group) != "nccl"


class Sent:
    """An :func:`isend` in flight; :meth:`wait` before the tensor is reused."""

    def __init__(self, work, buffer):
        self.work, self.buffer = work, buffer

    def wait(self) -> None:
        self.work.wait()
        self.buffer = None


def isend(x: torch.Tensor, dst: int, group) -> Sent:
    """Start sending ``x`` to group rank ``dst``."""
    buf = x.detach().contiguous()
    if _staged(group, buf):
        buf = buf.cpu()
    return Sent(dist.isend(buf, dist.get_global_rank(group, dst), group=group), buf)


def recv(like: torch.Tensor, src: int, group) -> torch.Tensor:
    """A tensor of ``like``'s shape, dtype and device, received from group
    rank ``src``."""
    buf = torch.empty(like.shape, dtype=like.dtype,
                      device="cpu" if _staged(group, like) else like.device)
    dist.recv(buf, dist.get_global_rank(group, src), group=group)
    return buf.to(like.device)


def _permute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    r = group_rank(group)
    dst = [d for s, d in pairs if s == r]
    src = [s for s, d in pairs if d == r]
    if len(dst) > 1 or len(src) > 1:
        raise ValueError(f"ppermute pairs {pairs} send or receive twice at rank {r}")
    x = x.detach().contiguous()
    out = torch.zeros_like(x)
    staged = _staged(group, x)
    send_buf = x.cpu() if staged and dst else x
    recv_buf = torch.empty_like(send_buf, device="cpu") if staged else out
    ops = []
    if dst:
        ops.append(dist.P2POp(dist.isend, send_buf, dist.get_global_rank(group, dst[0]), group))
    if src:
        ops.append(dist.P2POp(dist.irecv, recv_buf, dist.get_global_rank(group, src[0]), group))
    if dist.get_backend(group) == "nccl":
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = [op.op(op.tensor, op.peer, group=group) for op in ops]
    for w in works:
        w.wait()
    if src and staged:
        out.copy_(recv_buf)
    return out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pairs, group):
        ctx.pairs, ctx.group = pairs, group
        return _permute(x, pairs, group)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, [(d, s) for s, d in ctx.pairs], ctx.group), None, None


def ppermute(x: torch.Tensor, pairs, group) -> torch.Tensor:
    """JAX's ``lax.ppermute``: group rank ``s`` sends ``x`` to ``d`` for each
    ``(s, d)`` in ``pairs``; a rank that receives nothing gets zeros. Every
    rank of the group calls it with the same pairs. Differentiable: the
    backward permutes the cotangents back."""
    return _Ppermute.apply(x, [tuple(p) for p in pairs], group)


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
