"""The differentiable collectives the parallel layer is built from, on
``torch.distributed`` (NCCL on the card, gloo on the CPU).

Cotangent convention (``torch.distributed.nn``'s): of a value that every
rank of a group holds whole, the ranks hold partial cotangents whose sum
is its cotangent.  Hence:

* :func:`all_reduce` — backward all-reduces the cotangent;
* :func:`all_gather` — backward reduce-scatters it (an all-reduce, of
  which each rank keeps its own slice);
* a rank's own slice of a whole tensor, by plain indexing — backward puts
  the cotangent into that slice and zeros elsewhere;
* :func:`exchange` — backward sends the cotangents back the way the
  values came (ppermute's transpose is the reverse permutation);
* :func:`all_to_all` — backward is the same all-to-all of the cotangents.

So a loss that each of N ranks computes whole is seeded with 1/N on every
rank, and the gradient of an input that the ranks hold whole is the sum
(all-reduce) of theirs.  Every rank must issue the same collectives in
the same order, forward and backward: the functions of this package build
the same autograd graph on every rank, with rank-dependent choices made by
masks and indices, never by branches that add or drop operations.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch.autograd import Function


def _neighbours(group):
    """Global ranks of the previous and next rank of ``group`` (None at
    either end of the chain)."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    prev = dist.get_global_rank(group, rank - 1) if rank > 0 else None
    nxt = dist.get_global_rank(group, rank + 1) if rank < size - 1 else None
    return prev, nxt


def _exchange(group, to_prev, to_next):
    """Send ``to_prev`` to the previous rank and ``to_next`` to the next
    one; return (from_prev, from_next), zeros where there is no neighbour
    and None where the matching send is None on every rank."""
    cf = torch.contiguous_format
    from_prev = (None if to_next is None
                 else torch.zeros_like(to_next, memory_format=cf))
    from_next = (None if to_prev is None
                 else torch.zeros_like(to_prev, memory_format=cf))
    if dist.get_world_size(group) == 1:
        return from_prev, from_next  # a send to oneself fails (gloo, NCCL)
    prev, nxt = _neighbours(group)
    ops = []
    if to_prev is not None:       # upward: send to rank − 1, hear rank + 1
        if prev is not None:
            ops.append(dist.P2POp(dist.isend, to_prev.contiguous(), prev,
                                  group))
        if nxt is not None:
            ops.append(dist.P2POp(dist.irecv, from_next, nxt, group))
    if to_next is not None:       # downward: send to rank + 1, hear rank − 1
        if nxt is not None:
            ops.append(dist.P2POp(dist.isend, to_next.contiguous(), nxt,
                                  group))
        if prev is not None:
            ops.append(dist.P2POp(dist.irecv, from_prev, prev, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_prev, from_next


class _Exchange(Function):
    @staticmethod
    def forward(ctx, group, to_prev, to_next):
        ctx.group = group
        return _exchange(group, to_prev, to_next)

    @staticmethod
    def backward(ctx, g_from_prev, g_from_next):
        # what came from the previous rank goes back to it, and so on
        g_to_prev, g_to_next = _exchange(ctx.group, g_from_prev, g_from_next)
        return None, g_to_prev, g_to_next


def exchange(group, to_prev: Optional[torch.Tensor],
             to_next: Optional[torch.Tensor]):
    """Nearest-neighbour exchange along the ranks of ``group`` (a chain,
    not a ring): send ``to_prev`` to rank − 1 and ``to_next`` to rank + 1,
    and return ``(from_prev, from_next)`` — what rank − 1 sent as its
    ``to_next`` and rank + 1 as its ``to_prev``, zeros at the ends of the
    chain.  Pass None for a direction that no rank uses (its result is
    None).  Differentiable; sends nothing at group size 1."""
    return _Exchange.apply(group, to_prev, to_next)


class _AllReduce(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``group``; differentiable (the
    backward all-reduces the cotangent)."""
    return _AllReduce.apply(x, group)


class _AllGather(Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        size = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.k = group, dim, x.shape[dim]
        ctx.rank = dist.get_rank(group)
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g.narrow(ctx.dim, ctx.rank * ctx.k, ctx.k), None, None


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` of ``group`` concatenated along ``dim`` in rank
    order (equal shapes); differentiable (the backward reduce-scatters)."""
    return _AllGather.apply(x, group, dim)


class _AllToAll(Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty_like(g, memory_format=torch.contiguous_format)
        dist.all_to_all_single(out, g.contiguous(), group=ctx.group)
        return out, None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` split into P equal blocks along dim 0; block j goes to rank j
    of ``group`` and the result's block i came from rank i.
    Differentiable (the backward is the same exchange of cotangents)."""
    return _AllToAll.apply(x, group)


def rank_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal share of ``x`` along ``dim`` (its group rank's
    block); raises unless the group's size divides it."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"axis of length {n} is not divisible by the "
                         f"{size} ranks of its group")
    k = n // size
    return x.narrow(dim, rank * k, k)
