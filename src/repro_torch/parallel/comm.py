"""Collectives with stated backwards, for explicit SPMD on plain local
tensors.

Each function is a ``torch.autograd.Function`` over one process group;
every rank of the group must call it, in the same order.  Only the
primitives every backend of ``torch.distributed`` has are used:
``all_reduce`` (SUM, MAX) and ``all_gather`` into a list; a reduce-scatter
is an all-reduce and the rank's chunk.

- :func:`all_reduce_sum`: SUM forward, SUM backward.  For a statistic that
  every rank of the group folds into the same loss, whose gradients are
  then averaged over the group (the data axis).
- :func:`sum_partials`: SUM forward, identity backward.  For partial
  results combined over an axis downstream of which every rank computes
  the same loss (the model axis): the cotangent arriving at each rank's
  partial is already the true one, and an all-reduce would make it the
  group's size times too large.
- :func:`enter_partials`: identity forward, SUM backward, its mirror at
  the start of such a region: a replicated input whose uses are split over
  the ranks gets the sum of their gradients.
- :func:`all_gather_dim` / :func:`reduce_scatter_dim`: concatenation of
  the ranks' blocks along ``dim``, whose backward is the reduce-scatter of
  the cotangent, and the reverse.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "sum_partials", "enter_partials", "all_gather_dim",
           "reduce_scatter_dim", "all_reduce_max"]


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def _scatter_sum(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} ({x.shape[dim]}) does not split over {n} ranks")
    w = x.shape[dim] // n
    return _all_reduce(x, group).narrow(dim, dist.get_rank(group) * w, w).contiguous()


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _EnterPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter_sum(g, ctx.group, ctx.dim), None, None


class _ReduceScatterDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter_sum(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    return _AllReduceSum.apply(x, group)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    return _SumPartials.apply(x, group)


def enter_partials(x: torch.Tensor, group) -> torch.Tensor:
    return _EnterPartials.apply(x, group)


def all_gather_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _AllGatherDim.apply(x, group, dim)


def reduce_scatter_dim(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    return _ReduceScatterDim.apply(x, group, dim)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """Elementwise MAX over the group (no gradient)."""
    return _all_reduce(x, group, dist.ReduceOp.MAX)
