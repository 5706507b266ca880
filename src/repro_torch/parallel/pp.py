"""Pipeline parallelism: GPipe-style microbatched stage execution, the port
of the reference's ``parallel/pp.py``.

* The layer stack is split into ``n_stages`` contiguous stages, one a rank
  of the mesh's stage axis; each rank holds only its stage's parameters.
* Microbatches flow through the stages in the GPipe schedule (fill,
  steady state, drain) over ``n_micro + n_stages - 1`` ticks: at tick
  ``t`` stage ``s`` runs microbatch ``t - s`` when there is one, stage 0
  taking it from the input and the others from the ring buffer, and every
  stage passes its activation to the next round the ring (non-blocking
  ``isend`` / ``irecv``, so no rank waits on a send).
* The last stage's outputs reach every rank (an all-reduce of the buffer
  only it fills), as the reference's one-hot ``psum``.

``pipeline_apply`` is differentiable: the schedule is one autograd
Function whose backward runs the ticks in reverse, recomputing each
stage's step from its saved input (GPipe's recompute), sending each
cotangent the other way round the ring, and summing the input's gradient
(stage 0's) over the ranks.  ``bubble_fraction`` gives the schedule's idle
share ``(n_stages - 1) / (n_micro + n_stages - 1)``.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..checkpoint.store import flatten_with_keys, map_with_keys

__all__ = ["pipeline_apply", "bubble_fraction"]


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    """Idle fraction of the GPipe schedule."""
    ticks = n_micro + n_stages - 1
    return (n_stages - 1) / ticks


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Every rank sends ``x`` to the rank ``step`` ahead round the ring and
    returns what the rank ``step`` behind sent it."""
    ranks = dist.get_process_group_ranks(group)
    n, sid = len(ranks), dist.get_rank(group)
    out = torch.empty_like(x)
    recv = dist.irecv(out, ranks[(sid - step) % n], group=group)
    send = dist.isend(x.contiguous(), ranks[(sid + step) % n], group=group)
    send.wait()
    recv.wait()
    return out


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, tree, x, *leaves):
        n, sid = dist.get_world_size(group), dist.get_rank(group)
        n_micro = x.shape[0]
        keys = list(flatten_with_keys(tree))
        stage = [leaf[0] for leaf in leaves]
        p = map_with_keys(lambda k, _: stage[keys.index(k)], tree)
        buf = torch.zeros_like(x[0])
        outputs = torch.zeros_like(x)
        inputs = {}
        for t in range(n_micro + n - 1):
            mb = t - sid
            y = buf
            if 0 <= mb < n_micro:
                inputs[t] = x[mb] if sid == 0 else buf
                y = stage_fn(p, inputs[t])
                if sid == n - 1:
                    outputs[mb] = y
            buf = _shift(y, group, 1) if n > 1 else y
        ctx.stage_fn, ctx.group, ctx.tree, ctx.keys = stage_fn, group, tree, keys
        ctx.inputs, ctx.n_micro = inputs, n_micro
        ctx.save_for_backward(x, *leaves)
        dist.all_reduce(outputs, group=group)  # only the last stage's is not zero
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        x, *leaves = ctx.saved_tensors
        group, n_micro = ctx.group, ctx.n_micro
        n, sid = dist.get_world_size(group), dist.get_rank(group)
        stage = [leaf[0].detach().requires_grad_(True) for leaf in leaves]
        p = map_with_keys(lambda k, _: stage[ctx.keys.index(k)], ctx.tree)
        d_leaves = [torch.zeros_like(s) for s in stage]
        dx = torch.zeros_like(x)
        g_in = torch.zeros_like(x[0])  # the cotangent of the buffer of tick t + 1
        for t in reversed(range(n_micro + n - 1)):
            gy = _shift(g_in, group, -1) if n > 1 else g_in
            mb = t - sid
            if not 0 <= mb < n_micro:
                g_in = gy
                continue
            if sid == n - 1:
                gy = gy + g_out[mb]
            inp = ctx.inputs[t].detach().requires_grad_(True)
            with torch.enable_grad():
                y = ctx.stage_fn(p, inp)
            g = torch.autograd.grad(y, [inp] + stage, gy)
            for d, gi in zip(d_leaves, g[1:]):
                d.add_(gi)
            if sid == 0:
                dx[mb] += g[0]
                g_in = torch.zeros_like(g_in)
            else:
                g_in = g[0]
        dist.all_reduce(dx, group=group)  # stage 0's, to every rank
        return (None, None, None, dx) + tuple(d[None] for d in d_leaves)


def pipeline_apply(
    stage_fn: Callable,
    params_stacked,
    x: torch.Tensor,  # (n_micro, micro_batch, ...) microbatched activations
    mesh,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``stage_fn(stage_params, activation) -> activation`` as a GPipe
    pipeline over the ``axis`` mesh dimension.

    ``params_stacked``: this rank's block of the stage-stacked tree (each
    leaf's leading dim 1, its stage's slice).  ``x``: the microbatches,
    the same on every rank.  Returns the final stage's output a microbatch,
    ``(n_micro, micro_batch, ...)``, on every rank.  A collective over the
    axis's ranks, forward and backward."""
    leaves = list(flatten_with_keys(params_stacked).values())
    return _GPipe.apply(stage_fn, mesh.group(axis), params_stacked, x, *leaves)
