"""The kernel wrappers' autograd guard.

No Pallas kernel of the reference has a VJP (its kernels define no
``custom_vjp``), so the reference never differentiates through one: its
training path takes the dense or chunked attention.  The port's
attention wrappers keep that: on CPU tensors a port wrapper runs its
plain version, through which autograd would go; on CUDA tensors it
launches a ctypes kernel into a fresh tensor that has no ``grad_fn``, so
a gradient would be cut without a word.  :func:`no_backward` makes both
cases the same: when an operand requires a gradient it runs the wrapper
inside a :class:`torch.autograd.Function` whose forward is the wrapper
itself (same launch, same counters, same bits) and whose backward raises.
Without such an operand, or with grad mode off, it calls the wrapper
directly, so the serving path pays nothing.  (The WKV recurrence and the
selective scan, ``lax.scan``s that the reference differentiates, have
backward kernels of their own instead: :class:`.rwkv6.WKV`,
:class:`.mamba.SelectiveScan`.)
"""

from __future__ import annotations

from typing import Callable

import torch

__all__ = ["NoBackward", "no_backward", "needs_guard"]


class NoBackward(torch.autograd.Function):
    """``apply(name, fn, kwargs, *operands)``: forward ``fn(*operands,
    **kwargs)``; backward raises :class:`NotImplementedError`."""

    @staticmethod
    def forward(ctx, name, fn, kwargs, *operands):
        ctx.kernel_name = name
        return fn(*operands, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            f"{ctx.kernel_name} has no backward: the reference's Pallas kernel has no "
            "VJP, so neither has the port's. Train through the plain paths "
            "(attn_impl 'auto', 'dense' or 'chunked')")


def needs_guard(*operands) -> bool:
    """Grad mode is on and an operand requires a gradient."""
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in operands)


def no_backward(name: str, fn: Callable, *operands, **kwargs):
    """``fn(*operands, **kwargs)``, behind :class:`NoBackward` when
    :func:`needs_guard` says so."""
    if needs_guard(*operands):
        return NoBackward.apply(name, fn, kwargs, *operands)
    return fn(*operands, **kwargs)
