"""Entry points of the port's checkpoint kernels, with the layout of the
reference's ``kernels/ops.py`` (``quantize_checkpoint`` /
``dequantize_checkpoint``): a leaf of any shape in, the codec's
``(n_blocks, 256)`` int8 codes and ``(n_blocks, 1)`` f32 scales out.  The
kernels read the leaf flat with its length, so no padded copy is made.
There is no ``tile`` argument: the Pallas grid has no counterpart here."""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .ckpt_codec import dequantize_blocks, quantize_blocks

__all__ = ["quantize_checkpoint", "dequantize_checkpoint"]


def _flat_f32(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(-1).to(torch.float32).contiguous()


def quantize_checkpoint(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Leaf (f32 or f16) -> ``(q, s, n)``: int8 codes, f32 scales and the
    leaf's element count; with ``prev`` (as many elements), the codes of
    ``x - prev``."""
    q, s = quantize_blocks(_flat_f32(x), None if prev is None else _flat_f32(prev))
    return q, s, x.numel()


def dequantize_checkpoint(q: torch.Tensor, s: torch.Tensor, n: int,
                          shape: Sequence[int], prev: Optional[torch.Tensor] = None):
    """The f32 leaf of shape ``shape`` (``n`` elements) that ``q`` and
    ``s`` code, plus ``prev`` for the delta codec."""
    p = None if prev is None else _flat_f32(prev)
    return dequantize_blocks(q.contiguous(), s.contiguous(), p, n=n).reshape(tuple(shape))
