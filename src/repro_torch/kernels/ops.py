"""Model-facing entry points of the port's kernels, with the layouts of
the reference's ``kernels/ops.py``.

* ``flash_attention`` / ``decode_attention``: ``(B, S, H, hd)`` queries
  over ``(B, T, KV, hd)`` keys and values.  The reference broadcasts the
  KV heads to the query heads before its kernels; here the kernels read
  KV head ``h // (H // KV)`` in place, so pre-broadcast (``KV == H``) and
  grouped K/V both work and no repeated copy is made.  There are no block
  arguments: the Pallas grid has no counterpart here.
* ``wkv6``: the RWKV-6 recurrence on ``(B, S, H, hd)`` r, k, v, w with
  ``u`` ``(H, hd)`` and the ``(B, H, hd, hd)`` state.  The reference
  transposes to ``(B * H, S, hd)`` and broadcasts ``u`` to every batch
  row; here the kernel reads the model layout and ``u`` per head in
  place, and there is no ``chunk`` argument (the Pallas grid's block).
* ``selective_scan``: Mamba's scan (the reference's ``models/ssm._ssm_scan``,
  a ``lax.scan`` with no Pallas kernel) on ``(B, S, din)`` ``dt`` and
  ``x``, ``A`` ``(din, ds)``, ``(B, S, ds)`` ``Bc`` / ``Cc`` and the ``(B,
  din, ds)`` state: one launch of ``csrc/mamba_scan.cu`` a call on the
  card.
* ``quantize_checkpoint`` / ``dequantize_checkpoint``: a leaf of any shape
  in, the codec's ``(n_blocks, 256)`` int8 codes and ``(n_blocks, 1)`` f32
  scales out.  The kernels read the leaf flat with its length, so no
  padded copy is made.

``flash_attention`` and ``decode_attention`` have no backward, as the
reference's Pallas kernels have no VJP: given an operand that requires a
gradient they run behind :class:`.guard.NoBackward`, whose backward
raises, on the card and on the CPU alike.  ``wkv6`` and
``selective_scan`` are differentiable, as the reference's ``lax.scan``s
are: given such an operand they run inside an autograd Function whose
backward is a hand-written kernel on the card (``csrc/rwkv6_bwd.cu``,
``csrc/mamba_scan_bwd.cu``) and its plain version on the CPU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import decode_attention as _decode
from . import flash_attention as _flash
from . import mamba as _mamba
from . import rwkv6 as _rwkv6
from .ckpt_codec import dequantize_blocks, quantize_blocks
from .guard import no_backward

__all__ = ["flash_attention", "decode_attention", "wkv6", "selective_scan",
           "quantize_checkpoint", "dequantize_checkpoint"]


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q ``(B, S, H, hd)``; k, v ``(B, T, KV, hd)`` -> ``(B, S, H, hd)``
    (the kernel of ``flash_attention_bhsd``)."""
    return no_backward("flash_attention_bhsd", _flash.attention, q, k, v, causal=causal)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
    """q ``(B, 1, H, hd)``; caches k, v ``(B, S_max, KV, hd)``; ``pos``
    the 0-d int32 index of the newest valid cache row -> ``(B, 1, H, hd)``
    (the kernel of ``decode_attention_bhd``)."""
    return no_backward("decode_attention_bhd", _decode.attention, q[:, 0], k, v,
                       pos).unsqueeze(1)


#: the kernel of ``wkv6_bhsd`` in the model layout (its docstring holds the
#: shapes); the wrapper is already this layout's, so it is the entry itself
#: (its backward set up there)
wkv6 = _rwkv6.wkv

#: Mamba's selective scan, already in the model's layout (its backward set
#: up there)
selective_scan = _mamba.selective_scan


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
