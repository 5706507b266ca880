"""One decode step's attention: the plain PyTorch version and the CUDA
kernel wrapper.

:func:`decode_attention_bhd` attends one query row per (batch, head),
``q`` ``(BH, hd)``, over a cache ``k`` / ``v`` ``(BHk, S_max, hd)`` of
which rows ``0..pos`` take part (the reference's kernel layout; query row
``bh`` reads cache row ``bh // (BH // BHk)``).  :func:`attention` is the
same function in the model layout, ``q`` ``(B, H, hd)`` over the serving
cache ``(B, S_max, KV, hd)``.  Both wrap the hand-written CUDA kernels of
``csrc/decode_attention.cu`` (built by :mod:`.build`), which replace the
reference's Pallas kernel of the same name.

A call on CUDA tensors launches two device kernels on the current stream
(flash-decoding): a split pass over ``split_count(S_max)`` blocks per
(KV head, batch), each taking ``SPLIT_ROWS`` (128, a constant of the
kernel's source) cache rows and writing its running max, sum and
unnormalised accumulator to an f32 scratch ``(B, H, splits, hd + 2)``
that the wrapper allocates; then a combine pass that merges the live
splits in split order.  The grid depends on ``S_max`` only, never on
``pos``.

``pos`` is a 0-d int32 tensor on the operands' device: the kernels read
it there, so a step never waits for the host and can be replayed as a
CUDA graph at any ``pos``.  Scores and softmax are f32; ``q`` may be f32
over a bf16 cache; the output has ``q``'s dtype.
:func:`decode_attention_ref` is the plain version (the math of the
reference's ``kernels/ref.decode_attention_ref`` and
``models/layers.attention_decode``).  A wrapper given CPU tensors runs
the plain version; given CUDA tensors it launches the kernels or raises.
``decode_attention_bhd.launches`` counts calls (one per attention, two
device kernels each) from either entry.
"""

from __future__ import annotations

import math

import torch

from .flash_attention import (
    _DTYPE_CODE, MASKED, _check_device, _check_heads, _rows_aligned,
)
from .sim_step import _raise_on, _stream_ptr

__all__ = ["decode_attention_ref", "decode_attention_bhd", "attention", "attention_ref",
           "split_count", "SPLIT_ROWS"]

#: cache rows per block of the split pass: ``kSplitRows`` of
#: ``csrc/decode_attention.cu`` (PERF.md has the sweep that chose it)
SPLIT_ROWS = 128


def split_count(s_max: int) -> int:
    """Blocks of the split pass per (KV head, batch) for a cache of
    ``s_max`` rows: ``ceil(s_max / SPLIT_ROWS)``.  Depends on the cache's
    size only, never on ``pos``."""
    return -(-s_max // SPLIT_ROWS)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  pos: torch.Tensor) -> torch.Tensor:
    """Plain version in the model layout: ``q`` ``(B, H, hd)``, cache
    ``k`` / ``v`` ``(B, S_max, KV, hd)``, ``pos`` 0-d -> ``(B, H, hd)`` in
    ``q``'s dtype."""
    B, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.to(torch.float32).reshape(B, KV, H // KV, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.to(torch.float32)) / math.sqrt(hd)
    valid = torch.arange(S, device=q.device) <= pos
    s = torch.where(valid, s, torch.full((), MASKED, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.to(torch.float32))
    return out.reshape(B, H, hd).to(q.dtype)


def _as_model_layout(q, k, v):
    BH, hd = q.shape
    BHk = k.shape[0]
    if BHk < 1 or BH % BHk:
        raise ValueError(f"decode_attention_bhd: {BH} query rows do not group over {BHk} cache rows")
    return q.reshape(BHk, BH // BHk, hd), k.unsqueeze(2), v.unsqueeze(2)


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Plain version in the kernel layout: ``q`` ``(BH, hd)``, ``k`` /
    ``v`` ``(BHk, S_max, hd)`` -> ``(BH, hd)``."""
    q3, k4, v4 = _as_model_layout(q, k, v)
    return attention_ref(q3, k4, v4, pos).reshape(q.shape)


def _check(name, q, k, v, pos):
    for arg, x, nd in (("q", q, 3), ("k", k, 4), ("v", v, 4)):
        if not isinstance(x, torch.Tensor) or x.dim() != nd:
            raise TypeError(f"{name}: {arg} must be a {nd}-D tensor")
        if x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected float32 or bfloat16")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dimension is not contiguous")
    if v.dtype != k.dtype:
        raise TypeError(f"{name}: k is {k.dtype} and v is {v.dtype}")
    if not isinstance(pos, torch.Tensor) or pos.dtype != torch.int32 or pos.numel() != 1:
        raise TypeError(f"{name}: pos must be a one-element int32 tensor")
    B, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd or k.shape[1] < 1:
        raise ValueError(f"{name}: cache k {tuple(k.shape)} / v {tuple(v.shape)} does "
                         f"not match q {tuple(q.shape)}")
    _check_heads(name, H, k.shape[2], hd)
    return _check_device(name, (q, k, v, pos))


def _launch(q3, k4, v4, pos, o3) -> None:
    """Launch the split and combine kernels on (batch, head, hd) and
    (batch, seq, head, hd) views."""
    from . import build

    B, H, hd = q3.shape
    S, KV = k4.shape[1], k4.shape[2]
    if B > 65535 or KV > 65535:
        raise ValueError("decode_attention_bhd: batch and KV heads must each be <= 65535")
    part = torch.empty(B * H * split_count(S) * (hd + 2), dtype=torch.float32,
                       device=q3.device)
    rc = build.load("decode_attention").decode_attention_fwd(
        q3.data_ptr(), k4.data_ptr(), v4.data_ptr(), pos.data_ptr(), part.data_ptr(),
        o3.data_ptr(), _DTYPE_CODE[q3.dtype], _DTYPE_CODE[k4.dtype], B, H, KV, S, hd,
        int(_rows_aligned((q3, k4, v4), hd)),
        q3.stride(0), q3.stride(1), k4.stride(0), k4.stride(1), k4.stride(2),
        v4.stride(0), v4.stride(1), v4.stride(2), o3.stride(0), o3.stride(1),
        _stream_ptr(q3.device),
    )
    _raise_on("decode_attention_bhd", rc)
    if q3.numel():
        decode_attention_bhd.launches += 1


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              pos: torch.Tensor) -> torch.Tensor:
    """Decode attention in the model layout: ``q`` ``(B, H, hd)``, cache
    ``k`` / ``v`` ``(B, S_max, KV, hd)``, ``pos`` a one-element int32
    tensor -> a fresh ``(B, H, hd)`` in ``q``'s dtype.

    CUDA tensors launch the kernels; CPU tensors run :func:`attention_ref`."""
    dev = _check("attention", q, k, v, pos)
    if dev.type == "cpu":
        return attention_ref(q, k, v, pos.reshape(()))
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(q, k, v, pos, out)
    return out


def decode_attention_bhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> torch.Tensor:
    """Decode attention in the kernel layout: ``q`` ``(BH, hd)``, cache
    ``k`` / ``v`` ``(BHk, S_max, hd)`` with ``BH % BHk == 0``, ``pos`` a
    one-element int32 tensor -> a fresh ``(BH, hd)``.

    CUDA tensors launch the kernels; CPU tensors run
    :func:`decode_attention_ref`."""
    for arg, x, nd in (("q", q, 2), ("k", k, 3), ("v", v, 3)):
        if not isinstance(x, torch.Tensor) or x.dim() != nd:
            raise TypeError(f"decode_attention_bhd: {arg} must be a {nd}-D tensor")
    q3, k4, v4 = _as_model_layout(q, k, v)
    dev = _check("decode_attention_bhd", q3, k4, v4, pos)
    if dev.type == "cpu":
        return decode_attention_ref(q, k, v, pos.reshape(()))
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(q3, k4, v4, pos, out.reshape(q3.shape))
    return out


decode_attention_bhd.launches = 0
