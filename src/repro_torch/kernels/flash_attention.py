"""Attention forward (prefill): the plain PyTorch version and the CUDA
kernel wrapper.

:func:`flash_attention_bhsd` computes ``softmax(q kᵀ / sqrt(hd) [causal])
v`` per (batch, head) in the reference's kernel layout, ``q`` ``(BH, S,
hd)`` and ``k`` / ``v`` ``(BHk, T, hd)``; query row ``bh`` reads K/V row
``bh // (BH // BHk)``, so pre-broadcast K/V (``BHk == BH``) and grouped
K/V (GQA) both work.  :func:`attention` is the same function in the model
layout, ``q`` ``(B, S, H, hd)`` and ``k`` / ``v`` ``(B, T, KV, hd)``,
where query head ``h`` reads KV head ``h // (H // KV)``.  Both wrap the
hand-written CUDA kernels of ``csrc/flash_attention.cu`` (built by
:mod:`.build`), which replace the reference's Pallas kernel of the same
name; the kernels take strided operands, so neither layout is copied and
the GQA repeat is never made.

A call on CUDA tensors launches one device kernel, chosen by the
operands alone (:func:`kernel_variant`): bf16 operands whose rows start
16-byte aligned, with ``hd % 8 == 0``, take the tensor-core kernel
(``"tc"``: ``wgmma`` products, P rounded once to bf16 before P V, as
SDPA does); everything else -- f32, or unaligned bf16 -- takes the f32
kernel on the CUDA cores (``"simt"``, exact to 2e-6).

The causal mask lets row ``r`` see column ``c <= r + (T - S)`` (the
prefix offset of the reference's ``models/layers._dense_attn``); masked
scores are -1e30, so a row that sees no column averages ``v``.  Scores,
softmax and the weighted sum accumulate in f32; the output has ``q``'s
dtype (f32 or bf16).  :func:`flash_attention_ref` is the plain version
(the math of the reference's ``kernels/ref.flash_attention_ref``, a
materialised f32 softmax).  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches a kernel or raises.
``flash_attention_bhsd.launches`` counts the launches from either entry,
``flash_attention_bhsd.tc_launches`` those of the tensor-core kernel.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .sim_step import _raise_on, _stream_ptr

__all__ = ["flash_attention_ref", "flash_attention_bhsd", "attention", "attention_ref",
           "kernel_variant"]

MASKED = -1e30
#: kernel dtype codes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128


def _check_device(name: str, tensors: Sequence[torch.Tensor]) -> torch.device:
    """One device for all, the current one if CUDA; returns it."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev:
            raise ValueError(f"{name}: operands on {x.device} and {dev}")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _check_heads(name: str, H: int, KV: int, hd: int) -> None:
    if KV < 1 or H % KV:
        raise ValueError(f"{name}: {H} query heads do not group over {KV} KV heads")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {hd} is outside 1..{MAX_HEAD_DIM}")


def _rows_aligned(tensors: Sequence[torch.Tensor], hd: int) -> bool:
    """Every row start of every operand 16-byte aligned (the kernels'
    vector loads), for rows of ``hd`` elements with ``hd % 8 == 0``."""
    if hd % 8:
        return False
    for x in tensors:
        per16 = 16 // x.element_size()
        if x.data_ptr() % 16 or any(s % per16 for s in x.stride()[:-1]):
            return False
    return True


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True) -> torch.Tensor:
    """Plain version in the model layout: ``q`` ``(B, S, H, hd)``, ``k`` /
    ``v`` ``(B, T, KV, hd)`` -> ``(B, S, H, hd)`` in ``q``'s dtype."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.to(torch.float32).reshape(B, S, KV, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.to(torch.float32)) / math.sqrt(hd)
    if causal:
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        s = torch.where(mask, s, torch.full((), MASKED, device=q.device))
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(torch.float32))
    return out.reshape(B, S, H, hd).to(q.dtype)


def _as_model_layout(q, k, v):
    """Views of kernel-layout ``(BH, S, hd)`` / ``(BHk, T, hd)`` operands
    in the model layout, with batch ``BHk`` and ``BH // BHk`` heads."""
    BH, S, hd = q.shape
    BHk, T = k.shape[0], k.shape[1]
    if BHk < 1 or BH % BHk:
        raise ValueError(f"flash_attention_bhsd: {BH} query rows do not group over {BHk} K/V rows")
    G = BH // BHk
    q4 = q.reshape(BHk, G, S, hd).transpose(1, 2)
    return q4, k.unsqueeze(2), v.unsqueeze(2)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Plain version in the kernel layout: ``q`` ``(BH, S, hd)``, ``k`` /
    ``v`` ``(BHk, T, hd)`` -> ``(BH, S, hd)``."""
    q4, k4, v4 = _as_model_layout(q, k, v)
    return attention_ref(q4, k4, v4, causal).transpose(1, 2).reshape(q.shape)


def _check(name, q, k, v):
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 4:
            raise TypeError(f"{name}: {arg} must be a 4-D tensor")
        if x.dtype != q.dtype or x.dtype not in _DTYPE_CODE:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}; q, k and v must "
                            "all be float32 or all bfloat16")
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: {arg}'s last dimension is not contiguous")
    B, S, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1:
        raise ValueError(f"{name}: no keys")
    _check_heads(name, H, k.shape[2], hd)
    return _check_device(name, (q, k, v))


def kernel_variant(q4: torch.Tensor, k4: torch.Tensor, v4: torch.Tensor,
                   o4: torch.Tensor) -> str:
    """The device kernel a call on these 4-D (batch, seq, head, hd)
    operands launches: ``"tc"`` (tensor cores) for bf16 whose rows all
    start 16-byte aligned with ``hd % 8 == 0``, else ``"simt"`` (f32 on
    the CUDA cores).  Reads dtypes, shapes, strides and addresses only."""
    if q4.dtype == torch.bfloat16 and _rows_aligned((q4, k4, v4, o4), q4.shape[-1]):
        return "tc"
    return "simt"


def _launch(q4, k4, v4, o4, causal: bool) -> None:
    """Launch the kernel :func:`kernel_variant` picks on 4-D (batch, seq,
    head, hd) views."""
    from . import build

    B, S, H, hd = q4.shape
    T, KV = k4.shape[1], k4.shape[2]
    if B > 65535 or H > 65535:
        raise ValueError("flash_attention_bhsd: batch and heads must each be <= 65535")

    def bsh(x):
        s = x.stride()
        return s[0], s[1], s[2]

    lib = build.load("flash_attention")
    strides = (*bsh(q4), *bsh(k4), *bsh(v4), *bsh(o4))
    ptrs = (q4.data_ptr(), k4.data_ptr(), v4.data_ptr(), o4.data_ptr())
    tc = kernel_variant(q4, k4, v4, o4) == "tc"
    if tc:
        rc = lib.flash_attention_tc_fwd(*ptrs, B, H, KV, S, T, hd, int(causal), *strides,
                                        _stream_ptr(q4.device))
    else:
        rc = lib.flash_attention_fwd(*ptrs, _DTYPE_CODE[q4.dtype], B, H, KV, S, T, hd,
                                     int(causal), int(_rows_aligned((q4, k4, v4, o4), hd)),
                                     *strides, _stream_ptr(q4.device))
    _raise_on("flash_attention_bhsd", rc)
    if q4.numel():
        flash_attention_bhsd.launches += 1
        flash_attention_bhsd.tc_launches += int(tc)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool = True) -> torch.Tensor:
    """Attention in the model layout: ``q`` ``(B, S, H, hd)``, ``k`` /
    ``v`` ``(B, T, KV, hd)`` (``H % KV == 0``; any strides with ``hd``
    contiguous) -> a fresh ``(B, S, H, hd)`` in ``q``'s dtype.

    CUDA tensors launch the kernel; CPU tensors run :func:`attention_ref`."""
    dev = _check("attention", q, k, v)
    if dev.type == "cpu":
        return attention_ref(q, k, v, causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    _launch(q, k, v, out, causal)
    return out


def flash_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Attention in the kernel layout: ``q`` ``(BH, S, hd)``, ``k`` / ``v``
    ``(BHk, T, hd)`` with ``BH % BHk == 0`` -> a fresh ``(BH, S, hd)``.

    CUDA tensors launch the kernel; CPU tensors run
    :func:`flash_attention_ref`."""
    for arg, x in (("q", q), ("k", k), ("v", v)):
        if not isinstance(x, torch.Tensor) or x.dim() != 3:
            raise TypeError(f"flash_attention_bhsd: {arg} must be a 3-D tensor")
    q4, k4, v4 = _as_model_layout(q, k, v)
    dev = _check("flash_attention_bhsd", q4, k4, v4)
    if dev.type == "cpu":
        return flash_attention_ref(q, k, v, causal)
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    o4 = out.reshape(q4.shape[0], q4.shape[2], q4.shape[1], q4.shape[3]).transpose(1, 2)
    _launch(q4, k4, v4, o4, causal)
    return out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.tc_launches = 0
