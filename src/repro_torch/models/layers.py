"""Transformer primitives: norms, RoPE, GQA attention, SwiGLU MLP, the
token cross entropy.

The port of the reference's ``models/layers.py`` for one device: the same
functions over tensors, with no sharding annotations.  Projections and the
MLP are plain products (``torch.einsum`` / ``@``), as the reference leaves
them to XLA; ``rms_norm`` and RoPE compute in f32, as the reference does.

Attention implementations (``RuntimeFlags.attn_impl``):
  dense    materialised scores over the GQA-repeated K/V (the reference's
           ``_dense_attn``, rounding included)
  chunked  online softmax over KV chunks (the reference's ``_chunked_attn``)
  pallas   the hand-written attention kernels (:mod:`..kernels.ops`): the
           CUDA counterparts of the reference's Pallas kernels, reading the
           unrepeated K/V; on CPU tensors their plain versions.  They have
           no backward (nor have the reference's), so a loss through them
           raises on ``backward()``
  auto     in training (``loss_fn``), the reference's rule: ``dense`` up to
           ``dense_attn_max`` query tokens, ``chunked`` beyond; in prefill,
           ``pallas`` (the kernel takes any length; the reference's rule
           would take the plain paths there)
Decode attends the new token over the KV cache with the decode kernel
(``pallas`` / ``auto``) or its plain version, the reference's
``attention_decode`` math (``dense`` / ``chunked``).  The new K/V row is
written into the cache in place at ``pos``, a 0-d int32 device tensor,
without a host sync.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.decode_attention import attention_ref as decode_attention_plain
from ..kernels.flash_attention import MASKED

__all__ = [
    "RuntimeFlags",
    "rms_norm",
    "rope_table",
    "apply_rope",
    "attention",
    "attention_decode",
    "swiglu_mlp",
    "init_attention",
    "init_mlp",
    "cross_entropy_loss",
]

ATTN_IMPLS = ("auto", "dense", "chunked", "pallas")


@dataclass(frozen=True)
class RuntimeFlags:
    """Execution options, the reference's fields and defaults.  In the
    port, ``dense_attn_max`` acts in training only (``auto`` there is
    dense up to it, chunked beyond; prefill takes the kernel),
    ``moe_capacity_factor`` overrides the config's capacity factor in the
    MoE blocks when set, ``seq_shard_prefill`` has no effect (one device),
    and ``remat_policy`` (``"none"``, ``"full"`` or ``"dots"``, training
    only) is :class:`~.transformer.LanguageModel`'s to apply."""

    attn_impl: str = "auto"  # auto | dense | chunked | pallas
    dense_attn_max: int = 8192
    kv_chunk: int = 1024
    remat_policy: str = "none"  # none | full | dots
    compute_dtype: torch.dtype = torch.bfloat16
    moe_capacity_factor: Optional[float] = None
    seq_shard_prefill: bool = False

    def __post_init__(self):
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl {self.attn_impl!r} is not one of {ATTN_IMPLS}")


# --------------------------------------------------------------------------- #
# Norms / RoPE
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.to(torch.float32)
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * scale.to(torch.float32)).to(dtype)


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) tables of shape ``positions.shape + (head_dim // 2,)``."""
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions.to(torch.float32)[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); sin / cos: (..., seq, head_dim/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    sin = sin[..., None, :]  # broadcast over heads
    cos = cos[..., None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------- #
# Attention
# --------------------------------------------------------------------------- #
def _normal(generator: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=generator, device=generator.device) * std
    return x.to(dtype)


def init_attention(generator: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Random attention weights, stacked over ``lead`` (the layer axis)."""
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(H * hd)
    p = {
        "wq": _normal(generator, lead + (D, H, hd), s_in, dtype),
        "wk": _normal(generator, lead + (D, KV, hd), s_in, dtype),
        "wv": _normal(generator, lead + (D, KV, hd), s_in, dtype),
        "wo": _normal(generator, lead + (H, hd, D), s_out, dtype),
    }
    if cfg.qkv_bias:
        for name, heads in (("bq", H), ("bk", KV), ("bv", KV)):
            p[name] = torch.zeros(lead + (heads, hd), dtype=dtype, device=generator.device)
    return p


def attention_specs(cfg) -> dict:
    """Logical axes per attention parameter, the reference's."""
    h = "heads" if cfg.shard_heads_ok() else None
    specs = {
        "wq": ("d_model", h, "head_dim"),
        "wk": ("d_model", "kv_heads", "head_dim"),
        "wv": ("d_model", "kv_heads", "head_dim"),
        "wo": (h, "head_dim", "d_model"),
    }
    if cfg.qkv_bias:
        specs["bq"] = (h, "head_dim")
        specs["bk"] = ("kv_heads", "head_dim")
        specs["bv"] = ("kv_heads", "head_dim")
    return specs


def _project(x, w, b=None):
    y = torch.einsum("bsd,dhk->bshk", x, w)
    return y if b is None else y + b


def _dense_attn(q, k, v, causal: bool):
    hd = q.shape[-1]
    scores = torch.einsum("bqhk,bshk->bhqs", q, k).to(torch.float32) / math.sqrt(hd)
    if causal:
        S, T = scores.shape[-2], scores.shape[-1]
        mask = torch.ones(S, T, dtype=torch.bool, device=q.device).tril(T - S)
        scores = torch.where(mask, scores, torch.full((), MASKED, device=q.device))
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", w, v)


def _chunked_attn(q, k, v, causal: bool, kv_chunk: int):
    """Online softmax over KV chunks (flash-style, O(S * chunk) memory)."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    n_chunks = max(T // kv_chunk, 1)
    if T % n_chunks:
        raise ValueError(f"chunked attention: {T} keys do not split into {n_chunks} chunks")
    c = T // n_chunks
    scale = 1.0 / math.sqrt(hd)
    q32 = q.to(torch.float32)
    q_pos = torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, H, S), -math.inf, device=q.device)
    l = torch.zeros((B, H, S), device=q.device)
    acc = torch.zeros((B, H, S, hd), device=q.device)
    for ci in range(n_chunks):
        kb = k[:, ci * c:(ci + 1) * c].to(torch.float32)
        vb = v[:, ci * c:(ci + 1) * c].to(torch.float32)
        s = torch.einsum("bqhk,bshk->bhqs", q32, kb) * scale
        if causal:
            kv_pos = ci * c + torch.arange(c, device=q.device)[None, :]
            mask = q_pos + (T - S) >= kv_pos  # allow prefix offset
            s = torch.where(mask[None, None], s, torch.full((), MASKED, device=q.device))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqs,bshk->bhqk", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def attention(p: dict, x: torch.Tensor, cfg, sin: torch.Tensor, cos: torch.Tensor,
              flags: RuntimeFlags, causal: bool = True, train: bool = False):
    """Full-sequence attention (prefill, or training with ``train``).
    Returns ``(output, (k, v))``; ``k`` / ``v`` hold the unrepeated KV
    heads, RoPE applied to ``k``, for the decode cache."""
    k_raw = apply_rope(_project(x, p["wk"], p.get("bk")), sin, cos)
    v_raw = _project(x, p["wv"], p.get("bv"))
    q = apply_rope(_project(x, p["wq"], p.get("bq")), sin, cos)
    impl = flags.attn_impl
    if impl == "auto":
        if train:
            impl = "dense" if q.shape[1] <= flags.dense_attn_max else "chunked"
        else:
            impl = "pallas"
    if impl == "pallas":
        out = ops.flash_attention(q, k_raw, v_raw, causal)
    else:
        group = cfg.num_heads // cfg.num_kv_heads
        k = k_raw.repeat_interleave(group, dim=2) if group > 1 else k_raw
        v = v_raw.repeat_interleave(group, dim=2) if group > 1 else v_raw
        if impl == "chunked":
            out = _chunked_attn(q, k, v, causal, flags.kv_chunk)
        else:
            out = _dense_attn(q, k, v, causal)
    y = torch.einsum("bqhk,hkd->bqd", out, p["wo"])
    return y, (k_raw, v_raw)


def attention_decode(p: dict, x: torch.Tensor, cfg, pos: torch.Tensor,
                     kv_cache: Tuple[torch.Tensor, torch.Tensor], flags: RuntimeFlags):
    """One-token decode: ``x`` ``(B, 1, D)``, ``pos`` the 0-d int32 index of
    the new token, ``kv_cache`` one layer's ``(B, S_max, KV, hd)`` K and V.
    Writes the new K/V row at ``pos`` **in place** and returns
    ``(output, (k_cache, v_cache))``."""
    sin, cos = rope_table(pos.reshape(1), cfg.resolved_head_dim, cfg.rope_theta)
    q = apply_rope(_project(x, p["wq"], p.get("bq")), sin[None], cos[None])
    k = apply_rope(_project(x, p["wk"], p.get("bk")), sin[None], cos[None])
    v = _project(x, p["wv"], p.get("bv"))
    ck, cv = kv_cache
    row = pos.reshape(1).to(torch.int64)
    ck.index_copy_(1, row, k.to(ck.dtype))
    cv.index_copy_(1, row, v.to(cv.dtype))
    if flags.attn_impl in ("auto", "pallas"):
        out = ops.decode_attention(q, ck, cv, pos)
    else:
        out = decode_attention_plain(q[:, 0], ck, cv, pos).unsqueeze(1)
    y = torch.einsum("bqhk,hkd->bqd", out, p["wo"])
    return y, (ck, cv)


# --------------------------------------------------------------------------- #
# MLP
# --------------------------------------------------------------------------- #
def init_mlp(generator: torch.Generator, d_model: int, d_ff: int, dtype, lead=()) -> dict:
    """Random SwiGLU weights, stacked over ``lead`` (the layer axis)."""
    lead = tuple(lead)
    s_in, s_out = 1.0 / math.sqrt(d_model), 1.0 / math.sqrt(d_ff)
    return {
        "wi_gate": _normal(generator, lead + (d_model, d_ff), s_in, dtype),
        "wi_up": _normal(generator, lead + (d_model, d_ff), s_in, dtype),
        "wo": _normal(generator, lead + (d_ff, d_model), s_out, dtype),
    }


#: logical axes of the SwiGLU leaves, the reference's
MLP_SPECS = {
    "wi_gate": ("d_model", "ff"),
    "wi_up": ("d_model", "ff"),
    "wo": ("ff", "d_model"),
}


def swiglu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ p["wi_gate"]) * (x @ p["wi_up"])) @ p["wo"]


# --------------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------------- #
def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross entropy in f32, the reference's arithmetic: the
    row max held out of the gradient (``detach``, the reference's
    ``stop_gradient``), the gold logit taken by a masked sum over the
    vocabulary, and with ``mask`` the masked mean over at least one
    token."""
    l32 = logits.to(torch.float32)
    m = l32.amax(dim=-1).detach()
    z = torch.exp(l32 - m[..., None])
    logz = torch.log(z.sum(dim=-1)) + m
    vocab = torch.arange(l32.shape[-1], device=l32.device)
    gold = torch.where(vocab == targets[..., None], l32, 0.0).sum(dim=-1)
    nll = logz - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
