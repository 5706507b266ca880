"""RWKV-6 (Finch) time mix and channel mix: the port of the RWKV part of
the reference's ``models/ssm.py`` for one device (no sharding
annotations).

The time mix is the reference's Finch core: a static token-shift lerp
(``mu``), r / k / v / g projections, a data-dependent per-channel decay
``w_t = exp(-exp(w0 + LoRA(x_t)))``, the bonus ``u``, the WKV recurrence
over a per-head ``(hd, hd)`` f32 state, a per-head group norm and the
gated output projection.  The recurrence runs through
:func:`..kernels.ops.wkv6`, the hand-written CUDA kernel on the card (its
plain version on the CPU), in prefill and in decode (one token), where
the reference runs a ``lax.scan`` that XLA fuses.

Rounding follows the reference: the token-shift mixes are computed in f32
(``mu`` is f32) and rounded to the compute dtype; r, k, v are products in
the compute dtype cast to f32; the decay LoRA is two products in the
compute dtype (``(x @ a) @ b``, the reference's three-operand einsum);
``w`` and the group norm are f32 (population variance, as ``jnp.var``).

Decode state (the caller's cache, per layer): the WKV state ``(B, H, hd,
hd)`` f32 and the previous token's mixer input ``(B, D)``, kept in bf16
by the model as the reference keeps it.  Decode is the same functions
given the cache (the reference's ``rwkv_decode`` and
``rwkv_channel_mix_decode`` are aliases of them).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..kernels import ops
from .layers import _normal

__all__ = [
    "init_rwkv",
    "rwkv_apply",
    "rwkv_cache_spec",
    "init_rwkv_channel_mix",
    "rwkv_channel_mix",
]

#: group-norm epsilon of the reference's time mix
GN_EPS = 1e-5


# --------------------------------------------------------------------------- #
# Time mix
# --------------------------------------------------------------------------- #
def init_rwkv(generator: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Random time-mix weights, stacked over ``lead`` (the layer axis), by
    the reference's laws: ``mu`` 0.5, ``w0`` and ``u`` zeros, ``ln``
    ones, the products normal."""
    D, hd, H, lora = cfg.d_model, cfg.ssm.rwkv_head_dim, cfg.rwkv_heads, cfg.ssm.decay_lora
    lead = tuple(lead)
    dev = generator.device
    s = 1.0 / math.sqrt(D)
    return {
        "mu": torch.full(lead + (5, D), 0.5, device=dev),  # r, k, v, w, g shift lerps
        "w0": torch.zeros(lead + (H, hd), device=dev),
        "w_lora_a": _normal(generator, lead + (D, lora), s, dtype),
        "w_lora_b": _normal(generator, lead + (lora, H, hd), 0.1, dtype),
        "u": torch.zeros(lead + (H, hd), device=dev),
        "wr": _normal(generator, lead + (D, H, hd), s, dtype),
        "wk": _normal(generator, lead + (D, H, hd), s, dtype),
        "wv": _normal(generator, lead + (D, H, hd), s, dtype),
        "wg": _normal(generator, lead + (D, H, hd), s, dtype),
        "wo": _normal(generator, lead + (H, hd, D), 1.0 / math.sqrt(H * hd), dtype),
        "ln": torch.ones(lead + (H, hd), device=dev),
    }


def _token_shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """xs[t] = x[t-1]; xs[0] = last."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x`` ``(B, S, D)`` times ``w`` ``(D, H, hd)`` -> ``(B, S, H, hd)``."""
    B, S, _ = x.shape
    return (x @ w.reshape(w.shape[0], -1)).view(B, S, *w.shape[1:])


def _rwkv_projections(p: dict, x: torch.Tensor, last: torch.Tensor):
    xs = _token_shift(x, last)
    mu = p["mu"]
    d = xs - x
    xi = [(x + mu[i] * d).to(x.dtype) for i in range(5)]  # r, k, v, w, g
    f32 = torch.float32
    r = _heads(xi[0], p["wr"]).to(f32)
    k = _heads(xi[1], p["wk"]).to(f32)
    v = _heads(xi[2], p["wv"]).to(f32)
    g = _heads(xi[4], p["wg"])
    dd = _heads(xi[3] @ p["w_lora_a"], p["w_lora_b"])
    w = torch.exp(-torch.exp(p["w0"] + dd.to(f32)))  # decays in (0, 1)
    return r, k, v, w, g


def rwkv_apply(p: dict, x: torch.Tensor, cache: Optional[dict] = None, *,
               state_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """The time mix over ``x`` ``(B, S, D)``, from ``cache`` (``state``
    ``(B, H, hd, hd)`` f32 and ``last`` ``(B, D)``) or, without one, from a
    zero state and a zero previous token.  Returns ``(out, {"state": sT,
    "last": x[:, -1]})``; the final state is written into ``state_out``
    when given (it may be ``cache["state"]``: decode in place)."""
    B, S, D = x.shape
    last = cache["last"].to(x.dtype) if cache else x.new_zeros((B, D))
    s0 = cache["state"] if cache else None
    r, k, v, w, g = _rwkv_projections(p, x, last)
    y, sT = ops.wkv6(r, k, v, w, p["u"], s0, state_out=state_out)
    # per-head group norm, population variance (ddof 0)
    mean = y.mean(dim=-1, keepdim=True)
    c = y - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = c * torch.rsqrt(var + GN_EPS) * p["ln"]
    y = y.to(x.dtype) * (g * torch.sigmoid(g))  # jax.nn.silu's two roundings
    out = y.reshape(B, S, -1) @ p["wo"].reshape(-1, D)
    return out, {"state": sT, "last": x[:, -1, :]}


def rwkv_cache_spec(cfg, batch: int) -> dict:
    """The time mix's decode state, ``{name: (shape, dtype)}``."""
    H, hd = cfg.rwkv_heads, cfg.ssm.rwkv_head_dim
    return {
        "state": ((batch, H, hd, hd), torch.float32),
        "last": ((batch, cfg.d_model), torch.bfloat16),
    }


# --------------------------------------------------------------------------- #
# Channel mix
# --------------------------------------------------------------------------- #
def init_rwkv_channel_mix(generator: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Random channel-mix weights, stacked over ``lead``, by the
    reference's laws."""
    D, Fd = cfg.d_model, cfg.d_ff
    lead = tuple(lead)
    return {
        "mu": torch.full(lead + (2, D), 0.5, device=generator.device),
        "wk": _normal(generator, lead + (D, Fd), 1.0 / math.sqrt(D), dtype),
        "wv": _normal(generator, lead + (Fd, D), 1.0 / math.sqrt(Fd), dtype),
        "wr": _normal(generator, lead + (D, D), 1.0 / math.sqrt(D), dtype),
    }


def rwkv_channel_mix(p: dict, x: torch.Tensor, last: Optional[torch.Tensor] = None):
    """``(out, x[:, -1])`` of the channel mix over ``x`` ``(B, S, D)``,
    shifting in ``last`` (zeros if None)."""
    if last is None:
        last = x.new_zeros((x.shape[0], x.shape[2]))
    xs = _token_shift(x, last)
    d = xs - x
    xk = (x + p["mu"][0] * d).to(x.dtype)
    xr = (x + p["mu"][1] * d).to(x.dtype)
    k = torch.relu(xk @ p["wk"]).square()
    kv = k @ p["wv"]
    return torch.sigmoid(xr @ p["wr"]) * kv, x[:, -1, :]
