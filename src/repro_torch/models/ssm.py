"""State-space and linear-recurrence mixers: Mamba (Jamba) and RWKV-6
(Finch), the port of the reference's ``models/ssm.py`` for one device (no
sharding annotations).

**Mamba.**  The input projection splits into ``x`` and the gate ``z``; a
depthwise causal convolution over the sequence (``d_conv`` taps, its last
``d_conv - 1`` inputs kept as decode state), SiLU, the ``x_proj`` product
whose columns are ``dt_raw``, ``B`` and ``C``, ``dt = softplus(dt_raw @
dt_w + dt_b)``, ``A = -exp(A_log)``, the selective scan over a ``(d_inner,
d_state)`` f32 state, the skip ``D_skip * x``, the gate ``silu(z)`` and the
output projection.  The scan runs through :func:`..kernels.ops.
selective_scan`: the hand-written CUDA kernel on the card (its plain
version on the CPU), where the reference runs a ``lax.scan``.

Rounding follows the reference: the convolution sums its taps in the
compute dtype in tap order, ``((p0 + p1) + p2) + p3``, then adds the bias;
``B`` and ``C`` are sliced from the compute-dtype ``x_proj`` output and
cast to f32; ``dt_raw @ dt_w + dt_b`` takes ``dt_b``'s dtype when it is
wider (``dt_b`` stays out of the compute cast, as in the reference's
``_KEEP_F32``: f32 with f32 params, the param dtype otherwise); the
softplus is ``jax.nn.softplus``'s ``logaddexp(x, 0)``, ``max(x, 0) +
log1p(exp(-|x|))`` (torch's ``F.softplus`` switches to ``x`` above 20); the
scan output plus the skip is f32, rounded to the compute dtype before the
gate.  SiLU is ``x * sigmoid(x)``, ``jax.nn.silu``'s two roundings.

Decode state (the caller's cache, per layer): ``conv`` ``(B, d_conv - 1,
d_inner)``, kept in bf16 whatever the compute dtype (the reference stores
it so and decode reads it back in the compute dtype), and ``ssm`` ``(B,
d_inner, d_state)`` f32.  Decode is :func:`mamba_apply` at S = 1 given the
cache (the reference's ``mamba_decode`` is an alias of it).

**RWKV-6.**  The time mix is the reference's Finch core: a static
token-shift lerp (``mu``), r / k / v / g projections, a data-dependent
per-channel decay ``w_t = exp(-exp(w0 + LoRA(x_t)))``, the bonus ``u``, the
WKV recurrence over a per-head ``(hd, hd)`` f32 state, a per-head group
norm and the gated output projection.  The recurrence runs through
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
    "init_mamba",
    "mamba_apply",
    "mamba_decode",
    "mamba_cache_spec",
    "softplus",
    "init_rwkv",
    "rwkv_apply",
    "rwkv_cache_spec",
    "init_rwkv_channel_mix",
    "rwkv_channel_mix",
]

#: group-norm epsilon of the reference's time mix
GN_EPS = 1e-5


# --------------------------------------------------------------------------- #
# Mamba
# --------------------------------------------------------------------------- #
def _dt_rank(cfg) -> int:
    return cfg.ssm.dt_rank or math.ceil(cfg.d_model / 16)


#: logical axes of the Mamba leaves, the reference's
MAMBA_SPECS = {
    "in_proj": ("d_model", "inner"),
    "conv_w": ("inner", None),
    "conv_b": ("inner",),
    "x_proj": ("inner", None),
    "dt_w": (None, "inner"),
    "dt_b": ("inner",),
    "A_log": ("inner", "state"),
    "D_skip": ("inner",),
    "out_proj": ("inner", "d_model"),
}


def init_mamba(generator: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Random Mamba weights, stacked over ``lead`` (the layer axis), by the
    reference's laws: the products normal, ``conv_b`` zeros, ``dt_b``
    -4.6 (softplus^-1(0.01)) in the param dtype, ``A_log`` ``log(1..ds)``
    per channel and ``D_skip`` ones, both f32."""
    D, din, ds, dc = cfg.d_model, cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    dtr = _dt_rank(cfg)
    lead = tuple(lead)
    dev = generator.device
    a_log = torch.log(torch.arange(1, ds + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": _normal(generator, lead + (D, 2 * din), 1.0 / math.sqrt(D), dtype),
        "conv_w": _normal(generator, lead + (din, dc), 0.2, dtype),
        "conv_b": torch.zeros(lead + (din,), dtype=dtype, device=dev),
        "x_proj": _normal(generator, lead + (din, dtr + 2 * ds), 1.0 / math.sqrt(din), dtype),
        "dt_w": _normal(generator, lead + (dtr, din), 1.0 / math.sqrt(dtr), dtype),
        "dt_b": torch.full(lead + (din,), -4.6, dtype=dtype, device=dev),
        "A_log": a_log.expand(lead + (din, ds)).clone(),
        "D_skip": torch.ones(lead + (din,), device=dev),
        "out_proj": _normal(generator, lead + (din, D), 1.0 / math.sqrt(din), dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))``
    in ``x``'s dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)  # jax.nn.silu's two roundings


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal convolution over the sequence: ``x`` ``(B, S,
    din)``, ``w`` ``(din, K)``, ``b`` ``(din,)``, ``state`` the previous
    ``K - 1`` inputs (zeros if None) -> ``(y, the last K - 1 inputs)``."""
    K = w.shape[1]
    B, S, din = x.shape
    pad = x.new_zeros((B, K - 1, din)) if state is None else state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, S + K - 1, din)
    y = xp[:, :S] * w[:, 0]
    for j in range(1, K):
        y = y + xp[:, j:j + S] * w[:, j]
    return y + b, (xp[:, -(K - 1):] if K > 1 else pad)


def mamba_apply(p: dict, x: torch.Tensor, cfg, cache: Optional[dict] = None, *,
                state_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, dict]:
    """The Mamba mixer over ``x`` ``(B, S, D)``, from ``cache`` (``conv``
    ``(B, d_conv - 1, din)``, ``ssm`` ``(B, din, ds)`` f32) or, without
    one, from zeros.  Returns ``(out, {"conv": the last d_conv - 1 conv
    inputs (compute dtype), "ssm": the final state})``; the final state is
    written into ``state_out`` when given (it may be ``cache["ssm"]``:
    decode in place)."""
    ds, dtr = cfg.ssm.d_state, _dt_rank(cfg)
    f32 = torch.float32
    xin, z = (x @ p["in_proj"]).chunk(2, dim=-1)
    xc, new_conv = _causal_conv(xin, p["conv_w"], p["conv_b"], cache["conv"] if cache else None)
    xc = _silu(xc)
    dbc = xc @ p["x_proj"]
    Bc = dbc[..., dtr:dtr + ds].to(f32)
    Cc = dbc[..., dtr + ds:].to(f32)
    dt = softplus(dbc[..., :dtr] @ p["dt_w"] + p["dt_b"]).to(f32)
    A = -torch.exp(p["A_log"])
    xc32 = xc.to(f32)
    y, h = ops.selective_scan(dt, xc32, A, Bc, Cc, cache["ssm"] if cache else None,
                              state_out=state_out)
    y = (y + p["D_skip"] * xc32).to(x.dtype) * _silu(z)
    return y @ p["out_proj"], {"conv": new_conv, "ssm": h}


#: the reference's decode entry: the same function given the cache
mamba_decode = mamba_apply


def mamba_cache_spec(cfg, batch: int) -> dict:
    """The mixer's decode state, ``{name: (shape, dtype)}``: the conv
    window in bf16 and the SSM state in f32."""
    din, ds, dc = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    return {
        "conv": ((batch, dc - 1, din), torch.bfloat16),
        "ssm": ((batch, din, ds), torch.float32),
    }


# --------------------------------------------------------------------------- #
# Time mix
# --------------------------------------------------------------------------- #
#: logical axes of the RWKV6 time-mix leaves, the reference's
RWKV_SPECS = {
    "mu": (None, "d_model"),
    "w0": ("heads", None),
    "w_lora_a": ("d_model", None),
    "w_lora_b": (None, "heads", None),
    "u": ("heads", None),
    "wr": ("d_model", "heads", None),
    "wk": ("d_model", "heads", None),
    "wv": ("d_model", "heads", None),
    "wg": ("d_model", "heads", None),
    "wo": ("heads", None, "d_model"),
    "ln": ("heads", None),
}


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
#: logical axes of the RWKV6 channel-mix leaves, the reference's
RWKV_CM_SPECS = {
    "mu": (None, "d_model"),
    "wk": ("d_model", "ff"),
    "wv": ("ff", "d_model"),
    "wr": ("d_model", None),
}


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
