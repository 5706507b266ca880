"""AdamW with optional 8-bit (blockwise-quantized) moments: the port of
the reference's ``optim/adamw.py``.

The 8-bit variant stores m / v as int8 with per-block f32 absmax scales,
blocks of 256 along each tensor's **last** dim (the parameter's own
layout; the scales have shape ``shape[:-1] + (ceil(L / 256),)``).

State layout (a tree mirroring params, under :class:`AdamWState`, a
NamedTuple with the reference's field names, so the checkpoint store keys
it ``opt/.step`` and ``opt/.moments/...`` as the reference's does):
    f32:   {"m": f32[shape], "v": f32[shape]}
    int8:  {"m_q": i8[shape], "m_s": f32[..., nblocks], "v_q": ..., "v_s": ...}

:func:`adamw_update` is functional: it returns new tensors and never
writes into ``params``, ``grads`` or ``state``, so a state kept by a
checkpointer (or by the executor's memory tier) cannot change behind its
back.  The reference maps its update over the leading dim of giant
stacked leaves (``jax.lax.map``) to bound the transient f32 copies; the
port loops over chunks of that dim, each of about ``_SLICE_ELEMS``
elements (the rows are independent: the int8 blocks run along the last
dim, so the bits are the whole leaf's).  A row at a time would be a
Python loop of a launch-bound update per row: Jamba's 65536 x 8192
embedding took ~50 s a step that way on an H100.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..checkpoint.store import flatten_with_keys, map_with_keys

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
]

_BLOCK = 256
#: leaves of at least this many elements (and 2+ dims) update in chunks of
#: leading-dim slices, as the reference's ``jax.lax.map`` maps over them,
#: each chunk of about _SLICE_ELEMS elements (at least one slice)
_SLICED_MIN = 1 << 29
_SLICE_ELEMS = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    moments: Any  # tree of per-param moment dicts


# --------------------------------------------------------------------------- #
# Blockwise int8 quantization along the last dim
# --------------------------------------------------------------------------- #
def _n_blocks(last: int) -> int:
    return (last + _BLOCK - 1) // _BLOCK


def _expand(scale: torch.Tensor, L: int) -> torch.Tensor:
    return scale.repeat_interleave(_BLOCK, dim=-1)[..., :L]


def _scales_of(scale: torch.Tensor, L: int, window) -> torch.Tensor:
    """Each entry's scale: the blocks of the last dim, or, for a
    ``window`` ``(offset, full, _)``, the entries ``offset .. offset + L``
    of a last dim ``full`` long whose blocks all ``scale`` holds."""
    if window is None:
        return _expand(scale, L)
    off, full, _ = window
    return _expand(scale, full)[..., off:off + L]


def _quantize(x: torch.Tensor, window=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: f32[..., L] -> (int8[..., L], f32[..., ceil(L / 256)]).  With a
    ``window`` ``(offset, full, reduce_max)``, ``x`` is entries ``offset
    .. offset + L`` of a last dim ``full`` long whose other entries other
    ranks hold (ZeRO-1 on the last dim): each block's largest ``|x|`` is
    taken over the ranks by ``reduce_max``, so every rank has the whole
    leaf's scales and codes its entries as the whole leaf would be."""
    if x.dim() == 0:
        x = x[None]
    L = x.shape[-1]
    if window is None:
        nb = _n_blocks(L)
        a = F.pad(x.abs(), (0, nb * _BLOCK - L))  # |x| >= 0: zero pads leave the max
        amax = a.reshape(x.shape[:-1] + (nb, _BLOCK)).amax(dim=-1)
    else:
        off, full, reduce_max = window
        nb = _n_blocks(full)
        a = torch.zeros(x.shape[:-1] + (nb * _BLOCK,), dtype=x.dtype, device=x.device)
        a[..., off:off + L] = x.abs()
        amax = reduce_max(a.reshape(x.shape[:-1] + (nb, _BLOCK)).amax(dim=-1))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(x / _scales_of(scale, L, window)), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape=None, window=None) -> torch.Tensor:
    out = q.to(torch.float32) * _scales_of(scale, q.shape[-1], window)
    return out if shape is None else out.reshape(shape)


# --------------------------------------------------------------------------- #
# init / update
# --------------------------------------------------------------------------- #
def _init_leaf(p: torch.Tensor, quantize: bool) -> Dict[str, torch.Tensor]:
    dev = p.device
    if quantize:
        shape = tuple(p.shape) if p.dim() else (1,)
        s_shape = shape[:-1] + (_n_blocks(shape[-1]),)
        return {
            "m_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "m_s": torch.zeros(s_shape, dtype=torch.float32, device=dev),
            "v_q": torch.zeros(shape, dtype=torch.int8, device=dev),
            "v_s": torch.zeros(s_shape, dtype=torch.float32, device=dev),
        }
    return {"m": torch.zeros(p.shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(p.shape, dtype=torch.float32, device=dev)}


def adamw_init(params, quantize: bool = False) -> AdamWState:
    """Zero moments (f32, or int8 with f32 scales) on each leaf's device
    and ``step`` 0 (int32)."""
    moments = map_with_keys(lambda _, p: _init_leaf(p, quantize), params)
    dev = next(iter(flatten_with_keys(params).values())).device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev), moments=moments)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, the leaves in
    tree order."""
    total = 0
    for x in flatten_with_keys(tree).values():
        total = total + x.to(torch.float32).square().sum()
    return torch.sqrt(total)


def _update(p, g, mom: dict, lr, c1, c2, b1, b2, eps, weight_decay, window=None):
    """One leaf's update; returns (new param, new moment dict)."""
    g = g.to(torch.float32)
    if "m" in mom:
        m = b1 * mom["m"] + (1 - b1) * g
        v = b2 * mom["v"] + (1 - b2) * g.square()
        new_mom = {"m": m, "v": v}
    else:
        gq = g if g.dim() else g[None]
        m_prev = _dequantize(mom["m_q"], mom["m_s"], window=window)
        v_prev = _dequantize(mom["v_q"], mom["v_s"], window=window)
        m = b1 * m_prev + (1 - b1) * gq
        v = b2 * v_prev + (1 - b2) * gq.square()
        mq, ms = _quantize(m, window)
        vq, vs = _quantize(v, window)
        new_mom = {"m_q": mq, "m_s": ms, "v_q": vq, "v_s": vs}
        m = m.reshape(p.shape)
        v = v.reshape(p.shape)
    delta = (m / c1) / (torch.sqrt(v / c2) + eps)
    p32 = p.to(torch.float32)
    new_p = p32 - lr * (delta + weight_decay * p32)
    return new_p.to(p.dtype), new_mom


def adamw_update(
    grads,
    state: AdamWState,
    params,
    lr,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
    grad_norm: Optional[torch.Tensor] = None,
    windows: Optional[Dict[str, tuple]] = None,
):
    """Returns ``(new_params, new_state, {"grad_norm": pre-clip norm})``:
    global-norm clipping, bias correction, decoupled weight decay on every
    leaf.  Functional: no input is written.

    For a sharded state (ZeRO-1: ``params``, ``grads`` and the moments are
    this rank's blocks) the caller gives the global pre-clip ``grad_norm``,
    and, per leaf key whose int8 moments are split along their last dim,
    a ``windows`` entry ``(offset, full, reduce_max)`` (:func:`_quantize`)."""
    windows = windows or {}
    with torch.no_grad():
        step = state.step + 1
        gnorm = global_norm(grads) if grad_norm is None else grad_norm
        scale = None
        if clip_norm is not None:
            scale = torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        stepf = step.to(torch.float32)
        c1 = 1.0 - b1 ** stepf
        c2 = 1.0 - b2 ** stepf
        flat_g = flatten_with_keys(grads)
        flat_m = flatten_with_keys(state.moments)
        moment_keys = {}
        for key in flat_m:
            leaf, _, name = key.rpartition("/")
            moment_keys.setdefault(leaf, {})[name] = flat_m[key]
        new_p, new_m = {}, {}
        for key, p in flatten_with_keys(params).items():
            # the reference's g * scale promotes a bf16 gradient to f32 before the
            # clip; a bf16 product would drop its low bits first
            g = flat_g[key] if scale is None else flat_g[key].to(torch.float32) * scale
            mom = moment_keys[key]
            if p.dim() >= 2 and p.numel() >= _SLICED_MIN:
                # chunks of leading-dim slices: the transient f32 copies
                # are one chunk, not the whole stack
                rows = max(1, _SLICE_ELEMS // (p.numel() // p.shape[0]))
                outs = [_update(p[i:i + rows], g[i:i + rows],
                                {k: v[i:i + rows] for k, v in mom.items()}, lr, c1, c2, b1, b2,
                                eps, weight_decay, windows.get(key))
                        for i in range(0, p.shape[0], rows)]
                new_p[key] = torch.cat([o[0] for o in outs])
                new_m[key] = {k: torch.cat([o[1][k] for o in outs]) for k in mom}
            else:
                new_p[key], new_m[key] = _update(p, g, mom, lr, c1, c2, b1, b2, eps,
                                                 weight_decay, windows.get(key))
        params_out = map_with_keys(lambda k, _: new_p[k], params)
        moments_out = map_with_keys(
            lambda k, _: new_m[k.rpartition("/")[0]][k.rpartition("/")[2]], state.moments)
    return params_out, AdamWState(step, moments_out), {"grad_norm": gnorm}


def cosine_schedule(step, base_lr: float, warmup: int = 100, total: int = 10000,
                    floor: float = 0.1):
    """Linear warmup to ``base_lr``, then cosine decay to ``floor *
    base_lr`` at ``total``; f32, a tensor on ``step``'s device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = base_lr * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * base_lr + (1 - floor) * base_lr * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
