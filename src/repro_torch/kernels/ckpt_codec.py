"""The checkpoint codec on the card: plain PyTorch versions and the two
CUDA kernel wrappers.

:func:`quantize_blocks` reads a flat f32 leaf in blocks of :data:`BLOCK`
elements (elements past its end count as 0), and gives int8 codes and
one f32 scale per block; with ``prev`` it codes ``x - prev``.
:func:`dequantize_blocks` is the inverse.  Both wrap hand-written CUDA
kernels (``csrc/ckpt_codec.cu``, built by :mod:`.build`) that replace the
reference's Pallas kernels of the same names.

What they compute is the host codec's arithmetic
(:mod:`repro_torch.checkpoint.codec`, which defines the file format), bit
for bit, on both devices:

* scale = ``max(absmax / 127, f32(1e-12))`` by IEEE division; a block
  holding a NaN gets that NaN's magnitude as its scale, payload and all,
  as numpy's ``max``, divide and ``maximum`` pass it on (a block's NaNs
  are taken to share one payload);
* code = ``clip(round(x / scale), -127, 127)``, rounding half to even; a
  NaN quotient codes 0, as numpy's cast gives on x86;
* decode = ``q * s`` rounded, then ``+ prev`` rounded: two roundings, no
  fused multiply-add.

:func:`quantize_ref` and :func:`dequantize_ref` are the plain versions
(the counterparts of the reference's ``kernels/ref.py`` oracles).  A
wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches its kernel or raises.  Each wrapper counts its launches in
``.launches``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .sim_step import _check, _raise_on, _stream_ptr

__all__ = [
    "BLOCK", "quantize_ref", "dequantize_ref", "quantize_blocks",
    "dequantize_blocks", "sample_codec_leaf",
]

BLOCK = 256


def _f32(v: float, device) -> torch.Tensor:
    """A 0-d f32 tensor on ``device``: the Python double rounded once, as
    numpy rounds a weak scalar against an f32 array (made by a fill, so a
    CUDA graph can capture it)."""
    return torch.full((), v, dtype=torch.float32, device=device)


def quantize_ref(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Flat leaf -> (int8 codes ``(n_blocks, 256)``, f32 scales
    ``(n_blocks, 1)``), the tail block padded with zeros."""
    flat = x.reshape(-1).to(torch.float32)
    if prev is not None:
        flat = flat - prev.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.view(-1, BLOCK)
    # |x| by clearing the sign bit, which keeps a NaN's payload on every
    # device (the card's abs instruction need not)
    mag = (blocks.view(torch.int32) & 0x7FFFFFFF).view(torch.float32)
    absmax = mag.amax(dim=1, keepdim=True)
    # the divisor is a device tensor: PyTorch's CUDA division multiplies by
    # the reciprocal of a Python-scalar divisor, 1 ulp off in some blocks
    s = torch.maximum(absmax / _f32(127.0, x.device), _f32(1e-12, x.device))
    # a NaN block's scale is the magnitude of its NaN, payload and all, as
    # numpy's max / divide / maximum pass it on (amax makes a NaN of its own)
    first_nan = torch.isnan(blocks).to(torch.uint8).argmax(dim=1, keepdim=True)
    s = torch.where(torch.isnan(absmax), mag.gather(1, first_nan), s)
    q = torch.round(blocks / s).clamp(-127, 127).nan_to_num(nan=0.0)
    return q.to(torch.int8), s


def dequantize_ref(q: torch.Tensor, s: torch.Tensor,
                   prev: Optional[torch.Tensor] = None, *, n: Optional[int] = None):
    """Codes and scales -> the flat f32 leaf of its first ``n`` elements
    (all of them by default)."""
    nb = s.numel()
    n = nb * BLOCK if n is None else n
    x = (q.reshape(nb, BLOCK).to(torch.float32) * s.reshape(nb, 1)).reshape(-1)[:n]
    if prev is not None:
        x = x + prev.reshape(-1).to(torch.float32)
    return x


def quantize_blocks(x: torch.Tensor, prev: Optional[torch.Tensor] = None):
    """Blockwise int8 codes of the contiguous f32 tensor ``x`` read flat,
    or of ``x - prev`` (``prev`` contiguous f32 with as many elements).
    Returns fresh ``(q, s)``: int8 ``(n_blocks, 256)`` and f32
    ``(n_blocks, 1)``, ``n_blocks = ceil(x.numel() / 256)``.

    CUDA tensors launch ``ckpt_quantize``; CPU tensors run
    :func:`quantize_ref`.  ``quantize_blocks.launches`` counts the kernel
    launches."""
    name = "quantize_blocks"
    n = x.numel() if isinstance(x, torch.Tensor) else 0
    specs = [("x", x, torch.float32, n)]
    if prev is not None:
        specs.append(("prev", prev, torch.float32, n))
    dev = _check(name, specs)
    if dev.type == "cpu":
        return quantize_ref(x, prev)
    from . import build

    nb = -(-n // BLOCK)
    q = torch.empty(nb, BLOCK, dtype=torch.int8, device=dev)
    s = torch.empty(nb, 1, dtype=torch.float32, device=dev)
    aligned = x.data_ptr() % 16 == 0 and (prev is None or prev.data_ptr() % 16 == 0)
    rc = build.load("ckpt_codec").ckpt_quantize(
        n, x.data_ptr(), None if prev is None else prev.data_ptr(),
        q.data_ptr(), s.data_ptr(), int(aligned), _stream_ptr(dev),
    )
    _raise_on(name, rc)
    if nb:
        quantize_blocks.launches += 1
    return q, s


quantize_blocks.launches = 0


def dequantize_blocks(q: torch.Tensor, s: torch.Tensor,
                      prev: Optional[torch.Tensor] = None, *, n: Optional[int] = None):
    """The flat f32 leaf of the codes ``q`` (int8, ``n_blocks * 256``
    elements) and scales ``s`` (f32, ``n_blocks``), first ``n`` elements
    only (all by default), plus ``prev`` (f32, ``n`` elements) for the
    delta codec.  Inputs are contiguous; the result is a fresh ``(n,)``.

    CUDA tensors launch ``ckpt_dequantize``; CPU tensors run
    :func:`dequantize_ref`.  ``dequantize_blocks.launches`` counts the
    kernel launches."""
    name = "dequantize_blocks"
    nb = s.numel() if isinstance(s, torch.Tensor) else 0
    n = nb * BLOCK if n is None else int(n)
    if not (nb - 1) * BLOCK < n <= nb * BLOCK:
        raise ValueError(f"{name}: n = {n} does not fit {nb} blocks")
    specs = [("q", q, torch.int8, nb * BLOCK), ("s", s, torch.float32, nb)]
    if prev is not None:
        specs.append(("prev", prev, torch.float32, n))
    dev = _check(name, specs)
    if dev.type == "cpu":
        return dequantize_ref(q, s, prev, n=n)
    from . import build

    out = torch.empty(n, dtype=torch.float32, device=dev)
    aligned = q.data_ptr() % 4 == 0 and (prev is None or prev.data_ptr() % 16 == 0)
    rc = build.load("ckpt_codec").ckpt_dequantize(
        n, q.data_ptr(), s.data_ptr(), None if prev is None else prev.data_ptr(),
        out.data_ptr(), int(aligned), _stream_ptr(dev),
    )
    _raise_on(name, rc)
    if n:
        dequantize_blocks.launches += 1
    return out


dequantize_blocks.launches = 0


# --------------------------------------------------------------------------- #
# Sample leaves (kernel checks)
# --------------------------------------------------------------------------- #
def sample_codec_leaf(seed: int):
    """A seeded f32 leaf of 17,280 elements (67.5 blocks: a padded tail)
    and a ``prev`` for the delta codec.  The leaf's first 23 blocks are
    the codec's edge cases: zeros (scale floor), -0.0, subnormals, exact
    .5 ties at scales 1 and 2^-10, NaN, +Inf, -Inf, NaN with Inf, values
    near the f32 maximum, and block scales from 1e-30 to 1e30.  ``prev``
    is 0 on those blocks (the delta keeps them) but for one Inf and one
    NaN; the other blocks are normal values at block scales from e^-20 to
    e^5, and ``prev`` is ``x`` off by a 1e-3 relative perturbation there."""
    rng = np.random.default_rng(seed)
    n = 17_280
    nb = -(-n // BLOCK)
    g = rng.standard_normal((nb, BLOCK))
    x = g * np.exp(rng.uniform(-20.0, 5.0, (nb, 1)))
    ties = np.concatenate([np.arange(-127, 127) + 0.5, [127.0, -127.0]])
    edge = [
        np.zeros(BLOCK),
        np.full(BLOCK, -0.0),
        rng.uniform(-1.0, 1.0, BLOCK) * 1e-39,
        rng.permutation(ties),
        rng.permutation(ties) * 2.0**-10,
        np.where(np.arange(BLOCK) == 7, np.nan, g[0]),
        np.where(np.arange(BLOCK) == 9, np.inf, g[1]),
        np.where(np.arange(BLOCK) == 200, -np.inf, g[2]),
        np.where(np.arange(BLOCK) == 3, np.nan, np.where(np.arange(BLOCK) == 4, np.inf, g[3])),
        g[4] * 3e37,
    ] + [g[5 + i] * 10.0**e for i, e in enumerate(range(-30, 31, 5))]
    k = len(edge)
    x[:k] = np.stack(edge)
    x = x.reshape(-1)[:n].astype(np.float32)
    prev = (x.astype(np.float64) * (1.0 - 1e-3 * rng.standard_normal(n))).astype(np.float32)
    prev[: k * BLOCK] = 0.0
    prev[11 * BLOCK + 5] = np.inf  # an Inf delta in a finite block
    prev[12 * BLOCK + 6] = np.nan  # a NaN delta in a finite block
    return x, prev
