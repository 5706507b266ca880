"""Int8 gradient compression with error feedback: the port of the
reference's ``optim/compress.py``.

Classic EF-SGD / 1-bit-Adam structure: the *transmitted* gradient is an
int8 blockwise quantization (blocks of 256 over the flattened tensor, f32
absmax scales) of gradient + residual; the quantization error is carried
to the next step.  :func:`dp_allreduce_int8` is the reference's explicit
data-parallel reduction with int8 on the wire, over a mesh's data axis.

Trees are those of :func:`repro_torch.checkpoint.store.map_with_keys`; a
compressed leaf is the tuple ``(int8 (nblocks, 256), f32 (nblocks,))``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..checkpoint.store import flatten_with_keys, map_with_keys

__all__ = ["compress_gradients", "decompress_gradients", "ef_compress_step",
           "dp_allreduce_int8"]

_BLOCK = 256


def _blockwise(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    scale = torch.clamp(blocks.abs().amax(dim=1) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _decode(q: torch.Tensor, s: torch.Tensor, n: int, shape) -> torch.Tensor:
    return (q.to(torch.float32) * s[:, None]).reshape(-1)[:n].reshape(shape)


def compress_gradients(tree):
    """Tree of f32 / bf16 leaves -> tree of ``(int8 blocks, f32 scales)``."""
    return map_with_keys(lambda _, g: _blockwise(g.to(torch.float32)), tree)


def decompress_gradients(ctree, shapes_tree):
    """The f32 leaves ``ctree`` codes, shaped as ``shapes_tree``'s leaves."""
    codes = flatten_with_keys(ctree)

    def leaf(k, ref):
        pre = k + "/" if k else ""
        return _decode(codes[pre + "0"], codes[pre + "1"], ref.numel(), ref.shape)

    return map_with_keys(leaf, shapes_tree)


def ef_compress_step(grads, residual):
    """Error-feedback compression: ``(decompressed grads, new residual)``;
    ``residual`` has the grads' structure and shapes (zeros at step 0)."""
    flat_r = flatten_with_keys(residual)
    out = {}
    for k, g in flatten_with_keys(grads).items():
        g32 = g.to(torch.float32) + flat_r[k]
        deq = _decode(*_blockwise(g32), g.numel(), g.shape)
        out[k] = (deq.to(g.dtype), (g32 - deq).to(torch.float32))
    return (map_with_keys(lambda k, _: out[k][0], grads),
            map_with_keys(lambda k, _: out[k][1], grads))


def dp_allreduce_int8(x: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The sum of every ``axis`` rank's tensor ``x`` (this rank's), moving
    int8 on the wire: each rank quantizes its tensor blockwise (f32, blocks
    of 256), the ``(int8, scale)`` pairs are all-gathered over the axis,
    and every rank dequantizes them and adds them in rank order, so every
    rank gets the same bits.  Wire bytes ``(N - 1) / N * (1 + 4 / 256)`` an
    element against ``2 * 4`` for a ring all-reduce of f32.  Returns f32
    of ``x``'s shape.  A collective: every rank of the axis calls it."""
    group = mesh.group(axis)
    n = dist.get_world_size(group)
    q, s = _blockwise(x.to(torch.float32))
    qs = [torch.empty_like(q) for _ in range(n)]
    ss = [torch.empty_like(s) for _ in range(n)]
    dist.all_gather(qs, q, group=group)
    dist.all_gather(ss, s, group=group)
    total = qs[0].to(torch.float32) * ss[0][:, None]
    for r in range(1, n):
        total = total + qs[r].to(torch.float32) * ss[r][:, None]
    return total.reshape(-1)[:x.numel()].reshape(x.shape)
