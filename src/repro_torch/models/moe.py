"""Mixture-of-Experts layer with capacity-based sorted dispatch: the port
of the reference's ``models/moe.py`` single-device path (``moe_apply``
with one dispatch group).

1. The router runs in f32: softmax over the experts, the top ``k`` per
   token (ties toward the lower expert index, as ``jax.lax.top_k``), the
   gates normalised by their sum floored at 1e-9, and the Switch
   load-balance loss ``E * sum(me * ce)``.
2. The token-choice pairs are sorted by expert with a stable sort (what
   ``jnp.argsort`` does), ranked within their expert, and dropped beyond
   the capacity ``C = ceil(top_k * tokens * capacity_factor / E)``
   (padded to a multiple of 4, at least 4).
3. The kept pairs are copied into the ``(E * C, D)`` buffer, one row
   each: no two kept pairs share a slot, so the copy is deterministic.
4. The expert SwiGLU runs as batched products over ``(E, C, .)``: the
   reference's einsums, outside any Pallas kernel, so ``torch.bmm`` here.
5. Each token sums its ``k`` weighted outputs in ascending expert order,
   one add at a time in the compute dtype: the order in which the
   reference's scatter-add ``.at[st].add`` accumulates the sorted pairs.
   No atomics, so a decode replayed after a fault gives the same bits.

Arctic-style ``dense_residual``: a SwiGLU MLP runs beside the experts and
the outputs are summed.

Decode runs the same path at ``T = batch`` tokens (``C = 4``), so every
expert's products run, as in the reference.  ``moe_apply_shard_map`` and
the sharding specs wait for the port's distributed layer.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import init_mlp, swiglu_mlp

__all__ = ["Routing", "init_moe", "route", "moe_apply"]


def init_moe(generator: torch.Generator, cfg, dtype, lead=()) -> dict:
    """Random MoE weights, the reference's laws, stacked over ``lead``
    (the layer axis): ``router`` ``lead + (D, E)`` f32, ``wi_gate`` /
    ``wi_up`` ``lead + (E, D, F)`` and ``wo`` ``lead + (E, F, D)`` in
    ``dtype``, and ``dense`` (``init_mlp``) for a dense residual.

    The expert stacks are drawn one (layer, expert) slice at a time, in
    f32, straight into a tensor of ``dtype``: drawn whole, Qwen3-30B-A3B's
    ``wi_gate`` would be a 38.7 GB f32 temporary beside its 19.3 GB bf16
    result."""
    D, Fd, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    lead = tuple(lead)
    dev = generator.device
    s_in, s_out = 1.0 / math.sqrt(D), 1.0 / math.sqrt(Fd)
    p = {"router": torch.randn(lead + (D, E), generator=generator, device=dev) * s_in}
    for name, shape, std in (("wi_gate", (D, Fd), s_in), ("wi_up", (D, Fd), s_in),
                             ("wo", (Fd, D), s_out)):
        out = torch.empty(lead + (E,) + shape, dtype=dtype, device=dev)
        for idx in itertools.product(*(range(n) for n in lead + (E,))):
            out[idx].copy_(torch.randn(shape, generator=generator, device=dev) * std)
        p[name] = out
    if cfg.moe.dense_residual:
        p["dense"] = init_mlp(generator, D, Fd, dtype, lead=lead)
    return p


def _capacity(tokens: int, top_k: int, num_experts: int, cf: float) -> int:
    cap = int(math.ceil(top_k * tokens * cf / num_experts))
    return max(4, ((cap + 3) // 4) * 4)  # pad to a multiple of 4


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values, by
    falling value, equal values in index order (a stable descending sort;
    ``torch.topk`` promises no order of ties on CUDA)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One call's routing, every per-pair field in token-major order (pair
    ``t * k + j`` is token ``t``'s ``j``-th choice, choices by falling
    probability).  ``expert_ids`` / ``gates`` ``(T, k)``; ``keep`` (the
    pair fits its expert's capacity), ``slot`` (its row of the ``(E * C,
    D)`` buffer; meaningless where dropped) ``(T * k,)``; ``aux`` the
    load-balance loss; ``capacity`` C."""

    expert_ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    aux: torch.Tensor
    capacity: int


def route(p: dict, xt: torch.Tensor, cfg, capacity_factor: Optional[float] = None) -> Routing:
    """The router and the sorted dispatch's bookkeeping for tokens ``xt``
    ``(T, D)``: the reference's ``moe_apply`` up to the buffer."""
    T = xt.shape[0]
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    C = _capacity(T, K, E, capacity_factor or cfg.moe.capacity_factor)
    probs = torch.softmax(xt.to(torch.float32) @ p["router"], dim=-1)  # (T, E)
    gates, expert_ids = _top_k(probs, K)
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    flat = expert_ids.reshape(-1)
    # pairs per expert as a one-hot sum: no atomics, and no host sync
    # (bincount reads the largest id back to size its output)
    counts = (flat[:, None] == torch.arange(E, device=flat.device)).sum(dim=0)
    aux = E * torch.sum(probs.mean(dim=0) * (counts.to(torch.float32) / (T * K)))
    # rank of each pair within its expert, in token order: a stable sort
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    keep = rank < C
    return Routing(expert_ids, gates, keep, flat * C + rank, aux, C)


def moe_apply(p: dict, x: torch.Tensor, cfg,
              capacity_factor: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, S, D)`` -> (output ``(B, S, D)`` in ``x``'s dtype, aux
    load-balance loss, f32 scalar).  ``capacity_factor`` (the runtime
    flag ``moe_capacity_factor``) overrides the config's when given."""
    B, S, D = x.shape
    K = cfg.moe.top_k
    xt = x.reshape(B * S, D)
    r = route(p, xt, cfg, capacity_factor)
    E, C, TK = cfg.moe.num_experts, r.capacity, r.keep.numel()
    # dispatch: the kept pairs' rows, one slot each; dropped pairs land on a
    # spare row that is cut off
    dest = torch.where(r.keep, r.slot, E * C)
    buf = torch.zeros((E * C + 1, D), dtype=x.dtype, device=x.device)
    buf[dest] = xt.repeat_interleave(K, dim=0)
    buf = buf[:E * C].view(E, C, D)
    # the experts' SwiGLU, batched over E
    h = F.silu(torch.bmm(buf, p["wi_gate"])) * torch.bmm(buf, p["wi_up"])
    out = torch.bmm(h, p["wo"]).view(E * C, D)
    # combine: each pair's weighted output (0 where dropped), then each
    # token's k pairs summed in ascending expert order
    src = torch.where(r.keep, r.slot, 0)
    contrib = torch.where(r.keep[:, None], out[src], 0) * r.gates.reshape(TK, 1).to(x.dtype)
    asc = torch.argsort(r.expert_ids, dim=-1)  # distinct ids: order is unique
    contrib = contrib.view(-1, K, D).gather(1, asc[:, :, None].expand(-1, -1, D))
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]
    y = y.view(B, S, D)
    if "dense" in p:  # arctic: parallel dense residual
        y = y + swiglu_mlp(p["dense"], x)
    return y, r.aux
