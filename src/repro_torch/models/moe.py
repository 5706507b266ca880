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
expert's products run, as in the reference.

**Expert parallelism** (the reference's ``moe_apply_shard_map``): under
sharding rules whose ``experts`` axis (``model``) is larger than 1 and
divides ``E``, each model rank holds ``E / M`` experts and runs
:func:`moe_expert_share` for them: the router and the routing are
replicated over the model axis (every rank of a data group holds the
group's tokens), each rank dispatches, runs and combines only the pairs
routed to its experts, and the shares are summed over the model axis
(:func:`..parallel.comm.sum_partials`: SUM forward, identity backward; the
replicated tokens and gates enter through its mirror, whose backward sums
their gradients over the ranks).  The expert weights come in the
reference's two regimes: FSDP (``d_model`` -> data: the weights' ``D``
blocks are all-gathered over data, whose backward reduce-scatters their
gradients) and weight-stationary (``expert_ff`` -> data: the token buffers
are all-gathered over data and the partial outputs reduce-scattered
back).  Capacity is per data group (``C`` from the group's tokens), and
the load-balance loss is global: the sums behind ``me`` and ``ce`` are
all-reduced over data.  :func:`moe_expert_share` uses no collective, so
every rank's share can run in one process; at ``M = 1`` it is
:func:`moe_apply`'s own computation, bit for bit.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..parallel import comm
from ..parallel.sharding import axes_of, data_axis
from .layers import init_mlp, swiglu_mlp

__all__ = ["Routing", "init_moe", "route", "moe_apply", "moe_expert_share", "MOE_SPECS"]

#: logical axes of the MoE leaves, the reference's
MOE_SPECS = {
    "router": ("d_model", None),
    "wi_gate": ("experts", "d_model", "expert_ff"),
    "wi_up": ("experts", "d_model", "expert_ff"),
    "wo": ("experts", "expert_ff", "d_model"),
    "dense": {
        "wi_gate": ("d_model", "ff"),
        "wi_up": ("d_model", "ff"),
        "wo": ("ff", "d_model"),
    },
}
#: the leaves expert parallelism shards (the rest of the block is replicated)
EXPERT_LEAVES = ("wi_gate", "wi_up", "wo")


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
        if dev.type == "meta":  # shapes only (abstract_params)
            p[name] = out
            continue
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


def route(p: dict, xt: torch.Tensor, cfg, capacity_factor: Optional[float] = None,
          data_group=None) -> Routing:
    """The router and the sorted dispatch's bookkeeping for tokens ``xt``
    ``(T, D)``: the reference's ``moe_apply`` up to the buffer.  With
    ``data_group`` (a data-parallel run; ``xt`` the group's tokens) the
    capacity stays the group's, and the load-balance loss is the global
    one: the probability sums and the pair counts are all-reduced over the
    group (the sums by :func:`..parallel.comm.all_reduce_sum`, so the
    gradients, averaged over data afterwards, are those of the global
    loss)."""
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
    p_sum, n_pairs, T_all = probs.sum(dim=0), counts, T
    if data_group is not None:
        p_sum = comm.all_reduce_sum(p_sum, data_group)
        n_pairs = comm.all_reduce_sum(counts, data_group)
        T_all = T * dist.get_world_size(data_group)
    aux = E * torch.sum((p_sum / T_all) * (n_pairs.to(torch.float32) / (T_all * K)))
    # rank of each pair within its expert, in token order: a stable sort
    order = torch.argsort(flat, stable=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=flat.device) - starts[flat[order]]
    keep = rank < C
    return Routing(expert_ids, gates, keep, flat * C + rank, aux, C)


def _dispatch(xt: torch.Tensor, r: Routing, lo: int, n_exp: int):
    """The kept pairs routed to experts ``lo .. lo + n_exp - 1`` copied to
    their slots of a ``(n_exp, C, D)`` buffer, one row each; the other
    pairs land on a spare row that is cut off.  Returns ``(buf, sel, row)``:
    the pairs taken and their rows."""
    C, D, K = r.capacity, xt.shape[1], r.expert_ids.shape[1]
    eid = r.expert_ids.reshape(-1)
    sel = r.keep & (eid >= lo) & (eid < lo + n_exp)
    row = r.slot - lo * C
    buf = torch.zeros((n_exp * C + 1, D), dtype=xt.dtype, device=xt.device)
    buf[torch.where(sel, row, n_exp * C)] = xt.repeat_interleave(K, dim=0)
    return buf[:n_exp * C].view(n_exp, C, D), sel, row


def _experts(buf: torch.Tensor, wg, wu, wo) -> torch.Tensor:
    """The experts' SwiGLU, batched over the expert dim."""
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wu)
    return torch.bmm(h, wo)


def _combine(out: torch.Tensor, r: Routing, gates: torch.Tensor, sel, row) -> torch.Tensor:
    """Each taken pair's weighted output (0 for the others), each token's
    ``k`` pairs summed in ascending expert order, one add at a time."""
    K = r.expert_ids.shape[1]
    D = out.shape[-1]
    out = out.reshape(-1, D)
    contrib = torch.where(sel[:, None], out[torch.where(sel, row, 0)], 0) \
        * gates.reshape(-1, 1).to(out.dtype)
    asc = torch.argsort(r.expert_ids, dim=-1)  # distinct ids: order is unique
    contrib = contrib.view(-1, K, D).gather(1, asc[:, :, None].expand(-1, -1, D))
    y = contrib[:, 0]
    for j in range(1, K):
        y = y + contrib[:, j]
    return y


def moe_expert_share(xt: torch.Tensor, r: Routing, wg, wu, wo, m: int, M: int,
                     gates: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Model rank ``m`` of ``M``'s share of the MoE output for tokens
    ``xt`` ``(T, D)`` under routing ``r``: the kept pairs routed to experts
    ``m * E / M .. (m + 1) * E / M - 1`` through that slice of the expert
    weights (``wg`` / ``wu`` ``(E / M, D, F)``, ``wo`` ``(E / M, F, D)``),
    weighted by their gates (``r.gates`` unless given) and summed per token
    in ascending expert order -> ``(T, D)``.  The ``M`` shares summed are
    the MoE output (without a dense residual).  No collective."""
    if not 0 <= m < M:
        raise ValueError(f"model rank {m} is not one of {M}")
    n_exp = wg.shape[0]
    buf, sel, row = _dispatch(xt, r, m * n_exp, n_exp)
    return _combine(_experts(buf, wg, wu, wo), r, r.gates if gates is None else gates,
                    sel, row)


def moe_apply(p: dict, x: torch.Tensor, cfg, capacity_factor: Optional[float] = None,
              rules=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x`` ``(B, S, D)`` -> (output ``(B, S, D)`` in ``x``'s dtype, aux
    load-balance loss, f32 scalar).  ``capacity_factor`` (the runtime
    flag ``moe_capacity_factor``) overrides the config's when given.

    With ``rules`` bound to a mesh over a process group, ``x`` is this
    data rank's tokens and ``p`` holds this rank's blocks of the expert
    weights: expert parallelism when the model axis is larger than 1,
    divides ``E`` and the tokens divide over the data groups (the
    reference's choice), else the one-group path on the gathered weights;
    either way with per-group capacity and the global load-balance loss."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    if rules is None:
        r = route(p, xt, cfg, capacity_factor)
        y = moe_expert_share(xt, r, p["wi_gate"], p["wi_up"], p["wo"], 0, 1)
    else:
        y, r = _moe_sharded(p, xt, cfg, rules, capacity_factor)
    y = y.view(B, S, D)
    if "dense" in p:  # arctic: parallel dense residual
        y = y + swiglu_mlp(p["dense"], x)
    return y, r.aux


def _moe_sharded(p: dict, xt: torch.Tensor, cfg, rules, capacity_factor):
    """The MoE output's ``(T, D)`` rows for this data rank's tokens, and
    the routing, under ``rules`` (:func:`moe_apply`)."""
    mesh = rules.mesh
    E = cfg.moe.num_experts
    _, data_group, _ = data_axis(rules)
    model_axes = axes_of(rules.assignment("experts"))
    M = mesh.shape[model_axes[0]] if model_axes else 1
    # the reference's choice; its third term, the tokens dividing over the
    # data groups, always holds here: each data rank brings its own
    ep = M > 1 and E % M == 0
    fsdp = axes_of(rules.assignment("d_model"))
    ef = axes_of(rules.assignment("expert_ff"))
    wg, wu, wo = p["wi_gate"], p["wi_up"], p["wo"]
    # the expert weights' data blocks: gathered (FSDP), or kept where they
    # are and the tokens brought to them (weight-stationary, EP only)
    if fsdp and not ef:
        g = mesh.group(fsdp[0])
        wg, wu, wo = (comm.all_gather_dim(wg, g, 1), comm.all_gather_dim(wu, g, 1),
                      comm.all_gather_dim(wo, g, 2))
    elif ef and not ep:
        g = mesh.group(ef[0])
        wg, wu, wo = (comm.all_gather_dim(wg, g, 2), comm.all_gather_dim(wu, g, 2),
                      comm.all_gather_dim(wo, g, 1))
    r = route(p, xt, cfg, capacity_factor, data_group)
    if not ep:
        return moe_expert_share(xt, r, wg, wu, wo, 0, 1), r
    model_group = mesh.group(model_axes[0])
    m = mesh.axis_rank(model_axes[0])
    xt_in = comm.enter_partials(xt, model_group)
    gates = comm.enter_partials(r.gates, model_group)
    if not ef:
        part = moe_expert_share(xt_in, r, wg, wu, wo, m, M, gates)
    else:
        g = mesh.group(ef[0])
        buf, sel, row = _dispatch(xt_in, r, m * wg.shape[0], wg.shape[0])
        # every data rank's buffer through this rank's F-slice, the partial
        # outputs reduce-scattered back to their owners
        buf_all = comm.all_gather_dim(buf[None], g, 0)  # (Gd, E_l, C, D)
        h = F.silu(torch.einsum("gecd,edf->gecf", buf_all, wg)) \
            * torch.einsum("gecd,edf->gecf", buf_all, wu)
        ob = comm.reduce_scatter_dim(torch.einsum("gecf,efd->gecd", h, wo), g, 0)[0]
        part = _combine(ob, r, gates, sel, row)
    return comm.sum_partials(part, model_group), r
