"""Model construction, the train step, the serving step functions and
their sharding helpers: the port of the reference's ``launch/steps.py``.

Without a mesh everything is one device's.  With one
(``build_model(cfg, mesh=...)``, a :class:`..launch.mesh.Mesh` over a
process group) the distributed layer is on, as explicit SPMD:

- Every rank holds its blocks of the parameters (:func:`param_shardings`)
  and of the AdamW moments (:func:`moment_shardings`: ZeRO-1, the
  moments sharded over the data axis on the first free divisible dim)
  and its data rank's slice of the batch.  In this slice the model axis
  shards the MoE experts and nothing else: the rules are the reference's
  with ``heads``, ``ff``, ``vocab``, ``inner``, ``cache_inner``,
  ``attn_seq`` and ``cache_seq`` overridden to ``None`` (``with_overrides``),
  and ``d_model`` to ``None`` on every leaf but the expert weights.
- The train step (:func:`build_train_step`) runs the loss on the rank's
  slice (the MoE blocks expert-parallel, their load-balance loss global),
  averages the gradients over data (an all-reduce; the expert weights'
  data blocks come already summed out of their gathers' backward), takes
  the global gradient norm from per-leaf sums of squares (all-reduced over
  each axis the moments are split on, so a replicated leaf counts once),
  updates each rank's ZeRO-1 block with :func:`..optim.adamw.adamw_update`
  and all-gathers the updated blocks over data.  The metrics are the
  global ones.

The ``*_arg_structs`` give meta tensors (no allocation) and
:class:`..parallel.sharding.NamedSharding` records, the port's layout.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..checkpoint.store import flatten_with_keys, map_with_keys
from ..configs.base import ArchConfig, ShapeConfig
from ..models.layers import RuntimeFlags
from ..models.moe import EXPERT_LEAVES
from ..models.transformer import LanguageModel
from ..optim.adamw import AdamWState, adamw_init, adamw_update, cosine_schedule
from ..parallel.comm import all_gather_dim, all_reduce_max
from ..parallel.sharding import (
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    axes_of,
    block_index,
    data_axis,
    make_rules,
    spec_axes,
)

__all__ = [
    "build_model", "build_train_step", "build_prefill_step", "build_decode_step",
    "input_specs", "train_arg_structs", "prefill_arg_structs", "decode_arg_structs",
    "fitted_sharding", "tree_shardings", "zero1_moment_specs", "param_shardings",
    "moment_shardings", "sharded_value_and_grad", "RULES_MODES",
]


# --------------------------------------------------------------------------- #
# sharding helpers (the reference's)
# --------------------------------------------------------------------------- #
def _axes_size(mesh, assignment) -> int:
    if assignment is None:
        return 1
    if isinstance(assignment, str):
        return mesh.shape[assignment]
    return math.prod(mesh.shape[a] for a in assignment)


def fitted_sharding(struct, logical, rules: ShardingRules) -> NamedSharding:
    """NamedSharding from logical axes, dropping any axis that does not
    divide the dimension (e.g. batch=1 long_500k on a 16-wide data axis)."""
    mesh = rules.mesh
    spec = []
    for dim, logical_name in zip(struct.shape, tuple(logical) + (None,) * 10):
        a = rules.assignment(logical_name)
        if a is not None and dim % _axes_size(mesh, a) != 0:
            a = None
        spec.append(a)
    return NamedSharding(mesh, PartitionSpec(*spec[: len(struct.shape)]))


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, (str, type(None))) for i in x)


def _map_logical(fn, structs, logical, key: str = ""):
    """``fn(key, struct, logical)`` over a tree of structs (tensors) and the
    matching tree of logical tuples; leaves keyed as the checkpoint store
    keys them."""
    if isinstance(structs, dict):
        return {k: _map_logical(fn, structs[k], logical[k], f"{key}/{k}" if key else str(k))
                for k in sorted(structs)}
    if isinstance(structs, (list, tuple)):
        return type(structs)(_map_logical(fn, s, l, f"{key}/{i}" if key else str(i))
                             for i, (s, l) in enumerate(zip(structs, logical)))
    if not _is_logical(logical):
        raise ValueError(f"{key}: no logical axes for a leaf of shape {tuple(structs.shape)}")
    return fn(key, structs, logical)


def tree_shardings(structs, logical_tree, rules: ShardingRules):
    """Map a tree of structs + matching tree of logical tuples to
    NamedShardings."""
    return _map_logical(lambda _, s, l: fitted_sharding(s, l, rules), structs, logical_tree)


def _zero1_leaf(struct, logical, rules: ShardingRules, quantized: bool):
    mesh = rules.mesh
    data_size = mesh.shape.get("data", 1)

    def f32_spec():
        lg = tuple(logical) + (None,) * 10
        out, used = [], set()
        for i, dim in enumerate(struct.shape):
            a = rules.assignment(lg[i])
            if a is not None and dim % _axes_size(mesh, a) == 0:
                out.append(a)
                used.update(axes_of(a))
            else:
                out.append(None)
        # ZeRO-1 on top: the data axis on the first free divisible dim
        # unless the parameter sharding (FSDP) already consumed it
        dp = rules.assignment("dp_shard")
        if dp and dp not in used:
            for i, dim in enumerate(struct.shape):
                if out[i] is None and dim % data_size == 0:
                    out[i] = dp
                    break
        return NamedSharding(mesh, PartitionSpec(*out))

    if quantized:
        # int8 moments keep the parameter's own shape and sharding; the
        # last-dim blockwise scales are unsharded on the block dim
        q_sh = f32_spec()
        scale_spec = PartitionSpec(*(tuple(q_sh.spec)[:-1] + (None,)))
        if len(struct.shape) == 0:
            q_sh = NamedSharding(mesh, PartitionSpec(None))
            scale_spec = PartitionSpec(None)
        s_sh = NamedSharding(mesh, scale_spec)
        return {"m_q": q_sh, "m_s": s_sh, "v_q": q_sh, "v_s": s_sh}
    s = f32_spec()
    return {"m": s, "v": s}


def zero1_moment_specs(param_structs, param_logical, rules, quantized: bool):
    """Moment shardings: parameter sharding + ZeRO-1 over the data axis on
    the first divisible unsharded dim (f32 moments).  Quantized moments
    keep the parameter's layout, their scales unsharded on the block
    dim."""
    return _map_logical(lambda _, s, l: _zero1_leaf(s, l, rules, quantized),
                        param_structs, param_logical)


# --------------------------------------------------------------------------- #
# model / step builders
# --------------------------------------------------------------------------- #
#: named sharding regimes (the reference's)
RULES_MODES = {
    "baseline": {},
    # weight-stationary experts + no FSDP on the dense weights
    "moe_stationary": {"d_model": None, "expert_ff": "data"},
    # serve-mode 2D weight sharding (the port keeps activations rank-local
    # on the batch: act_batch has no effect)
    "serve2d": {
        "d_model": None,
        "act_batch": None,
        "ff": ("data", "model"),
        "inner": ("data", "model"),
        "expert_ff": "data",
    },
}

#: the dense layers' model-axis entries, off in this slice (tensor
#: parallelism of the dense layers comes later)
_DENSE_OFF = dict(heads=None, ff=None, vocab=None, inner=None, cache_inner=None,
                  attn_seq=None, cache_seq=None)


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None, mesh=None,
                rules_mode: str = "baseline") -> LanguageModel:
    """The model; with ``mesh`` (a :class:`..launch.mesh.Mesh` over a
    process group) bound to its rules (``model.rules``): the reference's
    ``make_rules(mesh, shard_heads=cfg.shard_heads_ok(M), overrides=
    RULES_MODES[rules_mode])`` with the dense entries off."""
    rules = None
    if mesh is not None:
        rules = make_rules(
            mesh,
            shard_heads=cfg.shard_heads_ok(mesh.shape.get("model", 1)),
            overrides=RULES_MODES[rules_mode],
        ).with_overrides(**_DENSE_OFF)
    return LanguageModel(cfg, flags or RuntimeFlags(), rules)


def _is_expert_leaf(model: LanguageModel, key: str) -> bool:
    parts = key.split("/")
    return (len(parts) == 4 and parts[0] == "blocks" and parts[2] == "mlp"
            and parts[3] in EXPERT_LEAVES and model.cfg.pattern[int(parts[1])].mlp == "moe")


def _leaf_rules(model: LanguageModel, rules: ShardingRules, key: str) -> ShardingRules:
    """``d_model`` shards (FSDP) only the expert weights in this slice."""
    return rules if _is_expert_leaf(model, key) else rules.with_overrides(d_model=None)


def param_shardings(model: LanguageModel, rules: Optional[ShardingRules] = None, structs=None):
    """The parameters' layout: a NamedSharding a leaf."""
    rules = rules or model.rules
    structs = model.abstract_params() if structs is None else structs
    return _map_logical(lambda k, s, l: fitted_sharding(s, l, _leaf_rules(model, rules, k)),
                        structs, model.param_specs())


def moment_shardings(model: LanguageModel, quantized: bool,
                     rules: Optional[ShardingRules] = None, structs=None):
    """The AdamW moments' layout (ZeRO-1): a dict of NamedShardings a leaf."""
    rules = rules or model.rules
    structs = model.abstract_params() if structs is None else structs
    return _map_logical(
        lambda k, s, l: _zero1_leaf(s, l, _leaf_rules(model, rules, k), quantized),
        structs, model.param_specs())


def _value_and_grad(model: LanguageModel, params: dict, batch: dict):
    """``(loss, metrics, grads)`` of ``model.loss_fn`` at ``params``, the
    gradients by key (:func:`flatten_with_keys`), by ``torch.autograd``
    through views of the leaves (no copy; ``params`` itself never
    requires a gradient)."""
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, batch)
    flat = flatten_with_keys(live)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(flat, grads)))


def _accumulated(model: LanguageModel, params: dict, batch: dict, micro_batches: int):
    """:func:`_value_and_grad` over ``micro_batches`` equal batch slices:
    the gradients' sum over the count, the loss the mean, the metrics the
    last slice's."""
    if micro_batches == 1:
        return _value_and_grad(model, params, batch)
    grads, loss = {}, 0.0
    for i in range(micro_batches):
        part = {k: v.reshape((micro_batches, v.shape[0] // micro_batches)
                             + tuple(v.shape[1:]))[i] for k, v in batch.items()}
        l_i, metrics, g = _value_and_grad(model, params, part)
        grads = {k: grads[k] + x if k in grads else x for k, x in g.items()}
        loss = loss + l_i
    return loss / micro_batches, metrics, {k: x / micro_batches for k, x in grads.items()}


def sharded_value_and_grad(model: LanguageModel, params: dict, batch: dict,
                           micro_batches: int = 1, p_sh=None):
    """``(loss, metrics, grads)`` of the global batch from this rank's
    parameter blocks and data slice: the gradients averaged over the data
    axis (an all-reduce, except for the leaves whose blocks are split over
    data, whose gathers' backward already summed them), the loss and
    ``ce`` the data ranks' mean, ``aux`` the global one."""
    data, group, dp = data_axis(model.rules)
    if p_sh is None:  # {key: NamedSharding}
        p_sh = flatten_with_keys(param_shardings(model))
    loss, metrics, grads = _accumulated(model, params, batch, micro_batches)

    def mean(v, split_over_data=False):
        """In place: ``v`` is this step's own tensor (no copy of the
        gradients is made: they are the step's largest temporaries)."""
        if group is not None and not split_over_data:
            dist.all_reduce(v, group=group)
        return v.div_(dp)

    for k, g in grads.items():
        mean(g, data in spec_axes(p_sh[k].spec))
    return mean(loss), {**metrics, "ce": mean(metrics["ce"])}, grads


def _zero_dim(p_spec, m_spec, axis) -> Optional[int]:
    """The dim ZeRO-1 adds the data axis on (``None`` if the moments are
    laid out as the parameter)."""
    p_spec, m_spec = tuple(p_spec), tuple(m_spec)
    for d, a in enumerate(m_spec):
        if axis in axes_of(a) and (d >= len(p_spec) or axis not in axes_of(p_spec[d])):
            return d
    return None


def _chunk(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    w = x.shape[dim] // n
    return x.narrow(dim, i * w, w)


def _sharded_train_step(model: LanguageModel, lr: float, total_steps: int,
                        micro_batches: int):
    rules = model.rules
    mesh = rules.mesh
    daxis, group, dp = data_axis(rules)
    structs = model.abstract_params()
    p_sh = flatten_with_keys(param_shardings(model, structs=structs))
    layouts, masks = {}, {}

    def layout(quantized: bool):
        """Per leaf: its ZeRO-1 dim, the mesh axes its moments use, and
        the assignment of their last dim (int8 moments: the axes a
        quantization block may span)."""
        if quantized not in layouts:
            first = "m_q" if quantized else "m"
            lay = {}
            for k, sh in flatten_with_keys(
                    moment_shardings(model, quantized, structs=structs)).items():
                leaf, _, name = k.rpartition("/")
                if name == first:
                    spec = tuple(sh.spec)
                    lay[leaf] = (_zero_dim(p_sh[leaf].spec, spec, daxis), spec_axes(spec),
                                 spec[-1] if spec else None)
            layouts[quantized] = lay
        return layouts[quantized]

    def block_max(axes):
        def reduce(a):
            for ax in axes:
                a = all_reduce_max(a, mesh.group(ax))
            return a
        return reduce

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        loss, metrics, grads = sharded_value_and_grad(model, params, batch, micro_batches,
                                                      p_sh=p_sh)
        flat_m = flatten_with_keys(opt_state.moments)
        quantized = any(k.endswith("/m_q") for k in flat_m)
        lay = layout(quantized)
        coord = mesh.coordinate()
        g_blk, p_blk, windows, partial, axes = {}, {}, {}, [], []
        for key, p in flatten_with_keys(params).items():
            z, used, last = lay[key]
            g = grads[key]
            if z is not None and dp > 1:
                i = coord[daxis]
                g, p = _chunk(g, z, i, dp), _chunk(p, z, i, dp)
            i, n = block_index(mesh, last, coord)
            if quantized and n > 1:  # blocks of 256 across ranks: shared scales
                windows[key] = (i * p.shape[-1], p.shape[-1] * n, block_max(axes_of(last)))
            g_blk[key], p_blk[key] = g, p
            partial.append(g.to(torch.float32).square().sum())
            axes.append(used)
        # the global norm: each leaf's sum of squares over the axes its
        # blocks split, then summed in leaf order (global_norm's order)
        v = torch.stack(partial)
        for ax in mesh.axis_names:
            on = [ax in u for u in axes]
            if any(on):
                key = (quantized, ax)
                if key not in masks:  # made once: no host copy in later steps
                    masks[key] = torch.tensor(on, device=v.device)
                mask = masks[key]
                part = torch.where(mask, v, torch.zeros_like(v))
                dist.all_reduce(part, group=mesh.group(ax))
                v = torch.where(mask, part, v)
        total = 0
        for x in v:
            total = total + x
        gnorm = torch.sqrt(total)
        lr_t = cosine_schedule(opt_state.step, lr, warmup=100, total=total_steps)
        new_blk, new_state, _ = adamw_update(
            map_with_keys(lambda k, _: g_blk[k], params), opt_state,
            map_with_keys(lambda k, _: p_blk[k], params), lr_t, grad_norm=gnorm,
            windows=windows)
        flat_new = flatten_with_keys(new_blk)

        def rebuilt(key, _):
            z = lay[key][0]
            x = flat_new[key]
            return x if z is None or dp == 1 else all_gather_dim(x, group, z)

        new_params = map_with_keys(rebuilt, params)
        return new_params, new_state, {"loss": loss, **metrics, "grad_norm": gnorm}

    return train_step


def build_train_step(model: LanguageModel, lr: float = 3e-4, total_steps: int = 10000,
                     micro_batches: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    fwd + bwd + AdamW, the reference's train step.  ``micro_batches`` > 1
    accumulates the gradients of equal batch slices in a loop (the
    reference scans them): the sum divided by the count, the loss the
    mean, ``ce`` / ``aux`` the last slice's.  The learning rate follows
    ``cosine_schedule(step, lr, warmup=100, total=total_steps)``.  The
    metrics (``loss``, ``ce``, ``aux``, ``grad_norm``) stay tensors on the
    device: the step makes no host sync of its own.  The returned params
    and state are new tensors (:func:`..optim.adamw.adamw_update` is
    functional).

    For a model with a mesh (:func:`build_model`) the step takes and
    returns this rank's blocks (:func:`param_shardings`,
    :func:`moment_shardings`) and this data rank's batch slice; see the
    module's docstring."""
    if model.rules is not None:
        return _sharded_train_step(model, lr, total_steps, micro_batches)

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        loss, metrics, grads = _accumulated(model, params, batch, micro_batches)
        lr_t = cosine_schedule(opt_state.step, lr, warmup=100, total=total_steps)
        new_params, new_state, om = adamw_update(
            map_with_keys(lambda k, _: grads[k], params), opt_state, params, lr_t)
        return new_params, new_state, {"loss": loss, **metrics,
                                       "grad_norm": om["grad_norm"]}

    return train_step


def build_prefill_step(model: LanguageModel, max_seq: int):
    """``step(params, {"tokens": (B, S) int32, optional "frontend": (B, P,
    D)}) -> (logits, cache)``; with a mesh, this rank's parameter blocks
    and data slice, and its slice's logits and cache."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], max_seq, batch.get("frontend"))

    return prefill_step


def build_decode_step(model: LanguageModel):
    """``step(params, cache, tokens (B, 1)) -> (logits, cache)``, the cache
    updated in place."""

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step


# --------------------------------------------------------------------------- #
# abstract inputs per (arch x shape)
# --------------------------------------------------------------------------- #
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Meta stand-ins for the batch of this cell."""
    B, S = shape.global_batch, shape.seq_len
    prefix = cfg.frontend_prefix if cfg.frontend else 0
    if shape.kind in ("train", "prefill"):
        out = {"tokens": _meta((B, S - prefix), torch.int32)}
        if prefix:
            out["frontend"] = _meta((B, prefix, cfg.d_model), torch.bfloat16)
        return out
    return {"tokens": _meta((B, 1), torch.int32)}


def _batch_logical(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, tuple]:
    out = {"tokens": ("batch", None)}
    if shape.kind in ("train", "prefill") and cfg.frontend:
        out["frontend"] = ("batch", None, None)
    return out


def _replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())


def train_arg_structs(model: LanguageModel, shape: ShapeConfig, rules: ShardingRules):
    """(arg structs, in_shardings, out_shardings) for the train step: the
    port's layout (:func:`param_shardings`, :func:`moment_shardings`)."""
    cfg = model.cfg
    params = model.abstract_params()
    quant = cfg.optimizer == "adamw8bit"
    opt = adamw_init(params, quantize=quant)
    batch = input_specs(cfg, shape)
    p_sh = param_shardings(model, rules, params)
    o_sh = AdamWState(step=_replicated(rules.mesh),
                      moments=moment_shardings(model, quant, rules, params))
    b_sh = tree_shardings(batch, _batch_logical(cfg, shape), rules)
    metrics_sh = {k: _replicated(rules.mesh) for k in ("loss", "ce", "aux", "grad_norm")}
    return (params, opt, batch), (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh)


def _cache_structs(model: LanguageModel, batch: int, max_seq: int) -> dict:
    st = model.cache_struct(batch, max_seq)
    return {"pos": _meta(*st["pos"]),
            "blocks": tuple({k: _meta(s, dt) for k, (s, dt) in b.items()}
                            for b in st["blocks"])}


def prefill_arg_structs(model: LanguageModel, shape: ShapeConfig, rules: ShardingRules):
    cfg = model.cfg
    params = model.abstract_params()
    p_sh = param_shardings(model, rules, params)
    batch = input_specs(cfg, shape)
    b_sh = tree_shardings(batch, _batch_logical(cfg, shape), rules)
    cache = _cache_structs(model, shape.global_batch, shape.seq_len)
    c_sh = tree_shardings(cache, model.cache_specs(), rules)
    logits = _meta((shape.global_batch, 1, cfg.vocab_size), torch.bfloat16)
    l_sh = fitted_sharding(logits, ("batch", None, "vocab"), rules)
    return (params, batch), (p_sh, b_sh), (l_sh, c_sh)


def decode_arg_structs(model: LanguageModel, shape: ShapeConfig, rules: ShardingRules):
    cfg = model.cfg
    params = model.abstract_params()
    p_sh = param_shardings(model, rules, params)
    cache = _cache_structs(model, shape.global_batch, shape.seq_len)
    c_sh = tree_shardings(cache, model.cache_specs(), rules)
    tokens = _meta((shape.global_batch, 1), torch.int32)
    t_sh = fitted_sharding(tokens, ("batch", None), rules)
    logits = _meta((shape.global_batch, 1, cfg.vocab_size), torch.bfloat16)
    l_sh = fitted_sharding(logits, ("batch", None, "vocab"), rules)
    return (params, cache, tokens), (p_sh, c_sh, t_sh), (l_sh, c_sh)
