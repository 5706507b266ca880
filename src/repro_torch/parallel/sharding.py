"""Logical-axis sharding rules: the port of the reference's
``parallel/sharding.py``.

Tensors are annotated with *logical* axis names; a :class:`ShardingRules`
table maps those to mesh axes.  The table, its defaults and
``with_overrides`` are the reference's:

    batch        -> (pod, data)     data parallelism
    vocab        -> model           embedding / LM-head tensor parallelism
    heads        -> model           attention-head TP (when the head count
                                    divides the axis)
    ff / inner   -> model           MLP / Mamba / RWKV feature TP
    experts      -> model           expert parallelism (MoE)
    cache_seq    -> model           sequence-sharded KV cache
    dp_shard     -> data            ZeRO-1 optimizer-moment sharding

The port runs explicit SPMD: every rank holds plain local tensors, its
blocks of each sharded leaf (:func:`local_block`), and the collectives are
written out where the math needs them (:mod:`.comm`).  A
:class:`NamedSharding` is a record of a mesh and a :class:`PartitionSpec`
(one entry a dimension: ``None``, an axis name or a tuple of names, split
row-major), the reference's layout of a leaf over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Mapping, Optional, Tuple, Union

import torch
import torch.distributed as dist

from ..launch.mesh import Mesh

AxisAssignment = Union[None, str, Tuple[str, ...]]

__all__ = [
    "PartitionSpec", "NamedSharding", "ShardingRules", "make_rules", "logical_spec",
    "shard", "axes_of", "data_axis", "block_index", "local_block", "gather_block", "shard_tree",
    "gather_tree", "spec_axes",
]


class PartitionSpec(tuple):
    """One mesh assignment a dimension (``None``, an axis name, or a tuple
    of axis names); trailing dimensions not listed are unsharded, as in
    JAX's ``PartitionSpec``, which also reads a tuple of one axis as that
    axis and an empty one as ``None``."""

    def __new__(cls, *parts: AxisAssignment):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return None if not a else (a[0] if len(a) == 1 else a)
            return a

        return super().__new__(cls, tuple(norm(a) for a in parts))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


@dataclass(frozen=True)
class NamedSharding:
    """A leaf's layout: ``spec`` over ``mesh``."""

    mesh: Mesh
    spec: PartitionSpec


@dataclass(frozen=True)
class ShardingRules:
    """Mapping from logical axis names to mesh axis names."""

    table: Mapping[str, AxisAssignment] = field(default_factory=dict)
    mesh: Optional[Mesh] = None

    def assignment(self, logical: Optional[str]) -> AxisAssignment:
        if logical is None:
            return None
        return self.table.get(logical)

    def spec(self, *logical: Optional[str]) -> PartitionSpec:
        return PartitionSpec(*[self.assignment(l) for l in logical])

    def named(self, *logical: Optional[str]) -> NamedSharding:
        if self.mesh is None:
            raise ValueError("rules have no mesh bound")
        return NamedSharding(self.mesh, self.spec(*logical))

    def with_overrides(self, **kw: AxisAssignment) -> "ShardingRules":
        t = dict(self.table)
        t.update(kw)
        return replace(self, table=t)


def make_rules(
    mesh: Mesh,
    *,
    shard_heads: bool = True,
    shard_experts: bool = True,
    zero1: bool = True,
    seq_shard_cache: bool = True,
    overrides: Optional[Mapping[str, AxisAssignment]] = None,
) -> ShardingRules:
    """The reference's default table for ``mesh``'s axes."""
    axes = mesh.axis_names
    data_axes: Tuple[str, ...] = tuple(a for a in axes if a in ("pod", "data"))
    model = "model" if "model" in axes else None
    table: dict = {
        "batch": data_axes if data_axes else None,
        "act_batch": data_axes if data_axes else None,
        "cache_batch": data_axes if data_axes else None,
        "seq": None,
        "d_model": "data" if "data" in axes else None,
        "vocab": model,
        "heads": model if shard_heads else None,
        "kv_heads": None,
        "head_dim": None,
        "attn_seq": None if shard_heads else model,
        "ff": model,
        "inner": model,
        "cache_inner": model,
        "state": None,
        "experts": model if shard_experts else None,
        "expert_ff": None,
        "layers": None,
        "cache_seq": model if seq_shard_cache else None,
        "dp_shard": "data" if (zero1 and "data" in axes) else None,
        "frontend": None,
    }
    if overrides:
        table.update(overrides)
    return ShardingRules(table=table, mesh=mesh)


def logical_spec(rules: Optional[ShardingRules], *logical) -> PartitionSpec:
    if rules is None:
        return PartitionSpec()
    return rules.spec(*logical)


def shard(x, rules: Optional[ShardingRules], *logical):
    """The identity, with rules or without.  The reference pins an
    activation's layout here (``with_sharding_constraint``); in the port
    activations are rank-local (each data rank holds its slice of the
    batch, replicated over the model axis) and every collective is
    explicit, so there is nothing to constrain."""
    return x


# --------------------------------------------------------------------------- #
# Blocks of a leaf under a spec
# --------------------------------------------------------------------------- #
def axes_of(assignment: AxisAssignment) -> Tuple[str, ...]:
    if assignment is None:
        return ()
    return (assignment,) if isinstance(assignment, str) else tuple(assignment)


def data_axis(rules: ShardingRules):
    """The data axis of ``rules``' mesh (the axis ``batch`` maps to): its
    name, process group and size; ``(None, None, 1)`` without one."""
    axes = axes_of(rules.assignment("batch"))
    if not axes:
        return None, None, 1
    if len(axes) > 1:
        raise NotImplementedError(f"data parallelism over several mesh axes {axes}")
    return axes[0], rules.mesh.group(axes[0]), rules.mesh.shape[axes[0]]


def block_index(mesh: Mesh, assignment: AxisAssignment, coord: Mapping[str, int]):
    """``(index, count)`` of a rank's block along a dimension assigned to
    ``assignment``: row-major over the listed axes, as JAX splits a
    dimension over a tuple of mesh axes."""
    idx, count = 0, 1
    for a in axes_of(assignment):
        idx = idx * mesh.shape[a] + coord[a]
        count *= mesh.shape[a]
    return idx, count


def _spec_dims(x: torch.Tensor, spec) -> list:
    spec = tuple(spec)
    if any(a is not None for a in spec[x.dim():]):
        raise ValueError(f"spec {spec} shards more dims than the leaf's {x.dim()}")
    return list(spec[:x.dim()]) + [None] * (x.dim() - len(spec))


def local_block(x: torch.Tensor, sharding: NamedSharding, coord=None) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``sharding`` (a
    view): along each sharded dimension the ``index``-th of ``count``
    equal chunks (:func:`block_index`).  ``coord`` (``{axis: index}``)
    defaults to this rank's coordinate on the sharding's mesh."""
    mesh = sharding.mesh
    if coord is None:
        coord = mesh.coordinate()
    for d, a in enumerate(_spec_dims(x, sharding.spec)):
        i, n = block_index(mesh, a, coord)
        if n > 1:
            if x.shape[d] % n:
                raise ValueError(f"dim {d} ({x.shape[d]}) does not split over {a} ({n})")
            w = x.shape[d] // n
            x = x.narrow(d, i * w, w)
    return x


def gather_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """The full tensor from each rank's block ``x`` under ``sharding``:
    along each sharded dimension an all-gather over the ranks of its axes
    (a collective: every rank of those axes calls it).  Dimensions are
    gathered last to first, each axis of a tuple innermost first."""
    mesh = sharding.mesh
    for d in reversed(range(x.dim())):
        a = _spec_dims(x, sharding.spec)[d]
        for ax in reversed(axes_of(a)):
            if mesh.shape[ax] == 1:
                continue
            parts = [torch.empty_like(x) for _ in range(mesh.shape[ax])]
            dist.all_gather(parts, x.contiguous(), group=mesh.group(ax))
            x = torch.cat(parts, dim=d)
    return x


def shard_tree(tree, shardings, coord=None):
    """Each leaf's block (:func:`local_block`) under ``shardings``: one
    :class:`NamedSharding` for every leaf, or a tree of them keyed as
    ``tree`` (``None`` entries leave a leaf whole)."""
    from ..checkpoint.store import flatten_with_keys, map_with_keys

    flat = None if isinstance(shardings, NamedSharding) else flatten_with_keys(shardings)

    def leaf(k, x):
        sh = shardings if flat is None else flat.get(k)
        return x if sh is None else local_block(x, sh, coord)

    return map_with_keys(leaf, tree)


def gather_tree(tree, shardings):
    """The full leaves from this rank's blocks (:func:`gather_block`; a
    collective), ``shardings`` as in :func:`shard_tree`."""
    from ..checkpoint.store import flatten_with_keys, map_with_keys

    flat = None if isinstance(shardings, NamedSharding) else flatten_with_keys(shardings)

    def leaf(k, x):
        sh = shardings if flat is None else flat.get(k)
        return x if sh is None else gather_block(x, sh)

    return map_with_keys(leaf, tree)


def spec_axes(spec) -> set:
    """The mesh axes a spec uses."""
    out = set()
    for a in tuple(spec):
        out.update(axes_of(a))
    return out

