"""Device meshes: the port of the reference's ``launch/mesh.py``.

:class:`Mesh` is a named grid of ranks: its axis names and sizes, and,
when it was built over a process group, the
``torch.distributed.device_mesh.DeviceMesh`` that holds one process group
per axis.  A mesh without one (:func:`make_production_mesh`, or
``Mesh(shape, names)``) is the reference's shapes as data: the sharding
tables and specs read it, and nothing communicates over it.

Importing this module touches no device and no process group.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch.distributed as dist

from ..core.torch_sim import resolve_device

__all__ = ["Mesh", "make_mesh_compat", "make_production_mesh"]


class Mesh:
    """Axis names and sizes (``shape``: ``{name: size}`` in axis order, as
    a JAX mesh's ``shape``), and the ``DeviceMesh`` over the process group
    when there is one."""

    def __init__(self, shape: Sequence[int], names: Sequence[str], device_mesh=None):
        if len(shape) != len(names):
            raise ValueError(f"mesh shape {tuple(shape)} and axis names {tuple(names)} differ "
                             "in length")
        self.axis_names: Tuple[str, ...] = tuple(names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.device_mesh = device_mesh

    def _dm(self):
        if self.device_mesh is None:
            raise RuntimeError("this mesh holds shapes only (no process group); build one "
                               "with make_mesh_compat inside an initialised process group")
        return self.device_mesh

    def group(self, axis: str):
        """The process group of the ranks that differ only along ``axis``."""
        return self._dm().get_group(axis)

    def coordinate(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        return dict(zip(self.axis_names, self._dm().get_coordinate()))

    def axis_rank(self, axis: str) -> int:
        return self.coordinate()[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}{'' if self.device_mesh is None else ', bound'})"


def make_mesh_compat(shape, names, device=None) -> Mesh:
    """A mesh of ``shape`` over the initialised default process group
    (whose world size must be the product of ``shape``), its axes named
    ``names``: ``init_device_mesh`` on the device type of ``device`` (the
    current CUDA device unless the caller names the CPU, as every entry
    point of the port resolves it).  The process group's backend is the
    caller's choice (NCCL on the card, gloo on the CPU); nothing here picks
    or changes it."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh_compat needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks, the world has "
                         f"{dist.get_world_size()}")
    dev = resolve_device(device)
    return Mesh(shape, names, init_device_mesh(dev.type, shape, mesh_dim_names=names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production shapes, as data: 16 x 16 ``(data,
    model)``, or 2 x 16 x 16 ``(pod, data, model)`` with ``multi_pod``."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes)

