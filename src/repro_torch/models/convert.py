"""The reference's parameter trees as the port's.

The reference's ``LanguageModel.init`` gives a pytree of dicts and a
tuple (``blocks``); converted leaf by leaf with ``np.asarray`` it is a
tree of numpy arrays, which :func:`params_from_jax` turns into the port's
tree of tensors with the same structure, so the same key paths under
:func:`repro_torch.checkpoint.store.flatten_with_keys`.  The port never
imports JAX: the caller converts the arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.store import map_with_keys
from ..core.torch_sim import resolve_device

__all__ = ["params_from_jax"]


def _tensor(key: str, x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: move the bits
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    if a.dtype.kind not in "fiub":
        raise TypeError(f"params_from_jax: leaf {key!r} has dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a))


def params_from_jax(tree, device=None) -> dict:
    """The port's parameter tree of ``tree`` (the reference's params with
    numpy leaves) on ``device`` (CUDA by default): same structure, same
    key paths, same dtypes and values.  Without CUDA and without a device
    it raises; it never falls back to the CPU on its own."""
    dev = resolve_device(device)
    return map_with_keys(lambda k, x: _tensor(k, x).to(dev), tree)
