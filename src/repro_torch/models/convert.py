"""The reference's parameter trees and training states as the port's.

The reference's ``LanguageModel.init`` gives a pytree of dicts and a
tuple (``blocks``); converted leaf by leaf with ``np.asarray`` it is a
tree of numpy arrays, which :func:`params_from_jax` turns into the port's
tree of tensors with the same structure, so the same key paths under
:func:`repro_torch.checkpoint.store.flatten_with_keys` (an MoE block's
``blocks/0/mlp/router`` in f32, ``.../wi_gate``, ``.../wi_up``,
``.../wo`` and Arctic's ``.../dense/...`` in the parameter dtype), leaf
dtypes kept (bf16 leaves moved bit for bit).  The port never
imports JAX: the caller converts the arrays.  :func:`train_state_from_jax`
does the same for the reference's training state ``{"params", "opt"}``,
whose ``opt`` (the reference's ``AdamWState``) becomes the port's
:class:`repro_torch.optim.AdamWState`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..checkpoint.store import map_with_keys
from ..core.torch_sim import resolve_device
from ..optim.adamw import AdamWState

__all__ = ["params_from_jax", "train_state_from_jax"]


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


def train_state_from_jax(state, device=None) -> dict:
    """The port's training state of ``state``, the reference's ``{"params":
    ..., "opt": AdamWState(step, moments)}`` with numpy leaves (f32 or
    int8 quantized moments), on ``device`` (CUDA by default; without CUDA
    and without a device it raises): the params as :func:`params_from_jax`
    gives them and ``opt`` as the port's ``AdamWState``, ``step`` a 0-d
    int32 tensor.  ``opt`` is read by field name, so any NamedTuple with
    ``step`` and ``moments`` fields serves."""
    dev = resolve_device(device)
    opt = state["opt"]
    step = _tensor("opt/.step", opt.step).reshape(())
    if step.dtype != torch.int32:
        raise TypeError(f"train_state_from_jax: opt.step has dtype {step.dtype}, not int32")
    return {
        "params": params_from_jax(state["params"], dev),
        "opt": AdamWState(
            step=step.to(dev),
            moments=map_with_keys(lambda k, x: _tensor("opt/.moments/" + k, x).to(dev),
                                  opt.moments),
        ),
    }
