"""Configurations: the paper's platforms (:mod:`.paper`) and the model
architectures the port builds, resolved by name with :func:`get`."""

from __future__ import annotations

from importlib import import_module
from typing import List

from .base import ArchConfig, FTSpec, LayerSpec, MoESpec, SSMSpec

__all__ = ["ArchConfig", "FTSpec", "LayerSpec", "MoESpec", "SSMSpec",
           "ARCH_NAMES", "get"]

#: architectures ported so far (the reference's ``configs`` also has
#: jamba-1.5-large-398b, musicgen-large and llava-next-mistral-7b)
_MODULES = {
    "smollm-135m": "smollm_135m",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2-0.5b": "qwen2_0_5b",
    "granite-8b": "granite_8b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "arctic-480b": "arctic_480b",
}

ARCH_NAMES: List[str] = list(_MODULES)


def get(name: str) -> ArchConfig:
    """The published config of architecture ``name`` (``.reduced()`` is
    its CPU-sized variant)."""
    try:
        mod = _MODULES[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; the port has: {ARCH_NAMES}") from None
    return import_module(f".{mod}", __package__).CONFIG
