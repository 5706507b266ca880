"""Configurations: the paper's platforms (:mod:`.paper`) and the model
architectures, resolved by name with :func:`get`: every architecture of the
reference's ``configs``, under the same names in the same order."""

from __future__ import annotations

from importlib import import_module
from typing import List

from .base import SHAPES, ArchConfig, FTSpec, LayerSpec, MoESpec, ShapeConfig, SSMSpec

__all__ = ["ArchConfig", "FTSpec", "LayerSpec", "MoESpec", "SSMSpec", "ShapeConfig",
           "SHAPES", "ARCH_NAMES", "get"]

#: the architectures, in the reference's order
_MODULES = {
    "arctic-480b": "arctic_480b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-8b": "granite_8b",
    "qwen2-0.5b": "qwen2_0_5b",
    "qwen2-72b": "qwen2_72b",
    "smollm-135m": "smollm_135m",
    "musicgen-large": "musicgen_large",
    "rwkv6-7b": "rwkv6_7b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
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
