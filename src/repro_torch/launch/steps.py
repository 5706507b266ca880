"""Model construction and the serving step functions, the port of the
reference's ``launch/steps.py`` for one device (no mesh, no sharding
rules)."""

from __future__ import annotations

from typing import Optional

from ..configs.base import ArchConfig
from ..models.layers import RuntimeFlags
from ..models.transformer import LanguageModel

__all__ = ["build_model", "build_prefill_step", "build_decode_step"]


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None) -> LanguageModel:
    return LanguageModel(cfg, flags or RuntimeFlags())


def build_prefill_step(model: LanguageModel, max_seq: int):
    """``step(params, {"tokens": (B, S) int32}) -> (logits, cache)``."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], max_seq)

    return prefill_step


def build_decode_step(model: LanguageModel):
    """``step(params, cache, tokens (B, 1)) -> (logits, cache)``, the cache
    updated in place."""

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
