"""Optimizer substrate of the port: AdamW (+8-bit moments) and int8
gradient compression with error feedback, with its data-parallel int8
all-reduce ``dp_allreduce_int8`` (the reference's ``repro/optim``)."""

from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm
from .compress import (
    compress_gradients,
    decompress_gradients,
    dp_allreduce_int8,
    ef_compress_step,
)

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "compress_gradients",
    "decompress_gradients",
    "dp_allreduce_int8",
    "ef_compress_step",
]
