"""Optimizer substrate of the port: AdamW (+8-bit moments) and int8
gradient compression with error feedback (the reference's
``repro/optim``; its mesh all-reduce ``dp_allreduce_int8`` waits for the
port's ``parallel/``)."""

from .adamw import AdamWState, adamw_init, adamw_update, cosine_schedule, global_norm
from .compress import compress_gradients, decompress_gradients, ef_compress_step

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "cosine_schedule",
    "global_norm",
    "compress_gradients",
    "decompress_gradients",
    "ef_compress_step",
]
