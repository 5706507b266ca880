"""RWKV-6 (Finch) 7B (arXiv:2404.05892): the reference's
``configs/rwkv6_7b.py`` config.  Attention-free: 32 blocks of the
``rwkv`` time mix (64 WKV heads of dim 64, data-dependent decay with a
LoRA of rank 64) and the ``rwkv_cm`` channel mix, untied head,
7,534,546,944 parameters."""

from __future__ import annotations

from .base import ArchConfig, FTSpec, LayerSpec, SSMSpec

__all__ = ["CONFIG"]

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,   # WKV heads (d_model / 64); attention-free
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    pattern=(LayerSpec("rwkv", "rwkv_cm"),),
    ssm=SSMSpec(rwkv_head_dim=64, decay_lora=64),
    subquadratic=True,
    ft=FTSpec(C=120.0, R=120.0),
    source="arXiv:2404.05892",
)
