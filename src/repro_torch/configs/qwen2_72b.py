"""Qwen2-72B: GQA with QKV bias (arXiv:2407.10671): the reference's
``configs/qwen2_72b.py``.  bf16 parameters and 8-bit AdamW moments; at
145 GB of bf16 weights it does not fit one card, so a card runs a depth
cut of it."""

from .base import ArchConfig, FTSpec, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
    pattern=(LayerSpec("attn", "dense"),),
    param_dtype="bfloat16",
    optimizer="adamw8bit",
    ft=FTSpec(C=600.0, R=600.0),
    source="arXiv:2407.10671",
)
