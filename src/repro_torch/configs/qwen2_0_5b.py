"""Qwen2-0.5B: GQA with QKV bias, tied embeddings (arXiv:2407.10671): the
reference's ``configs/qwen2_0_5b.py``.  14 query heads over 2 KV heads,
a query group of 7 at head dim 64."""

from .base import ArchConfig, FTSpec, LayerSpec

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    pattern=(LayerSpec("attn", "dense"),),
    ft=FTSpec(C=20.0, R=20.0),
    source="arXiv:2407.10671",
)
