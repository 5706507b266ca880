"""Qwen3-30B-A3B: 128-expert top-8 MoE (hf:Qwen/Qwen3-30B-A3B): the
reference's ``configs/qwen3_moe_30b_a3b.py``.  32 query heads over 4 KV
heads at head dim 128 (a query group of 8); 30.5 B parameters, 3.35 B
active a token, 61 GB in bf16."""

from .base import ArchConfig, FTSpec, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    rope_theta=1e6,
    moe=MoESpec(num_experts=128, top_k=8),
    pattern=(LayerSpec("attn", "moe"),),
    ft=FTSpec(C=300.0, R=300.0),
    source="hf:Qwen/Qwen3-30B-A3B",
)
