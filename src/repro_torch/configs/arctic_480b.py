"""Snowflake Arctic 480B: 128-expert top-2 MoE with a dense residual MLP
(hf:Snowflake/snowflake-arctic-base): the reference's
``configs/arctic_480b.py``.  56 query heads over 8 KV heads at head dim
128 (a query group of 7); bf16 parameters and 8-bit AdamW moments.  At
~960 GB of bf16 weights it does not fit one card, so a card runs a depth
cut of it."""

from .base import ArchConfig, FTSpec, LayerSpec, MoESpec

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    moe=MoESpec(num_experts=128, top_k=2, dense_residual=True),
    pattern=(LayerSpec("attn", "moe"),),
    param_dtype="bfloat16",
    optimizer="adamw8bit",
    ft=FTSpec(C=1200.0, R=1200.0, predictor="paper-accurate"),
    source="hf:Snowflake/snowflake-arctic-base",
)
