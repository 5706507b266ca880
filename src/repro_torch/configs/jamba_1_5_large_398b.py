"""Jamba-1.5-Large 398B: Mamba and attention interleaved 7:1, a 16-expert
top-2 MoE on alternate layers (arXiv:2403.19887): the reference's
``configs/jamba_1_5_large_398b.py``.

A block of 8 layers, repeated 9 times (72 layers): attention at position
4, Mamba elsewhere; the MoE MLP at the odd positions.  bf16 parameters and
8-bit AdamW moments.  At ~796 GB of bf16 weights it does not fit one card,
so a card runs a cut of it (one repeat, half the experts).
"""

from .base import ArchConfig, FTSpec, LayerSpec, MoESpec, SSMSpec

_P = []
for i in range(8):
    mixer = "attn" if i == 4 else "mamba"
    mlp = "moe" if i % 2 == 1 else "dense"
    _P.append(LayerSpec(mixer, mlp))

CONFIG = ArchConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    moe=MoESpec(num_experts=16, top_k=2),
    pattern=tuple(_P),
    ssm=SSMSpec(d_state=16, d_conv=4, expand=2),
    subquadratic=True,
    param_dtype="bfloat16",
    optimizer="adamw8bit",
    ft=FTSpec(C=1200.0, R=1200.0),
    source="arXiv:2403.19887",
)
