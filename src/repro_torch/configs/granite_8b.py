"""IBM Granite 8B code model, llama architecture (arXiv:2405.04324): the
reference's ``configs/granite_8b.py``.  32 query heads over 8 KV heads,
a query group of 4 at head dim 128."""

from .base import ArchConfig, FTSpec, LayerSpec

CONFIG = ArchConfig(
    name="granite-8b",
    family="dense",
    num_layers=36,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=49152,
    rope_theta=1e7,
    pattern=(LayerSpec("attn", "dense"),),
    ft=FTSpec(C=120.0, R=120.0),
    source="arXiv:2405.04324",
)
