"""LLaVA-NeXT (v1.6) with its Mistral-7B backbone
(hf:llava-hf/llava-v1.6-mistral-7b-hf): the reference's
``configs/llava_next_mistral_7b.py``.

The backbone only; the anyres vision tower is a stub: the caller provides
precomputed patch embeddings, a 576-row prefix (one anyres tile)."""

from .base import ArchConfig, FTSpec, LayerSpec

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    rope_theta=1e6,
    pattern=(LayerSpec("attn", "dense"),),
    frontend="vision_patches",
    frontend_prefix=576,
    ft=FTSpec(C=120.0, R=120.0),
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)
