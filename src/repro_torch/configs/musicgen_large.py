"""MusicGen-large, a decoder over EnCodec tokens (arXiv:2306.05284): the
reference's ``configs/musicgen_large.py``.

The backbone only; the EnCodec / conditioning frontend is a stub: the
caller provides precomputed conditioning frame embeddings, a 64-row
prefix.  32 KV heads for 32 query heads: full multi-head attention.
"""

from .base import ArchConfig, FTSpec, LayerSpec

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    pattern=(LayerSpec("attn", "dense"),),
    frontend="audio_frames",
    frontend_prefix=64,
    ft=FTSpec(C=60.0, R=60.0),
    source="arXiv:2306.05284",
)
