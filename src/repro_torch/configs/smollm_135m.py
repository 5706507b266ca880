"""SmolLM-135M (llama architecture, tied embeddings;
hf:HuggingFaceTB/SmolLM-135M): the reference's ``configs/smollm_135m.py``
config, and the parameter shapes of its ``LanguageModel``, whose training
state the checkpoint path carries and whose serving path the port runs."""

from __future__ import annotations

from typing import Dict, Tuple

from .base import ArchConfig, FTSpec, LayerSpec

__all__ = ["CONFIG", "param_shapes"]

CONFIG = ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    pattern=(LayerSpec("attn", "dense"),),
    ft=FTSpec(C=10.0, R=10.0),
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    """The parameter tree's shapes by path key, in the order and with the
    keys the checkpoint store flattens it to: one block group stacked over
    the 30 layers (``blocks/0/...``), the tied embedding and the final
    norm."""
    c = CONFIG
    L, d, hd = c.num_layers, c.d_model, c.resolved_head_dim
    return {
        "blocks/0/mixer/wk": (L, d, c.num_kv_heads, hd),
        "blocks/0/mixer/wo": (L, c.num_heads, hd, d),
        "blocks/0/mixer/wq": (L, d, c.num_heads, hd),
        "blocks/0/mixer/wv": (L, d, c.num_kv_heads, hd),
        "blocks/0/mixer_norm": (L, d),
        "blocks/0/mlp/wi_gate": (L, d, c.d_ff),
        "blocks/0/mlp/wi_up": (L, d, c.d_ff),
        "blocks/0/mlp/wo": (L, c.d_ff, d),
        "blocks/0/mlp_norm": (L, d),
        "embed": (c.vocab_size, d),
        "final_norm": (d,),
    }
