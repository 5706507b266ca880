"""SmolLM-135M (llama architecture, tied embeddings;
hf:HuggingFaceTB/SmolLM-135M): the parameter shapes of the reference's
``LanguageModel`` for ``smollm-135m``, whose training state the
checkpoint path carries."""

from __future__ import annotations

from typing import Dict, Tuple

__all__ = ["NUM_LAYERS", "D_MODEL", "NUM_HEADS", "NUM_KV_HEADS", "HEAD_DIM",
           "D_FF", "VOCAB_SIZE", "param_shapes"]

NUM_LAYERS = 30
D_MODEL = 576
NUM_HEADS = 9
NUM_KV_HEADS = 3
HEAD_DIM = D_MODEL // NUM_HEADS
D_FF = 1536
VOCAB_SIZE = 49152


def param_shapes() -> Dict[str, Tuple[int, ...]]:
    """The parameter tree's shapes by path key, in the order and with the
    keys the checkpoint store flattens it to: one block group stacked over
    the 30 layers (``blocks/0/...``), the tied embedding and the final
    norm."""
    L, d, hd = NUM_LAYERS, D_MODEL, HEAD_DIM
    return {
        "blocks/0/mixer/wk": (L, d, NUM_KV_HEADS, hd),
        "blocks/0/mixer/wo": (L, NUM_HEADS, hd, d),
        "blocks/0/mixer/wq": (L, d, NUM_HEADS, hd),
        "blocks/0/mixer/wv": (L, d, NUM_KV_HEADS, hd),
        "blocks/0/mixer_norm": (L, d),
        "blocks/0/mlp/wi_gate": (L, d, D_FF),
        "blocks/0/mlp/wi_up": (L, d, D_FF),
        "blocks/0/mlp/wo": (L, D_FF, d),
        "blocks/0/mlp_norm": (L, d),
        "embed": (VOCAB_SIZE, d),
        "final_norm": (d,),
    }
