"""Checkpoint substrate: on-disk store, async pipeline, buddy memory tier,
int8 delta codec (encoded on the card by the port's CUDA kernels).  The
measured blocking cost is the paper's C."""

from .store import CheckpointStore, latest_step
from .async_ckpt import AsyncCheckpointer
from .memory import BuddyMemoryCheckpoint
from .codec import encode_tree, decode_tree

__all__ = [
    "CheckpointStore",
    "latest_step",
    "AsyncCheckpointer",
    "BuddyMemoryCheckpoint",
    "encode_tree",
    "decode_tree",
]
