"""In-memory buddy checkpointing (double in-memory checkpoint/restart,
after Zheng, Ni & Kale [13]).

Each node keeps its own newest snapshot in host RAM *and* a replica of a
buddy node's snapshot.  A single-node failure restores from the buddy in
O(RAM copy) instead of O(disk read), collapsing the paper's R for the
common case; only multi-node or correlated failures fall back to the disk
tier.  In one process the "nodes" are logical ranks and the buddy
exchange is a copy in host memory.

Snapshots are CPU tensors in the tree's structure.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from .store import _tensor, map_with_keys

__all__ = ["BuddyMemoryCheckpoint"]


class BuddyMemoryCheckpoint:
    def __init__(self, n_nodes: int = 2):
        self.n_nodes = n_nodes
        # own[i] = (step, snapshot of rank i); buddy[i] = replica of own[(i-1) % n]
        self._own: Dict[int, Any] = {}
        self._buddy: Dict[int, Any] = {}

    def buddy_of(self, rank: int) -> int:
        return (rank + 1) % self.n_nodes

    def save(self, step: int, tree, rank: int = 0) -> float:
        """Snapshot to own RAM and replicate to the buddy.  Returns seconds.
        The rank's previous snapshot and its replica stay until the new
        snapshot is in host memory, as the reference's do, so a failed copy
        leaves them restorable; the old replica is dropped before the new
        one is cloned, so host memory holds at most three copies of a
        training state of tens of GB, as the reference's does."""
        t0 = time.monotonic()
        host = map_with_keys(lambda _, x: _tensor(x).to("cpu", copy=True), tree)
        self._own[rank] = (step, host)
        self._buddy.pop(self.buddy_of(rank), None)
        self._buddy[self.buddy_of(rank)] = (step, map_with_keys(lambda _, x: x.clone(), host))
        return time.monotonic() - t0

    def restore(self, rank: int = 0, lost: bool = False):
        """Restore rank's snapshot; ``lost=True`` simulates the node's RAM
        being gone, forcing the buddy path."""
        if not lost and rank in self._own:
            return self._own[rank]
        buddy_holder = self.buddy_of(rank)
        if buddy_holder in self._buddy:
            return self._buddy[buddy_holder]
        return None

    def latest_step(self, rank: int = 0) -> Optional[int]:
        got = self.restore(rank)
        return got[0] if got else None
