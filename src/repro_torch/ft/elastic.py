"""Elastic scaling, preventive migration (paper Section 3.4) and straggler
mitigation: the port's copy of the reference's ``ft/elastic.py``.

On a real fleet this module talks to the cluster scheduler: it keeps a
spare-node pool, swaps a predicted-to-fail (or persistently slow) node for
a spare, and — when no spare exists — shrinks the mesh and re-shards from
the newest checkpoint (CheckpointStore.restore supports re-sharding).
Here the node set is logical; what is real is the *decision logic* and
its costs, which feed the paper's migration model (Equation (3), cost M).

Straggler mitigation reuses the paper's calculus: a straggler detector is
a "slowness predictor" with its own recall/precision; migrating a slow
node is priced exactly like migrating a predicted-faulty one.
"""

from __future__ import annotations

import statistics
from collections import defaultdict, deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Set

__all__ = ["ElasticManager", "StragglerDetector"]


@dataclass
class ElasticManager:
    n_nodes: int
    n_spares: int = 2
    migration_cost: float = 300.0  # M, seconds

    def __post_init__(self):
        self.active: Set[int] = set(range(self.n_nodes))
        self.spares: List[int] = list(
            range(self.n_nodes, self.n_nodes + self.n_spares)
        )
        self.retired: Set[int] = set()
        self.events: List[dict] = []

    # ------------------------------------------------------------------ #
    def migrate(self, node: Optional[int] = None, reason: str = "prediction") -> dict:
        """Swap ``node`` (or an arbitrary active node) for a spare.

        Returns the event record (incl. whether a shrink was needed)."""
        if node is None:
            node = next(iter(self.active))
        self.active.discard(node)
        self.retired.add(node)
        if self.spares:
            repl = self.spares.pop(0)
            self.active.add(repl)
            ev = {
                "kind": "migration",
                "from": node,
                "to": repl,
                "reason": reason,
                "cost": self.migration_cost,
                "shrunk": False,
            }
        else:
            ev = {
                "kind": "shrink",
                "from": node,
                "to": None,
                "reason": reason,
                # shrink = restore latest checkpoint on a smaller mesh
                "cost": self.migration_cost,
                "shrunk": True,
            }
        self.events.append(ev)
        return ev

    def lose_node(self, node: int) -> dict:
        """Unpredicted hard failure of ``node``."""
        return self.migrate(node, reason="failure")

    @property
    def world_size(self) -> int:
        return len(self.active)


class StragglerDetector:
    """Flags ranks whose step times are persistent outliers.

    A rank is a straggler when its trailing-window median exceeds
    ``threshold`` x the cross-rank median for ``patience`` consecutive
    windows.  The detector's empirical recall/precision can be fed to the
    paper's policy to decide whether acting on it is worthwhile
    (ElasticManager.migration_cost as M)."""

    def __init__(
        self,
        n_ranks: int,
        window: int = 16,
        threshold: float = 1.5,
        patience: int = 3,
    ):
        self.n_ranks = n_ranks
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self._hist: Dict[int, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window)
        )
        self._strikes: Dict[int, int] = defaultdict(int)

    def record(self, rank: int, step_time: float) -> None:
        self._hist[rank].append(step_time)

    def check(self) -> List[int]:
        """Returns ranks currently flagged as stragglers."""
        medians = {
            r: statistics.median(h)
            for r, h in self._hist.items()
            if len(h) >= self.window // 2
        }
        if len(medians) < 2:
            return []
        global_med = statistics.median(medians.values())
        flagged = []
        for r, m in medians.items():
            if m > self.threshold * global_med:
                self._strikes[r] += 1
                if self._strikes[r] >= self.patience:
                    flagged.append(r)
            else:
                self._strikes[r] = 0
        return flagged
