"""Experiment grid specification and structured sweep results.

An :class:`ExperimentCell` pins down one Monte-Carlo estimation problem —
(platform, predictor, strategy, failure law, job) — and a :class:`GridSpec`
bundles many cells with shared run count and seed.  The runner
(:mod:`repro_torch.experiments.runner`) flattens every (cell, run) pair
into one lane of the device engine, so the whole grid advances in one
cell-multiplexed dispatch.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.events import Distribution, exponential
from ..core.simulator import Strategy
from ..core.waste import Platform, PredictorModel

__all__ = ["ExperimentCell", "GridSpec", "CellResult", "SweepResult"]


@dataclass(frozen=True)
class ExperimentCell:
    """One grid cell: a (platform, predictor, strategy, failure-law) point.

    ``n_runs`` overrides the grid-wide Monte-Carlo repetition count for
    this cell; ``None`` inherits :attr:`GridSpec.n_runs`."""

    label: str
    work: float
    platform: Platform
    predictor: PredictorModel
    strategy: Strategy
    fault_dist: Optional[Distribution] = None  # None -> exponential
    false_pred_dist: Optional[Distribution] = None
    horizon_factor: float = 12.0
    n_runs: Optional[int] = None

    @property
    def dist(self) -> Distribution:
        return self.fault_dist or exponential()

    def group_key(self) -> Tuple:
        """Cells sharing a key sample their traces from one law family."""
        fp = self.false_pred_dist
        return (self.dist.name, fp.name if fp is not None else None)


@dataclass(frozen=True)
class GridSpec:
    """A full sweep: cells x ``n_runs`` Monte-Carlo repetitions (cells
    may override their own run count via :attr:`ExperimentCell.n_runs`)."""

    cells: Tuple[ExperimentCell, ...]
    n_runs: int = 100
    seed: int = 0

    def __post_init__(self):
        labels = [c.label for c in self.cells]
        if len(set(labels)) != len(labels):
            dupes = sorted({l for l in labels if labels.count(l) > 1})
            raise ValueError(f"duplicate cell labels: {dupes}")
        if any(r < 1 for r in self.cell_n_runs):
            raise ValueError("every cell needs n_runs >= 1")

    def cell_runs(self, ci: int) -> int:
        """Monte-Carlo repetition count of cell ``ci``."""
        r = self.cells[ci].n_runs
        return self.n_runs if r is None else int(r)

    @property
    def cell_n_runs(self) -> Tuple[int, ...]:
        return tuple(self.cell_runs(ci) for ci in range(len(self.cells)))

    @property
    def n_lanes(self) -> int:
        return sum(self.cell_n_runs)


@dataclass
class CellResult:
    """Aggregated Monte-Carlo statistics of one cell (mean +- 95% CI).

    Two backing layouts share one interface: per-run arrays
    (``collect="lanes"``), or summary moments reduced on the device
    (``collect="stats"``: the arrays are ``None`` and :attr:`stats`
    carries the moments)."""

    cell: ExperimentCell
    waste: Optional[np.ndarray] = None  # (n_runs,) per-run empirical waste
    makespan: Optional[np.ndarray] = None  # (n_runs,)
    n_faults: Optional[np.ndarray] = None
    n_proactive_ckpts: Optional[np.ndarray] = None
    n_regular_ckpts: Optional[np.ndarray] = None
    n_migrations: Optional[np.ndarray] = None
    n_exhausted: int = 0
    stats: Optional[Dict[str, float]] = None

    #: stats keys (from_stats argument order)
    _STAT_KEYS = (
        "n", "mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan",
        "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
        "mean_migrations",
    )

    @classmethod
    def from_stats(cls, cell: ExperimentCell, n_exhausted: int, *moments
                   ) -> "CellResult":
        """Build a stats-backed result from device-reduced summary
        moments (``_STAT_KEYS`` order)."""
        return cls(
            cell=cell, n_exhausted=int(n_exhausted),
            stats=dict(zip(cls._STAT_KEYS, (float(m) for m in moments))),
        )

    @staticmethod
    def _ci95(x: np.ndarray) -> float:
        n = x.shape[0]
        if n < 2:
            return math.nan
        return 1.96 * float(x.std(ddof=1)) / math.sqrt(n)

    @property
    def n_runs(self) -> int:
        if self.waste is None:
            return int(self.stats["n"])
        return int(self.waste.shape[0])

    def _stat(self, key: str, arr_name: str, reduce):
        if self.stats is not None and getattr(self, arr_name) is None:
            return self.stats[key]
        return reduce(getattr(self, arr_name))

    @property
    def mean_waste(self) -> float:
        return self._stat("mean_waste", "waste", lambda a: float(a.mean()))

    @property
    def ci95_waste(self) -> float:
        return self._stat("ci95_waste", "waste", self._ci95)

    @property
    def mean_makespan(self) -> float:
        return self._stat("mean_makespan", "makespan", lambda a: float(a.mean()))

    @property
    def ci95_makespan(self) -> float:
        return self._stat("ci95_makespan", "makespan", self._ci95)

    @property
    def mean_faults(self) -> float:
        return self._stat("mean_faults", "n_faults", lambda a: float(a.mean()))

    @property
    def mean_proactive_ckpts(self) -> float:
        return self._stat(
            "mean_proactive_ckpts", "n_proactive_ckpts",
            lambda a: float(a.mean()),
        )

    @property
    def mean_regular_ckpts(self) -> float:
        return self._stat(
            "mean_regular_ckpts", "n_regular_ckpts", lambda a: float(a.mean())
        )

    @property
    def mean_migrations(self) -> float:
        return self._stat(
            "mean_migrations", "n_migrations", lambda a: float(a.mean())
        )


@dataclass
class SweepResult:
    """Structured result of a grid sweep.

    ``collect`` records the result layout ("lanes": per-run arrays;
    "stats": device-reduced summary moments).  ``meta`` carries execution
    provenance that is not part of the statistical result: the device,
    the engine's outer iterations, host syncs and chunk count."""

    grid: GridSpec
    cells: List[CellResult]
    engine: str
    wall_time_s: float
    collect: str = "stats"
    meta: Optional[Dict] = None

    def __getitem__(self, label: str) -> CellResult:
        for c in self.cells:
            if c.cell.label == label:
                return c
        raise KeyError(label)

    def labels(self) -> List[str]:
        return [c.cell.label for c in self.cells]
