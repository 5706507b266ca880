"""Experiment grid specification and structured sweep results.

An :class:`ExperimentCell` pins down one Monte-Carlo estimation problem —
(platform, predictor, strategy, failure law, job) — and a :class:`GridSpec`
bundles many cells with shared run count and seed.  The runner
(:mod:`repro_torch.experiments.runner`) flattens every (cell, run) pair
into one lane of the device engine, so the whole grid advances in one
cell-multiplexed dispatch.  Each result row carries the cell's analytic
waste and period beside the simulated statistics
(:mod:`repro_torch.core.analytic`), and a sweep writes its rows as CSV or
strict JSON.
"""

from __future__ import annotations

import json
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

    ``n_components`` draws the fault trace as the superposition of that
    many component renewal processes (host trace mode only), fresh at
    t = 0 or, with ``stationary``, each started from its equilibrium
    residual life.  ``n_runs`` overrides the grid-wide Monte-Carlo
    repetition count for this cell; ``None`` inherits
    :attr:`GridSpec.n_runs`.  The fields keep the reference's order."""

    label: str
    work: float
    platform: Platform
    predictor: PredictorModel
    strategy: Strategy
    fault_dist: Optional[Distribution] = None  # None -> exponential
    false_pred_dist: Optional[Distribution] = None
    n_components: Optional[int] = None
    stationary: bool = False
    horizon_factor: float = 12.0
    n_runs: Optional[int] = None

    @property
    def dist(self) -> Distribution:
        return self.fault_dist or exponential()

    @property
    def gen_recall(self) -> float:
        """The recall the legacy per-run pipeline draws its traces with:
        strategies that ignore predictions get a prediction-free trace (as
        :func:`~repro_torch.core.simulator.simulate_many` does).  The
        batched runner draws full traces keyed on the predictor alone, and
        the engines' trust filter drops the predictions."""
        return self.predictor.recall if self.strategy.mode != "none" else 0.0

    def group_key(self) -> Tuple:
        """Cells sharing a key sample their traces from one law family
        with one superposition setting."""
        fp = self.false_pred_dist
        return (
            self.dist.name,
            fp.name if fp is not None else None,
            self.n_components,
            self.stationary,
        )


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
    # two-level disk-tier recoveries and silent-error detections per run
    n_disk_recoveries: Optional[np.ndarray] = None
    n_detections: Optional[np.ndarray] = None

    #: stats keys (from_stats argument order)
    _STAT_KEYS = (
        "n", "mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan",
        "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
        "mean_migrations", "mean_disk_recoveries", "mean_detections",
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

    @property
    def mean_disk_recoveries(self) -> float:
        return self._stat(
            "mean_disk_recoveries", "n_disk_recoveries", lambda a: float(a.mean())
        )

    @property
    def mean_detections(self) -> float:
        return self._stat("mean_detections", "n_detections", lambda a: float(a.mean()))

    @property
    def analytic_waste(self) -> float:
        """First-order analytic waste of the cell's strategy at its
        operating point (shared table models; see
        repro_torch.core.analytic)."""
        return float(_analytic_cols([self.cell])[0][0])

    @property
    def analytic_period(self) -> float:
        """The analytic optimal regular period T_extr at the cell's trust
        level (the period the paper predicts; compare with the tabled
        ``T_R`` the cell actually ran)."""
        return float(_analytic_cols([self.cell])[1][0])

    def to_row(self, analytic: Optional[Tuple[float, float]] = None) -> Dict:
        c = self.cell
        if analytic is None:
            aw, at = _analytic_cols([c])
            analytic = (float(aw[0]), float(at[0]))
        def fin(x: float):  # keep serialized rows strict-JSON/CSV clean
            return float(x) if math.isfinite(x) else None
        return {
            "label": c.label,
            "strategy": c.strategy.name,
            "T_R": c.strategy.T_R,
            "mode": c.strategy.mode,
            "mu": c.platform.mu,
            "C": c.platform.C,
            "recall": c.predictor.recall,
            "precision": c.predictor.precision,
            "window": c.predictor.window,
            "dist": c.dist.name,
            "work": c.work,
            "n_runs": self.n_runs,
            "mean_waste": self.mean_waste,
            "ci95_waste": fin(self.ci95_waste),
            "mean_makespan": self.mean_makespan,
            "ci95_makespan": fin(self.ci95_makespan),
            "mean_faults": self.mean_faults,
            "mean_proactive_ckpts": self.mean_proactive_ckpts,
            "mean_regular_ckpts": self.mean_regular_ckpts,
            "mean_migrations": self.mean_migrations,
            "n_exhausted": self.n_exhausted,
            # analytic-layer columns (appended last: downstream readers
            # key on the historical column prefix)
            "analytic_waste": fin(analytic[0]),
            "analytic_period": fin(analytic[1]),
        }


def _analytic_cols(cells) -> Tuple[np.ndarray, np.ndarray]:
    """(analytic waste at the tabled T_R, analytic optimal period) for a
    batch of cells, via the shared per-cell table layer."""
    from ..core import analytic as A  # lazy: grid stays light at import

    return A.analytic_waste_cells(cells), A.analytic_period_cells(cells)


#: column order of the CSV writer (and of ``to_row``)
_CSV_FIELDS = [
    "label", "strategy", "T_R", "mode", "mu", "C", "recall", "precision",
    "window", "dist", "work", "n_runs", "mean_waste", "ci95_waste",
    "mean_makespan", "ci95_makespan", "mean_faults", "mean_proactive_ckpts",
    "mean_regular_ckpts", "mean_migrations", "n_exhausted",
    "analytic_waste", "analytic_period",
]


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

    def to_rows(self) -> List[Dict]:
        if not self.cells:
            return []
        # one table build for the whole sweep, not one per row
        aw, at = _analytic_cols([c.cell for c in self.cells])
        return [
            c.to_row(analytic=(float(w), float(t)))
            for c, w, t in zip(self.cells, aw, at)
        ]

    def write_csv(self, path) -> None:
        import csv

        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=_CSV_FIELDS)
            w.writeheader()
            for row in self.to_rows():
                w.writerow(row)

    def write_json(self, path) -> None:
        payload = {
            "engine": self.engine,
            "collect": self.collect,
            "wall_time_s": self.wall_time_s,
            "n_runs": self.grid.n_runs,
            "seed": self.grid.seed,
            "cells": self.to_rows(),
        }
        if self.meta is not None:
            payload["meta"] = self.meta
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, allow_nan=False)
