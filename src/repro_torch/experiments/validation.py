"""Statistical acceptance harness: simulation vs the analytic waste models.

The port's copy of ``repro.experiments.validation``, with its margins
unchanged.

The paper's headline claim is that its analytic optimal periods are
"nicely corroborated by a comprehensive set of simulations".  This module
pins that claim with a *controlled* statistical contract instead of ad-hoc
tolerances:

* :func:`analytic_waste` evaluates the closed-form first-order waste of a
  grid cell's strategy at its operating point (Equations (1), (3), (4),
  (5), (6) of the paper, as the branchless table models of
  :mod:`repro_torch.core.analytic`);
* :func:`cell_z_rows` turns each simulated cell into an
  equivalence-margin z-test.  The first-order models carry *systematic*
  error O(T/mu) (they assume at most one event per period and a uniform
  fault position, so simulation sits consistently at or below the
  analytic value — exactly what the paper's own figures show); a fixed
  tolerance on the mean would therefore either mask engine regressions
  or turn flaky as ``n_runs`` changes.  Instead each cell tests

      H0: |waste_sim - waste_analytic| <= margin

  with an asymmetric margin (simulation may undershoot the pessimistic
  model by ``REL_MARGIN_LO_*``, but overshoot — the direction real engine
  regressions push — only by ``REL_MARGIN_HI``), and the Monte-Carlo
  noise enters only through the standard error, so the test neither
  loosens nor tightens as run counts change;
* :func:`holm_bonferroni` applies step-down multiple-comparison control
  across the grid: the suite's family-wise false-alarm rate is pinned at
  ``alpha`` no matter how many cells the grid grows to, which is what
  stops CI from trading tolerance slack for flakiness.

The margins below were calibrated on the paper grid (exponential faults,
``n_runs`` 100-400): observed |model error| peaks around 17-20% of the
analytic value for the uncapped periods at large N (T/mu ~ 0.7) and a few
percent elsewhere, while the engines agree with each other to float
rounding — a genuine engine regression moves the simulated waste far
outside these envelopes.
"""

from __future__ import annotations

import csv
import json
import math
from dataclasses import asdict, dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core import analytic as A
from ..core import waste as W
from ..core.batch_sim import MODE_CODES
from ..core.events import mu_e as _mu_e
from ..core.events import mu_p as _mu_p
from .grid import ExperimentCell, SweepResult

__all__ = [
    "analytic_waste",
    "analytic_waste_batch",
    "model_validity",
    "CellCheck",
    "cell_z_rows",
    "holm_bonferroni",
    "validate_sweep",
    "write_z_table",
]

#: asymmetric equivalence margins, as fractions of the analytic waste.
#: The undershoot side scales with the cell's distance from the model's
#: validity domain (see :func:`model_validity`): margin_lo =
#: (LO_BASE + LO_SLOPE * min(validity, 1)) * |analytic| + ABS_MARGIN.
#: The overshoot side — the direction engine regressions push — stays
#: flat at REL_MARGIN_HI.
REL_MARGIN_LO_BASE = 0.10
REL_MARGIN_LO_SLOPE = 0.45
REL_MARGIN_HI = 0.12
ABS_MARGIN = 0.004


def analytic_waste(cell: ExperimentCell) -> float:
    """First-order analytic waste of ``cell``'s strategy at its operating
    point (the quantity the paper's simulations corroborate).

    Dispatches on the strategy mode: Young's model for the q = 0
    baselines, Equation (1) for exact-date predictions, Equation (3) for
    migration, and Equations (5)/(6)/(4) for Instant / NoCkptI /
    WithCkptI window strategies.

    This evaluates the branchless table models of
    :mod:`repro_torch.core.analytic` (the same functions the batched
    Newton optimizer differentiates) on a one-cell table; they agree
    with the scalar :mod:`repro_torch.core.waste` formulas to float
    rounding."""
    return float(analytic_waste_batch([cell])[0])


def analytic_waste_batch(cells: Sequence[ExperimentCell]) -> np.ndarray:
    """Vectorized :func:`analytic_waste`: one table build + one
    evaluation for a whole sweep's cells."""
    for cell in cells:
        if cell.strategy.mode not in MODE_CODES:
            raise ValueError(
                f"no analytic model for strategy mode {cell.strategy.mode!r}"
            )
    if not cells:
        return np.zeros(0, dtype=np.float64)
    return A.analytic_waste_cells(cells)


def model_validity(cell: ExperimentCell) -> float:
    """How far ``cell`` sits from the first-order models' validity domain.

    The paper's waste formulas assume at most one event per regular
    period (Section 3.2: ``T <= alpha * mu_e`` keeps the chance of 2+
    events under 3%) and, for window strategies, that proactive episodes
    occupy a small fraction of the time.  Both break down progressively
    at the *uncapped* periods the simulations run (Section 5), so the
    systematic model error scales with

        T_R / mu_e  +  I' / mu_P        (second term: window cells)

    where ``I' = q((1-p) I + p E_f)`` is the expected proactive time per
    prediction.  The validation margins widen linearly in this quantity
    (clamped at 1): tight tests where the model is exact, honest slack
    where the paper's own figures show simulation drifting below the
    pessimistic formula."""
    s, p, pred = cell.strategy, cell.platform, cell.predictor
    r, prec = pred.recall, pred.precision
    trusts = s.mode not in ("none", "silent") and s.q > 0.0 and r > 0.0
    me = _mu_e(p.mu, r, prec) if trusts else p.mu
    if s.mode == "two_level":
        # expected rollback span: memory-tier faults (fraction f) lose at
        # most one memory period, disk-tier faults lose up to rho of them
        rho = s.rho if s.rho is not None else 1
        f = p.f if p.f is not None else 0.0
        span = s.T_R * (f + (1.0 - f) * rho)
    elif s.mode == "silent":
        # detection latency: a corruption survives up to k_V periods, and
        # a struck pattern forfeits its FULL wall time (not the T/2 mean
        # loss of a fail-stop fault) — twice the second-order sensitivity,
        # so the span doubles relative to the fail-stop scale
        span = 2.0 * s.T_R * (s.k_V if s.k_V is not None else 1)
    else:
        span = s.T_R
    v = span / me if math.isfinite(me) else 0.0
    if trusts and pred.window > 0.0:
        mp = _mu_p(p.mu, r, prec)
        if math.isfinite(mp):
            v += W.i_prime(s.q, prec, pred.window, pred.e_f) / mp
    return v


@dataclass
class CellCheck:
    """One cell's equivalence-margin z-test (see module docstring)."""

    label: str
    strategy: str
    dist: str
    n_runs: int
    mean_sim: float
    se_sim: float
    analytic: float
    delta: float  # mean_sim - analytic
    validity: float  # model-validity distance (see model_validity)
    margin: float  # the side-appropriate equivalence margin
    z: float  # (|delta| - margin) / se
    p: float  # one-sided p-value of H0: |delta_true| <= margin
    reject: bool = False  # set by the Holm pass


def _norm_sf(z: float) -> float:
    """Standard-normal survival function 1 - Phi(z)."""
    return 0.5 * math.erfc(z / math.sqrt(2.0))


def cell_z_rows(sweep: SweepResult) -> List[CellCheck]:
    """Per-cell z-statistics of a sweep against the analytic models, at
    the module's margins."""
    rows: List[CellCheck] = []
    was = analytic_waste_batch([cr.cell for cr in sweep.cells])
    for wa, cr in zip(was, sweep.cells):
        wa = float(wa)
        v = model_validity(cr.cell)
        n = cr.n_runs
        # the simulated moments as IEEE doubles: the z-test compares
        # them with the f64 analytic waste
        se = float(cr.ci95_waste) / 1.96
        delta = float(cr.mean_waste) - wa
        if delta > 0:
            rel = REL_MARGIN_HI
        else:
            rel = REL_MARGIN_LO_BASE + REL_MARGIN_LO_SLOPE * min(v, 1.0)
        margin = rel * abs(wa) + ABS_MARGIN
        stat = abs(delta) - margin
        if se > 0 and math.isfinite(se):
            z = stat / se
        else:  # degenerate cells (n < 2 / zero variance): margin decides
            z = math.inf if stat > 0 else -math.inf
        rows.append(
            CellCheck(
                label=cr.cell.label,
                strategy=cr.cell.strategy.name,
                dist=cr.cell.dist.name,
                n_runs=n,
                mean_sim=float(cr.mean_waste),
                se_sim=se,
                analytic=wa,
                delta=delta,
                validity=v,
                margin=margin,
                z=z,
                p=_norm_sf(z),
            )
        )
    return rows


def holm_bonferroni(pvals: Sequence[float], alpha: float = 0.01) -> np.ndarray:
    """Holm's step-down procedure: boolean reject mask at family-wise
    error rate ``alpha``.

    The i-th smallest p-value is compared against ``alpha / (m - i)``
    (i = 0..m-1); the first failure retains that hypothesis and every
    larger one.  Uniformly more powerful than plain Bonferroni at the
    same FWER guarantee, with no independence assumption."""
    p = np.asarray(pvals, dtype=np.float64)
    m = p.shape[0]
    reject = np.zeros(m, dtype=bool)
    if m == 0:
        return reject
    order = np.argsort(p, kind="stable")
    for i, idx in enumerate(order):
        if p[idx] <= alpha / (m - i):
            reject[idx] = True
        else:
            break
    return reject


def validate_sweep(
    sweep: SweepResult, alpha: float = 0.01
) -> Tuple[List[CellCheck], List[CellCheck]]:
    """Run the full acceptance harness on a sweep.

    Returns ``(rows, failures)``: every cell's :class:`CellCheck` (with
    ``reject`` filled by the Holm pass) and the rejected subset.  An
    empty ``failures`` list means the simulated grid is statistically
    compatible with the analytic models under the stated margins, at
    family-wise false-alarm rate ``alpha``."""
    rows = cell_z_rows(sweep)
    reject = holm_bonferroni([r.p for r in rows], alpha=alpha)
    for r, rej in zip(rows, reject):
        r.reject = bool(rej)
    return rows, [r for r in rows if r.reject]


def write_z_table(
    rows: Sequence[CellCheck], csv_path, json_path: Optional[str] = None
) -> None:
    """Dump the per-cell z-score table (the CI artifact)."""
    fields = list(CellCheck.__dataclass_fields__)
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields)
        w.writeheader()
        for r in rows:
            w.writerow(asdict(r))
    if json_path is not None:
        with open(json_path, "w") as f:
            json.dump(
                {
                    "n_cells": len(rows),
                    "n_rejected": sum(r.reject for r in rows),
                    "cells": [asdict(r) for r in rows],
                },
                f,
                indent=1,
            )
