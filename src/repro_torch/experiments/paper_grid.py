"""The paper's Section 5 experiment grid as a reusable cell factory.

* **platforms**: the paper's Section 5 scenarios (C = R = 10 mn,
  D = 1 mn, individual MTBF 125 years, N = 2^14 .. 2^19 processors),
  from :mod:`repro_torch.configs.paper`;
* **predictors**: the paper's two operating points — precision 0.82 /
  recall 0.85 and precision 0.4 / recall 0.7;
* **strategies**: the q = 0 Young baseline, ExactPrediction (Section 3),
  Migration (Section 3.4), and the window strategies Instant / NoCkptI /
  WithCkptI (Section 4) at each window length, every one at its
  analytic-optimal (uncapped) period.

All cells of a preset share one failure-law family (exponential unless
overridden), so the fused dispatch runs the whole grid as one megabatch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..configs.paper import N_RANGE, platform
from ..core import simulator as S
from ..core.events import Distribution
from ..core.waste import PredictorModel
from .grid import ExperimentCell

__all__ = ["PAPER_PREDICTORS", "paper_grid_cells"]

#: the paper's two (recall, precision) predictor operating points
PAPER_PREDICTORS = {
    "p82r85": PredictorModel(recall=0.85, precision=0.82),
    "p40r70": PredictorModel(recall=0.7, precision=0.4),
}

#: preset -> (platform sizes, window lengths in seconds)
_PRESETS = {
    # every strategy family and predictor on small / medium / large
    # platforms: the validation grid
    "validation": (N_RANGE[::2], (1200.0, 6000.0)),
    # every platform size, one window: the fused-dispatch benchmark grid
    "bench": (N_RANGE, (1200.0,)),
    # the full Section 5 sweep
    "full": (N_RANGE, (1200.0, 6000.0)),
}


def paper_grid_cells(
    preset: str = "validation",
    work: float = 8 * 86400.0,
    migration_m: float = 300.0,
    lead: float = 3600.0,
    fault_dist: Optional[Distribution] = None,
    n_list: Optional[Sequence[int]] = None,
    windows: Optional[Sequence[float]] = None,
    horizon_factor: float = 12.0,
) -> List[ExperimentCell]:
    """Build the paper grid's :class:`ExperimentCell` list.

    ``preset`` picks the (platform sizes, windows) pair; ``n_list`` /
    ``windows`` override it.  Every (platform, predictor) point carries
    its own Young baseline so the paired-trace design holds within each
    predictor scenario (the baseline shares the fault stream and ignores
    the predictions)."""
    if preset not in _PRESETS:
        raise ValueError(
            f"unknown preset {preset!r} (expected one of {sorted(_PRESETS)})"
        )
    p_n, p_w = _PRESETS[preset]
    n_list = list(p_n if n_list is None else n_list)
    windows = list(p_w if windows is None else windows)
    cells: List[ExperimentCell] = []
    for pk, pred in PAPER_PREDICTORS.items():
        for n in n_list:
            plat = platform(n, M=migration_m)
            exact_pred = PredictorModel(pred.recall, pred.precision, lead=lead)
            prefix = f"{pk}/N{n}"

            def cell(tag: str, strat, p, prefix=prefix, plat=plat) -> ExperimentCell:
                return ExperimentCell(
                    label=f"{prefix}/{tag}",
                    work=work,
                    platform=plat,
                    predictor=p,
                    strategy=strat,
                    fault_dist=fault_dist,
                    horizon_factor=horizon_factor,
                )

            cells.append(cell("Young", S.young(plat), exact_pred))
            cells.append(
                cell("Exact", S.exact_prediction(plat, exact_pred), exact_pred)
            )
            cells.append(
                cell("Migration", S.migration(plat, exact_pred), exact_pred)
            )
            for w in windows:
                wpred = PredictorModel(
                    pred.recall, pred.precision, lead=lead, window=w
                )
                cells.append(
                    cell(f"I{int(w)}/Instant", S.instant(plat, wpred), wpred)
                )
                cells.append(
                    cell(f"I{int(w)}/NoCkptI", S.nockpt(plat, wpred), wpred)
                )
                cells.append(
                    cell(f"I{int(w)}/WithCkptI", S.withckpt(plat, wpred), wpred)
                )
    return cells
