"""Figures 4-7: waste against platform size N, analytic (capped and
uncapped periods) against simulation, for both paper predictors.

The simulated column comes from one ``run_cells`` sweep in which every
(predictor, N) point is a cell (ExactPrediction, 8 days of work, seed
7; 25 runs a cell, quick: 5 runs and every other N), as the reference's
``benchmarks/waste_curves.py``.

    python -m repro_torch.paper.waste_curves [--quick] [--engine torch|batch|scalar|legacy] [--device cpu]
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs.paper import C, D, MU_IND, N_RANGE, R
from ..core import simulator as S
from ..core.analytic import optimize
from ..core.waste import Platform, PredictorModel, waste_exact, waste_young
from ..experiments import ExperimentCell, run_cells
from .common import emit, engine_kwargs, parser


def run(quick: bool = True, engine: str = "torch", device: Optional[str] = None) -> None:
    n_runs = 5 if quick else 25
    work = 8 * 86400.0
    cells = []
    for p, r in [(0.82, 0.85), (0.4, 0.7)]:
        pred = PredictorModel(r, p)
        for n in N_RANGE if not quick else N_RANGE[::2]:
            plat = Platform(mu=MU_IND / n, C=C, D=D, R=R)
            cells.append(
                ExperimentCell(
                    label=f"fig4/p{p}_r{r}/N{n}",
                    work=work,
                    platform=plat,
                    predictor=pred,
                    strategy=S.exact_prediction(plat, pred),
                )
            )
    sweep = run_cells(cells, n_runs=n_runs, seed=7, **engine_kwargs(engine, device))
    us_per_run = sweep.wall_time_s * 1e6 / sweep.grid.n_lanes

    for cr in sweep.cells:
        plat, pred = cr.cell.platform, cr.cell.predictor
        r, p = pred.recall, pred.precision
        # analytic: capped (Section 3.3 domain) and uncapped (Section 5)
        pol = optimize("exact", plat, pred)
        # T_extr at q = 1 and q = 0 (Equation (12) extrema, uncapped)
        t1 = float(np.sqrt(2.0 * plat.mu * C / (1.0 - r)))
        w_uncapped = waste_exact(t1, 1.0, C, D, R, plat.mu, r, p)
        ty = float(np.sqrt(2.0 * plat.mu * C))
        w_young = waste_young(ty, C, D, R, plat.mu)
        emit(
            cr.cell.label,
            us_per_run,
            {
                "waste_young_analytic": round(w_young, 4),
                "waste_pred_capped": round(pol.waste, 4),
                "waste_pred_uncapped": round(min(w_uncapped, 1.0), 4),
                "waste_pred_sim": round(cr.mean_waste, 4),
                "ci95": round(cr.ci95_waste, 4),
                "q": pol.q,
            },
        )


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    run(quick=args.quick, engine=args.engine, device=args.device)
