"""Figures 8-11: the impact of recall against precision on the waste.

One of (r, p) is fixed and the other swept over {0.3, 0.5, 0.7, 0.9,
0.99}; the driver reports the analytic optimal waste and a simulation of
every sweep point (one ``run_cells`` sweep, ExactPrediction, 6 days of
work, seed 3; 20 runs a cell, quick: 4), as the reference's
``benchmarks/recall_precision.py``.  The paper's conclusion, recall
matters much more than precision, shows as the difference of slopes.

    python -m repro_torch.paper.recall_precision [--quick] [--engine torch|batch|scalar|legacy] [--device cpu]
"""

from __future__ import annotations

from typing import Optional

from ..configs.paper import C, D, MU_IND, R
from ..core import simulator as S
from ..core.analytic import optimize
from ..core.waste import Platform, PredictorModel
from ..experiments import ExperimentCell, run_cells
from .common import emit, engine_kwargs, parser


def run(quick: bool = True, engine: str = "torch", device: Optional[str] = None) -> None:
    n_runs = 4 if quick else 20
    work = 6 * 86400.0
    sweep_vals = [0.3, 0.5, 0.7, 0.9, 0.99]

    cells = []
    for n in [2**16, 2**19]:
        plat = Platform(mu=MU_IND / n, C=C, D=D, R=R)
        for fixed_p in [0.4, 0.8]:
            for r in sweep_vals:
                pred = PredictorModel(r, fixed_p)
                cells.append(
                    ExperimentCell(
                        label=f"fig10/N{n}/p{fixed_p}/r{r}",
                        work=work,
                        platform=plat,
                        predictor=pred,
                        strategy=S.exact_prediction(plat, pred),
                    )
                )
    sweep = run_cells(cells, n_runs=n_runs, seed=3, **engine_kwargs(engine, device))
    us_per_run = sweep.wall_time_s * 1e6 / sweep.grid.n_lanes

    for n in [2**16, 2**19]:
        plat = Platform(mu=MU_IND / n, C=C, D=D, R=R)
        for fixed_r in [0.4, 0.8]:
            for p in sweep_vals:
                pol = optimize("exact", plat, PredictorModel(fixed_r, p))
                emit(
                    f"fig8/N{n}/r{fixed_r}/p{p}", 0.0,
                    {"waste_analytic": round(pol.waste, 4), "q": pol.q},
                )
    for cr in sweep.cells:
        pol = optimize("exact", cr.cell.platform, cr.cell.predictor)
        emit(
            cr.cell.label,
            us_per_run,
            {
                "waste_analytic": round(pol.waste, 4),
                "waste_sim": round(cr.mean_waste, 4),
                "q": pol.q,
            },
        )


if __name__ == "__main__":
    args = parser(__doc__).parse_args()
    run(quick=args.quick, engine=args.engine, device=args.device)
