"""The paper's Figure-4 trend as a terminal table: waste against N for
Young / ExactPrediction / NoCkptI, analytic and simulated.

The simulated columns come from one ``run_cells`` sweep in which every
(N, strategy) point is a cell (the paper predictor p 0.82, r 0.85 with a
300 s window, 6 days of work, 6 runs a cell, seed 1), as the
reference's ``examples/simulate_cluster.py``; the driver has one size.

    python -m repro_torch.paper.simulate_cluster [--engine torch|batch|scalar|legacy] [--device cpu]
"""

from __future__ import annotations

from typing import List, Optional

from ..configs.paper import C, D, MU_IND, N_RANGE, R
from ..core import simulator as S
from ..core.analytic import optimize
from ..core.waste import Platform, PredictorModel
from ..experiments import ExperimentCell, run_cells
from .common import engine_kwargs, parser

PRED = PredictorModel(0.85, 0.82, window=300.0)
WORK = 6 * 86400.0


def run(engine: str = "torch", device: Optional[str] = None) -> List[str]:
    """Print the table (and return its lines)."""
    cells = []
    for n in N_RANGE:
        plat = Platform(mu=MU_IND / n, C=C, D=D, R=R)
        cells.append(
            ExperimentCell(f"exact/N{n}", WORK, plat, PRED, S.exact_prediction(plat, PRED))
        )
        cells.append(ExperimentCell(f"nockpt/N{n}", WORK, plat, PRED, S.nockpt(plat, PRED)))
    sweep = run_cells(cells, n_runs=6, seed=1, **engine_kwargs(engine, device))

    lines = [f"{'N':>8} {'mu(mn)':>8} | {'Young':>7} {'Exact(an)':>9} "
             f"{'Exact(sim)':>10} {'NoCkptI(sim)':>12} | gain"]
    for n in N_RANGE:
        plat = Platform(mu=MU_IND / n, C=C, D=D, R=R)
        wy = optimize("exact", plat, PredictorModel(0.0, 1.0)).waste
        wa = optimize("exact", plat, PredictorModel(PRED.recall, PRED.precision)).waste
        we = sweep[f"exact/N{n}"].mean_waste
        wn = sweep[f"nockpt/N{n}"].mean_waste
        lines.append(
            f"{n:>8} {plat.mu/60:>8.0f} | {wy:>7.3f} {wa:>9.3f} {we:>10.3f} "
            f"{wn:>12.3f} | {100*(1-we/max(wy,1e-9)):>4.0f}%"
        )
    lines.append(f"\nWaste grows with N; prediction's advantage grows faster (paper Fig 4)."
                 f"  [sweep: {sweep.grid.n_lanes} lanes in {sweep.wall_time_s:.1f}s]")
    for ln in lines:
        print(ln)
    return lines


if __name__ == "__main__":
    args = parser(__doc__, quick=False).parse_args()
    run(engine=args.engine, device=args.device)
