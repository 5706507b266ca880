"""Tables 1-2: job execution times and gains against Young.

Grid: (p, r) in {(0.82, 0.85), (0.4, 0.7)} x N in {2^16, 2^19} x I in
{300 s, 3000 s} x failure law in {exponential, Weibull k=0.7, Weibull
k=0.5 (fresh-start superposed component traces, min(N, 2^15)
components)}; strategies Young (the baseline), ExactPrediction, Instant,
NoCkptI, WithCkptI; 10 days of work, a horizon of 30 times the work,
seed 100.  The quick grid drops the Weibull 0.5 family at N = 2^19 and
runs 16 runs a cell (full: 30).  The whole grid is one ``run_cells``
sweep, as the reference's ``benchmarks/sim_tables.py``.

    python -m repro_torch.paper.sim_tables [--quick] [--engine torch|batch|scalar|legacy] [--device cpu]
    python -m repro_torch.paper.sim_tables --quick --compare   # engines on one grid
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..configs.paper import C, D, MU_IND, R
from ..core import events as E
from ..core import simulator as S
from ..core.waste import Platform, PredictorModel
from ..experiments import ExperimentCell, run_cells
from .common import emit, engine_kwargs, parser

MN = 60.0
WORK = 10 * 86400.0


def _strategies(plat, pred):
    return [
        S.young(plat),
        S.exact_prediction(plat, PredictorModel(pred.recall, pred.precision)),
        S.instant(plat, pred),
        S.nockpt(plat, pred),
        S.withckpt(plat, pred),
    ]


def build_cells(quick: bool = True) -> list[ExperimentCell]:
    """The reference's Tables 1-2 cells, label for label (100 quick, 120
    full)."""
    dists = [
        ("exp", E.exponential(), None),
        ("weibull0.7", E.weibull(0.7), None),
        ("weibull0.5-fresh", E.weibull(0.5), "superposed"),
    ]
    cells: list[ExperimentCell] = []
    for p, r in [(0.82, 0.85), (0.4, 0.7)]:
        for n_procs in [2**16, 2**19]:
            plat = Platform(mu=MU_IND / n_procs, C=C, D=D, R=R)
            for I in [300.0, 3000.0]:
                pred = PredictorModel(r, p, window=I, lead=3600.0)
                for dname, dist, mode in dists:
                    if quick and dname == "weibull0.5-fresh" and n_procs == 2**19:
                        continue  # heavy burn-in trace; full mode only
                    n_comp = min(n_procs, 2**15) if mode == "superposed" else None
                    for strat in _strategies(plat, pred):
                        cells.append(
                            ExperimentCell(
                                label=(
                                    f"table12/{dname}/p{p}_r{r}/N{n_procs}/"
                                    f"I{int(I)}/{strat.name}"
                                ),
                                work=WORK,
                                platform=plat,
                                predictor=pred,
                                strategy=strat,
                                fault_dist=dist,
                                n_components=n_comp,
                                horizon_factor=30,
                            )
                        )
    return cells


def run_sweep(quick: bool = True, engine: str = "torch", seed: int = 100,
              device: Optional[str] = None):
    """The grid through ``run_cells`` on ``engine`` (16 runs a cell quick,
    30 full)."""
    n_runs = 16 if quick else 30
    return run_cells(build_cells(quick), n_runs=n_runs, seed=seed,
                     **engine_kwargs(engine, device))


def run(quick: bool = True, engine: str = "torch", device: Optional[str] = None) -> None:
    """Emit each cell's mean makespan in days, its gain against the Young
    cell of its row, and its mean waste with the 95% interval."""
    sweep = run_sweep(quick, engine=engine, device=device)
    us_per_run = sweep.wall_time_s * 1e6 / sweep.grid.n_lanes
    base_mk: dict[str, float] = {}
    for cr in sweep.cells:
        label = cr.cell.label
        mk = cr.mean_makespan
        prefix = label.rsplit("/", 1)[0]
        if cr.cell.strategy.name == "Young":
            base_mk[prefix] = mk
        base = base_mk.get(prefix)
        gain = 0.0 if base is None else (1 - mk / base)
        emit(
            label,
            us_per_run,
            {
                "days": round(mk / 86400, 2),
                "gain_vs_young_pct": round(100 * gain, 1),
                "waste": round(cr.mean_waste, 4),
                "ci95_waste": round(cr.ci95_waste, 4),
            },
        )


def compare(quick: bool = True, device: Optional[str] = None) -> dict:
    """The engines on one grid: the torch lane machine and the NumPy
    engine against the scalar oracle on the same traces (the largest
    relative difference of a cell's mean waste), and the wall times of
    each beside the seed's legacy pipeline (per-run traces and the scalar
    engine)."""
    torch_run = run_sweep(quick, engine="torch", device=device)
    batch = run_sweep(quick, engine="batch")
    oracle = run_sweep(quick, engine="scalar")
    legacy = run_sweep(quick, engine="legacy")

    def rel(a, b):
        return float(np.max([
            abs(x.mean_waste - s.mean_waste) / max(abs(s.mean_waste), 1e-12)
            for x, s in zip(a.cells, b.cells)
        ]))

    out = {
        "torch_s": round(torch_run.wall_time_s, 2),
        "batch_s": round(batch.wall_time_s, 2),
        "legacy_scalar_s": round(legacy.wall_time_s, 2),
        "oracle_scalar_s": round(oracle.wall_time_s, 2),
        "speedup_vs_legacy": round(legacy.wall_time_s / batch.wall_time_s, 1),
        "speedup_vs_oracle": round(oracle.wall_time_s / batch.wall_time_s, 1),
        "max_rel_waste_diff_same_traces": rel(batch, oracle),
        "max_rel_waste_diff_torch_vs_oracle": rel(torch_run, oracle),
        "n_cells": len(batch.cells),
        "n_runs": batch.grid.n_runs,
    }
    emit("table12/compare", batch.wall_time_s * 1e6 / batch.grid.n_lanes, out)
    return out


if __name__ == "__main__":
    ap = parser(__doc__)
    ap.add_argument("--compare", action="store_true",
                    help="run every engine on the same grid; report times and agreement")
    args = ap.parse_args()
    if args.compare:
        compare(quick=args.quick, device=args.device)
    else:
        run(quick=args.quick, engine=args.engine, device=args.device)
