"""Experiment grids and their fused execution on the device lane machine."""

from .grid import CellResult, ExperimentCell, GridSpec, SweepResult
from .paper_grid import PAPER_PREDICTORS, paper_grid_cells
from .runner import build_fused_layout, run_grid

__all__ = [
    "CellResult",
    "ExperimentCell",
    "GridSpec",
    "SweepResult",
    "PAPER_PREDICTORS",
    "paper_grid_cells",
    "build_fused_layout",
    "run_grid",
]
