"""Experiment grids, their fused execution on the device lane machine,
and the statistical validation of the simulated grid against the
analytic models."""

from .grid import CellResult, ExperimentCell, GridSpec, SweepResult
from .paper_grid import (
    PAPER_PREDICTORS,
    paper_grid_cells,
    paper_policy_table,
    silent_grid_cells,
    two_level_grid_cells,
)
from .runner import FusedLayout, build_fused_layout, run_cells, run_grid
from .validation import (
    analytic_waste,
    analytic_waste_batch,
    cell_z_rows,
    holm_bonferroni,
    model_validity,
    validate_sweep,
    write_z_table,
)

__all__ = [
    "CellResult",
    "ExperimentCell",
    "GridSpec",
    "SweepResult",
    "PAPER_PREDICTORS",
    "paper_grid_cells",
    "paper_policy_table",
    "silent_grid_cells",
    "two_level_grid_cells",
    "FusedLayout",
    "build_fused_layout",
    "run_cells",
    "run_grid",
    "analytic_waste",
    "analytic_waste_batch",
    "cell_z_rows",
    "holm_bonferroni",
    "model_validity",
    "validate_sweep",
    "write_z_table",
]
