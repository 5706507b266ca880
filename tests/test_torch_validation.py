"""The port's statistical validation of the simulated grid against the
analytic models, and its copy of the reference harness.

One module-scoped CPU sweep of ``paper_grid_cells("validation")`` (54
cells, 200 runs a cell, seed 11) through the port's ``run_grid`` is held
to the contract of the reference's own suite: 0 Holm rejects at alpha =
1%, a finite z and ``se_sim > 0`` in every cell.  The harness itself is
held to the reference's on the same simulated moments (``analytic``,
``validity``, ``margin``, ``z`` and ``p`` within rel 1e-12, the same
rejects), and ``model_validity`` / ``analytic_waste_batch`` /
``holm_bonferroni`` to theirs.  Every call into ``repro`` runs inside
``jax.enable_x64(True)``.
"""

import copy
import csv
import json
import math
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.core import analytic as RA
from repro.experiments import CellResult as RCellResult
from repro.experiments import SweepResult as RSweepResult
from repro.experiments import paper_grid as RPG
from repro.experiments import validation as RV
from repro_torch.experiments import (
    GridSpec,
    SweepResult,
    paper_grid_cells,
    run_grid,
    silent_grid_cells,
    two_level_grid_cells,
)
from repro_torch.experiments import validation as V

N_RUNS, SEED, ALPHA = 200, 11, 0.01


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(scope="module")
def paper_sweep():
    grid = GridSpec(tuple(paper_grid_cells("validation")), n_runs=N_RUNS, seed=SEED)
    return run_grid(grid, device="cpu")


@pytest.fixture(scope="module")
def paper_rows(paper_sweep):
    rows, _ = V.validate_sweep(paper_sweep, alpha=ALPHA)
    return rows


def _subset(sweep, keep):
    return SweepResult(grid=sweep.grid, cells=[c for c in sweep.cells if keep(c.cell)],
                       engine=sweep.engine, wall_time_s=0.0, collect=sweep.collect)


def _assert_no_rejects(sweep):
    rows, fails = V.validate_sweep(sweep, alpha=ALPHA)
    assert not fails, "cells out of the analytic envelope:\n" + "\n".join(
        f"  {r.label}: sim={r.mean_sim:.4f} analytic={r.analytic:.4f} "
        f"margin={r.margin:.4f} z={r.z:.2f}" for r in fails)
    return rows


def _reference_sweep(sweep):
    """The reference's SweepResult of the port's simulated moments, its
    cells rebuilt from the labels (the reference grid has the same
    labels in the same order)."""
    ref_cells = {c.label: c for c in (RPG.paper_grid_cells("validation")
                                      + RPG.paper_grid_cells("full"))}
    cells = [RCellResult.from_stats(ref_cells[cr.cell.label], cr.n_exhausted,
                                    *(cr.stats[k] for k in RCellResult._STAT_KEYS))
             for cr in sweep.cells]
    return RSweepResult(grid=None, cells=cells, engine="torch", wall_time_s=0.0,
                        collect="stats")


# --------------------------------------------------------------------------- #
# The contract on the port's own sweep
# --------------------------------------------------------------------------- #
def test_full_grid_family_controlled(paper_rows):
    """0 Holm rejects over the whole validation grid, with finite
    statistics in all 54 cells."""
    assert len(paper_rows) == 54
    assert not [r for r in paper_rows if r.reject]
    assert all(math.isfinite(r.z) for r in paper_rows)
    assert all(r.se_sim > 0 for r in paper_rows)
    assert all(r.n_runs == N_RUNS for r in paper_rows)


def test_exact_predictor_cells_match_theory(paper_sweep):
    sub = _subset(paper_sweep, lambda c: c.predictor.window == 0.0)
    assert len(sub.cells) >= 18
    rows = _assert_no_rejects(sub)
    assert any(r.strategy in ("ExactPrediction", "Migration") for r in rows)


def test_window_predictor_cells_match_theory(paper_sweep):
    sub = _subset(paper_sweep, lambda c: c.predictor.window > 0.0)
    assert len(sub.cells) >= 36
    rows = _assert_no_rejects(sub)
    assert {r.strategy for r in rows} >= {"Instant", "NoCkptI", "WithCkptI"}


def test_suite_catches_an_engine_regression(paper_sweep):
    """A cell's simulated waste set to its overshoot margin + 10 standard
    errors is flagged by the Holm pass."""
    tampered = copy.deepcopy(paper_sweep)
    victim = tampered.cells[7]
    wa = V.analytic_waste(victim.cell)
    se = victim.ci95_waste / 1.96
    victim.stats["mean_waste"] = wa + V.REL_MARGIN_HI * abs(wa) + V.ABS_MARGIN + 10.0 * se
    _, fails = V.validate_sweep(tampered, alpha=ALPHA)
    assert [r.label for r in fails] == [victim.cell.label]


def test_cell_z_rows_match_reference(paper_sweep):
    got, _ = V.validate_sweep(paper_sweep, alpha=ALPHA)
    want, _ = RV.validate_sweep(_reference_sweep(paper_sweep), alpha=ALPHA)
    assert [r.label for r in got] == [r.label for r in want]
    for a, b in zip(got, want):
        for k in ("analytic", "validity", "margin", "z", "p", "delta"):
            assert getattr(a, k) == pytest.approx(getattr(b, k), rel=1e-12), (a.label, k)
        assert (a.reject, a.strategy, a.dist, a.n_runs) == (b.reject, b.strategy, b.dist,
                                                            b.n_runs)
        assert (a.mean_sim, a.se_sim) == (b.mean_sim, b.se_sim)


def test_cell_z_rows_flag_both_sides(paper_sweep):
    """Undershoot and overshoot past the margins both reject, each side
    under its own margin, exactly as the reference's rows do."""
    tampered = copy.deepcopy(paper_sweep)
    lo, hi = tampered.cells[3], tampered.cells[10]
    for cr, sign in ((lo, -1.0), (hi, 1.0)):
        cr.stats["mean_waste"] = V.analytic_waste(cr.cell) * (1.0 + sign * 0.7)
    got, fails = V.validate_sweep(tampered, alpha=ALPHA)
    want, _ = RV.validate_sweep(_reference_sweep(tampered), alpha=ALPHA)
    assert {r.label for r in fails} == {lo.cell.label, hi.cell.label}
    for a, b in zip(got, want):
        assert a.margin == pytest.approx(b.margin, rel=1e-12)
        assert a.reject == b.reject


# --------------------------------------------------------------------------- #
# The harness's pieces against the reference
# --------------------------------------------------------------------------- #
_GRIDS = {
    "paper": (paper_grid_cells, RPG.paper_grid_cells),
    "two_level": (two_level_grid_cells, RPG.two_level_grid_cells),
    "silent": (silent_grid_cells, RPG.silent_grid_cells),
}


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_model_validity_matches_reference(grid):
    port, ref = (f("validation") for f in _GRIDS[grid])
    assert len(port) == len(ref) > 0
    for a, b in zip(port, ref):
        assert V.model_validity(a) == RV.model_validity(b), a.label


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_analytic_waste_matches_reference(grid):
    port, ref = (f("validation") for f in _GRIDS[grid])
    got = V.analytic_waste_batch(port)
    np.testing.assert_allclose(got, RA.analytic_waste_cells(ref), rtol=1e-12)
    np.testing.assert_allclose(got, RV.analytic_waste_batch(ref), rtol=1e-12)
    assert V.analytic_waste(port[-1]) == got[-1]


def test_analytic_waste_batch_edges(paper_sweep):
    assert V.analytic_waste_batch([]).shape == (0,)
    cell = paper_sweep.cells[0].cell
    bad = replace(cell, strategy=replace(cell.strategy, mode="bogus"))
    with pytest.raises(ValueError, match="no analytic model"):
        V.analytic_waste_batch([bad])


@pytest.mark.parametrize("seed", range(6))
def test_holm_bonferroni_matches_reference(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(1, 60))
    p = rng.random(m) ** rng.uniform(1.0, 6.0)
    p[rng.integers(0, m, m // 3)] = p[0]  # ties
    for alpha in (0.01, 0.05, 0.2):
        np.testing.assert_array_equal(V.holm_bonferroni(p, alpha), RV.holm_bonferroni(p, alpha))


def test_holm_bonferroni_step_down():
    rej = V.holm_bonferroni([0.010, 0.013, 0.04, 0.20], alpha=0.05)
    assert rej.tolist() == [True, True, False, False]
    assert V.holm_bonferroni([0.010, 0.020, 0.011, 0.9], alpha=0.05).tolist() == [
        True, True, True, False]
    assert V.holm_bonferroni([], alpha=0.05).shape == (0,)
    assert V.holm_bonferroni([0.001, 0.001, 0.001], alpha=0.01).all()


def test_margins_and_helpers_match_reference():
    for k in ("REL_MARGIN_LO_BASE", "REL_MARGIN_LO_SLOPE", "REL_MARGIN_HI", "ABS_MARGIN"):
        assert getattr(V, k) == getattr(RV, k)
    assert V.__all__ == RV.__all__
    assert list(V.CellCheck.__dataclass_fields__) == list(RV.CellCheck.__dataclass_fields__)
    for z in (-math.inf, -5.6, -1.0, 0.0, 0.3, 2.5, math.inf):
        assert V._norm_sf(z) == RV._norm_sf(z)


# --------------------------------------------------------------------------- #
# Artifacts
# --------------------------------------------------------------------------- #
def test_z_table_artifact_roundtrip(paper_rows, tmp_path):
    csv_path, json_path = tmp_path / "ztable.csv", tmp_path / "ztable.json"
    V.write_z_table(paper_rows, csv_path, str(json_path))
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(paper_rows)
    for got, r in zip(rows, paper_rows):
        assert got["label"] == r.label and got["reject"] == str(r.reject)
        assert float(got["z"]) == r.z and float(got["margin"]) == r.margin
    payload = json.loads(json_path.read_text())
    assert payload["n_cells"] == len(paper_rows) and payload["n_rejected"] == 0
    assert payload["cells"][5]["p"] == paper_rows[5].p


def test_sweep_rows_and_writers(paper_sweep, tmp_path):
    rows = paper_sweep.to_rows()
    assert len(rows) == len(paper_sweep.cells)
    ref_rows = _reference_sweep(paper_sweep).to_rows()
    for a, b in zip(rows, ref_rows):
        assert a.keys() == b.keys()
        for k in ("analytic_waste", "analytic_period"):
            assert a[k] == pytest.approx(b[k], rel=1e-12)
        assert {k: v for k, v in a.items() if not k.startswith("analytic")} == {
            k: v for k, v in b.items() if not k.startswith("analytic")}
    cr = paper_sweep.cells[4]
    assert cr.analytic_waste == V.analytic_waste(cr.cell)
    assert cr.to_row() == rows[4]
    assert cr.analytic_period == rows[4]["analytic_period"]

    csv_path, json_path = tmp_path / "sweep.csv", tmp_path / "sweep.json"
    paper_sweep.write_csv(csv_path)
    with open(csv_path) as f:
        back = list(csv.DictReader(f))
    assert [r["label"] for r in back] == paper_sweep.labels()
    assert float(back[4]["analytic_waste"]) == rows[4]["analytic_waste"]
    paper_sweep.write_json(json_path)
    payload = json.loads(json_path.read_text())
    assert payload["cells"] == rows
    assert (payload["n_runs"], payload["seed"], payload["engine"]) == (N_RUNS, SEED, "torch")
    assert payload["meta"]["device"] == "cpu"


def test_write_json_is_strict(paper_sweep, tmp_path):
    one = copy.deepcopy(_subset(paper_sweep, lambda c: True))
    one.cells = one.cells[:1]
    one.cells[0].stats["ci95_waste"] = math.nan
    one.write_json(tmp_path / "one.json")
    assert json.loads((tmp_path / "one.json").read_text())["cells"][0]["ci95_waste"] is None
    one.cells[0].stats["mean_waste"] = math.inf
    with pytest.raises(ValueError):
        one.write_json(tmp_path / "bad.json")
