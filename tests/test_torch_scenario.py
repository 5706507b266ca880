"""The lane machine's two-level and silent-error modes against the JAX
reference, and the port's copy of the reference's scenario validation
gates.

The 24 cells of ``two_level_grid_cells("validation") +
silent_grid_cells("validation")`` (seed 11) run through the port on the
CPU and through the reference's fused device-trace engine
(``simulate_batch_jax`` / ``repro.experiments.run_grid``, engine "jax",
``trace_mode="device"``, inside ``jax.enable_x64(True)``).  Both draw the
same counter-based streams (the tier coins among them), so they agree
lane for lane.  Tolerances: integer per-cell columns (lanes, faults,
checkpoints, migrations, exhaustions, disk recoveries, detections)
exact; waste / makespan moments and CIs rtol 1e-9; per-lane makespans
rtol 1e-9.  Chunk sizes and the fused against the per-family dispatch:
integers exact, moments rtol 1e-12 (the per-cell sums taken in another
order), lanes bit-equal.

The gates (``tests/test_validation.py::test_two_level_cells_match_theory``,
``test_silent_cells_match_theory``, ``test_scenario_grid_family_controlled``)
run on the port's own sweep at 200 runs a cell: 0 Holm rejects at alpha
1%, ``se_sim > 0`` everywhere and detections in every silent cell (under
a strike-cursor clobbering bug the silent cells simulate no corruption).
"""

import math
from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.core import jax_sim as RJ
from repro.experiments import GridSpec as RGridSpec
from repro.experiments import run_grid as ref_run_grid
from repro.experiments.paper_grid import silent_grid_cells as ref_silent
from repro.experiments.paper_grid import two_level_grid_cells as ref_two_level
from repro.experiments.runner import build_fused_layout as ref_layout
from repro.core.engine import EngineConfig
from repro_torch.core import batch_sim as PB
from repro_torch.core import events as PE
from repro_torch.core import torch_sim as PT
from repro_torch.experiments import (
    GridSpec,
    SweepResult,
    build_fused_layout,
    run_grid,
    silent_grid_cells,
    two_level_grid_cells,
)
from repro_torch.experiments import validation as V

N_RUNS, SEED, ALPHA = 8, 11, 0.01
GATE_RUNS = 200
SUM_INTS = ("n", "n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
            "n_exhausted", "n_disk_recoveries", "n_detections")
SUM_FLOATS = ("makespan_sum", "makespan_sumsq", "waste_sum", "waste_sumsq")
INT_KEYS = ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
            "mean_migrations", "mean_disk_recoveries", "mean_detections")
FLOAT_KEYS = ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan")
LANE_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
             "n_disk_recoveries", "n_detections")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _cells(side: str, fault_dist=None):
    tl, sil = ((two_level_grid_cells, silent_grid_cells) if side == "port"
               else (ref_two_level, ref_silent))
    return tuple(tl("validation", fault_dist=fault_dist)
                 + sil("validation", fault_dist=fault_dist))


def _port_grid(n_runs=N_RUNS):
    return GridSpec(_cells("port"), n_runs=n_runs, seed=SEED)


def _simulate(side: str, collect: str, chunk="auto"):
    """One engine call on the fused layout of the scenario grid."""
    if side == "ref":
        layout = ref_layout(RGridSpec(_cells("ref"), n_runs=N_RUNS, seed=SEED), "device")
        return RJ.simulate_batch_jax(layout.work_c, layout.plats_c, layout.strats_c,
                                     layout.specs[0], collect=collect)
    layout = build_fused_layout(_port_grid())
    info = {}
    out = PT.simulate_batch_torch(layout.work_c, layout.plats_c, layout.strats_c,
                                  layout.concat_spec(), device="cpu", collect=collect,
                                  chunk=chunk, info=info)
    return out, info


@pytest.fixture(scope="module")
def runs():
    """Each engine call once per module, on demand."""
    cache = {}

    def get(key):
        if key not in cache:
            with jax.enable_x64(True):
                cache[key] = {
                    "ref_stats": lambda: _simulate("ref", "stats"),
                    "ref_lanes": lambda: _simulate("ref", "lanes"),
                    "port_stats": lambda: _simulate("port", "stats")[0],
                    "port_lanes": lambda: _simulate("port", "lanes")[0],
                    "port_stats_chunk7": lambda: _simulate("port", "stats", chunk=7),
                    "port_stats_whole": lambda: _simulate("port", "stats", chunk=None),
                }[key]()
        return cache[key]

    return get


# --------------------------------------------------------------------------- #
# Against the reference's fused device-trace engine
# --------------------------------------------------------------------------- #
def test_scenario_cell_sums_match_reference(runs):
    ref, port = runs("ref_stats"), runs("port_stats")
    assert port.n_cells == ref.n_cells == 24
    for k in SUM_INTS:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    for k in SUM_FLOATS:
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=1e-9, atol=0,
                                   err_msg=k)
    # both families genuinely ran: disk recoveries in the two-level cells,
    # detections in the silent ones, and nothing of either elsewhere
    tl = np.array([c.strategy.mode == "two_level" for c in _cells("port")])
    assert (port.n_disk_recoveries[tl] > 0).all() and (port.n_disk_recoveries[~tl] == 0).all()
    assert (port.n_detections[~tl] > 0).all() and (port.n_detections[tl] == 0).all()


def test_scenario_lanes_match_reference(runs):
    ref, port = runs("ref_lanes"), runs("port_lanes")
    for k in LANE_INTS:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    np.testing.assert_array_equal(port.trace_exhausted, ref.trace_exhausted)
    np.testing.assert_allclose(port.makespan, ref.makespan, rtol=1e-9, atol=0)


def test_scenario_run_grid_matches_reference(runs):
    """``run_grid`` on the CPU against the reference's ``run_grid``, cell
    for cell; the port's rows also carry the disk recoveries and
    detections, held to the reference engine's per-cell sums."""
    port = run_grid(_port_grid(), device="cpu")
    ref = ref_run_grid(RGridSpec(_cells("ref"), n_runs=N_RUNS, seed=SEED),
                       EngineConfig(engine="jax", trace_mode="device", collect="stats"))
    sums = runs("ref_stats")
    assert port.labels() == ref.labels() and port.meta["device"] == "cpu"
    for i, (a, b) in enumerate(zip(ref.cells, port.cells)):
        assert b.n_exhausted == a.n_exhausted
        for k in INT_KEYS[:5]:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-9, atol=0,
                                       err_msg=f"{a.cell.label} {k}")
        assert b.mean_disk_recoveries * N_RUNS == sums.n_disk_recoveries[i]
        assert b.mean_detections * N_RUNS == sums.n_detections[i]


def test_scenario_lanes_through_run_grid(runs):
    lanes = run_grid(_port_grid(), device="cpu", collect="lanes")
    ref = runs("ref_lanes")
    got = np.concatenate([c.n_detections for c in lanes.cells])
    np.testing.assert_array_equal(got, ref.n_detections)
    got = np.concatenate([c.n_disk_recoveries for c in lanes.cells])
    np.testing.assert_array_equal(got, ref.n_disk_recoveries)
    np.testing.assert_allclose(np.concatenate([c.makespan for c in lanes.cells]),
                               ref.makespan, rtol=1e-9, atol=0)


def test_scenario_chunk_size_invariance(runs):
    (whole, info1), (small, info7) = runs("port_stats_whole"), runs("port_stats_chunk7")
    assert info1["n_chunks"] == 1 and info7["n_chunks"] == math.ceil(24 * N_RUNS / 7)
    for k in SUM_INTS:
        np.testing.assert_array_equal(getattr(small, k), getattr(whole, k), err_msg=k)
    for k in SUM_FLOATS:
        np.testing.assert_allclose(getattr(small, k), getattr(whole, k), rtol=1e-12, atol=0)


def test_scenario_fused_matches_perfamily_under_two_laws(runs):
    """The 24 cells under exponential and Weibull 0.7 faults in one fused
    dispatch (the law-indexed silent walk) equal ``dispatch="perfamily"``
    lane for lane, and the exponential cells equal the single-law run."""
    cells = tuple(replace(c, label=f"{tag}/{c.label}")
                  for tag, law in (("exp", None), ("wei", PE.weibull(0.7)))
                  for c in _cells("port", law))
    grid = GridSpec(cells, n_runs=4, seed=SEED)
    fused = run_grid(grid, device="cpu", collect="lanes")
    fam = run_grid(grid, device="cpu", collect="lanes", dispatch="perfamily")
    assert fused.meta["sampler"] == "indexed" and fused.meta["dispatches"] == 1
    assert fam.meta["dispatches"] == 2
    for a, b in zip(fused.cells, fam.cells):
        np.testing.assert_array_equal(a.makespan, b.makespan, err_msg=a.cell.label)
        for k in LANE_INTS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
    single = run_grid(GridSpec(_cells("port"), n_runs=4, seed=SEED), device="cpu",
                      collect="lanes")
    for a, b in zip(single.cells, fused.cells[:24]):
        np.testing.assert_array_equal(a.makespan, b.makespan, err_msg=a.cell.label)
        np.testing.assert_array_equal(a.n_detections, b.n_detections)
    wei = fused.cells[24:]
    assert sum(int(c.n_detections.sum()) for c in wei) > 0
    assert sum(int(c.n_disk_recoveries.sum()) for c in wei) > 0


def test_silent_lanes_strike_counter_untouched_by_primitive_update(monkeypatch):
    """The primitive update refills the strike cursor only where a lane
    faulted; silent lanes enter it with ``nf = +inf`` and never fault, so
    their strike counter leaves the call as it came (the lane machine keeps
    their cursor through the call)."""
    layout = build_fused_layout(_port_grid(n_runs=4))
    mode = np.array([PB.MODE_CODES[s.mode] for s in layout.strats_c])
    sil = mode[layout.cidx] == PB._M_SILENT
    real = PT.masked_primitive_update
    seen = {"silent_calls": 0, "other_moved": 0}

    def spy(prim, *args, stream, **kw):
        before = stream[1].clone()
        out = real(prim, *args, stream=stream, **kw)
        s = np.asarray(sil)
        assert (stream[1].numpy()[s] == before.numpy()[s]).all()
        assert np.isinf(stream[2].numpy()[s]).all()
        seen["silent_calls"] += int((prim.numpy()[s] != 0).any())
        seen["other_moved"] += int((stream[1] != before).any())
        return out

    monkeypatch.setattr(PT, "masked_primitive_update", spy)
    sums = PT.simulate_batch_torch(layout.work_c, layout.plats_c, layout.strats_c,
                                   layout.concat_spec(), device="cpu")
    assert seen["silent_calls"] > 100 and seen["other_moved"] > 10
    assert sums.n_detections.sum() > 0


def test_silent_cells_never_trust_the_predictor():
    """A silent-error strategy given trust q = 1 and a predictor sees no
    prediction (q_eff = 0): the same lanes as the untrusted strategy."""
    cell = silent_grid_cells("validation")[0]
    pred = replace(cell.predictor, recall=0.85, precision=0.82)
    trusted = replace(cell, label="q1", predictor=pred,
                      strategy=replace(cell.strategy, q=1.0))
    untrusted = replace(cell, label="q0", predictor=pred)
    res = run_grid(GridSpec((trusted, untrusted), n_runs=6, seed=SEED), device="cpu",
                   collect="lanes")
    a, b = res.cells
    np.testing.assert_array_equal(a.makespan, b.makespan)
    assert a.mean_proactive_ckpts == 0.0 and a.mean_detections > 0.0


# --------------------------------------------------------------------------- #
# The reference's scenario gates on the port's own sweep
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def gate_sweep():
    return run_grid(_port_grid(GATE_RUNS), device="cpu")


def _subset(sweep, keep):
    return SweepResult(grid=sweep.grid, cells=[c for c in sweep.cells if keep(c.cell)],
                       engine=sweep.engine, wall_time_s=0.0, collect=sweep.collect)


def _assert_no_rejects(sweep):
    rows, fails = V.validate_sweep(sweep, alpha=ALPHA)
    assert not fails, "cells out of the analytic envelope:\n" + "\n".join(
        f"  {r.label}: sim={r.mean_sim:.4f} analytic={r.analytic:.4f} "
        f"margin={r.margin:.4f} z={r.z:.2f}" for r in fails)
    return rows


def test_two_level_cells_match_theory(gate_sweep):
    sub = _subset(gate_sweep, lambda c: c.label.startswith("tl/"))
    assert len(sub.cells) >= 18
    rows = _assert_no_rejects(sub)
    trusted = [r for r in rows if r.label.count("/") == 4]
    untrusted = [r for r in rows if r.label.count("/") == 3]
    assert trusted and untrusted
    assert all(r.strategy == "TwoLevel" for r in rows)
    assert all(c.mean_disk_recoveries > 0 for c in sub.cells)


def test_silent_cells_match_theory(gate_sweep):
    sub = _subset(gate_sweep, lambda c: c.label.startswith("sil/"))
    assert len(sub.cells) >= 6
    rows = _assert_no_rejects(sub)
    assert all(r.strategy == "Silent" for r in rows)
    assert all(r.se_sim > 0 for r in rows)
    assert all(c.mean_detections > 0 for c in sub.cells)


def test_scenario_grid_family_controlled(gate_sweep):
    rows, fails = V.validate_sweep(gate_sweep, alpha=ALPHA)
    assert not fails
    assert all(math.isfinite(r.z) for r in rows)
    assert all(r.se_sim > 0 for r in rows)
    assert len(rows) >= 24
    assert all(r.n_runs == GATE_RUNS for r in rows)
