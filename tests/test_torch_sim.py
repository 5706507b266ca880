"""The port's slice as a whole against the JAX reference: the fused
paper-grid sweep (repro_torch.experiments.run_grid on the CPU) against
repro.experiments.run_grid with the JAX engine in device trace mode.

Both sides draw the same counter-based streams, so results agree lane for
lane.  Tolerances: integer per-cell columns (lane, fault, checkpoint,
migration and exhaustion counts) exact; waste / makespan means and CIs
rtol 1e-9 (sums taken in another order, gap transforms a few ulp apart
through libm versus XLA); per-lane makespans rtol 1e-9.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import events as RE
from repro.core import jax_sim as RJ
from repro.core.engine import EngineConfig
from repro.experiments import GridSpec as RGridSpec
from repro.experiments import run_grid as ref_run_grid
from repro.experiments.paper_grid import paper_grid_cells as ref_cells
from repro.experiments.runner import build_fused_layout as ref_layout
from repro_torch.core import batch_sim as PB
from repro_torch.core import events as PE
from repro_torch.core import torch_sim as PT
from repro_torch.experiments import GridSpec, build_fused_layout, paper_grid_cells, run_grid

N_RUNS = 8
INT_KEYS = ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
            "mean_migrations")
FLOAT_KEYS = ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan")
LAWS = {
    "exponential": (None, None),
    "weibull": (RE.weibull(0.7), PE.weibull(0.7)),
    "weibull0.5": (RE.weibull(0.5), PE.weibull(0.5)),  # the sqrt strength reduction
    "lognormal": (RE.lognormal(1.0), PE.lognormal(1.0)),  # Box-Muller, both words
    "uniform": (RE.uniform(), PE.uniform()),
}


def _grids(law):
    ref_law, port_law = LAWS[law]
    return (
        RGridSpec(tuple(ref_cells("validation", fault_dist=ref_law)), n_runs=N_RUNS, seed=0),
        GridSpec(tuple(paper_grid_cells("validation", fault_dist=port_law)),
                 n_runs=N_RUNS, seed=0),
    )


def _ref(grid, collect):
    with jax.enable_x64(True):
        return ref_run_grid(
            grid, EngineConfig(engine="jax", trace_mode="device", collect=collect)
        )


@pytest.fixture(scope="module")
def runs():
    """Each sweep once per module, on demand."""
    cache = {}

    def get(side, law, collect="stats", chunk="auto"):
        key = (side, law, collect, chunk)
        if key not in cache:
            ref_grid, port_grid = _grids(law)
            if side == "ref":
                cache[key] = _ref(ref_grid, collect)
            else:
                cache[key] = run_grid(port_grid, device="cpu", collect=collect,
                                      chunk_lanes=chunk)
        return cache[key]

    return get


def _diff_lanes(ref_cell, port_cell):
    """Lanes of one cell whose counters differ (reported on failure)."""
    bad = []
    for f in ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations"):
        a, b = getattr(ref_cell, f), getattr(port_cell, f)
        bad += [(f, int(i), int(a[i]), int(b[i])) for i in np.flatnonzero(a != b)]
    return bad


@pytest.mark.parametrize("law", list(LAWS))
def test_cell_counters_exact(runs, law):
    ref, port = runs("ref", law), runs("port", law)
    assert port.meta["device"] == "cpu" and port.collect == "stats"
    assert port.labels() == ref.labels()
    for a, b in zip(ref.cells, port.cells):
        assert b.n_exhausted == a.n_exhausted, a.cell.label
        for k in INT_KEYS:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        assert b.n_runs == N_RUNS


@pytest.mark.parametrize("law", list(LAWS))
def test_cell_moments_close(runs, law):
    ref, port = runs("ref", law), runs("port", law)
    for a, b in zip(ref.cells, port.cells):
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-9, atol=0,
                                       err_msg=f"{a.cell.label} {k}")


def test_lanes_match_reference(runs):
    ref, port = runs("ref", "exponential", "lanes"), runs("port", "exponential", "lanes")
    assert port.collect == "lanes"
    for a, b in zip(ref.cells, port.cells):
        assert _diff_lanes(a, b) == [], a.cell.label
        np.testing.assert_allclose(b.makespan, a.makespan, rtol=1e-9, atol=0,
                                   err_msg=a.cell.label)
        np.testing.assert_allclose(b.waste, a.waste, rtol=1e-9, atol=1e-15)
        assert b.n_exhausted == a.n_exhausted


def test_stats_agree_with_own_lanes(runs):
    lanes, stats = runs("port", "exponential", "lanes"), runs("port", "exponential")
    for a, b in zip(lanes.cells, stats.cells):
        assert b.stats["mean_faults"] * N_RUNS == a.n_faults.sum()
        np.testing.assert_allclose(b.mean_waste, a.mean_waste, rtol=1e-12)
        np.testing.assert_allclose(b.ci95_makespan, a.ci95_makespan, rtol=1e-9)


def test_chunk_size_invariance(runs):
    one, small = runs("port", "exponential", chunk=None), runs("port", "exponential", chunk=128)
    assert one.meta["n_chunks"] == 1 and small.meta["n_chunks"] == 4
    for a, b in zip(one.cells, small.cells):
        assert b.n_exhausted == a.n_exhausted
        for k in INT_KEYS:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-12, atol=0)


def test_reference_packed_chunk_runs_in_port(runs):
    """The reference packers' chunk (tables, stream words, zeroed state,
    padded to its 1024-lane tile) carried across with tables_from_numpy
    runs in the port's lane machine to the reference's per-cell sums."""
    ref_grid, _ = _grids("exponential")
    layout = ref_layout(ref_grid, "device")
    spec = layout.specs[0]
    n_cells = spec.n_cells
    n_tab = max(8, 1 << n_cells.bit_length())
    W, C, D, R, M, T_R, T_P, mode, q = PB._lane_params(
        layout.work_c, layout.plats_c, layout.strats_c, n_cells)
    q_eff = np.where(mode == PB._M_NONE, 0.0, np.clip(q, 0.0, 1.0))
    tables = RJ._cell_tables(
        n_cells, n_tab, np.float64, W, C, D, R, M, T_R, T_P, mode,
        spec.horizon, spec.window, -1.0, mtbf=spec.mtbf, fp_mean=spec.fp_mean,
        recall=spec.recall, q_eff=q_eff,
    )
    L = spec.n_lanes
    consts, state = RJ._pack_chunk_spec_cells(
        tables, spec, spec.cell_index, n_cells, slice(0, L), RJ.LANE_TILE,
        np.float64, np.int64,
    )
    c = PT.tables_from_numpy(consts, "cpu")
    tally = PT._Tally()
    fin = PT._run_chunk(
        c, PT._to_device(state, "cpu"), gen=("exponential", 0.0, "exponential", 0.0),
        has_mig=True, max_iters=5_000_000, eps=1e-6, tally=tally,
    )
    assert tally.iters > 0 and tally.syncs > tally.iters
    assert (fin["phase"][L:] == PB._PH_DONE).all() and (fin["t"][L:] == 0.0).all()
    cs = PT._cell_sums(fin, c["W"].index_select(0, c["cidx"]), c["cidx"], n_tab).numpy()
    sums = PT.CellSums.from_matrix(cs[:n_cells])
    ref = runs("ref", "exponential")
    for k, ci in enumerate(layout.cell_order):
        a = ref.cells[ci]
        assert sums.n[k] == N_RUNS and sums.n_exhausted[k] == a.n_exhausted
        assert sums.n_faults[k] / N_RUNS == a.stats["mean_faults"]
        assert sums.n_migrations[k] / N_RUNS == a.stats["mean_migrations"]
        np.testing.assert_allclose(sums.mean_makespan[k], a.stats["mean_makespan"], rtol=1e-9)
        np.testing.assert_allclose(sums.mean_waste[k], a.stats["mean_waste"], rtol=1e-9)


@pytest.mark.parametrize("max_iters", [5, 13])
def test_outer_loop_stops_at_max_iters(max_iters):
    cells = paper_grid_cells("validation", n_list=[2**18])[:3]
    layout = build_fused_layout(GridSpec(tuple(cells), n_runs=4))
    info = {}
    with pytest.raises(RuntimeError, match="did not converge"):
        PT.simulate_batch_torch(
            layout.work_c, layout.plats_c, layout.strats_c, layout.specs[0],
            device="cpu", max_iters=max_iters, info=info,
        )
    assert info["outer_iters"] == max_iters and info["n_chunks"] == 1


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, grid = _grids("exponential")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_grid(grid)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PT.resolve_device(None)


def test_mixed_law_grid_runs_as_the_reference():
    """A grid mixing two law families runs in one dispatch on the
    law-indexed sampler, cell for cell the reference's fused run."""
    def cells(mk, law):
        out = mk("validation", n_list=[2**14])[:2]
        return out + [mk("validation", n_list=[2**16], fault_dist=law)[0]]

    ref_grid = RGridSpec(tuple(cells(ref_cells, RE.weibull(0.7))), n_runs=2)
    grid = GridSpec(tuple(cells(paper_grid_cells, PE.weibull(0.7))), n_runs=2)
    spec = PE.make_trace_spec(2, 1e6, 1e3, 0.5, 0.7, fault_dist=[PE.weibull(0.7)],
                              cell_index=[0, 0])
    assert spec.fault_dist == spec.false_pred_dist == (PE.weibull(0.7),)
    port = run_grid(grid, device="cpu", collect="lanes")
    ref = _ref(ref_grid, "lanes")
    assert port.meta["dispatches"] == 1 and port.meta["sampler"] == "indexed"
    assert port.labels() == ref.labels()
    for a, b in zip(ref.cells, port.cells):
        assert _diff_lanes(a, b) == [], a.cell.label
        np.testing.assert_allclose(b.makespan, a.makespan, rtol=1e-9, atol=0)
