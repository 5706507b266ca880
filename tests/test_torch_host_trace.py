"""The lane machine's host trace mode against the JAX reference.

A grid of every mode runs through the port on the CPU and through the
reference's host-trace engine (``repro.experiments.run_grid``, engine
"jax", ``trace_mode="host"``: ``simulate_batch_jax`` with
``BatchTraces``, ``rng`` and ``cell_index``, its primitive the Pallas
``_step_kernel`` in interpret mode), inside ``jax.enable_x64(True)``:
fail-stop (Young, exact dates, windows), migration (with cancelled
faults reached by the cursor), two-level, silent errors, trust q of 0,
0.5 and 1, exponential and Weibull 0.7 laws, and a Weibull 0.5 group of
superposed component traces (fresh and stationary).  Both draw the same
NumPy traces and trust coins from the same seeds, so they agree lane for
lane.  Tolerances: integer columns and ``trace_exhausted`` exact;
per-lane waste and makespan rtol 1e-9; ``collect="stats"`` moments rtol
1e-9.  Chunk sizes: integers exact, lanes bit-equal.  Fused against
``dispatch="percell"`` (both trace modes, mirroring
``tests/test_experiments.py::test_fused_vs_percell_sweepresult_equality``),
``run_cells`` against ``run_grid``: lane for lane.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.core import events as RE
from repro.core import jax_sim as RJ
from repro.core.engine import EngineConfig
from repro.experiments import GridSpec as RGridSpec
from repro.experiments import run_grid as ref_run_grid
from repro.experiments.paper_grid import paper_grid_cells as ref_paper
from repro.experiments.paper_grid import silent_grid_cells as ref_silent
from repro.experiments.paper_grid import two_level_grid_cells as ref_two_level
from repro.experiments.runner import build_fused_layout as ref_layout
from repro_torch.core import events as PE
from repro_torch.core import torch_sim as PT
from repro_torch.experiments import (
    GridSpec,
    paper_grid_cells,
    run_cells,
    run_grid,
    silent_grid_cells,
    two_level_grid_cells,
)

N_RUNS, SEED = 5, 7
N = 2**16
LANE_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
             "n_disk_recoveries", "n_detections")
STAT_INTS = ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
             "mean_migrations")
STAT_FLOATS = ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _cells(side: str):
    """The grid's cells on one side ("ref" or "port"): the paper cells
    (the p40r70 Exact, Migration and Instant cells at q 0.5), two-level
    and silent cells, three Weibull 0.7 cells, and Weibull 0.5 cells of
    64 superposed components, fresh and stationary."""
    paper, tl, sil, ev = ((paper_grid_cells, two_level_grid_cells, silent_grid_cells, PE)
                          if side == "port" else (ref_paper, ref_two_level, ref_silent, RE))
    out = []
    for c in paper("validation", n_list=[N]):
        if c.label.startswith("p40r70") and c.strategy.mode in ("exact", "migration"):
            c = replace(c, strategy=replace(c.strategy, q=0.5))
        out.append(c)
    out += tl("validation", n_list=[N])[:3] + sil("validation", n_list=[N])
    wb = paper("validation", n_list=[N], fault_dist=ev.weibull(0.7))[:3]
    out += [replace(c, label="w/" + c.label) for c in wb]
    sp = paper("validation", n_list=[N], fault_dist=ev.weibull(0.5))[:2]
    out += [replace(c, label="sp/" + c.label, n_components=64) for c in sp]
    out += [replace(sp[1], label="st/" + sp[1].label, n_components=64, stationary=True)]
    return tuple(out)


def _grid(side: str, n_runs=N_RUNS):
    spec = RGridSpec if side == "ref" else GridSpec
    return spec(_cells(side), n_runs=n_runs, seed=SEED)


@pytest.fixture(scope="module")
def runs():
    """Each sweep once per module, on demand."""
    cache = {}

    def get(key):
        if key not in cache:
            with jax.enable_x64(True):
                side, collect = key[:2]
                if side == "ref" and collect == "stats":
                    cache[key] = ref_run_grid(_grid("ref"), EngineConfig(
                        engine="jax", trace_mode="host", collect=collect))
                elif side == "ref":
                    # the engine call itself: its lanes carry the disk
                    # recoveries and detections
                    lay = ref_layout(_grid("ref"), "host")
                    cache[key] = lay, RJ.simulate_batch_jax(
                        lay.work_c, lay.plats_c, lay.strats_c, lay.traces,
                        rng=np.random.default_rng([SEED, lay.n_groups]),
                        cell_index=lay.cidx, collect="lanes")
                else:
                    kw = dict(key[2:])
                    cache[key] = run_grid(_grid("port"), device="cpu", collect=collect,
                                          trace_mode="host", **kw)
        return cache[key]

    return get


def test_grid_covers_every_mode():
    modes = {c.strategy.mode for c in _cells("port")}
    assert modes == {"none", "exact", "nockpt", "withckpt", "migration", "two_level",
                     "silent"}
    assert {c.strategy.q for c in _cells("port")} == {0.0, 0.5, 1.0}
    assert {(c.n_components, c.stationary) for c in _cells("port")} == {
        (None, False), (64, False), (64, True)}


def test_host_cell_stats_match_reference(runs):
    ref, port = runs(("ref", "stats")), runs(("port", "stats"))
    assert port.meta["trace_mode"] == "host" and port.meta["dispatches"] == 1
    assert port.labels() == ref.labels()
    for a, b in zip(ref.cells, port.cells):
        assert b.n_exhausted == a.n_exhausted, a.cell.label
        for k in STAT_INTS:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        for k in STAT_FLOATS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-9, atol=0,
                                       err_msg=f"{a.cell.label} {k}")


def test_host_lanes_match_reference(runs):
    (lay, ref), port = runs(("ref", "lanes")), runs(("port", "lanes"))
    for k, ci in enumerate(lay.cell_order):
        a, b = slice(int(lay.offs[k]), int(lay.offs[k + 1])), port.cells[ci]
        label = b.cell.label
        for f in LANE_INTS:
            np.testing.assert_array_equal(getattr(b, f), getattr(ref, f)[a],
                                          err_msg=f"{label} {f}")
        assert b.n_exhausted == int(ref.trace_exhausted[a].sum()), label
        np.testing.assert_allclose(b.makespan, ref.makespan[a], rtol=1e-9, atol=0)
        np.testing.assert_allclose(b.waste, ref.waste[a], rtol=1e-9, atol=0)
    fams = {p: sum(int(getattr(c, k).sum()) for c in port.cells if c.cell.label.startswith(p))
            for p, k in (("tl/", "n_disk_recoveries"), ("sil/", "n_detections"))}
    assert fams["tl/"] > 0 and fams["sil/"] > 0
    assert sum(int(c.n_migrations.sum()) for c in port.cells) > 0


def test_migration_cancels_are_reached(monkeypatch):
    """The migration cells mark predicted faults in ``Fcancel`` and the
    strike cursor passes marked rows (a cancelled fault skipped)."""
    seen = []
    real = PT._run_chunk

    def spy(consts, st, **kw):
        fin = real(consts, st, **kw)
        if "Fcancel" in fin:
            rows = np.arange(fin["Fcancel"].shape[0])[:, None]
            marks = fin["Fcancel"].numpy()
            seen.append((int(marks.sum()),
                         int((marks & (rows < fin["fi"].numpy()[None, :])).sum())))
        return fin

    monkeypatch.setattr(PT, "_run_chunk", spy)
    cells = [c for c in _cells("port") if c.strategy.mode == "migration"]
    run_grid(GridSpec(tuple(cells), n_runs=N_RUNS, seed=SEED), device="cpu",
             collect="lanes", trace_mode="host")
    assert seen and sum(m for m, _ in seen) > 0 and sum(p for _, p in seen) > 0


def test_host_chunk_invariance(runs):
    whole = runs(("port", "lanes"))
    chunked = runs(("port", "lanes", ("chunk_lanes", 23)))
    assert chunked.meta["n_chunks"] > 1
    for a, b in zip(whole.cells, chunked.cells):
        np.testing.assert_array_equal(a.makespan, b.makespan)
        for k in LANE_INTS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


def _lanes_equal(a, b):
    for ca, cb in zip(a.cells, b.cells):
        assert ca.cell.label == cb.cell.label
        np.testing.assert_array_equal(ca.makespan, cb.makespan, err_msg=ca.cell.label)
        for k in LANE_INTS:
            np.testing.assert_array_equal(getattr(ca, k), getattr(cb, k))
        assert ca.n_exhausted == cb.n_exhausted


def _deterministic_cells():
    """The grid's cells at trust q in {0, 1} (a fractional q's host trust
    coins are drawn per engine call) that device mode can run."""
    return tuple(c for c in _cells("port") if c.strategy.q in (0.0, 1.0)
                 and not c.n_components)


@pytest.mark.parametrize("trace_mode", ["host", "device"])
def test_fused_vs_percell(trace_mode):
    grid = GridSpec(_deterministic_cells()[::2], n_runs=3, seed=SEED)
    fused = run_grid(grid, device="cpu", collect="lanes", trace_mode=trace_mode)
    percell = run_grid(grid, device="cpu", collect="lanes", trace_mode=trace_mode,
                       dispatch="percell")
    assert (fused.meta["dispatches"], percell.meta["dispatches"]) == (1, len(grid.cells))
    assert percell.meta["dispatch"] == "percell"
    _lanes_equal(fused, percell)


def test_run_cells_is_run_grid():
    cells = _cells("port")[::4]
    a = run_cells(cells, n_runs=3, seed=SEED, device="cpu", collect="lanes",
                  trace_mode="host")
    b = run_grid(GridSpec(cells, n_runs=3, seed=SEED), device="cpu", collect="lanes",
                 trace_mode="host")
    _lanes_equal(a, b)


def test_run_grid_raises_where_the_reference_raises():
    sp = GridSpec(tuple(c for c in _cells("port") if c.n_components), n_runs=2)
    with pytest.raises(ValueError, match="n_components"):
        run_grid(sp, device="cpu", trace_mode="device")
    small = GridSpec(_cells("port")[:2], n_runs=2)
    with pytest.raises(ValueError, match="stats"):
        run_grid(small, device="cpu", dispatch="percell")
    with pytest.raises(ValueError, match="trace_mode"):
        run_grid(small, device="cpu", trace_mode="disk")
    with pytest.raises(ValueError, match="dispatch"):
        run_grid(small, device="cpu", dispatch="perlane")
    with pytest.raises(ValueError, match="perfamily"):
        run_grid(small, device="cpu", trace_mode="host", dispatch="perfamily")
    with pytest.raises(ValueError, match="cell_index"):
        PT.simulate_batch_torch(1.0, small.cells[0].platform, small.cells[0].strategy,
                                PE.make_event_traces_batch(np.random.default_rng(0), 2,
                                                           1e5, 1e4, 0.5, 0.5),
                                device="cpu")


def test_host_meta_reports_the_split(runs):
    meta = runs(("port", "stats")).meta
    for k in ("host_gen_s", "pack_s", "copy_s", "loop_s"):
        assert meta[k] >= 0.0, k
    assert meta["slab_bytes"] > 0 and len(meta["slabs"]) == meta["n_chunks"] == 1
    assert set(meta["slabs"][0]) == {"F", "P0", "Pft", "Ftier", "bytes"}
