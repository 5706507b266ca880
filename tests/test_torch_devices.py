"""``devices=``: the lane machine's lanes sharded over a device set.

Three shards on the CPU (``devices=["cpu"] * 3``) against one device
(``None``, with ``device="cpu"``), in both trace modes and at chunk
sizes None and 64, on a grid of every mode (migration, two-level, silent
errors, fractional trust): per-lane results equal (makespans bit for bit,
integer columns exact) and per-cell stats with integer columns exact and
moments within rtol 1e-12 (each shard keeps its own sums, added once in
device order at the end).  The shards' outer iterations interleave, and
the termination poll reads every live shard's flag.  The errors of the
reference's ``devices=`` rules: ``devices=`` with a host engine, an int
above the device count, and ``device=`` together with ``devices=``.
"""

from dataclasses import replace

import numpy as np
import pytest
import torch

from repro_torch.core import EngineConfig, simulate_many
from repro_torch.core import simulator as PS
from repro_torch.core import torch_sim as PT
from repro_torch.configs.paper import platform
from repro_torch.core.waste import PredictorModel
from repro_torch.experiments import (
    GridSpec,
    build_fused_layout,
    paper_grid_cells,
    run_grid,
    silent_grid_cells,
    two_level_grid_cells,
)

N = 2**16
N_RUNS = 7
LANE_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
             "n_disk_recoveries", "n_detections")
STAT_INTS = ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
             "mean_migrations", "mean_disk_recoveries", "mean_detections")
STAT_FLOATS = ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan")
THREE = ["cpu"] * 3


def _grid():
    cells = [c for c in paper_grid_cells("validation", n_list=[N])
             if c.label.startswith("p40r70")][:6]
    cells[2] = replace(cells[2], strategy=replace(cells[2].strategy, q=0.5))
    cells += two_level_grid_cells("validation", n_list=[N])[:2]
    cells += silent_grid_cells("validation", n_list=[N])[:2]
    return GridSpec(tuple(cells), n_runs=N_RUNS, seed=3)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(devices, trace_mode, chunk, collect):
        key = (devices is None, trace_mode, chunk, collect)
        if key not in cache:
            cfg = EngineConfig(trace_mode=trace_mode, chunk_lanes=chunk, collect=collect,
                               devices=devices)
            cache[key] = run_grid(_grid(), cfg, device=None if devices else "cpu")
        return cache[key]

    return get


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("trace_mode", ["host", "device"])
def test_three_shards_give_the_one_device_lanes(runs, trace_mode, chunk):
    one, three = runs(None, trace_mode, chunk, "lanes"), runs(THREE, trace_mode, chunk, "lanes")
    assert three.meta["devices"] == THREE and one.meta["devices"] == ["cpu"]
    assert three.meta["n_chunks"] == one.meta["n_chunks"]
    # every shard is polled: more syncs, the same rounds of iterations
    assert three.meta["host_syncs"] > one.meta["host_syncs"]
    for a, b in zip(one.cells, three.cells):
        np.testing.assert_array_equal(a.makespan, b.makespan, err_msg=a.cell.label)
        for k in LANE_INTS:
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.n_exhausted == b.n_exhausted
    if trace_mode == "host":
        assert len(three.meta["slabs"]) == 3 * len(one.meta["slabs"])


@pytest.mark.parametrize("chunk", [None, 64])
@pytest.mark.parametrize("trace_mode", ["host", "device"])
def test_three_shards_give_the_one_device_stats(runs, trace_mode, chunk):
    one, three = runs(None, trace_mode, chunk, "stats"), runs(THREE, trace_mode, chunk, "stats")
    for a, b in zip(one.cells, three.cells):
        assert a.n_exhausted == b.n_exhausted
        for k in STAT_INTS:
            assert a.stats[k] == b.stats[k], (a.cell.label, k)
        for k in STAT_FLOATS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-12, atol=0,
                                       err_msg=f"{a.cell.label} {k}")
    lanes = runs(None, trace_mode, chunk, "lanes")
    for a, b in zip(lanes.cells, three.cells):
        np.testing.assert_allclose(b.mean_waste, a.mean_waste, rtol=1e-12)


def test_shards_interleave(monkeypatch):
    """Each round steps every live shard once: no shard runs to its end
    before the next starts."""
    order = []
    real = PT._chunk_machine

    def spy(consts, st, **kw):
        s, step = real(consts, st, **kw)
        shard = spy.n
        spy.n += 1

        def logged():
            order.append(shard)
            step()

        return s, logged

    spy.n = 0
    monkeypatch.setattr(PT, "_chunk_machine", spy)
    lay = build_fused_layout(_grid(), "host")
    info = {}
    PT.simulate_batch_torch(lay.work_c, lay.plats_c, lay.strats_c, lay.traces,
                            cell_index=lay.cidx, devices=THREE, chunk=None, info=info)
    assert spy.n == 3 and set(order) == {0, 1, 2}
    # the first rounds run all three shards in turn
    assert order[:6] == [0, 1, 2, 0, 1, 2]
    first_end = {s: max(i for i, x in enumerate(order) if x == s) for s in range(3)}
    first_start = {s: order.index(s) for s in range(3)}
    assert all(first_start[s] < first_end[t] for s in range(3) for t in range(3))
    assert info["outer_iters"] == max(order.count(s) for s in range(3))


def test_more_devices_than_lanes():
    plat = platform(N)
    pred = PredictorModel(0.85, 0.82, window=300.0)
    one = simulate_many(8 * 86400.0, plat, PS.exact_prediction(plat, pred), pred, n_runs=2,
                        config=EngineConfig(), device="cpu")
    many = simulate_many(8 * 86400.0, plat, PS.exact_prediction(plat, pred), pred, n_runs=2,
                         config=EngineConfig(devices=["cpu"] * 5))
    assert [r.makespan for r in one] == [r.makespan for r in many]


def test_devices_errors():
    grid = _grid()
    with pytest.raises(ValueError, match="devices= requires engine='torch'"):
        EngineConfig(engine="batch", devices=THREE).validate()
    with pytest.raises(ValueError, match="require engine='torch'"):
        run_grid(grid, EngineConfig(engine="batch", devices=THREE))
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match=f"devices={n_cuda + 1} but this process has"):
        run_grid(grid, EngineConfig(devices=n_cuda + 1))
    with pytest.raises(ValueError, match="devices=0"):
        PT.resolve_devices(0)
    with pytest.raises(ValueError, match="either device= or devices="):
        run_grid(grid, EngineConfig(devices=THREE), device="cpu")
    lay = build_fused_layout(grid, "host")
    with pytest.raises(ValueError, match="either device= or devices="):
        PT.simulate_batch_torch(lay.work_c, lay.plats_c, lay.strats_c, lay.traces,
                                cell_index=lay.cidx, device="cpu", devices=THREE)
    with pytest.raises(ValueError, match="expected 'all'"):
        PT.resolve_devices("some")
    with pytest.raises(ValueError, match="at least one"):
        PT.resolve_devices([])
    if not n_cuda:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PT.resolve_devices("all")
    assert PT.resolve_devices(None, "cpu") == [torch.device("cpu")]
    assert PT.resolve_devices(("cpu", torch.device("cpu"))) == [torch.device("cpu")] * 2
