"""BestPeriod, ``optimize(method="search")``, against the reference.

Every family's simulated period search runs on the port's lane machine
(``engine="torch"`` on the CPU: one cell-multiplexed host-trace dispatch
of ``len(grid) * n_runs`` lanes, ``collect="stats"``) and on the port's
NumPy engine, against the reference's NumPy engine on the same seed:
the same argmin ``T_R`` and the waste within rtol 1e-9 (the lane
machine's per-cell sums against a mean of the lanes).

Pinned: the reference rebuilds each candidate from five fields of the
family's strategy (``simulator.py:723, 741``), so a two-level search runs
with the disk stride ``rho`` at 1 and a silent search with the
verification stride ``k_V`` at 1; and its traces carry no tier coins, so
the reference's NumPy engine fails a two-level search with an
``IndexError`` while its JAX engine runs it (every failure to disk).  The
port does the same on each engine.  Every call into ``repro`` sits inside
``jax.enable_x64(True)``.
"""

from dataclasses import asdict, replace

import jax
import numpy as np
import pytest
import torch

from repro.configs.paper import platform as ref_platform
from repro.core import optimize as ref_optimize
from repro.core.waste import PredictorModel as RPred
from repro_torch.configs.paper import platform
from repro_torch.core import EngineConfig, best_period_search, optimize
from repro_torch.core import simulator as PS
from repro_torch.core import torch_sim as PT
from repro_torch.core.analytic import _strategy_stub
from repro_torch.core.waste import PredictorModel

N = 2**16
N_RUNS = 6
PRED = PredictorModel(0.85, 0.82, window=300.0)
FAMILIES = ("young", "daly", "exact", "instant", "nockpt", "withckpt", "migration",
            "silent")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _ref(name, engine="batch", **kw):
    return ref_optimize(name, ref_platform(N), RPred(**asdict(PRED)), method="search",
                        n_runs=N_RUNS, seed=0, engine=engine, **kw)


def _port(name, engine, **kw):
    dev = {"device": "cpu"} if engine == "torch" else {}
    return optimize(name, platform(N), PRED, method="search", n_runs=N_RUNS, seed=0,
                    engine=engine, **dev, **kw)


@pytest.fixture(scope="module")
def ref_table():
    with jax.enable_x64(True):
        return ref_optimize(list(FAMILIES), ref_platform(N), RPred(**asdict(PRED)),
                            method="search", n_runs=N_RUNS, seed=0)


@pytest.mark.parametrize("engine", ["torch", "batch"])
def test_every_family_matches_reference(engine, ref_table):
    got = optimize(list(FAMILIES), platform(N), PRED, method="search", n_runs=N_RUNS,
                   seed=0, engine=engine, device="cpu" if engine == "torch" else None)
    assert got.method == "search" and got.strategy == ref_table.strategy
    np.testing.assert_array_equal(got.T_R, ref_table.T_R)
    np.testing.assert_array_equal(got.q, ref_table.q)
    np.testing.assert_allclose(got.waste, ref_table.waste, rtol=1e-9, atol=0)
    np.testing.assert_array_equal(np.isnan(got.T_P), np.isnan(ref_table.T_P))
    if engine == "batch":  # both NumPy: the same bits
        np.testing.assert_array_equal(got.waste, ref_table.waste)


def test_single_item_and_objective():
    got = _port("exact", "torch", objective="availability")
    want = _ref("exact", objective="availability")
    assert got.strategy == want.strategy == "exact" and got.T_R == want.T_R
    assert got.value == pytest.approx(want.value, rel=1e-9)
    assert got.value == pytest.approx(1.0 - got.waste, rel=1e-15)


def test_custom_grid_and_fault_law():
    from repro.core.events import weibull as ref_weibull
    from repro_torch.core.events import weibull

    grid = (0.5, 1.0, 2.0)
    got = _port("migration", "torch", grid=grid, fault_dist=weibull(0.7), work=3 * 86400.0)
    want = _ref("migration", grid=grid, fault_dist=ref_weibull(0.7), work=3 * 86400.0)
    assert got.T_R == want.T_R
    assert got.waste == pytest.approx(want.waste, rel=1e-9)


def test_two_level_search_is_the_references():
    """The reference's NumPy engine fails a two-level search (no tier
    coins in its traces: ``IndexError``), and so does the port's copy;
    the lane machine runs it as the reference's JAX engine does."""
    with pytest.raises(IndexError):
        _ref("two_level")
    with pytest.raises(IndexError):
        _port("two_level", "batch")
    got, want = _port("two_level", "torch"), _ref("two_level", engine="jax")
    assert got.T_R == want.T_R and got.q == want.q == 1
    assert got.waste == pytest.approx(want.waste, rel=1e-9)


@pytest.mark.parametrize("name, stride", [("two_level", "rho"), ("silent", "k_V")])
def test_search_runs_with_the_stride_at_one(name, stride):
    """The candidates are rebuilt without ``rho`` / ``k_V``.  The family
    constructors give a stride of 1 wherever a search runs (a two-level
    stride above 1 needs f > 0, which needs tier coins), so the drop is
    pinned on a base given a stride of 3: the reference's search returns
    what it returns for the stride-1 base, and so does the port's; the
    search's waste is the stride-1 strategy's on the same traces, not
    the stride-3 one's."""
    from repro.core import simulator as RS

    work = 8 * 86400.0
    plat = replace(platform(N), C2=3 * platform(N).C) if name == "two_level" else replace(
        platform(N), V=2 * platform(N).C)
    base3 = replace(_strategy_stub(name, plat, PRED), **{stride: 3})
    rplat = ref_platform(N).__class__(**asdict(plat))
    rbase = RS.Strategy(**asdict(base3))
    ref_engine = "jax" if name == "two_level" else "batch"  # see above

    def ref(b):
        return RS._best_period_search(work, rplat, b, RPred(**asdict(PRED)), n_runs=N_RUNS,
                                      seed=0, config=RS.EngineConfig(engine=ref_engine))

    want = ref(rbase)
    assert want == ref(replace(rbase, **{stride: None}))
    rec = {}
    t_r, w = PS._best_period_search(work, plat, base3, PRED, n_runs=N_RUNS, seed=0,
                                    config=EngineConfig(), device="cpu", info=rec)
    assert t_r == want[0] and w == pytest.approx(want[1], rel=1e-9)
    assert rec["outer_iters"] > 0 and rec["n_chunks"] == 1
    rng = np.random.default_rng(0)
    traces = PS._traces_for(work, plat, base3, PRED, N_RUNS, rng, None, None, 12.0,
                            None, False)

    def lanes_waste(strat):
        return float(PT.simulate_batch_torch(work, plat, strat, traces, rng=rng,
                                             device="cpu", collect="lanes").waste.mean())

    assert w == pytest.approx(lanes_waste(replace(base3, T_R=t_r, **{stride: None})),
                              rel=1e-12)
    assert lanes_waste(replace(base3, T_R=t_r)) != pytest.approx(w, rel=1e-6)
    if name == "silent":  # the NumPy engines agree on the same lanes
        t_b, w_b = PS._best_period_search(work, plat, base3, PRED, n_runs=N_RUNS, seed=0,
                                          config=EngineConfig(engine="batch"))
        assert (t_b, w_b) == want


def test_search_is_one_cell_multiplexed_dispatch(monkeypatch):
    calls = []
    real = PT.simulate_batch_torch

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(PT, "simulate_batch_torch", spy)
    info = []
    optimize(["exact", "young"], platform(N), PRED, method="search", n_runs=N_RUNS,
             seed=0, device="cpu", info=info)
    assert len(calls) == 2 and len(info) == 2
    for args, kw in calls:
        n_periods = len(PS.PERIOD_GRID)
        np.testing.assert_array_equal(
            kw["cell_index"], np.repeat(np.arange(n_periods, dtype=np.int32), N_RUNS))
        assert kw["collect"] == "stats" and len(args[2]) == n_periods
        assert args[3].n_lanes == n_periods * N_RUNS
    assert all(r["trace_mode"] == "host" and r["outer_iters"] > 0 for r in info)


def test_search_errors_and_deprecated_spelling():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            optimize("exact", platform(N), PRED, method="search", n_runs=2)
    with pytest.raises(ValueError, match="'best' is not supported"):
        optimize("best", platform(N), PRED, method="search", device="cpu")
    with pytest.raises(ValueError, match="not both"):
        optimize("exact", platform(N), PRED, method="search",
                 config=EngineConfig(engine="batch"), engine="batch")
    with pytest.raises(ValueError, match="unknown engine"):
        optimize("exact", platform(N), PRED, method="search", engine="scalar")
    with pytest.raises(ValueError, match="host traces only"):
        optimize("exact", platform(N), PRED, method="search",
                 config=EngineConfig(engine="batch", trace_mode="device"))
    with pytest.raises(ValueError, match="device="):
        optimize("exact", platform(N), PRED, method="search", engine="batch", device="cpu")
    base = _strategy_stub("exact", platform(N), PRED)
    with pytest.warns(DeprecationWarning, match="optimize"):
        t, w = best_period_search(8 * 86400.0, platform(N), base, PRED, n_runs=N_RUNS,
                                  config=EngineConfig(engine="batch"))
    want = _ref("exact")
    assert t == want.T_R and w == want.waste
