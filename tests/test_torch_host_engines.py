"""The port's host engines against the reference's.

``repro_torch.core.batch_sim.simulate_batch`` (the NumPy lane engine) and
``repro_torch.core.simulator.simulate`` (the scalar event loop) run the
same :class:`BatchTraces` as the reference's ``repro.core.batch_sim.
simulate_batch`` and ``repro.core.simulator.simulate``: every strategy
mode (Young, exact dates, Instant, NoCkptI, WithCkptI, migration,
two-level with a memory tier, silent errors), trust q of 0, 1 and 0.5,
single renewal and superposed (Weibull 0.5, 64 components) traces.  Both
sides are NumPy, so makespans and counters are bit-equal.

``simulate_many`` on ``batch`` / ``scalar`` / ``torch`` (on the CPU)
against the reference's ``batch`` / ``scalar`` / ``jax``: integer
columns exact, makespans rtol 1e-9 (the lane machines fuse fast-forwarded
periods into one multiply), in both trace modes for the lane machines.
And ``run_grid`` on the host engines (``batch`` and ``scalar``, fused
and per cell, host and device traces; ``legacy``) against the
reference's runner, lane for lane.  Every call into ``repro`` sits
inside ``jax.enable_x64(True)``.
"""

from dataclasses import asdict, fields, replace

import jax
import numpy as np
import pytest

from repro.core import batch_sim as RB
from repro.core import events as RE
from repro.core import simulator as RS
from repro.core.engine import EngineConfig as REngineConfig
from repro.experiments import GridSpec as RGridSpec
from repro.experiments import run_grid as ref_run_grid
from repro.experiments.paper_grid import paper_grid_cells as ref_paper
from repro.experiments.paper_grid import silent_grid_cells as ref_silent
from repro.experiments.paper_grid import two_level_grid_cells as ref_two_level
from repro_torch.configs.paper import C, D, MU_IND, R
from repro_torch.core import EngineConfig, simulate, simulate_batch, simulate_many
from repro_torch.core import batch_sim as PB
from repro_torch.core import events as PE
from repro_torch.core import simulator as PS
from repro_torch.core.waste import Platform, PredictorModel
from repro_torch.experiments import (
    GridSpec,
    paper_grid_cells,
    run_grid,
    silent_grid_cells,
    two_level_grid_cells,
)

WORK = 2 * 86400.0
N = 2**17
L = 24
SCALAR_LANES = 8
RESULT_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
               "n_disk_recoveries", "n_detections")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _plat(**kw):
    return Platform(mu=MU_IND / N, C=C, D=D, R=R, **kw)


PRED = PredictorModel(0.85, 0.82, window=3000.0, lead=3600.0)


def _strategies():
    """(label, platform, strategy): every mode, q 0 / 1 / 0.5."""
    base = _plat(M=0.5 * C)
    tl_plat = _plat(C2=3 * C, R2=3 * R, f=0.6)
    sil_plat = _plat(V=0.5 * C)
    out = [
        ("young", base, PS.young(base)),
        ("daly", base, PS.daly(base)),
        ("exact", base, PS.exact_prediction(base, PRED)),
        ("exact_q0", base, replace(PS.exact_prediction(base, PRED), q=0.0)),
        ("instant", base, PS.instant(base, PRED)),
        ("nockpt", base, PS.nockpt(base, PRED)),
        ("withckpt", base, PS.withckpt(base, PRED)),
        ("migration", base, PS.migration(base, PRED)),
        ("nockpt_q05", base, replace(PS.nockpt(base, PRED), q=0.5)),
        ("two_level", tl_plat, PS.two_level(tl_plat, PRED)),
        ("silent", sil_plat, PS.silent(sil_plat)),
    ]
    assert {s.mode for _, _, s in out} == set(PB.MODE_CODES)
    return out


def _traces(superposed: bool):
    """One reference batch (tier coins drawn) and the port's copy of it."""
    rng = np.random.default_rng(11 if superposed else 12)
    kw = dict(fault_dist=RE.weibull(0.5), n_components=64) if superposed else {}
    ref = RE.make_event_traces_batch(
        rng, L, horizon=12 * WORK, mtbf=MU_IND / N, recall=PRED.recall,
        precision=PRED.precision, window=PRED.window, lead=PRED.lead, tier=True, **kw)
    port = PE.BatchTraces(**{f.name: getattr(ref, f.name) for f in fields(PE.BatchTraces)})
    return ref, port


def _ref_strategy(s):
    return RS.Strategy(**asdict(s))


def _ref_platform(p):
    from repro.core.waste import Platform as RPlatform

    return RPlatform(**asdict(p))


@pytest.mark.parametrize("superposed", [False, True], ids=["renewal", "superposed"])
@pytest.mark.parametrize("label", [k for k, _, _ in _strategies()])
def test_simulate_batch_and_scalar_match_reference(label, superposed):
    _, plat, strat = next(x for x in _strategies() if x[0] == label)
    ref_tr, port_tr = _traces(superposed)
    rp, rs = _ref_platform(plat), _ref_strategy(strat)
    want = RB.simulate_batch(WORK, rp, rs, ref_tr, rng=np.random.default_rng(3))
    got = simulate_batch(WORK, plat, strat, port_tr, rng=np.random.default_rng(3))
    assert isinstance(got, PB.BatchResult)
    for f in fields(RB.BatchResult):
        np.testing.assert_array_equal(getattr(got, f.name), getattr(want, f.name),
                                      err_msg=f"{label} {f.name}")
    # the scalar engines on the same lanes, with the same trust coins
    for i in range(SCALAR_LANES):
        w = RS.simulate(WORK, rp, rs, ref_tr.lane(i), np.random.default_rng(100 + i))
        g = simulate(WORK, plat, strat, port_tr.lane(i), np.random.default_rng(100 + i))
        assert asdict(g) == asdict(w), (label, i)
        if strat.q in (0.0, 1.0):
            # deterministic trust: the scalar engine is the lane engine
            assert g.makespan == pytest.approx(got.makespan[i], rel=1e-12, abs=0)
            assert g.n_faults == got.n_faults[i]
    if label in ("two_level", "silent"):
        key = "n_disk_recoveries" if label == "two_level" else "n_detections"
        assert getattr(got, key).sum() > 0
    if label == "migration":
        assert got.n_migrations.sum() > 0


def test_two_level_needs_tier_draws():
    ref_tr, port_tr = _traces(False)
    port_tr = replace(port_tr, fault_tier=None)
    plat = _plat(C2=3 * C, R2=3 * R, f=0.6)
    with pytest.raises(ValueError, match="tier draws"):
        simulate_batch(WORK, plat, PS.two_level(plat, PRED), port_tr)


def test_batch_result_views():
    _, port_tr = _traces(False)
    plat = _plat()
    res = simulate_batch(WORK, plat, PS.exact_prediction(plat, PRED), port_tr)
    assert res.n_lanes == L
    lanes = res.to_results()
    assert [r.makespan for r in lanes] == list(res.makespan)
    np.testing.assert_array_equal(res.waste, [r.waste for r in lanes])


def _many(side, engine, strat_label, trace_mode="host", n_runs=6):
    _, plat, strat = next(x for x in _strategies() if x[0] == strat_label)
    kw = dict(n_runs=n_runs, seed=4, horizon_factor=12.0)
    if side == "ref":
        return RS.simulate_many(WORK, _ref_platform(plat), _ref_strategy(strat),
                                _ref_pred(), config=REngineConfig(
                                    engine=engine, trace_mode=trace_mode), **kw)
    return simulate_many(WORK, plat, strat, PRED,
                         config=EngineConfig(engine=engine, trace_mode=trace_mode),
                         device="cpu" if engine == "torch" else None, **kw)


def _ref_pred():
    from repro.core.waste import PredictorModel as RPred

    return RPred(**asdict(PRED))


def _close(got, want, what):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in RESULT_INTS + ("trace_exhausted",):
            assert getattr(g, k) == getattr(w, k), (what, k)
        assert g.makespan == pytest.approx(w.makespan, rel=1e-9, abs=0), what


@pytest.mark.parametrize("label", ["exact", "migration", "silent"])
def test_simulate_many_host_engines_match_reference(label):
    for engine in ("batch", "scalar"):
        _close(_many("port", engine, label), _many("ref", engine, label),
               f"{label} {engine}")


def test_simulate_many_two_level_without_tier_coins():
    """simulate_many draws no tier coins.  On a memory-tier platform (f >
    0) both packages refuse the two-level strategy.  On f = 0 (every
    failure to disk) the reference's NumPy engine indexes its one-column
    stand-in for the missing coins past its end (IndexError) at the
    second fault; the port's copy does the same, and its lane machine runs
    the lanes as the reference's JAX engine does."""
    plat = _plat(C2=3 * C, R2=3 * R, f=0.6)
    strat = PS.two_level(plat, PRED)
    with pytest.raises(ValueError, match="tier draws"):
        RS.simulate_many(WORK, _ref_platform(plat), _ref_strategy(strat), _ref_pred(),
                         n_runs=4, config=REngineConfig(engine="batch"))
    with pytest.raises(ValueError, match="tier draws"):
        simulate_many(WORK, plat, strat, PRED, n_runs=4,
                      config=EngineConfig(engine="batch"))
    plat0 = _plat(C2=3 * C, R2=3 * R)
    strat0 = PS.two_level(plat0, PRED)
    ref_args = (WORK, _ref_platform(plat0), _ref_strategy(strat0), _ref_pred())
    with pytest.raises(IndexError):
        RS.simulate_many(*ref_args, n_runs=6, seed=4, config=REngineConfig(engine="batch"))
    with pytest.raises(IndexError):
        simulate_many(WORK, plat0, strat0, PRED, n_runs=6, seed=4,
                      config=EngineConfig(engine="batch"))
    got = simulate_many(WORK, plat0, strat0, PRED, n_runs=6, seed=4,
                        config=EngineConfig(engine="torch"), device="cpu")
    want = RS.simulate_many(*ref_args, n_runs=6, seed=4, config=REngineConfig(engine="jax"))
    _close(got, want, "torch")
    assert sum(r.n_disk_recoveries for r in got) == sum(r.n_faults for r in got) > 0
    # the scalar engine reads the 1.0 tier default of each fault: disk
    scal = simulate_many(WORK, plat0, strat0, PRED, n_runs=6, seed=4,
                         config=EngineConfig(engine="scalar"))
    _close(scal, got, "scalar")


@pytest.mark.parametrize("trace_mode", ["host", "device"])
@pytest.mark.parametrize("label", ["exact", "migration", "silent"])
def test_simulate_many_torch_matches_reference_jax(label, trace_mode):
    got = _many("port", "torch", label, trace_mode)
    _close(got, _many("ref", "jax", label, trace_mode), f"{label} {trace_mode}")
    # and the port's own oracle on the same traces
    _close(got, _many("port", "batch", label, trace_mode), f"{label} batch")


def test_simulate_many_errors():
    plat = _plat()
    s = PS.young(plat)
    with pytest.raises(ValueError, match="collect='stats'"):
        simulate_many(WORK, plat, s, PRED, n_runs=2,
                      config=EngineConfig(engine="torch", collect="stats"), device="cpu")
    with pytest.raises(ValueError, match="n_components"):
        simulate_many(WORK, plat, s, PRED, n_runs=2, n_components=4,
                      config=EngineConfig(engine="batch", trace_mode="device"))
    with pytest.raises(ValueError, match="device="):
        simulate_many(WORK, plat, s, PRED, n_runs=2, config=EngineConfig(engine="batch"),
                      device="cpu")
    with pytest.raises(ValueError, match="devices="):
        simulate_many(WORK, plat, s, PRED, n_runs=2,
                      config=EngineConfig(engine="scalar", devices=["cpu"]))
    with pytest.raises(ValueError, match="unknown engine"):
        simulate_many(WORK, plat, s, PRED, n_runs=2, config=EngineConfig(engine="legacy"))
    with pytest.warns(DeprecationWarning):
        out = simulate_many(WORK, plat, s, PRED, n_runs=2, engine="batch")
    assert len(out) == 2


def _grid_cells(side):
    paper, tl, sil = ((paper_grid_cells, two_level_grid_cells, silent_grid_cells)
                      if side == "port" else (ref_paper, ref_two_level, ref_silent))
    cells = [c for c in paper("validation", n_list=[2**16])
             if c.strategy.mode in ("none", "exact", "withckpt", "migration")][:6]
    cells += tl("validation", n_list=[2**16])[:2] + sil("validation", n_list=[2**16])[:2]
    return tuple(cells)


@pytest.mark.parametrize("engine, trace_mode, dispatch", [
    ("batch", "host", "fused"),
    ("batch", "device", "fused"),
    ("batch", "host", "percell"),
    ("scalar", "host", "fused"),
    ("scalar", "device", "percell"),
    ("legacy", "host", "percell"),
])
def test_run_grid_host_engines_match_reference(engine, trace_mode, dispatch):
    n_runs = 3 if engine in ("scalar", "legacy") else 6
    cells, ref_cells = _grid_cells("port"), _grid_cells("ref")
    want = ref_run_grid(RGridSpec(ref_cells, n_runs=n_runs, seed=13), REngineConfig(
        engine=engine, trace_mode=trace_mode, dispatch=dispatch))
    got = run_grid(GridSpec(cells, n_runs=n_runs, seed=13), EngineConfig(
        engine=engine, trace_mode=trace_mode, dispatch=dispatch))
    assert got.engine == engine and got.collect == "lanes"
    assert got.meta["dispatch"] == dispatch
    assert got.labels() == want.labels()
    for a, b in zip(want.cells, got.cells):
        for k in ("waste", "makespan", "n_faults", "n_proactive_ckpts", "n_regular_ckpts",
                  "n_migrations"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"{a.cell.label} {k}")
        assert b.n_exhausted == a.n_exhausted
