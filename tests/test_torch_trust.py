"""Fractional trust (0 < q < 1) in the lane machine against the JAX
reference.

A trusted prediction is acted on only if its per-event trust coin (the
TP-trust stream for a true positive, the FP-trust stream for a false
prediction) falls below the strategy's ``q``; both engines draw the same
coins, so they agree lane for lane.  The paper's validation cells at two
platform sizes, every strategy but the untrusted baselines set to q = 0.3
or 0.5 (exact-date, window and migration modes), run through the port on
the CPU and through the reference's fused device-trace engine inside
``jax.enable_x64(True)``.  Tolerances: integer per-cell columns exact,
moments rtol 1e-9, per-lane makespans rtol 1e-9 (libm against XLA
transcendentals in the gap transforms).  Chunk sizes: bit-equal lanes,
as ``tests/test_jax_sim.py::test_device_gen_chunk_invariance``.
"""

from dataclasses import replace

import jax
import numpy as np
import pytest

from repro.core import events as RE
from repro.core import jax_sim as RJ
from repro.core import simulator as RS
from repro.core import Platform as RPlatform
from repro.core import PredictorModel as RPredictorModel
from repro.experiments import GridSpec as RGridSpec
from repro.experiments.paper_grid import paper_grid_cells as ref_cells
from repro.experiments.runner import build_fused_layout as ref_layout
from repro_torch.core import events as PE
from repro_torch.core import simulator as PS
from repro_torch.core import torch_sim as PT
from repro_torch.core.waste import Platform, PredictorModel
from repro_torch.experiments import GridSpec, build_fused_layout, paper_grid_cells, run_grid

N_RUNS, SEED = 4, 3
N_LIST = [2**16, 2**19]
QS = (0.3, 0.5)
SUM_INTS = ("n", "n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations",
            "n_exhausted")
SUM_FLOATS = ("makespan_sum", "makespan_sumsq", "waste_sum", "waste_sumsq")
LANE_INTS = ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations")

MN = 60.0
WORK = 20 * 86400.0


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _fractional(cells):
    """Every strategy but the untrusted baselines at q = 0.3 or 0.5."""
    out = []
    for i, c in enumerate(cells):
        if c.strategy.mode != "none":
            c = replace(c, strategy=replace(c.strategy, q=QS[i % 2]))
        out.append(c)
    return tuple(out)


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(side, collect):
        key = (side, collect)
        if key not in cache:
            with jax.enable_x64(True):
                if side == "ref":
                    grid = RGridSpec(_fractional(ref_cells("validation", n_list=N_LIST)),
                                     n_runs=N_RUNS, seed=SEED)
                    lay = ref_layout(grid, "device")
                    cache[key] = RJ.simulate_batch_jax(
                        lay.work_c, lay.plats_c, lay.strats_c, lay.specs[0], collect=collect)
                else:
                    grid = GridSpec(_fractional(paper_grid_cells("validation", n_list=N_LIST)),
                                    n_runs=N_RUNS, seed=SEED)
                    lay = build_fused_layout(grid)
                    cache[key] = PT.simulate_batch_torch(
                        lay.work_c, lay.plats_c, lay.strats_c, lay.concat_spec(),
                        device="cpu", collect=collect)
        return cache[key]

    return get


def test_fractional_grid_covers_every_trusting_mode():
    cells = _fractional(paper_grid_cells("validation", n_list=N_LIST))
    modes = {c.strategy.mode for c in cells if c.strategy.q in QS}
    assert modes == {"exact", "migration", "nockpt", "withckpt"}
    assert {c.predictor.window > 0 for c in cells if c.strategy.q in QS} == {False, True}


def test_fractional_cell_sums_match_reference(runs):
    ref, port = runs("ref", "stats"), runs("port", "stats")
    for k in SUM_INTS:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    for k in SUM_FLOATS:
        np.testing.assert_allclose(getattr(port, k), getattr(ref, k), rtol=1e-9, atol=0,
                                   err_msg=k)
    assert port.n_proactive_ckpts.sum() > 0 and port.n_migrations.sum() > 0


def test_fractional_lanes_match_reference(runs):
    ref, port = runs("ref", "lanes"), runs("port", "lanes")
    for k in LANE_INTS:
        np.testing.assert_array_equal(getattr(port, k), getattr(ref, k), err_msg=k)
    np.testing.assert_allclose(port.makespan, ref.makespan, rtol=1e-9, atol=0)


def test_fractional_trust_thins_the_predictions(runs):
    """Fewer proactive actions than the same grid at full trust."""
    grid = GridSpec(paper_grid_cells("validation", n_list=N_LIST), n_runs=N_RUNS, seed=SEED)
    lay = build_fused_layout(grid)
    full = PT.simulate_batch_torch(lay.work_c, lay.plats_c, lay.strats_c, lay.concat_spec(),
                                   device="cpu")
    frac = runs("port", "stats")
    assert frac.n_proactive_ckpts.sum() < full.n_proactive_ckpts.sum()
    assert frac.n_migrations.sum() < full.n_migrations.sum()


# --------------------------------------------------------------------------- #
# Chunk invariance and a single strategy against the reference
# --------------------------------------------------------------------------- #
def _spec(mod, pred, dist, n, seed):
    kw = dict(cell_index=np.zeros(n, np.int32)) if mod is PE else {}
    return mod.make_trace_spec(n, horizon=12 * WORK, mtbf=1000 * MN, recall=pred.recall,
                               precision=pred.precision, window=pred.window,
                               lead=pred.lead, fault_dist=dist, seed=seed, **kw)


def test_chunk_invariance_with_fractional_trust():
    plat = Platform(mu=1000 * MN, C=10 * MN, D=1 * MN, R=10 * MN, M=5 * MN)
    pred = PredictorModel(recall=0.85, precision=0.82, window=3000.0)
    strat = PS.instant(plat, pred)
    spec = _spec(PE, pred, PE.weibull(0.7), 7, 3)

    def run(s, chunk):
        return PT.simulate_batch_torch(WORK, plat, s, spec, device="cpu", chunk=chunk,
                                       collect="lanes")

    whole = run(strat, None)
    for chunk in (2, 3):
        got = run(strat, chunk)
        np.testing.assert_array_equal(whole.makespan, got.makespan)
        np.testing.assert_array_equal(whole.n_faults, got.n_faults)
    frac = PS.Strategy("Frac", strat.T_R, q=0.5, mode="exact")
    f1, f2 = run(frac, None), run(frac, 2)
    np.testing.assert_array_equal(f1.makespan, f2.makespan)
    np.testing.assert_array_equal(f1.n_proactive_ckpts, f2.n_proactive_ckpts)
    # ... and lane for lane the reference's (per-lane layout) run
    rplat = RPlatform(mu=1000 * MN, C=10 * MN, D=1 * MN, R=10 * MN, M=5 * MN)
    rpred = RPredictorModel(recall=0.85, precision=0.82, window=3000.0)
    rfrac = RS.Strategy("Frac", strat.T_R, q=0.5, mode="exact")
    ref = RJ.simulate_batch_jax(WORK, rplat, rfrac, _spec(RE, rpred, RE.weibull(0.7), 7, 3))
    np.testing.assert_allclose(f1.makespan, ref.makespan, rtol=1e-9, atol=0)
    for k in LANE_INTS:
        np.testing.assert_array_equal(getattr(f1, k), getattr(ref, k), err_msg=k)


def test_run_grid_runs_fractional_cells():
    cells = _fractional(paper_grid_cells("validation", n_list=[2**16]))[:6]
    res = run_grid(GridSpec(cells, n_runs=3, seed=SEED), device="cpu")
    assert res.meta["device"] == "cpu"
    assert all(0.0 < c.mean_waste < 1.0 for c in res.cells)
