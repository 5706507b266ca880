"""The port's analytic layer and period optimizer against the reference.

Held to ``repro.core.analytic`` (the NumPy table models), its jnp twins
in ``repro.kernels.analytic`` and their ``jax.grad`` derivatives, the
reference's batched Newton solve and its unified ``optimize`` entry
point.  Tolerances: the models rtol 1e-12 (the reference's own twin
tolerance), W' / W'' rtol 1e-10 against ``jax.grad`` and rtol 1e-6
against finite differences, the Newton table ``T_R`` rtol 1e-9 and waste
abs 1e-12, the closed-form case analyses rel 1e-15.  Every call into
``repro`` runs inside ``jax.enable_x64(True)``.
"""

from dataclasses import asdict, replace

import jax
import numpy as np
import pytest
import torch

from repro.core import Platform as RPlatform
from repro.core import PredictorModel as RPredictor
from repro.core import analytic as RA
from repro.core import optimize as r_optimize
from repro.experiments import paper_grid_cells as ref_cells
from repro.experiments import paper_policy_table as ref_policy_table
from repro.kernels import analytic as RK
from repro_torch.core import OptimalPolicy, PolicyTable, optimize, optimize_cells
from repro_torch.core import analytic as A
from repro_torch.core import simulator as S
from repro_torch.core.waste import Platform, PredictorModel
from repro_torch.experiments import paper_grid_cells, paper_policy_table
from repro_torch.kernels import analytic as K


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _tt(x, dt=torch.float64):
    return torch.as_tensor(np.asarray(x)).to(dt)


def _cols(tabs):
    """``cell_waste``'s column arguments of a NumPy table: NumPy for the
    reference, tensors for the port."""
    with np.errstate(invalid="ignore"):
        p = RA.precision_from_fp(tabs["mtbf"], tabs["fp_mean"], tabs["recall"])
    np_cols = (
        tabs["mode"].astype(np.int32), tabs["q_eff"], tabs["C"], tabs["DR"],
        tabs["lead_act"], tabs["mtbf"], tabs["recall"], p, tabs["window"],
        tabs["T_P"], tabs["tp_eff_default"], tabs["C2"], tabs["DR2"], tabs["V"],
        tabs["fmem"], tabs["rho"], tabs["kv"],
    )
    t_cols = [_tt(c, torch.int32 if i == 0 else torch.float64)
              for i, c in enumerate(np_cols)]
    t_cols[7] = K.precision_from_fp(_tt(tabs["mtbf"]), _tt(tabs["fp_mean"]),
                                    _tt(tabs["recall"]))
    return np_cols, t_cols


def _port_derivs(T, t_cols):
    g, h = K.waste_derivatives(_tt(T), t_cols)
    return g.numpy(), h.numpy()


def _ref_derivs(T, np_cols):
    grad = jax.vmap(jax.grad(RK.cell_waste), in_axes=(0,) * 18)
    hess = jax.vmap(jax.grad(jax.grad(RK.cell_waste)), in_axes=(0,) * 18)
    return np.asarray(grad(T, *np_cols)), np.asarray(hess(T, *np_cols))


@pytest.fixture(scope="module")
def vgrid():
    with jax.enable_x64(True):
        return paper_grid_cells("validation"), ref_cells("validation")


@pytest.fixture(scope="module")
def bench():
    """The bench grid's table and both Newton solves (port on the CPU)."""
    with jax.enable_x64(True):
        cells = paper_grid_cells("bench")
        tabs = A.tables_from_cells(cells)
        ref = RA.newton_optimize_tables(RA.tables_from_cells(ref_cells("bench")))
        return cells, tabs, A.newton_optimize_tables(tabs, device="cpu"), ref


def _random_table(mode: int, n: int = 64, seed: int = 0):
    """Seeded random columns of one strategy mode (recall 0, q 0 and
    windowless rows among them)."""
    rng = np.random.default_rng(seed + 31 * mode)
    C = rng.uniform(30.0, 900.0, n)
    r = np.where(rng.random(n) < 0.15, 0.0, rng.uniform(0.05, 0.95, n))
    window = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(100.0, 8000.0, n))
    mu = rng.uniform(2e3, 2e5, n)
    p = rng.uniform(0.1, 0.99, n)
    fp = np.where(r > 0.0, p * mu / np.maximum(r * (1.0 - p), 1e-300), np.inf)
    return {
        "mode": np.full(n, mode, np.int32),
        "q_eff": np.where(rng.random(n) < 0.2, 0.0, rng.choice([0.5, 1.0], n)),
        "C": C, "DR": rng.uniform(30.0, 900.0, n),
        "lead_act": np.where(mode == 4, rng.uniform(30.0, 600.0, n), C),
        "mtbf": mu, "recall": r, "fp_mean": fp, "window": window,
        "T_P": np.where(mode == 3, rng.uniform(600.0, 3000.0, n), np.nan),
        "tp_eff_default": np.maximum(C, window),
        "C2": rng.uniform(200.0, 2000.0, n), "DR2": rng.uniform(100.0, 2000.0, n),
        "V": rng.uniform(10.0, 1200.0, n), "fmem": rng.uniform(0.05, 0.95, n),
        "rho": rng.integers(1, 6, n).astype(np.float64),
        "kv": rng.integers(1, 9, n).astype(np.float64),
        "T_R": rng.uniform(1.1, 3.0, n) * np.sqrt(2.0 * mu * C),
    }


# --------------------------------------------------------------------------- #
# The branchless models
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [0.6, 1.0, 1.9])
def test_models_match_reference_on_validation_table(vgrid, scale):
    cells, rcells = vgrid
    tabs = A.tables_from_cells(cells)
    T = tabs["T_R"] * scale
    got = A.table_waste(T, tabs)
    np.testing.assert_allclose(got, RA.table_waste(T, RA.tables_from_cells(rcells)),
                               rtol=1e-12)
    np_cols, _ = _cols(tabs)
    np.testing.assert_allclose(got, np.asarray(RK.cell_waste(T, *np_cols)), rtol=1e-12)
    if scale == 1.0:
        np.testing.assert_array_equal(A.analytic_waste_cells(cells), got)


@pytest.mark.parametrize("mode", range(7))
def test_models_match_reference_on_random_columns(mode):
    tabs = _random_table(mode)
    T = tabs["T_R"]
    got = A.table_waste(T, tabs)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, RA.table_waste(T, tabs), rtol=1e-12)
    np_cols, _ = _cols(tabs)
    np.testing.assert_allclose(got, np.asarray(RK.cell_waste(T, *np_cols)), rtol=1e-12)


_MODEL_ARGS = {
    "precision_from_fp": ("mu", "fp", "r"),
    "young_waste": ("T", "C", "DR", "mu"),
    "exact_waste": ("T", "q", "C", "DR", "mu", "r", "p"),
    "migration_waste": ("T", "q", "C", "DR", "M", "mu", "r", "p"),
    "instant_waste": ("T", "q", "C", "DR", "mu", "r", "p", "E_f"),
    "nockpt_waste": ("T", "q", "C", "DR", "mu", "r", "p", "I", "E_f"),
    "withckpt_waste": ("T", "T_P", "q", "C", "DR", "mu", "r", "p", "I", "E_f"),
    "two_level_waste": ("T", "T_d", "C", "C2", "D", "R", "R2", "mu", "f", "r", "q", "p"),
    "silent_waste": ("T", "C", "V", "DR", "mu", "k"),
}


@pytest.mark.parametrize("name", sorted(_MODEL_ARGS))
def test_each_model_matches_both_reference_sides(name):
    rng = np.random.default_rng(len(name))
    n = 200
    d = {k: rng.uniform(a, b, n) for k, (a, b) in {
        "T": (300.0, 3e4), "T_d": (3e3, 6e4), "C": (30.0, 900.0), "C2": (200.0, 2e3),
        "DR": (30.0, 900.0), "D": (10.0, 120.0), "R": (30.0, 900.0), "R2": (90.0, 2e3),
        "M": (30.0, 600.0), "mu": (2e3, 2e5), "p": (0.1, 0.99), "I": (0.0, 8e3),
        "T_P": (600.0, 3e3), "f": (0.05, 0.95), "V": (10.0, 1200.0), "fp": (1e3, 1e6),
    }.items()}
    d["r"] = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(0.05, 0.95, n))
    d["q"] = rng.choice([0.0, 0.5, 1.0], n)
    d["E_f"] = d["I"] / 2.0
    d["k"] = rng.integers(1, 9, n).astype(np.float64)
    d["fp"] = np.where(rng.random(n) < 0.2, np.inf, d["fp"])
    args = [d[k] for k in _MODEL_ARGS[name]]
    got = getattr(K, name)(*(_tt(a) for a in args)).numpy()
    np.testing.assert_allclose(got, getattr(RA, name)(*args), rtol=1e-12)
    np.testing.assert_allclose(got, np.asarray(getattr(RK, name)(*args)), rtol=1e-12)


# --------------------------------------------------------------------------- #
# Derivatives
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("scale", [0.8, 1.6])
def test_derivatives_match_jax_grad(vgrid, scale):
    tabs = A.tables_from_cells(vgrid[0])
    T = tabs["T_R"] * scale
    kink = ((tabs["mode"] == 1) & (tabs["window"] > 0.0)
            & (np.abs(T - tabs["window"]) < 0.02 * np.maximum(T, tabs["window"])))
    np_cols, t_cols = _cols(tabs)
    g, h = _port_derivs(T, t_cols)
    rg, rh = _ref_derivs(T, np_cols)
    np.testing.assert_allclose(g[~kink], rg[~kink], rtol=1e-10)
    np.testing.assert_allclose(h[~kink], rh[~kink], rtol=1e-10)


@pytest.mark.parametrize("mode", range(7))
def test_derivatives_match_jax_grad_on_random_columns(mode):
    tabs = _random_table(mode, seed=5)
    T = tabs["T_R"]
    np_cols, t_cols = _cols(tabs)
    g, h = _port_derivs(T, t_cols)
    rg, rh = _ref_derivs(T, np_cols)
    off = np.abs(T - tabs["window"]) > 1e-3 * T
    np.testing.assert_allclose(g[off], rg[off], rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(h[off], rh[off], rtol=1e-10, atol=1e-24)


def test_derivatives_at_the_instant_kink(vgrid):
    """At T = window, min(E_f, T/2) ties: torch.minimum and lax.min both
    split the gradient evenly, so W' there is the reference's."""
    tabs = A.tables_from_cells(vgrid[0])
    inst = (tabs["mode"] == 1) & (tabs["window"] > 0.0) & (tabs["q_eff"] > 0.0)
    assert inst.sum() >= 8
    T = np.where(inst, tabs["window"], tabs["T_R"])
    np_cols, t_cols = _cols(tabs)
    g, h = _port_derivs(T, t_cols)
    rg, rh = _ref_derivs(T, np_cols)
    # atol: the other cells sit at their optimum T_R, where W' is a
    # cancellation residue of order 1e-22
    np.testing.assert_allclose(g, rg, rtol=1e-10, atol=1e-18)
    np.testing.assert_allclose(h, rh, rtol=1e-10, atol=1e-24)
    np.testing.assert_allclose(g[inst], rg[inst], rtol=1e-10)
    # the tie gives the mean of the two one-sided slopes
    eps = 1e-7 * T
    gl, _ = _port_derivs(T - eps, t_cols)
    gr, _ = _port_derivs(T + eps, t_cols)
    np.testing.assert_allclose(g[inst], 0.5 * (gl + gr)[inst], rtol=1e-6)


@pytest.mark.parametrize("seed", range(8))
def test_derivatives_match_finite_differences(vgrid, seed):
    tabs = A.tables_from_cells(vgrid[0])
    rng = np.random.default_rng(seed)
    T = tabs["T_R"] * rng.uniform(0.5, 2.5, tabs["T_R"].shape)
    kink = ((tabs["window"] > 0.0)
            & (np.abs(T - tabs["window"]) < 0.02 * np.maximum(T, tabs["window"])))
    hstep = 1e-5 * T
    want = (A.table_waste(T + hstep, tabs) - A.table_waste(T - hstep, tabs)) / (2 * hstep)
    g, _ = _port_derivs(T, _cols(tabs)[1])
    np.testing.assert_allclose(g[~kink], want[~kink], rtol=1e-6, atol=1e-10)


def test_derivatives_finite_on_every_row_padding_included(vgrid):
    args, n = A.newton_inputs(A.tables_from_cells(vgrid[0]), device="cpu")
    assert args[0].shape[0] == 64 and n == 54
    cols, lo, hi = args[:17], args[17], args[18]
    for T in (lo, 0.5 * (lo + hi), hi, cols[9].nan_to_num(1.0).clamp(min=1.0)):
        g, h = K.waste_derivatives(T, cols)
        assert torch.isfinite(g).all() and torch.isfinite(h).all()


# --------------------------------------------------------------------------- #
# The batched Newton solve
# --------------------------------------------------------------------------- #
def test_newton_matches_reference_on_bench_grid(bench):
    _, _, got, want = bench
    assert set(got) == set(want)
    for k in ("T_R", "T0", "T1"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, err_msg=k)
    for k in ("waste", "waste0", "waste1"):
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(got["q"], want["q"])


def test_newton_dominates_host_period_scan(bench):
    cells, _, sol, _ = bench
    scan = [replace(c, strategy=replace(c.strategy, T_R=max(c.platform.C * 1.01,
                                                            c.strategy.T_R * m)))
            for c in cells for m in S.PERIOD_GRID]
    best = np.minimum(A.analytic_waste_cells(scan), 1.0).reshape(len(cells), -1).min(1)
    excess = sol["waste"] - best
    assert excess.max() <= 1e-12, [cells[i].label for i in np.flatnonzero(excess > 1e-12)]


def test_newton_lands_on_the_closed_form_extremizer(bench):
    cells, tabs, sol, _ = bench
    te = A.analytic_period_cells(cells)
    smooth = ((tabs["q_eff"] > 0.0) & (tabs["recall"] > 0.0) & (sol["q"] == tabs["q_eff"])
              & ~((tabs["mode"] == 1) & (tabs["window"] > 0.0)))
    assert smooth.sum() >= 24
    np.testing.assert_allclose(sol["T_R"][smooth], te[smooth], rtol=1e-9)


def test_padding_rows_do_not_leak(vgrid):
    cells = vgrid[0]
    sol3 = A.newton_optimize_tables(A.tables_from_cells(cells[:3]), device="cpu")
    soln = A.newton_optimize_tables(A.tables_from_cells(cells), device="cpu")
    for k in ("T_R", "q", "waste"):
        assert sol3[k].shape == (3,)
        np.testing.assert_allclose(sol3[k], soln[k][:3], rtol=1e-12)


def test_batched_newton_matches_scalar_calls():
    names = ["exact", "young", "best", "nockpt", "two_level", "silent"]
    table = optimize(names, PLAT, PREDS[:4] + [PREDS[0], PREDS[4]],
                     method="newton", device="cpu")
    assert isinstance(table, PolicyTable) and len(table) == len(names)
    for i, (name, pm) in enumerate(zip(names, PREDS[:4] + [PREDS[0], PREDS[4]])):
        one = optimize(name, PLAT, pm, method="newton", device="cpu")
        assert table.waste[i] == pytest.approx(one.waste, abs=1e-12)
        assert table.T_R[i] == pytest.approx(one.T_R, rel=1e-12)


def test_newton_needs_a_device_without_cuda(monkeypatch, vgrid):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tabs = A.tables_from_cells(vgrid[0][:4])
    for call in (
        lambda: A.newton_optimize_tables(tabs),
        lambda: optimize("exact", PLAT, PREDS[0], method="newton"),
        lambda: optimize_cells(vgrid[0][:4]),
        lambda: paper_policy_table("validation"),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


# --------------------------------------------------------------------------- #
# The unified optimizer
# --------------------------------------------------------------------------- #
PLAT_KW = dict(mu=7500.0, C=600.0, D=60.0, R=300.0, M=300.0, C2=1800.0, R2=900.0,
               f=0.8, V=300.0)
PLAT = Platform(**PLAT_KW)
PRED_KW = [dict(recall=0.85, precision=0.82), dict(recall=0.7, precision=0.4),
           dict(recall=0.85, precision=0.82, window=1200.0),
           dict(recall=0.7, precision=0.4, window=6000.0),
           dict(recall=0.0, precision=1.0)]
PREDS = [PredictorModel(**kw) for kw in PRED_KW]
FAMILIES = ["young", "daly", "exact", "instant", "nockpt", "withckpt", "migration",
            "two_level", "silent", "best"]


def _same_policy(a, b):
    assert a.strategy == b.strategy and a.q == b.q
    assert a.T_R == pytest.approx(b.T_R, rel=1e-15)
    assert a.waste == pytest.approx(b.waste, rel=1e-15)
    assert a.value == pytest.approx(b.value, rel=1e-15)
    assert (a.T_P, a.k_P, a.T_d, a.k_V, a.objective) == (b.T_P, b.k_P, b.T_d, b.k_V,
                                                         b.objective)


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("pk", range(len(PRED_KW)))
@pytest.mark.parametrize("family", FAMILIES)
def test_analytic_optimize_matches_reference(family, pk, capped):
    got = optimize(family, PLAT, PREDS[pk], capped=capped)
    want = r_optimize(family, RPlatform(**PLAT_KW), RPredictor(**PRED_KW[pk]), capped=capped)
    assert isinstance(got, OptimalPolicy)
    _same_policy(got, want)


@pytest.mark.parametrize("pk", [0, 3])
def test_availability_objective_matches_reference(pk):
    got = optimize(FAMILIES, PLAT, PREDS[pk], objective="availability")
    want = r_optimize(FAMILIES, RPlatform(**PLAT_KW), RPredictor(**PRED_KW[pk]),
                      objective="availability")
    assert got.method == want.method == "analytic"
    for a, b in zip(got, want):
        _same_policy(a, b)
    np.testing.assert_array_equal(got.k_P, want.k_P)
    np.testing.assert_allclose(got.value, 1.0 - got.waste)


@pytest.mark.parametrize("family", FAMILIES)
def test_newton_optimize_matches_reference(family):
    for pk in (0, 2, 3):
        got = optimize(family, PLAT, PREDS[pk], method="newton", device="cpu")
        want = r_optimize(family, RPlatform(**PLAT_KW), RPredictor(**PRED_KW[pk]),
                          method="newton")
        assert got.strategy == want.strategy and got.q == want.q
        assert got.T_R == pytest.approx(want.T_R, rel=1e-9)
        assert got.waste == pytest.approx(want.waste, abs=1e-12)
        assert got.T_P == want.T_P


@pytest.mark.parametrize("family", FAMILIES)
def test_newton_capped_matches_reference(family):
    """The Section 3.2/4.3 validity caps as the Newton solve's domain."""
    for pk in (0, 2, 3):
        got = optimize(family, PLAT, PREDS[pk], method="newton", capped=True, device="cpu")
        want = r_optimize(family, RPlatform(**PLAT_KW), RPredictor(**PRED_KW[pk]),
                          method="newton", capped=True)
        assert got.strategy == want.strategy and got.q == want.q
        assert got.T_R == pytest.approx(want.T_R, rel=1e-9)
        assert got.waste == pytest.approx(want.waste, abs=1e-12)


def test_optimize_errors():
    with pytest.raises(ValueError, match="unknown strategy 'quantum'"):
        optimize("quantum", PLAT)
    with pytest.raises(ValueError, match="unknown objective 'speed'"):
        optimize("exact", PLAT, PREDS[0], objective="speed")
    with pytest.raises(ValueError, match="unknown method 'sgd'"):
        optimize("exact", PLAT, PREDS[0], method="sgd")
    with pytest.raises(ValueError, match="sequence length"):
        optimize(["exact", "young"], [PLAT], PREDS[0])
    # BestPeriod runs the lane machine: on CUDA or a named device, never a
    # silent fallback; "best" has no simulated search
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            optimize("exact", PLAT, PREDS[0], method="search")
    with pytest.raises(ValueError, match="'best' is not supported"):
        optimize(["best", "young"], PLAT, PREDS[0], method="search", device="cpu")


def test_policy_table_indexing():
    table = optimize(["young", "daly", "exact", "withckpt", "best"], PLAT,
                     [PREDS[0], PREDS[0], PREDS[0], PREDS[2], PREDS[3]])
    assert len(table) == 5
    pols = list(table)
    assert all(isinstance(p, OptimalPolicy) for p in pols)
    assert [p.strategy for p in pols][:3] == ["young", "daly", "exact"]
    assert pols[3].T_P is not None and pols[3].k_P >= 1
    assert pols[0].T_P is None and pols[0].k_P is None
    assert pols[2].q == 1 and pols[2].value == pols[2].waste
    newt = optimize(["young", "withckpt"], PLAT, [PREDS[0], PREDS[2]], method="newton",
                    device="cpu")
    assert newt.tables is not None and newt.k_P is None
    assert newt[0].T_P is None and newt[1].T_P == table[3].T_P


def test_optimize_cells_matches_reference(vgrid):
    cells, rcells = vgrid
    got = optimize_cells(cells, device="cpu")
    want = RA.optimize_cells(rcells)
    assert got.strategy == want.strategy and len(got) == len(cells)
    np.testing.assert_allclose(got.T_R, want.T_R, rtol=1e-9)
    np.testing.assert_allclose(got.waste, want.waste, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(got.q, want.q)
    np.testing.assert_array_equal(got.T_P, want.T_P)
    assert np.all(got.waste <= np.minimum(A.analytic_waste_cells(cells), 1.0) + 1e-12)
    av = optimize_cells(cells, objective="availability", device="cpu")
    np.testing.assert_array_equal(av.value, 1.0 - got.waste)


def test_paper_policy_table_matches_reference():
    got = paper_policy_table("bench", device="cpu")
    want = ref_policy_table("bench")
    assert isinstance(got, PolicyTable) and len(got) == len(want) == 72
    np.testing.assert_allclose(got.T_R, want.T_R, rtol=1e-9)
    np.testing.assert_allclose(got.waste, want.waste, rtol=0, atol=1e-12)
    for a, b in zip(got, want):
        assert asdict(a).keys() == asdict(b).keys()
        assert (a.strategy, a.q, a.T_P) == (b.strategy, b.q, b.T_P)
