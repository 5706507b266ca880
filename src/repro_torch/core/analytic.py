"""The analytic layer over the fused per-cell tables, and the unified
period optimizer.

The port of ``repro.core.analytic``.  The closed-form waste models of
:mod:`repro_torch.core.waste` exist a second time as branchless
functions of per-cell parameter columns in
:mod:`repro_torch.kernels.analytic`, over the exact ``(n_cells,)`` table
layout that :func:`repro_torch.core.torch_sim._cell_tables` builds for
the lane machine (``C``/``DR``/``T_R``/``T_P``/``mode``/``window``/
``lead_act``/``mtbf``/``fp_mean``/``recall``/``q_eff`` and the two-level
and silent columns), so one parameter table drives both the analytic and
the simulated half of the reproduction.  The functions here are host
functions that take and return NumPy; they run those models on CPU f64
tensors, except the Newton solve, which runs on the card.

On top sits the unified optimizer entry point

    optimize(strategy, platform, pred, *,
             objective="waste" | "availability",
             method="analytic" | "newton", ...)

over the per-strategy case analyses of :mod:`repro_torch.core.periods`
(``method="analytic"``) and the batched safeguarded-Newton solver
(``method="newton"``).  Scalar inputs return an
:class:`~repro_torch.core.periods.OptimalPolicy`; sequence inputs return
a :class:`PolicyTable`.  ``method="search"`` (the simulated brute force
over ``best_period_search``) is not ported yet and raises.

The predictor's precision is derived from the table's ``fp_mean`` column
(inverting :func:`repro_torch.core.events.false_prediction_mtbf`),
because the lane machine's table carries ``fp_mean`` and not
``precision``: the analytic layer consumes that table as it is.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import batch_sim as B
from . import events as E
from . import periods as P
from . import waste as W
from ..kernels import analytic as K
from .periods import OptimalPolicy
from .waste import Platform, PredictorModel

__all__ = [
    "TABLE_COLS",
    "table_waste",
    "cell_tables",
    "tables_from_cells",
    "analytic_waste_cells",
    "analytic_period_cells",
    "newton_inputs",
    "newton_optimize_tables",
    "PolicyTable",
    "optimize",
    "optimize_cells",
]

#: table columns the analytic layer consumes (a subset of the lane
#: machine's tables), in the positional order of
#: :func:`~repro_torch.kernels.analytic.cell_waste`'s column arguments
#: after ``T``, with ``recall`` followed by the precision derived from
#: ``fp_mean``
TABLE_COLS = (
    "mode", "q_eff", "C", "DR", "lead_act", "mtbf", "recall",
    "window", "T_P", "tp_eff_default",
    "C2", "DR2", "V", "fmem", "rho", "kv",
)

#: the two-level / silent columns' fills on tables that lack them (the
#: padding rows' fills too)
_EXTRA_DEFAULTS = {"C2": 0.0, "DR2": 0.0, "V": 0.0, "fmem": 0.0,
                   "rho": 1.0, "kv": 1.0}


def _model_args(tables: Dict[str, np.ndarray], device) -> List[torch.Tensor]:
    """:func:`~repro_torch.kernels.analytic.cell_waste`'s column
    arguments (after ``T``) as tensors on ``device``: f64 columns,
    ``mode`` int32, the precision recovered from ``fp_mean``."""
    C = np.asarray(tables["C"], np.float64)

    def col(k):
        if k in tables:
            a = np.asarray(tables[k])
        else:
            a = np.full_like(C, _EXTRA_DEFAULTS[k])
        dt = np.int32 if k == "mode" else np.float64
        return torch.tensor(a.astype(dt), device=device)

    t = {k: col(k) for k in TABLE_COLS}
    p = K.precision_from_fp(t["mtbf"], col("fp_mean"), t["recall"])
    return [
        t["mode"], t["q_eff"], t["C"], t["DR"], t["lead_act"], t["mtbf"],
        t["recall"], p, t["window"], t["T_P"], t["tp_eff_default"],
        t["C2"], t["DR2"], t["V"], t["fmem"], t["rho"], t["kv"],
    ]


def table_waste(T, tables: Dict[str, np.ndarray]) -> np.ndarray:
    """:func:`~repro_torch.kernels.analytic.cell_waste` applied to a
    ``_cell_tables`` column dict on the CPU, with precision recovered
    from the ``fp_mean`` column.  Tables without the two-level / silent
    columns get their benign fills (0/0/0/0/1/1)."""
    cols = _model_args(tables, "cpu")
    Tt = torch.as_tensor(np.asarray(T, np.float64))
    return K.cell_waste(Tt, *cols).numpy()


# --------------------------------------------------------------------------- #
# The shared per-cell parameter table
# --------------------------------------------------------------------------- #
def cell_tables(
    work,
    platforms: Sequence[Platform],
    predictors: Sequence[PredictorModel],
    strategies: Sequence,
    horizon,
    fault_dists=None,
    fp_dists=None,
    n_tab: Optional[int] = None,
    dtype=np.float64,
) -> Dict[str, np.ndarray]:
    """Build the lane machine's per-cell parameter table on the host.

    Delegates to :func:`repro_torch.core.torch_sim._cell_tables`, the one
    packing routine the device sweep uses, so the analytic layer and the
    simulator consume the same columns, the two-level and silent-error
    columns ``C2``, ``DR2 = D + R2``, ``V``, ``fmem``, ``rho`` and ``kv``
    among them.  ``n_tab`` pads with the engine's benign rows (zero extra
    costs, f = 0, degenerate strides); default is no padding."""
    from . import torch_sim as T  # the lane machine imports its kernels

    n = len(strategies)
    n_tab = n_tab if n_tab is not None else n
    Wk, C, D, R, M, T_R, T_P, mode, q = B._lane_params(
        work, list(platforms), list(strategies), n
    )
    mtbf = np.asarray([p.mu for p in platforms], dtype=np.float64)
    recall = np.asarray([p.recall for p in predictors], dtype=np.float64)
    precision = np.asarray([p.precision for p in predictors], dtype=np.float64)
    window = np.asarray([p.window for p in predictors], dtype=np.float64)
    fp_mean = E.false_prediction_mtbf_batch(mtbf, recall, precision)
    # silent-error cells never trust the fail-stop predictor
    q_eff = np.where(
        (mode == B._M_NONE) | (mode == B._M_SILENT),
        0.0, np.clip(q, 0.0, 1.0),
    )
    fault_laws = E.law_table(fault_dists) if fault_dists is not None else None
    fp_laws = E.law_table(fp_dists) if fp_dists is not None else None
    return T._cell_tables(
        n, n_tab, dtype,
        Wk, C, D, R, M, T_R, T_P, mode,
        np.broadcast_to(np.asarray(horizon, np.float64), (n,)), window,
        mtbf, fp_mean, recall, q_eff,
        fault_laws=fault_laws, fp_laws=fp_laws,
        tier=B._tier_params(platforms, strategies),
    )


def tables_from_cells(
    cells: Sequence, n_tab: Optional[int] = None, dtype=np.float64
) -> Dict[str, np.ndarray]:
    """The shared table of a sequence of experiment cells (anything with
    ``work``/``platform``/``predictor``/``strategy``/``horizon_factor``
    and the grid's ``dist`` attributes, i.e.
    :class:`repro_torch.experiments.grid.ExperimentCell`)."""
    dists = [getattr(c, "dist", None) for c in cells]
    have_laws = all(d is not None for d in dists) and len(cells) > 0
    if have_laws:
        try:
            for d in dists:
                E.require_inverse_cdf(d)
        except ValueError:
            have_laws = False
    return cell_tables(
        [c.work for c in cells],
        [c.platform for c in cells],
        [c.predictor for c in cells],
        [c.strategy for c in cells],
        [c.horizon_factor * c.work for c in cells],
        fault_dists=dists if have_laws else None,
        n_tab=n_tab,
        dtype=dtype,
    )


def analytic_waste_cells(cells: Sequence) -> np.ndarray:
    """First-order analytic waste of every cell at its operating period
    (the quantity the paper's simulations corroborate)."""
    tabs = tables_from_cells(cells)
    return table_waste(tabs["T_R"], tabs)


def analytic_period_cells(cells: Sequence) -> np.ndarray:
    """Closed-form uncapped optimal period per cell: ``T_extr^{q_eff}``
    (Section 3.3's unified formula, floored at C), evaluated on the
    shared table columns."""
    tabs = tables_from_cells(cells)
    with np.errstate(divide="ignore"):
        denom = 1.0 - tabs["recall"] * tabs["q_eff"]
        te = np.where(
            denom > 0.0,
            np.sqrt(2.0 * tabs["mtbf"] * tabs["C"] / np.where(denom > 0.0, denom, 1.0)),
            np.inf,
        )
    return np.maximum(te, tabs["C"])


# --------------------------------------------------------------------------- #
# Batched period optimization (safeguarded Newton)
# --------------------------------------------------------------------------- #
def _mu_e_np(mu, r, p):
    """Vectorized :func:`repro_torch.core.events.mu_e` (harmonic event
    rate)."""
    with np.errstate(divide="ignore"):
        inv_p = np.where(r > 0.0, r / (p * mu), 0.0)
        inv_np = np.where(r < 1.0, (1.0 - r) / mu, 0.0)
        inv = inv_p + inv_np
        return np.where(inv > 0.0, 1.0 / np.where(inv > 0.0, inv, 1.0), np.inf)


def _newton_bounds(
    tables: Dict[str, np.ndarray], capped: bool
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell period domains ``(lo, hi0, hi1)`` for the q=0 / q=q_eff
    Newton solves, mirroring the host case analyses: uncapped (the
    paper's Section 5 default) brackets generously past every extremal
    period; ``capped=True`` reproduces ``_t_young`` / ``_t_one``'s
    Section 3.2/4.3 validity caps (``_clamp`` semantics: hi >= lo)."""
    C, mu = tables["C"], tables["mtbf"]
    r, q, I = tables["recall"], tables["q_eff"], tables["window"]
    lo = np.asarray(C, np.float64)
    if capped:
        p = K.precision_from_fp(
            *(torch.as_tensor(np.asarray(x, np.float64))
              for x in (mu, tables["fp_mean"], r))
        ).numpy()
        cap1 = np.where(
            r > 0.0,
            np.maximum(W.ALPHA * _mu_e_np(mu, r, p) - I, C),
            np.maximum(W.ALPHA * mu, C),
        )
        cap0 = np.where(
            (I > 0.0) & (r > 0.0),
            np.maximum(W.ALPHA * _mu_e_np(mu, r, p) - I, C),
            np.maximum(W.ALPHA * mu, C),
        )
        return lo, np.maximum(cap0, lo), np.maximum(cap1, lo)
    te0 = np.sqrt(2.0 * mu * C)
    te1 = np.sqrt(2.0 * mu * C / np.maximum(1.0 - r * q, 0.015625))
    hi = 64.0 * np.maximum(te0, te1) + I + C
    if "fmem" in tables:  # two-level cells: T_m* grows like 1/sqrt(f)
        fm = np.maximum(np.asarray(tables["fmem"], np.float64), 0.015625)
        hi = np.where(
            np.asarray(tables["mode"]) == K._M_TWO_LEVEL, hi / np.sqrt(fm), hi
        )
    return lo, hi, hi


def newton_inputs(
    tables: Dict[str, np.ndarray], capped: bool = False, device=None
) -> Tuple[List[torch.Tensor], int]:
    """:func:`~repro_torch.kernels.analytic.newton_policy`'s positional
    arguments for a table, on ``device`` (CUDA unless the caller names
    another), and the table's row count.  The table is padded to a power
    of two (at least 8 rows) with the engine's benign rows, as the
    reference does; the solve's rows past the count are padding."""
    from .torch_sim import resolve_device

    dev = resolve_device(device)
    n = int(np.asarray(tables["C"]).shape[0])
    n_tab = max(8, 1 << max(int(n) - 1, 0).bit_length())
    if n and n_tab != n:
        padded = dict(tables)
        fills = {"T_P": np.nan, "fp_mean": np.inf, "C": 1.0, "mtbf": 1.0,
                 "T_R": 2.0, "lead_act": 1.0, "tp_eff_default": 1.0,
                 "rho": 1.0, "kv": 1.0}
        # a missing two-level / silent column is filled whole by _model_args
        for k in (k for k in TABLE_COLS + ("T_R", "fp_mean") if k in tables):
            col = np.asarray(tables[k])
            pad = np.full(n_tab - n, fills.get(k, 0.0), col.dtype)
            padded[k] = np.concatenate([col, pad])
        tables = padded
    bounds = _newton_bounds(tables, capped)
    args = _model_args(tables, dev) + [
        torch.tensor(np.asarray(b, np.float64), device=dev) for b in bounds
    ]
    return args, n


def newton_optimize_tables(
    tables: Dict[str, np.ndarray], capped: bool = False, device=None
) -> Dict[str, np.ndarray]:
    """Solve every cell's optimal period in one batched call on
    ``device`` (CUDA unless the caller names another; without CUDA and
    without a device it raises).

    Runs :func:`repro_torch.kernels.analytic.newton_policy` (per-cell
    safeguarded Newton with autograd W' / W'' and bisection fallback on
    a shrinking derivative bracket, split at the Instant kink ``T = I``)
    over the shared table, then the q in {0, q_eff} case analysis, as the
    host ``_optimize_*`` functions do, for the whole grid at once.
    Returns per-cell ``T_R``, ``q``, ``waste`` (min'd with 1), plus both
    branches' raw solutions, as f64 NumPy arrays without the padding
    rows."""
    args, n = newton_inputs(tables, capped, device)
    out = K.newton_policy(*args)
    T, qs, waste, T0, w0, T1, w1 = (a[:n].cpu().numpy() for a in out)
    return {
        "T_R": T, "q": qs, "waste": waste,
        "T0": T0, "waste0": w0, "T1": T1, "waste1": w1,
    }


# --------------------------------------------------------------------------- #
# The unified optimizer API
# --------------------------------------------------------------------------- #
@dataclass(frozen=True, eq=False)
class PolicyTable:
    """Batched :class:`OptimalPolicy`: one optimized operating point per
    cell, plus the shared parameter table that produced it."""

    strategy: Tuple[str, ...]
    q: np.ndarray
    T_R: np.ndarray
    waste: np.ndarray
    value: np.ndarray
    objective: str = "waste"
    method: str = "newton"
    T_P: Optional[np.ndarray] = None
    k_P: Optional[np.ndarray] = None
    tables: Optional[Dict[str, np.ndarray]] = None

    def __len__(self) -> int:
        return len(self.strategy)

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def __getitem__(self, i: int) -> OptimalPolicy:
        tp = None if self.T_P is None or np.isnan(self.T_P[i]) else float(self.T_P[i])
        kp = None
        if self.k_P is not None and self.k_P[i] > 0:
            kp = int(self.k_P[i])
        return OptimalPolicy(
            self.strategy[i], int(round(float(self.q[i]))), float(self.T_R[i]),
            float(self.waste[i]), T_P=tp, k_P=kp,
            objective=self.objective, value=float(self.value[i]),
        )


def _optimize_young(platform, pred, alpha, capped):
    ty = P._t0(platform.mu, platform.C, alpha, capped)
    w0 = W.waste_young(ty, platform.C, platform.D, platform.R, platform.mu)
    return OptimalPolicy("young", 0, ty, min(w0, 1.0))


def _optimize_daly(platform, pred, alpha, capped):
    td = max(P._t_daly(platform.mu, platform.R, platform.C), platform.C)
    if capped:
        td = P._clamp(td, platform.C, max(alpha * platform.mu, platform.C))
    w0 = W.waste_young(td, platform.C, platform.D, platform.R, platform.mu)
    return OptimalPolicy("daly", 0, td, min(w0, 1.0))


#: the host case analysis of each family, all called as
#: ``(platform, pred, alpha, capped)``
_ANALYTIC_DISPATCH = {
    "young": _optimize_young,
    "daly": _optimize_daly,
    "exact": P._optimize_exact,
    "migration": P._optimize_migration,
    "instant": P._optimize_instant,
    "nockpt": P._optimize_nockpt,
    "withckpt": P._optimize_withckpt,
    "two_level": P._optimize_two_level,
    "silent": P._optimize_silent,
    "best": P._best_policy,
}


def _with_objective(policy: OptimalPolicy, objective: str) -> OptimalPolicy:
    value = policy.waste if objective == "waste" else 1.0 - policy.waste
    return replace(policy, objective=objective, value=value)


def _strategy_stub(name: str, platform, pred):
    """Strategy object of a named family at a placeholder period (the
    optimizer solves T_R; T_P comes from the host integer partition,
    matching the simulator factories' degenerate-window fallback)."""
    from . import simulator as S

    factory = {
        "young": lambda: S.young(platform),
        "daly": lambda: S.daly(platform),
        "exact": lambda: S.exact_prediction(platform, pred),
        "instant": lambda: S.instant(platform, pred),
        "nockpt": lambda: S.nockpt(platform, pred),
        "withckpt": lambda: S.withckpt(platform, pred),
        "migration": lambda: S.migration(platform, pred),
        "two_level": lambda: S.two_level(platform, pred),
        "silent": lambda: S.silent(platform),
    }[name]
    return factory()


def _newton_policies(
    names: List[str],
    platforms: List[Platform],
    preds: List[PredictorModel],
    capped: bool,
    device,
    objective: str,
) -> PolicyTable:
    """Batched method="newton": expand "best" items into their candidate
    families (Equation (12) pruning included), solve every candidate in
    one call, then reduce back to one winner per item."""
    cand_names: List[str] = []
    cand_items: List[int] = []
    for i, (name, plat, pred) in enumerate(zip(names, platforms, preds)):
        if name == "best":
            if pred.window <= 0.0:
                fams = ["exact"]
            else:
                fams = ["instant", "nockpt"]
                if not P._nockpt_dominates(
                    plat.C, pred.precision, pred.window, pred.e_f
                ):
                    fams.append("withckpt")
        else:
            fams = [name]
        for f in fams:
            cand_names.append(f)
            cand_items.append(i)
    strategies = [
        _strategy_stub(f, platforms[i], preds[i])
        for f, i in zip(cand_names, cand_items)
    ]
    tabs = cell_tables(
        0.0,
        [platforms[i] for i in cand_items],
        [preds[i] for i in cand_items],
        strategies,
        0.0,
    )
    sol = newton_optimize_tables(tabs, capped=capped, device=device)
    n = len(names)
    best = np.full(n, np.inf)
    idx = np.full(n, -1, np.int64)
    for j, i in enumerate(cand_items):
        if sol["waste"][j] < best[i]:
            best[i] = sol["waste"][j]
            idx[i] = j
    T_P = np.array(
        [s.T_P if s.T_P is not None else np.nan for s in strategies]
    )[idx]
    waste = sol["waste"][idx]
    value = waste if objective == "waste" else 1.0 - waste
    return PolicyTable(
        strategy=tuple(cand_names[j] for j in idx),
        q=sol["q"][idx],
        T_R=sol["T_R"][idx],
        waste=waste,
        value=value,
        objective=objective,
        method="newton",
        T_P=T_P,
        tables=tabs,
    )


def optimize(
    strategy,
    platform,
    pred=None,
    *,
    objective: str = "waste",
    method: str = "analytic",
    capped: bool = False,
    device=None,
) -> Union[OptimalPolicy, "PolicyTable"]:
    """The unified period optimizer.

    strategy    a family name ("young", "daly", "exact", "instant",
                "nockpt", "withckpt", "migration", "two_level",
                "silent") or "best" (the paper's Section 4.3 recipe with
                Equation (12) pruning); a sequence of names batches (with
                ``platform`` / ``pred`` broadcast or zipped) and returns a
                :class:`PolicyTable`.
    objective   "waste" minimizes the closed-form waste; "availability"
                maximizes 1 - waste (same argmin, the reported ``value``
                flips to availability).
    method      "analytic"  the paper's closed-form case analyses (host);
                "newton"    batched safeguarded Newton on the branchless
                            table models, the whole batch in one call on
                            ``device`` (CUDA unless the caller names
                            another);
                "search"    the simulated brute force: not ported yet,
                            raises ``NotImplementedError``.
    capped      restrict periods to the Section 3.2/4.3 validity domain
                ``T <= ALPHA mu_e`` (the paper's own simulations use the
                uncapped default).
    """
    if objective not in ("waste", "availability"):
        raise ValueError(
            f"unknown objective {objective!r} "
            "(expected 'waste' or 'availability')"
        )
    if method not in ("analytic", "newton", "search"):
        raise ValueError(
            f"unknown method {method!r} "
            "(expected 'analytic', 'newton' or 'search')"
        )
    batched = isinstance(strategy, (list, tuple))
    names = list(strategy) if batched else [strategy]
    n = len(names)

    def _bcast(x, kind):
        if isinstance(x, (list, tuple)):
            if len(x) != n:
                raise ValueError(
                    f"{kind} sequence length {len(x)} != {n} strategies"
                )
            return list(x)
        return [x] * n

    platforms = _bcast(platform, "platform")
    preds = [
        p if p is not None else PredictorModel(0.0, 1.0)
        for p in _bcast(pred, "pred")
    ]
    for name in names:
        if name not in _ANALYTIC_DISPATCH:
            raise ValueError(
                f"unknown strategy {name!r} "
                f"(expected one of {sorted(_ANALYTIC_DISPATCH)})"
            )

    if method == "analytic":
        policies = []
        for name, plat, pm in zip(names, platforms, preds):
            pol = _ANALYTIC_DISPATCH[name](plat, pm, W.ALPHA, capped)
            policies.append(_with_objective(pol, objective))
        if not batched:
            return policies[0]
        return PolicyTable(
            strategy=tuple(p.strategy for p in policies),
            q=np.array([p.q for p in policies], np.float64),
            T_R=np.array([p.T_R for p in policies]),
            waste=np.array([p.waste for p in policies]),
            value=np.array([p.value for p in policies]),
            objective=objective,
            method="analytic",
            T_P=np.array(
                [p.T_P if p.T_P is not None else np.nan for p in policies]
            ),
            k_P=np.array(
                [p.k_P if p.k_P is not None else 0 for p in policies],
                np.int64,
            ),
        )

    if method == "search":
        raise NotImplementedError(
            "optimize(method='search') needs best_period_search, which the "
            "port does not have yet (ROADMAP queue 1 item 4, the host "
            "engines); use method='analytic' or 'newton'"
        )

    table = _newton_policies(
        names, platforms, preds, capped, device, objective
    )
    if batched:
        return table
    return table[0]


def optimize_cells(
    cells: Sequence, objective: str = "waste", device=None
) -> PolicyTable:
    """Optimize the periods of a prebuilt experiment-cell sequence (the
    grid consumers' entry point): the cells' own strategies fix the
    family/q/T_P, only the regular period is re-solved, uncapped, by the
    batched Newton solve in one call on ``device`` (CUDA unless the
    caller names another)."""
    tabs = tables_from_cells(cells)
    sol = newton_optimize_tables(tabs, device=device)
    waste = sol["waste"]
    value = waste if objective == "waste" else 1.0 - waste
    return PolicyTable(
        strategy=tuple(c.strategy.name for c in cells),
        q=sol["q"],
        T_R=sol["T_R"],
        waste=waste,
        value=value,
        objective=objective,
        method="newton",
        T_P=tabs["T_P"][: len(cells)].copy(),
        tables=tabs,
    )
