"""Strategy descriptions of the paper's Section 5 simulations.

The port's copy of the strategy constructors of ``repro.core.simulator``
and of BestPeriod's period-multiplier grid.  The scalar event-loop oracle
stays in the reference package; the port's engine is
:mod:`repro_torch.core.torch_sim`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from . import periods as P
from .waste import Platform, PredictorModel

#: absolute time tolerance (seconds) — periods are O(10^3) s, so 1 us is
#: far below any modelled quantity yet far above float64 residuals.
_EPS = 1e-6

__all__ = [
    "Strategy",
    "young",
    "daly",
    "exact_prediction",
    "instant",
    "nockpt",
    "withckpt",
    "migration",
    "two_level",
    "silent",
    "PERIOD_GRID",
]

#: BestPeriod's default period-multiplier grid (Section 5)
PERIOD_GRID = (0.25, 0.4, 0.6, 0.8, 1.0, 1.25, 1.6, 2.0, 3.0, 4.0)


@dataclass(frozen=True)
class Strategy:
    """An operating point of the scheduling algorithm.

    mode:
      "none"      ignore all predictions (Young / Daly baselines)
      "exact"     Section 3 — proactive checkpoint right before the predicted
                  date (for window traces: act on t0, return to regular; this
                  is also the Instant strategy of Section 4)
      "nockpt"    Section 4 — no checkpoints inside the window
      "withckpt"  Section 4 — proactive period T_P inside the window
      "migration" Section 3.4 — migrate (cost M) instead of checkpointing
      "two_level" beyond-paper — memory-tier checkpoints of period T_R
                  nested in disk-tier checkpoints every ``rho``-th period
                  (see waste.waste_two_level)
      "silent"    beyond-paper — latent corruptions, verification every
                  ``k_V``-th checkpoint (see waste.waste_silent)
    """

    name: str
    T_R: float
    q: float = 0.0
    mode: str = "none"
    T_P: Optional[float] = None
    #: two-level nesting stride (every rho-th regular ckpt is disk-tier)
    rho: Optional[int] = None
    #: silent-error verification stride (every k_V-th regular ckpt verifies)
    k_V: Optional[int] = None


def young(platform: Platform) -> Strategy:
    """Uncapped Young period sqrt(2 mu C) (the simulation baseline)."""
    return Strategy("Young", P._t_extr(platform.mu, platform.C), q=0.0, mode="none")


def daly(platform: Platform) -> Strategy:
    return Strategy(
        "Daly", P._t_daly(platform.mu, platform.R, platform.C), q=0.0, mode="none"
    )


def _t1(platform: Platform, pred: PredictorModel) -> float:
    """Uncapped T_extr^{1} = sqrt(2 mu C / (1 - r)) — Section 5 uses the
    uncapped value to mimic a real execution."""
    return P._t_extr(platform.mu, platform.C, pred.recall, 1.0)


def exact_prediction(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("ExactPrediction", _t1(platform, pred), q=1.0, mode="exact")


def instant(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("Instant", _t1(platform, pred), q=1.0, mode="exact")


def nockpt(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("NoCkptI", _t1(platform, pred), q=1.0, mode="nockpt")


def withckpt(platform: Platform, pred: PredictorModel) -> Strategy:
    tp = P._t_p_opt(platform.C, pred.precision, pred.window, pred.e_f)
    if tp is None:  # window cannot hold a checkpoint: degenerate to NoCkptI
        return Strategy("WithCkptI", _t1(platform, pred), q=1.0, mode="nockpt")
    return Strategy(
        "WithCkptI", _t1(platform, pred), q=1.0, mode="withckpt", T_P=tp[0]
    )


def migration(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("Migration", _t1(platform, pred), q=1.0, mode="migration")


def two_level(platform: Platform, pred: Optional[PredictorModel] = None) -> Strategy:
    """Two-level checkpointing at the corrected joint extremizers: memory
    period T_m, disk stride rho = round(T_d / T_m) (>= 1 by the T_d >= T_m
    constraint of :func:`~repro_torch.core.periods.two_level_periods`)."""
    C2 = platform.C2 if platform.C2 is not None else platform.C
    R2 = platform.R2 if platform.R2 is not None else platform.R
    f = platform.f if platform.f is not None else 0.0
    r = pred.recall if pred is not None else 0.0
    q = 1.0 if pred is not None and r > 0.0 else 0.0
    p = pred.precision if pred is not None else 1.0
    t_m, t_d = P.two_level_periods(
        platform.mu, platform.C, C2, f, r, q, p, platform.D, platform.R, R2
    )
    return Strategy(
        "TwoLevel", t_m, q=q, mode="two_level", rho=max(1, round(t_d / t_m))
    )


def silent(platform: Platform) -> Strategy:
    """Silent-error strategy: verified checkpoints every k_V-th period (the
    predictor never fires on latent corruptions, so q = 0 always)."""
    V = platform.V if platform.V is not None else platform.C
    t, k = P.silent_period(platform.mu, platform.C, V, platform.D, platform.R)
    return Strategy("Silent", t, q=0.0, mode="silent", k_V=k)
