"""Strategy descriptions of the paper's Section 5 simulations.

The port's copy of the strategy constructors of ``repro.core.simulator``
that the paper grid uses.  The scalar event-loop oracle stays in the
reference package; the port's engine is :mod:`repro_torch.core.torch_sim`.
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
    "exact_prediction",
    "instant",
    "nockpt",
    "withckpt",
    "migration",
]


@dataclass(frozen=True)
class Strategy:
    """An operating point of the scheduling algorithm.

    mode:
      "none"      ignore all predictions (Young baseline)
      "exact"     Section 3 — proactive checkpoint right before the predicted
                  date (for window traces: act on t0, return to regular; this
                  is also the Instant strategy of Section 4)
      "nockpt"    Section 4 — no checkpoints inside the window
      "withckpt"  Section 4 — proactive period T_P inside the window
      "migration" Section 3.4 — migrate (cost M) instead of checkpointing
    """

    name: str
    T_R: float
    q: float = 0.0
    mode: str = "none"
    T_P: Optional[float] = None


def young(platform: Platform) -> Strategy:
    """Uncapped Young period sqrt(2 mu C) (the simulation baseline)."""
    return Strategy("Young", P._t_extr(platform.mu, platform.C), q=0.0, mode="none")


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
