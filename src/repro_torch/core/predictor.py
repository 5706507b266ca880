"""Fault-predictor interfaces and literature presets (paper Table 3): the
port's copy of the reference's ``core/predictor.py``, on the port's
``core/events.py`` and ``core/waste.py``.

Two layers:

* :class:`PredictorModel` (in ``waste.py``) — the *statistical* description
  (recall, precision, lead, window) used by the closed-form optimizers.
* :class:`OnlinePredictor` — the *runtime* interface consumed by the
  fault-tolerant executor: a stream of :class:`PredictionEvent` announcements.
  :class:`SimulatedPredictor` replays a generated trace; a production
  deployment would adapt fleet health telemetry (ECC rates, link flaps,
  thermal alarms) to the same interface.
"""

from __future__ import annotations

import math
from typing import List, Protocol

import numpy as np

from .events import EventTrace, PredictionEvent, make_event_trace
from .waste import PredictorModel

__all__ = [
    "TABLE3_PREDICTORS",
    "predictor_preset",
    "OnlinePredictor",
    "SimulatedPredictor",
    "estimate_recall_precision",
]


#: Paper Table 3 — published predictor operating points.
#: (label, lead seconds, precision, recall, window seconds or None)
TABLE3_PREDICTORS: dict[str, PredictorModel] = {
    # Zheng et al. [14], Blue Gene/P event-driven, 300 s lead
    "zheng-lead300": PredictorModel(recall=0.70, precision=0.40, lead=300.0),
    "zheng-lead600": PredictorModel(recall=0.60, precision=0.35, lead=600.0),
    # Yu et al. [12], Blue Gene/P period-based (window size unpublished)
    "yu-2h": PredictorModel(recall=0.652, precision=0.648, lead=7200.0, window=3600.0),
    "yu-0min": PredictorModel(recall=0.854, precision=0.823, lead=0.0, window=300.0),
    # Gainaru et al. [6]
    "gainaru": PredictorModel(recall=0.43, precision=0.93, lead=32.0),
    # Fulp et al. [5], SVM on syslogs
    "fulp": PredictorModel(recall=0.75, precision=0.70, lead=math.inf),
    # Liang et al. [9], BG/L event logs, several window sizes
    "liang-1h": PredictorModel(recall=0.30, precision=0.20, window=3600.0),
    "liang-4h": PredictorModel(recall=0.75, precision=0.30, window=4 * 3600.0),
    "liang-6h": PredictorModel(recall=0.90, precision=0.40, window=6 * 3600.0),
    "liang-12h": PredictorModel(recall=0.85, precision=0.60, window=12 * 3600.0),
    # The paper's two simulation operating points (Section 5.1)
    "paper-accurate": PredictorModel(recall=0.85, precision=0.82, window=300.0),
    "paper-limited": PredictorModel(recall=0.70, precision=0.40, window=300.0),
}


def predictor_preset(name: str) -> PredictorModel:
    try:
        return TABLE3_PREDICTORS[name]
    except KeyError:
        raise KeyError(
            f"unknown predictor preset {name!r}; available: "
            f"{sorted(TABLE3_PREDICTORS)}"
        ) from None


class OnlinePredictor(Protocol):
    """Runtime prediction stream consumed by the FT executor."""

    model: PredictorModel

    def poll(self, now: float) -> List[PredictionEvent]:
        """Predictions announced at or before ``now`` not yet delivered."""
        ...


class SimulatedPredictor:
    """Replays the prediction half of an :class:`EventTrace`."""

    def __init__(self, trace: EventTrace, model: PredictorModel):
        self.model = model
        # deliver in announce order
        self._events = sorted(trace.predictions, key=lambda e: e.announce_time)
        self._i = 0

    def poll(self, now: float) -> List[PredictionEvent]:
        out: List[PredictionEvent] = []
        while self._i < len(self._events) and (
            self._events[self._i].announce_time <= now
        ):
            out.append(self._events[self._i])
            self._i += 1
        return out

    @staticmethod
    def generate(
        model: PredictorModel,
        mtbf: float,
        horizon: float,
        seed: int = 0,
    ) -> tuple["SimulatedPredictor", EventTrace]:
        rng = np.random.default_rng(seed)
        trace = make_event_trace(
            rng,
            horizon=horizon,
            mtbf=mtbf,
            recall=model.recall,
            precision=model.precision,
            window=model.window,
            lead=model.lead,
        )
        return SimulatedPredictor(trace, model), trace


def estimate_recall_precision(
    n_true_positive: int, n_false_positive: int, n_false_negative: int
) -> tuple[float, float]:
    """Online r/p estimation from observed counters (Section 2.2).

    With zero observed predictions (TP + FP == 0) there is *no evidence*
    of precision, and the estimate must not be trusted: returning the
    old optimistic 1.0 let the executor's online re-optimization flip to
    full q=1 trust in a predictor that had never produced a prediction.
    Both undefined ratios now degrade to 0.0 (claim nothing you have not
    observed); callers wanting a prior should gate on the evidence count
    instead (see ``repro_torch.ft.executor._MIN_PRED_EVIDENCE``)."""
    tp, fp, fn = n_true_positive, n_false_positive, n_false_negative
    r = tp / (tp + fn) if tp + fn else 0.0
    p = tp / (tp + fp) if tp + fp else 0.0
    return r, p
