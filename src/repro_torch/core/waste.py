"""Platform and predictor descriptions (the paper's Sections 2.1-2.2).

The port's copy of the two dataclasses of ``repro.core.waste`` that the
simulation path consumes; the closed-form waste models are not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from .events import mu_e as _mu_e
from .events import mu_np as _mu_np
from .events import mu_p as _mu_p

__all__ = ["Platform", "PredictorModel"]


@dataclass(frozen=True)
class Platform:
    """Fault-tolerance characteristics of a platform (Section 2.1).

    If built from individual components, ``mu = mu_ind / N``.
    """

    mu: float  # platform MTBF, seconds
    C: float  # checkpoint duration
    D: float  # downtime
    R: float  # recovery duration
    M: Optional[float] = None  # migration duration (Section 3.4)

    @staticmethod
    def from_components(
        mu_ind: float, n: int, C: float, D: float, R: float, M: Optional[float] = None
    ) -> "Platform":
        return Platform(mu=mu_ind / n, C=C, D=D, R=R, M=M)


@dataclass(frozen=True)
class PredictorModel:
    """Recall/precision/lead/window description of a predictor (Section 2.2)."""

    recall: float
    precision: float
    lead: float = math.inf
    window: float = 0.0

    @property
    def e_f(self) -> float:
        """E_I^{(f)} under the paper's uniform-fault-in-window assumption."""
        return self.window / 2.0

    def mu_p(self, mu: float) -> float:
        return _mu_p(mu, self.recall, self.precision)

    def mu_np(self, mu: float) -> float:
        return _mu_np(mu, self.recall)

    def mu_e(self, mu: float) -> float:
        return _mu_e(mu, self.recall, self.precision)
