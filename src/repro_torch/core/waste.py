"""Closed-form waste models from the paper, and the platform and
predictor descriptions they take (Sections 2.1-4).

The port's copy of ``repro.core.waste``.  Equation numbers refer to
Aupy, Robert, Vivien, Zaidouni, "Impact of fault prediction on
checkpointing strategies" (2012).  Every function returns the *waste*:
the steady-state fraction of platform time not spent on useful work.
Parameters follow the paper's notation:

    T   checkpointing period (regular mode), seconds
    C   checkpoint duration
    D   downtime after a fault
    R   recovery duration
    mu  platform MTBF
    r   predictor recall
    p   predictor precision
    q   probability of trusting a prediction
    I   prediction-window length
    E_f expectation of the fault position inside the window (E_I^{(f)};
        I/2 under the paper's uniform assumption)
    M   migration duration (Section 3.4)

The functions take Python floats or NumPy arrays; :func:`i_prime` is
plain arithmetic and also takes tensors (the branchless models of
:mod:`repro_torch.kernels.analytic` call it).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np

from .events import mu_e as _mu_e
from .events import mu_np as _mu_np
from .events import mu_p as _mu_p

#: a Python float or a NumPy array of them
FloatLike = Union[float, np.ndarray]

__all__ = [
    "ALPHA",
    "Platform",
    "PredictorModel",
    "waste_checkpoint_only",
    "waste_young",
    "waste_exact",
    "waste_migration",
    "waste_instant",
    "waste_nockpt",
    "waste_withckpt",
    "waste_two_level",
    "waste_silent",
    "i_prime",
    "withckpt_minus_nockpt",
]

#: Validity tuning parameter (Section 3.2): with T <= ALPHA * mu_e the
#: probability of 2+ events in a period is <= 3%.
ALPHA = 0.27


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
    C2: Optional[float] = None  # disk-tier checkpoint duration (two-level)
    R2: Optional[float] = None  # disk-tier recovery duration (two-level)
    f: Optional[float] = None  # fraction of failures covered by the fast tier
    V: Optional[float] = None  # verification duration (silent errors)

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


# --------------------------------------------------------------------------- #
# Section 2.1 / Section 3
# --------------------------------------------------------------------------- #
def waste_checkpoint_only(T: FloatLike, C: FloatLike) -> FloatLike:
    """Fault-free waste: C / T (Section 2.1)."""
    return C / T


def waste_young(
    T: FloatLike, C: FloatLike, D: FloatLike, R: FloatLike, mu: FloatLike
) -> FloatLike:
    """WASTE^{q=0}: Young's waste model (Section 3.3).

    WASTE_Y(T) = C/T + (1/mu) [ T/2 + D + R ]
    """
    return C / T + (T / 2.0 + D + R) / mu


def waste_exact(
    T: FloatLike, q: FloatLike, C: FloatLike, D: FloatLike, R: FloatLike,
    mu: FloatLike, r: FloatLike, p: FloatLike,
) -> FloatLike:
    """Equation (1): predictor with exact event dates.

    WASTE = C/T + (1/mu) [ (1 - r q) T/2 + D + R + (q r / p) C ]
    """
    pred_term = (q * r / p) * C if r > 0 else 0.0
    return C / T + ((1.0 - r * q) * T / 2.0 + D + R + pred_term) / mu


def waste_migration(
    T: FloatLike, q: FloatLike, C: FloatLike, D: FloatLike, R: FloatLike,
    M: FloatLike, mu: FloatLike, r: FloatLike, p: FloatLike,
) -> FloatLike:
    """Equation (3): proactive migration instead of proactive checkpoint.

    WASTE = C/T + (1/mu) [ (1 - r q)(T/2 + D + R) + (q r / p) M ]
    """
    pred_term = (q * r / p) * M if r > 0 else 0.0
    return C / T + ((1.0 - r * q) * (T / 2.0 + D + R) + pred_term) / mu


# --------------------------------------------------------------------------- #
# Section 4: window-based predictions
# --------------------------------------------------------------------------- #
def i_prime(q: FloatLike, p: FloatLike, I: FloatLike, E_f: FloatLike) -> FloatLike:
    """I' = q ((1-p) I + p E_I^f): expected time spent in proactive mode per
    prediction (Section 4.1)."""
    return q * ((1.0 - p) * I + p * E_f)


def waste_instant(
    T_R: FloatLike, q: FloatLike, C: FloatLike, D: FloatLike, R: FloatLike,
    mu: FloatLike, r: FloatLike, p: FloatLike, I: FloatLike, E_f: FloatLike,
) -> FloatLike:
    """Equation (5): strategy Instant (ignore the window, act at t0).

    WASTE = C/T_R + (1/mu)[ (1-rq) T_R/2 + D + R + (qr/p) C
                            + q r min(E_I^f, T_R/2) ]
    """
    pred_term = (q * r / p) * C if r > 0 else 0.0
    lost = q * r * np.minimum(E_f, T_R / 2.0)
    return C / T_R + ((1.0 - r * q) * T_R / 2.0 + D + R + pred_term + lost) / mu


def waste_nockpt(
    T_R: FloatLike, q: FloatLike, C: FloatLike, D: FloatLike, R: FloatLike,
    mu: FloatLike, r: FloatLike, p: FloatLike, I: FloatLike, E_f: FloatLike,
) -> FloatLike:
    """Equation (6): strategy NoCkptI (no checkpoints inside the window).

    Outside the validity domain (windows so long/frequent that I' > mu_P,
    i.e. the platform would sit in proactive mode permanently) the
    proactive fraction is clamped to 1, keeping the formula total."""
    if r <= 0:
        return waste_young(T_R, C, D, R, mu)
    m_p = _mu_p(mu, r, p)
    m_np = _mu_np(mu, r)
    ip = min(i_prime(q, p, I, E_f), m_p)
    reg_frac = 1.0 - ip / m_p
    waste = (reg_frac / T_R + q / m_p) * C
    waste += (p * (1.0 - q) / m_p) * (T_R / 2.0)
    waste += (p * q / m_p) * E_f
    waste += reg_frac / m_np * (T_R / 2.0)
    waste += (p / m_p + reg_frac / m_np) * (D + R)
    return waste


def waste_withckpt(
    T_R: FloatLike, T_P: FloatLike, q: FloatLike, C: FloatLike,
    D: FloatLike, R: FloatLike, mu: FloatLike, r: FloatLike, p: FloatLike,
    I: FloatLike, E_f: FloatLike,
) -> FloatLike:
    """Equation (4): strategy WithCkptI (periodic checkpoints of period T_P
    inside the window)."""
    if r <= 0:
        return waste_young(T_R, C, D, R, mu)
    m_p = _mu_p(mu, r, p)
    m_np = _mu_np(mu, r)
    ip = min(i_prime(q, p, I, E_f), m_p)  # validity clamp (see waste_nockpt)
    reg_frac = 1.0 - ip / m_p
    waste = (reg_frac / T_R + (ip / m_p) / T_P + q / m_p) * C
    waste += (p * (1.0 - q) / m_p) * (T_R / 2.0)
    waste += (p * q / m_p) * T_P
    waste += reg_frac / m_np * (T_R / 2.0)
    waste += (p / m_p + reg_frac / m_np) * (D + R)
    return waste


def waste_two_level(
    T_m: FloatLike, T_d: FloatLike, C_m: FloatLike, C_d: FloatLike,
    D: FloatLike, R_m: FloatLike, R_d: FloatLike, mu: FloatLike,
    f: FloatLike, r: float = 0.0, q: float = 0.0, p: float = 1.0,
) -> FloatLike:
    """Beyond-paper: two-level checkpointing (memory buddy tier + disk).

    A fraction ``f`` of failures is recoverable from the in-memory buddy
    tier (single-node loss: cost D + R_m, work lost since the last
    *memory* checkpoint, period T_m, cost C_m); the remaining (1-f)
    require the durable disk tier (period T_d >= T_m, cost C_d, recovery
    R_d).  Prediction only protects the *memory* tier: a trusted true
    positive triggers a proactive memory checkpoint right before the
    fault, so a memory-tier failure then loses (almost) no work — but a
    disk-tier failure destroys the memory tier, proactive checkpoint
    included, and still rolls back to the last disk checkpoint.  (The
    previous revision scaled the disk term by (1-rq) too, which
    simulation refutes: predictions cannot shield losses the surviving
    tier never held.)  Downtime + recovery is paid on every fault,
    predicted or not:

      WASTE = C_m/T_m + C_d/T_d
            + (1/mu) [ f ((1-rq) T_m/2 + D + R_m)
                       + (1-f)(T_d/2 + D + R_d) ]
            + (qr/p) C_m / mu                      (proactive ckpts hit the
                                                    fast tier)
    """
    waste = C_m / T_m + C_d / T_d
    waste += (
        f * ((1.0 - r * q) * T_m / 2.0 + D + R_m)
        + (1 - f) * (T_d / 2.0 + D + R_d)
    ) / mu
    if r > 0 and q > 0:
        # p <= 0 means "no true positive is ever trusted for free": clamp the
        # denominator exactly like the other prediction-aware models instead
        # of raising ZeroDivisionError when a predictor is active with p=0.
        waste += (q * r / max(p, 1e-12)) * C_m / mu
    return waste


def waste_silent(
    T: FloatLike, C: FloatLike, V: FloatLike, D: FloatLike, R: FloatLike,
    mu: FloatLike, k: int = 1,
) -> FloatLike:
    """Beyond-paper: silent-data-corruption waste (arXiv:1310.8486).

    Pattern of ``k`` checkpointing periods of length ``T`` (each ending in a
    checkpoint of cost ``C``); the ``k``-th checkpoint additionally runs a
    verification of cost ``V``, so the pattern wall time is ``P = k T + V``.
    Corruptions strike at rate ``1/mu`` but stay latent until the pattern-end
    verification, which rolls back to the last *verified* checkpoint: a
    struck pattern forfeits its full wall time (detection latency reaches
    past the k-1 unverified checkpoints) plus the recovery ``D + R``:

      WASTE = (k C + V) / (k T) + (k T + V + D + R) / mu
    """
    return (k * C + V) / (k * T) + (k * T + V + D + R) / mu


def withckpt_minus_nockpt(
    T_P: FloatLike, C: FloatLike, mu: FloatLike, r: FloatLike,
    p: FloatLike, I: FloatLike, E_f: FloatLike,
) -> FloatLike:
    """Equation (11) at q=1: WASTE_withCkpt - WASTE_noCkpt.

    = (r ((1-p) I + p E_f) / (p mu)) * C / T_P + (r/mu) (T_P - E_f)
    """
    K = ((1.0 - p) * I + p * E_f) / p
    return (r / mu) * (K * C / T_P + T_P - E_f)
