"""Checkpointing periods the paper-grid strategies run at (Sections 3.3, 4.3).

The port's copy of the period helpers of ``repro.core.periods`` that
:mod:`repro_torch.core.simulator` calls; every function is scalar ``float``
(IEEE doubles via ``math``), as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

__all__ = ["_t_extr", "_t_daly", "_t_p_extr", "_t_p_opt"]


def _t_extr(mu: float, C: float, r: float = 0.0, q: float = 0.0) -> float:
    """Unified extremal period T_extr^{q} = sqrt(2 mu C / (1 - r q));
    ``inf`` when r q >= 1 (every fault is caught and trusted)."""
    denom = 1.0 - r * q
    if denom <= 0.0:
        return math.inf
    return math.sqrt(2.0 * mu * C / denom)


def _t_daly(mu: float, R: float, C: float) -> float:
    """Daly's first-order refinement T = sqrt(2 (mu + R) C) [Daly 2004]."""
    return math.sqrt(2.0 * (mu + R) * C)


def _t_p_extr(C: float, p: float, I: float, E_f: Optional[float] = None) -> float:
    """Equation (7): T_P^extr = sqrt( ((1-p) I + p E_I^f) / p * C )."""
    if E_f is None:
        E_f = I / 2.0
    K = ((1.0 - p) * I + p * E_f) / p
    return math.sqrt(K * C)


def _t_p_opt(
    C: float, p: float, I: float, E_f: Optional[float] = None
) -> Optional[Tuple[float, int]]:
    """Integer-partition proactive period (Section 4.3): ``(T_P, k)`` with
    ``k = I / T_P`` integer and ``T_P >= C`` minimizing K C / T_P + T_P,
    or ``None`` when the window cannot hold a checkpoint (I < C)."""
    if E_f is None:
        E_f = I / 2.0
    if I < C or I <= 0.0:
        return None
    K = ((1.0 - p) * I + p * E_f) / p
    te = _t_p_extr(C, p, I, E_f)

    def cost(tp: float) -> float:
        return K * C / tp + tp

    k_lo = max(1, math.floor(I / te)) if te > 0 else 1
    candidates = []
    for k in {k_lo, k_lo + 1}:
        tp = I / k
        if tp >= C:
            candidates.append((cost(tp), tp, k))
    if not candidates:
        # every candidate shorter than C: largest feasible k with I/k >= C
        k = max(1, math.floor(I / C))
        tp = I / k
        candidates.append((cost(tp), tp, k))
    _, tp, k = min(candidates)
    return tp, k
