"""Optimal checkpointing periods (Sections 3.3, 3.4, 4.3 of the paper).

The port's copy of ``repro.core.periods``: the *unified period formula*

    T_extr^{q} = sqrt( 2 mu C / (1 - r q) )

which extends Young's T = sqrt(2 mu C) to platforms with a fault
predictor of recall ``r`` trusted with probability ``q``, the case
analyses that clamp the period to its admissible domain, and the fact
that the optimal ``q`` is always 0 or 1 (the waste is affine in ``q``).
:func:`repro_torch.core.optimize` (:mod:`repro_torch.core.analytic`) is
the entry point that dispatches to the underscore-prefixed case analyses
here.  The reference's deprecated public aliases of them (``t_extr``,
``optimize_exact``, ``best_policy``, ...) are not ported.

Every function is scalar ``float`` (IEEE doubles via ``math``), as in
the reference.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

from . import waste as W
from .events import mu_e as _mu_e

__all__ = [
    "_t_extr",
    "_t_young",
    "_t_daly",
    "_t_one",
    "_t_p_extr",
    "_t_p_opt",
    "OptimalPolicy",
    "two_level_periods",
    "silent_period",
]


# --------------------------------------------------------------------------- #
# Extremal and clamped periods
# --------------------------------------------------------------------------- #
def _t_extr(mu: float, C: float, r: float = 0.0, q: float = 0.0) -> float:
    """Unified extremal period T_extr^{q} = sqrt(2 mu C / (1 - r q)).

    For r q -> 1 the period diverges: the predictor catches every fault and
    is always trusted, so periodic checkpointing is useless (the caller
    clamps to the admissible domain).
    """
    denom = 1.0 - r * q
    if denom <= 0.0:
        return math.inf
    return math.sqrt(2.0 * mu * C / denom)


def _t_young(mu: float, C: float, alpha: float = W.ALPHA) -> float:
    """T_Y = min(alpha mu, max(sqrt(2 mu C), C)) (Section 3.3).

    Degenerate platforms where alpha*mu < C have an empty validity domain;
    C is the least-bad admissible period (waste ~= 1 regardless)."""
    return max(C, min(alpha * mu, max(math.sqrt(2.0 * mu * C), C)))


def _t_daly(mu: float, R: float, C: float) -> float:
    """Daly's first-order refinement T = sqrt(2 (mu + R) C) [Daly 2004]."""
    return math.sqrt(2.0 * (mu + R) * C)


def _t_one(
    mu: float,
    C: float,
    r: float,
    p: float,
    I: float = 0.0,
    alpha: float = W.ALPHA,
) -> float:
    """T_1 = min(alpha mu_e - I, max(sqrt(2 mu C / (1 - r)), C)).

    The upper clamp uses the mean time between *events* (predictions of any
    kind + unpredicted faults) minus the window length, per Section 4.3.
    For I = 0 this is the Section 3.3 domain.
    """
    cap = alpha * _mu_e(mu, r, p) - I
    cap = max(cap, C)  # degenerate platforms: keep the domain non-empty
    return min(cap, max(_t_extr(mu, C, r, 1.0), C))


def _t_p_extr(C: float, p: float, I: float, E_f: Optional[float] = None) -> float:
    """Equation (7): T_P^extr = sqrt( ((1-p) I + p E_I^f) / p * C )."""
    if E_f is None:
        E_f = I / 2.0
    K = ((1.0 - p) * I + p * E_f) / p
    return math.sqrt(K * C)


def _t_p_opt(
    C: float, p: float, I: float, E_f: Optional[float] = None
) -> Optional[Tuple[float, int]]:
    """Integer-partition proactive period (Section 4.3).

    Returns ``(T_P, k)`` with ``k = I / T_P`` integer and ``T_P >= C``
    minimizing WASTE_{T_P} = K C / T_P + T_P, or ``None`` when the window
    cannot hold a checkpoint (I < C).
    """
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


# --------------------------------------------------------------------------- #
# Full policy optimization
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class OptimalPolicy:
    """Result of a waste minimization: the strategy's operating point.

    ``objective`` / ``value`` record what the unified optimizer was asked
    to optimize ("waste" minimization or "availability" = 1 - waste
    maximization — same argmin, the affine flip only changes the reported
    value); legacy constructions leave them at the waste default."""

    strategy: str
    q: int  # 0 or 1 — affine-in-q argument, Section 3.3
    T_R: float
    waste: float
    T_P: Optional[float] = None  # proactive period (WithCkptI only)
    k_P: Optional[int] = None  # number of proactive periods in the window
    objective: str = "waste"
    value: Optional[float] = None
    T_d: Optional[float] = None  # disk-tier period (two-level only)
    k_V: Optional[int] = None  # checkpoints per verification (silent only)


def _clamp(T: float, lo: float, hi: float) -> float:
    hi = max(hi, lo)
    return min(hi, max(T, lo))


def _t0(mu, C, alpha, capped) -> float:
    return _t_young(mu, C, alpha) if capped else max(_t_extr(mu, C), C)


def _t1(mu, C, r, p, I, alpha, capped) -> float:
    if capped:
        return _t_one(mu, C, r, p, I, alpha)
    return max(_t_extr(mu, C, r, 1.0), C)


def _optimize_exact(
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float = W.ALPHA,
    capped: bool = False,
) -> OptimalPolicy:
    """Section 3.3 case analysis: min(WASTE_Y(T_Y), WASTE^{1}(T_1)).

    ``capped=True`` restricts periods to the Section 3.2 validity domain
    [C, alpha*mu_e].  The paper's own simulations (Section 5) use the
    *uncapped* extremal periods — the capped model over-penalizes poor
    precision (mu_e shrinks with false predictions), so uncapped is the
    default here, matching the policy the paper validates."""
    mu, C, D, R = platform.mu, platform.C, platform.D, platform.R
    r, p = pred.recall, pred.precision

    ty = _t0(mu, C, alpha, capped)
    w0 = W.waste_exact(ty, 0.0, C, D, R, mu, r, p)

    if r <= 0:
        return OptimalPolicy("exact", 0, ty, min(w0, 1.0))

    t1 = _t1(mu, C, r, p, 0.0, alpha, capped)
    w1 = W.waste_exact(t1, 1.0, C, D, R, mu, r, p)
    if w1 < w0:
        return OptimalPolicy("exact", 1, t1, min(w1, 1.0))
    return OptimalPolicy("exact", 0, ty, min(w0, 1.0))


def _optimize_migration(
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float = W.ALPHA,
    capped: bool = False,
) -> OptimalPolicy:
    """Section 3.4: same case analysis with Equation (3)."""
    mu, C, D, R = platform.mu, platform.C, platform.D, platform.R
    M = platform.M if platform.M is not None else C
    r, p = pred.recall, pred.precision

    ty = _t0(mu, C, alpha, capped)
    w0 = W.waste_migration(ty, 0.0, C, D, R, M, mu, r, p)
    if r <= 0:
        return OptimalPolicy("migration", 0, ty, min(w0, 1.0))
    t1 = _t1(mu, C, r, p, 0.0, alpha, capped)
    w1 = W.waste_migration(t1, 1.0, C, D, R, M, mu, r, p)
    if w1 < w0:
        return OptimalPolicy("migration", 1, t1, min(w1, 1.0))
    return OptimalPolicy("migration", 0, ty, min(w0, 1.0))


def _optimize_window(
    strategy: str,
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float,
    capped: bool = False,
) -> OptimalPolicy:
    mu, C, D, R = platform.mu, platform.C, platform.D, platform.R
    r, p, I = pred.recall, pred.precision, pred.window
    E_f = pred.e_f

    # q = 0 branch is Young's waste with the window-reduced cap (Section 4.3).
    if capped:
        cap0 = max(alpha * _mu_e(mu, r, p) - I, C) if r > 0 else alpha * mu
        t_r0 = _clamp(_t_extr(mu, C), C, cap0)
    else:
        t_r0 = max(_t_extr(mu, C), C)
    w0 = W.waste_young(t_r0, C, D, R, mu)
    best = OptimalPolicy(strategy, 0, t_r0, min(w0, 1.0))
    if r <= 0:
        return best

    t_r1 = _t1(mu, C, r, p, I, alpha, capped)
    if strategy == "instant":
        w1 = W.waste_instant(t_r1, 1.0, C, D, R, mu, r, p, I, E_f)
        cand = OptimalPolicy(strategy, 1, t_r1, min(w1, 1.0))
    elif strategy == "nockpt":
        w1 = W.waste_nockpt(t_r1, 1.0, C, D, R, mu, r, p, I, E_f)
        cand = OptimalPolicy(strategy, 1, t_r1, min(w1, 1.0))
    elif strategy == "withckpt":
        tp = _t_p_opt(C, p, I, E_f)
        if tp is None:
            return best  # window cannot hold a checkpoint
        T_P, k = tp
        w1 = W.waste_withckpt(t_r1, T_P, 1.0, C, D, R, mu, r, p, I, E_f)
        cand = OptimalPolicy(strategy, 1, t_r1, min(w1, 1.0), T_P=T_P, k_P=k)
    else:  # pragma: no cover - guarded by callers
        raise ValueError(strategy)

    return cand if cand.waste < best.waste else best


def _optimize_instant(platform, pred, alpha: float = W.ALPHA, capped: bool = False) -> OptimalPolicy:
    return _optimize_window("instant", platform, pred, alpha, capped)


def _optimize_nockpt(platform, pred, alpha: float = W.ALPHA, capped: bool = False) -> OptimalPolicy:
    return _optimize_window("nockpt", platform, pred, alpha, capped)


def _optimize_withckpt(platform, pred, alpha: float = W.ALPHA, capped: bool = False) -> OptimalPolicy:
    return _optimize_window("withckpt", platform, pred, alpha, capped)


def two_level_periods(
    mu: float,
    C_m: float,
    C_d: float,
    f: float,
    r: float = 0.0,
    q: float = 0.0,
    p: float = 1.0,
    D: float = 0.0,
    R_m: float = 0.0,
    R_d: float = 0.0,
) -> Tuple[float, float]:
    """Argmin periods of the two-level model (see waste.waste_two_level).

    The model's proactive term ``(qr/p) C_m / mu`` is constant in both
    periods, so it shifts the waste but never the argmin; ``p`` (and the
    D/R costs) are threaded through so this optimizer evaluates the same
    model :func:`waste.waste_two_level` charges.  Each tier's term is
    Young-shaped in its own period — but prediction shields only the
    memory tier (a disk-tier failure destroys the proactive memory
    checkpoint with the tier, see ``waste.waste_two_level``), so ``rq``
    stretches the memory extremizer alone:

      T_m* = sqrt(2 mu C_m / ((1-rq) f))
      T_d* = sqrt(2 mu C_d / (1-f))

    When the unconstrained extremizers violate ``T_d >= T_m`` the
    constrained argmin sits ON that boundary (the objective is separable
    convex), where every checkpoint is a combined memory+disk one of cost
    ``C_m + C_d`` against the blended loss slope ``f(1-rq) + (1-f)`` — a
    joint Young problem, NOT the pair of independently clamped per-tier
    optima the previous revision returned:

      T* = sqrt(2 mu (C_m + C_d) / (f(1-rq) + 1-f))     (T_m = T_d = T*)

    Periods are floored at their own checkpoint cost (``T_m >= C_m``,
    ``T_d >= C_d`` per tier, ``T >= C_m + C_d`` on the boundary)."""
    del p  # constant proactive term: affects the waste, never the argmin
    denom = max(1.0 - r * q, 1e-12)
    t_m = math.sqrt(2.0 * mu * C_m / (denom * max(f, 1e-12)))
    t_d = math.sqrt(2.0 * mu * C_d / max(1.0 - f, 1e-12))
    t_m = max(t_m, C_m)
    t_d = max(t_d, C_d)
    if t_d < t_m:
        blend = max(f * denom + (1.0 - f), 1e-12)
        t = max(math.sqrt(2.0 * mu * (C_m + C_d) / blend), C_m + C_d)
        return t, t
    del D, R_m, R_d  # additive fault costs: shift the waste, not the argmin
    return t_m, t_d


def silent_period(
    mu: float,
    C: float,
    V: float,
    D: float = 0.0,
    R: float = 0.0,
    k: Optional[int] = None,
    k_max: int = 16,
) -> Tuple[float, int]:
    """Argmin period and verification stride of the silent-error model
    (see waste.waste_silent, arXiv:1310.8486).

    For a fixed stride ``k`` (one verification every ``k`` checkpoints)
    the waste (k C + V)/(k T) + (k T + V + D + R)/mu is Young-shaped with
    extremizer

      T*(k) = sqrt(mu (k C + V)) / k

    (note: no factor 2 — a latent corruption forfeits the *whole* pattern,
    not half a period).  With ``k=None`` the stride is chosen by scanning
    ``1..k_max`` and keeping the argmin of the full model."""
    def t_star(kk: int) -> float:
        return max(math.sqrt(mu * (kk * C + V)) / kk, C)

    if k is not None:
        return t_star(k), k
    best = None
    for kk in range(1, max(k_max, 1) + 1):
        t = t_star(kk)
        w = W.waste_silent(t, C, V, D, R, mu, kk)
        if best is None or w < best[0]:
            best = (w, t, kk)
    return best[1], best[2]


def _two_level_platform(platform: W.Platform):
    """Two-level knobs with their degenerate-platform fallbacks: a missing
    disk tier costs like the memory one, a missing coverage fraction means
    no failure is memory-recoverable."""
    C2 = platform.C2 if platform.C2 is not None else platform.C
    R2 = platform.R2 if platform.R2 is not None else platform.R
    f = platform.f if platform.f is not None else 0.0
    return C2, R2, f


def _optimize_two_level(
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float = W.ALPHA,
    capped: bool = False,
) -> OptimalPolicy:
    """Two-level case analysis: the corrected extremizers of
    :func:`two_level_periods` under the q in {0, 1} affine argument."""
    mu, C, D, R = platform.mu, platform.C, platform.D, platform.R
    C2, R2, f = _two_level_platform(platform)
    r, p = pred.recall, pred.precision

    def pol(q: float) -> OptimalPolicy:
        t_m, t_d = two_level_periods(mu, C, C2, f, r, q, p, D, R, R2)
        if capped:
            cap = max(alpha * mu, C)
            t_m = _clamp(t_m, C, cap)
            t_d = max(min(t_d, max(cap, C2)), t_m)
        w = W.waste_two_level(t_m, t_d, C, C2, D, R, R2, mu, f, r, q, p)
        return OptimalPolicy("two_level", int(q), t_m, min(w, 1.0), T_d=t_d)

    best = pol(0.0)
    if r <= 0:
        return best
    cand = pol(1.0)
    return cand if cand.waste < best.waste else best


def _optimize_silent(
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float = W.ALPHA,
    capped: bool = False,
) -> OptimalPolicy:
    """Silent-error optimum: scan the verification stride, Young-shaped
    period per stride (predictions never fire on latent corruptions, so
    the predictor is ignored: q = 0 always)."""
    mu, C, D, R = platform.mu, platform.C, platform.D, platform.R
    V = platform.V if platform.V is not None else C
    t, k = silent_period(mu, C, V, D, R)
    if capped:
        t = _clamp(t, C, max(alpha * mu, C))
    w = W.waste_silent(t, C, V, D, R, mu, k)
    return OptimalPolicy("silent", 0, t, min(w, 1.0), k_V=k)


def _nockpt_dominates(
    C: float, p: float, I: float, E_f: Optional[float] = None
) -> bool:
    """Equation (12): sufficient condition for NoCkptI <= WithCkptI.

    2 sqrt( ((1-p) I + p E_f) / p * C ) >= E_f.
    Under the uniform assumption (E_f = I/2) this reduces to
    I <= 16 (1 - p/2) C / p.
    """
    if E_f is None:
        E_f = I / 2.0
    return 2.0 * _t_p_extr(C, p, I, E_f) >= E_f


def _best_policy(
    platform: W.Platform,
    pred: W.PredictorModel,
    alpha: float = W.ALPHA,
    capped: bool = False,
) -> OptimalPolicy:
    """The paper's final recipe (Section 4.3 Summary): evaluate every
    strategy at its own optimum and keep the best; when Equation (12)
    holds, WithCkptI cannot beat NoCkptI and is pruned."""
    if pred.window <= 0.0:
        return _optimize_exact(platform, pred, alpha, capped)
    cands = [
        _optimize_instant(platform, pred, alpha, capped),
        _optimize_nockpt(platform, pred, alpha, capped),
    ]
    if not _nockpt_dominates(platform.C, pred.precision, pred.window, pred.e_f):
        cands.append(_optimize_withckpt(platform, pred, alpha, capped))
    return min(cands, key=lambda pol: pol.waste)
