"""The branchless analytic waste models and the batched period optimizer,
in PyTorch.

The port of ``repro.kernels.analytic`` and of the NumPy models of
``repro.core.analytic``, as one implementation: every function up to
:func:`cell_waste` is a branchless model over the fused engine's
per-cell parameter columns (``torch.where`` / ``torch.minimum`` in place
of the reference's ``np`` / ``jnp`` selects).  The host layer
(:mod:`repro_torch.core.analytic`) runs them on CPU f64 tensors; the
optimizer below runs them, and their derivatives, on the card.  The
derivatives come from autograd: every cell is independent, so the
gradient of ``cell_waste(T, ...).sum()`` with respect to ``T`` is each
cell's own W', and a second pass through that gradient gives W''.

Selects keep every branch finite (``p_safe`` / ``r_safe``, the ``T_P``
fill): autograd multiplies an untaken branch's zero cotangent by its
partial, and an infinite partial there would turn the derivative NaN.

:func:`newton_policy` solves every cell's optimal regular period in one
call: per-cell safeguarded Newton steps (accepted only when the local
second derivative is positive and the step stays inside a shrinking
derivative-sign bracket, else bisection) on the domain ``[lo, hi]``
supplied by the host, split at ``T = I`` where strategy Instant's waste
is non-smooth (``min(E_f, T/2)``).  Each sub-interval is convex, so
bracketed Newton on both and a final compare is the global minimizer.
The q in {0, q_eff} case analysis of the host ``_optimize_*`` functions
runs vectorized on top.  The loop runs a fixed number of iterations with
no data-dependent exit and reads nothing back, so the solve issues no
host sync until its result is read; on the card, all iterations after
the first replay one captured CUDA graph of an iteration.

No CUDA kernel here: the reference is plain ``jnp`` under one
``jax.jit``, with no Pallas kernel to port.
"""

from __future__ import annotations

import torch

from ..core.waste import i_prime

__all__ = [
    "precision_from_fp",
    "young_waste",
    "exact_waste",
    "migration_waste",
    "instant_waste",
    "nockpt_waste",
    "withckpt_waste",
    "two_level_waste",
    "silent_waste",
    "cell_waste",
    "waste_derivatives",
    "newton_policy",
    "NEWTON_ITERS",
]

#: iterations of every bracket solve, a fixed count with no
#: data-dependent exit
NEWTON_ITERS = 60

#: integer strategy-mode codes of the engine tables (values of
#: ``repro_torch.core.batch_sim.MODE_CODES``, fixed by the packing format)
_M_NONE, _M_EXACT, _M_NOCKPT, _M_WITHCKPT, _M_MIGRATION = 0, 1, 2, 3, 4
_M_TWO_LEVEL, _M_SILENT = 5, 6


# --------------------------------------------------------------------------- #
# Branchless waste models
# --------------------------------------------------------------------------- #
def precision_from_fp(mu, fp_mean, r):
    """Precision from the table's false-prediction mean inter-arrival.

    Inverts ``fp_mean = p mu / (r (1 - p))`` to ``p = r fp / (mu + r fp)``;
    an infinite ``fp_mean`` (no false predictions) means precision 1."""
    fin = torch.isfinite(fp_mean)
    fp = torch.where(fin, fp_mean, 1.0)
    return torch.where(fin, r * fp / (mu + r * fp), 1.0)


def young_waste(T, C, DR, mu):
    """WASTE^{q=0} (Section 3.3): Young's model over table columns."""
    return C / T + (T / 2.0 + DR) / mu


def exact_waste(T, q, C, DR, mu, r, p):
    """Equation (1): exact-date predictions, branchless."""
    p_safe = torch.where(r > 0.0, p, 1.0)
    pred_term = torch.where(r > 0.0, (q * r / p_safe) * C, 0.0)
    return C / T + ((1.0 - r * q) * T / 2.0 + DR + pred_term) / mu


def migration_waste(T, q, C, DR, M, mu, r, p):
    """Equation (3): proactive migration, branchless."""
    p_safe = torch.where(r > 0.0, p, 1.0)
    pred_term = torch.where(r > 0.0, (q * r / p_safe) * M, 0.0)
    return C / T + ((1.0 - r * q) * (T / 2.0 + DR) + pred_term) / mu


def instant_waste(T, q, C, DR, mu, r, p, E_f):
    """Equation (5): strategy Instant, branchless."""
    p_safe = torch.where(r > 0.0, p, 1.0)
    pred_term = torch.where(r > 0.0, (q * r / p_safe) * C, 0.0)
    lost = q * r * torch.minimum(E_f, T / 2.0)
    return C / T + ((1.0 - r * q) * T / 2.0 + DR + pred_term + lost) / mu


def nockpt_waste(T, q, C, DR, mu, r, p, I, E_f):
    """Equation (6): strategy NoCkptI, branchless.

    The ``r <= 0`` fallback and the validity clamp ``I' <= mu_P`` of the
    scalar model become selects; divisor inputs are substituted with
    benign values on untaken branches so the derivatives stay NaN-free."""
    r_safe = torch.where(r > 0.0, r, 0.5)
    p_safe = torch.where(r > 0.0, p, 1.0)
    m_p = p_safe * mu / r_safe
    m_np = mu / (1.0 - r_safe)
    ip = torch.minimum(i_prime(q, p_safe, I, E_f), m_p)
    reg_frac = 1.0 - ip / m_p
    w = (reg_frac / T + q / m_p) * C
    w = w + (p_safe * (1.0 - q) / m_p) * (T / 2.0)
    w = w + (p_safe * q / m_p) * E_f
    w = w + reg_frac / m_np * (T / 2.0)
    w = w + (p_safe / m_p + reg_frac / m_np) * DR
    return torch.where(r > 0.0, w, young_waste(T, C, DR, mu))


def withckpt_waste(T, T_P, q, C, DR, mu, r, p, I, E_f):
    """Equation (4): strategy WithCkptI, branchless (see nockpt_waste)."""
    r_safe = torch.where(r > 0.0, r, 0.5)
    p_safe = torch.where(r > 0.0, p, 1.0)
    m_p = p_safe * mu / r_safe
    m_np = mu / (1.0 - r_safe)
    ip = torch.minimum(i_prime(q, p_safe, I, E_f), m_p)
    reg_frac = 1.0 - ip / m_p
    w = (reg_frac / T + (ip / m_p) / T_P + q / m_p) * C
    w = w + (p_safe * (1.0 - q) / m_p) * (T / 2.0)
    w = w + (p_safe * q / m_p) * T_P
    w = w + reg_frac / m_np * (T / 2.0)
    w = w + (p_safe / m_p + reg_frac / m_np) * DR
    return torch.where(r > 0.0, w, young_waste(T, C, DR, mu))


def two_level_waste(T_m, T_d, C_m, C_d, D, R_m, R_d, mu, f, r, q, p):
    """Beyond-paper two-level model, branchless over per-cell columns.

    ``D`` / ``R_m`` / ``R_d`` are kept separate, as in
    :func:`repro_torch.core.waste.waste_two_level` (callers holding folded
    ``DR`` columns pass ``D=0``: the terms only ever appear summed).
    Prediction shields only the memory-tier work loss: a disk-tier
    failure destroys the proactive memory checkpoint along with the
    tier."""
    w = C_m / T_m + C_d / T_d
    w = w + (
        f * ((1.0 - r * q) * T_m / 2.0 + D + R_m)
        + (1.0 - f) * (T_d / 2.0 + D + R_d)
    ) / mu
    p_safe = torch.where(r > 0.0, p, 1.0)
    pred = torch.where((r > 0.0) & (q > 0.0), (q * r / p_safe) * C_m / mu, 0.0)
    return w + pred


def silent_waste(T, C, V, DR, mu, k):
    """Silent-error waste (arXiv:1310.8486, see ``waste.waste_silent``)
    branchless over per-cell columns: ``k`` periods per verification, a
    latent corruption forfeits the whole pattern plus recovery ``DR``."""
    return (k * C + V) / (k * T) + (k * T + V + DR) / mu


def cell_waste(
    T, mode, q, C, DR, lead_act, mu, r, p, window, T_P, tp_eff,
    C2, DR2, V, fmem, rho, kv,
):
    """Mode-dispatched waste over the fused engine's per-cell columns.

    One select chain: mode "exact" means Equation (1), or Equation (5)
    when the predictor is window-based; ``lead_act`` is the engine's
    migration-or-checkpoint lead column (M for migration cells, C
    otherwise); a NaN ``T_P`` (the fill of cells other than WithCkptI) is
    replaced by the table's benign default so every branch stays finite
    under differentiation; and mode "none" / untrusted / recall-free
    cells fall back to Young's model exactly like the scalar dispatch."""
    E_f = 0.5 * window
    tp = torch.where(torch.isnan(T_P), tp_eff, T_P)
    w_y = young_waste(T, C, DR, mu)
    w = torch.where(
        window > 0.0,
        instant_waste(T, q, C, DR, mu, r, p, E_f),
        exact_waste(T, q, C, DR, mu, r, p),
    )
    w = torch.where(
        mode == _M_MIGRATION, migration_waste(T, q, C, DR, lead_act, mu, r, p), w
    )
    w = torch.where(
        mode == _M_NOCKPT, nockpt_waste(T, q, C, DR, mu, r, p, window, E_f), w
    )
    w = torch.where(
        mode == _M_WITHCKPT,
        withckpt_waste(T, tp, q, C, DR, mu, r, p, window, E_f),
        w,
    )
    w = torch.where((mode == _M_NONE) | (q <= 0.0) | (r <= 0.0), w_y, w)
    w = torch.where(
        mode == _M_TWO_LEVEL,
        two_level_waste(T, rho * T, C, C2, 0.0, DR, DR2, mu, fmem, r, q, p),
        w,
    )
    return torch.where(mode == _M_SILENT, silent_waste(T, C, V, DR, mu, kv), w)


# --------------------------------------------------------------------------- #
# Batched safeguarded-Newton period optimization
# --------------------------------------------------------------------------- #
def waste_derivatives(T, cols):
    """Every cell's ``(W', W'')`` at ``T`` (``cols``: :func:`cell_waste`'s
    column arguments after ``T``).  The cells are independent, so the
    gradient of the summed waste is each cell's own derivative."""
    with torch.enable_grad():
        T = T.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(cell_waste(T, *cols).sum(), T, create_graph=True)
        (h,) = torch.autograd.grad(g.sum(), T)
    return g.detach(), h


def _newton_step(cols, T, lo_b, hi_b) -> None:
    """One safeguarded-Newton iteration, in place on ``T`` and its
    bracket ``[lo_b, hi_b]``.

    The bracket tracks the derivative's sign change: W' <= 0 moves
    ``lo_b``, W' > 0 moves ``hi_b`` (convexity makes the minimizer the
    unique sign change, or a boundary, which the bracket collapses
    onto).  A Newton step ``T - W'/W''`` is taken when the curvature is
    positive, finite and the step stays strictly inside the bracket;
    otherwise the iteration bisects."""
    g, h = waste_derivatives(T, cols)
    lo_b.copy_(torch.where(g <= 0.0, T, lo_b))
    hi_b.copy_(torch.where(g > 0.0, T, hi_b))
    Tn = T - g / torch.where(h > 0.0, h, 1.0)
    ok = (h > 0.0) & torch.isfinite(Tn) & (Tn > lo_b) & (Tn < hi_b)
    T.copy_(torch.where(ok, Tn, 0.5 * (lo_b + hi_b)))


def _replay_steps(cols, T, lo_b, hi_b) -> None:
    """:data:`NEWTON_ITERS` iterations on the card: the first eager (it
    also readies autograd for capture), the rest as replays of one
    captured iteration.  An iteration is some 530 elementwise kernels,
    each issued by the host in more time than the card takes to run it;
    a replay issues them all with one launch.  The kernels are those of
    the eager loop, so the result is the same bit for bit, and nothing
    here waits on the card."""
    dev = T.device
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        _newton_step(cols, T, lo_b, hi_b)
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin()
        _newton_step(cols, T, lo_b, hi_b)
        graph.capture_end()
        for _ in range(NEWTON_ITERS - 1):
            graph.replay()
    torch.cuda.current_stream(dev).wait_stream(stream)


def _solve_bracket(cols, T0, lo, hi):
    """Safeguarded Newton (:func:`_newton_step`) on one convex
    sub-interval, all cells at once, for :data:`NEWTON_ITERS`
    iterations: the bisections alone bound the error by
    ``(hi - lo) * 2**-NEWTON_ITERS`` even if Newton never fires.  CUDA
    tensors replay one captured iteration (:func:`_replay_steps`)."""
    T = torch.clamp(T0, lo, hi)
    lo_b, hi_b = lo.clone(), hi.clone()
    if T.is_cuda:
        _replay_steps(cols, T, lo_b, hi_b)
    else:
        for _ in range(NEWTON_ITERS):
            _newton_step(cols, T, lo_b, hi_b)
    return T


def newton_policy(
    mode, q, C, DR, lead_act, mu, r, p, window, T_P, tp_eff,
    C2, DR2, V, fmem, rho, kv,
    lo, hi0, hi1,
):
    """Batched period optimization over a cell table, in one call.

    Solves the trusted branch (q as tabled) on ``[lo, hi1]``, split at
    the Instant kink ``T = window``, and the untrusted q = 0 branch on
    ``[lo, hi0]``, then keeps the better operating point per cell (the
    waste is affine in q, so the optimum is at q = 0 or q = q_eff, as in
    the host case analyses).  The three bracket solves run as one batch
    of ``3 n`` rows, elementwise the reference's three solves.  The
    two-level / silent-error columns (``C2``/``DR2``/``V``/``fmem``/
    ``rho``/``kv``) are benign fills (0/0/0/0/1/1) on every other mode's
    cells.  Every argument is an ``(n,)`` f64 tensor (``mode`` int32) on
    one device.  Returns ``(T, q, waste, T0, waste0, T1, waste1)`` with
    ``waste`` min'd against 1 like
    :class:`~repro_torch.core.periods.OptimalPolicy`."""
    n = C.shape[0]
    extra = (C2, DR2, V, fmem, rho, kv)
    cols1 = (mode, q, C, DR, lead_act, mu, r, p, window, T_P, tp_eff) + extra
    zq = torch.zeros_like(q)
    cols0 = (mode, zq, C, DR, lead_act, mu, r, p, window, T_P, tp_eff) + extra

    t0_guess = torch.sqrt(2.0 * mu * C)
    den = torch.clamp(1.0 - r * q, min=0.015625)
    t1_guess = torch.sqrt(2.0 * mu * C / den)

    knot = torch.minimum(torch.maximum(window, lo), hi1)
    # rows [0, n): Ta on [lo, knot]; [n, 2n): Tb on [knot, hi1]; [2n, 3n):
    # T0 at q = 0 on [lo, hi0]
    cols = tuple(torch.cat((a, a, b)) for a, b in zip(cols1, cols0))
    T_all = _solve_bracket(
        cols,
        torch.cat((torch.minimum(t0_guess, knot), torch.maximum(t1_guess, knot),
                   t0_guess)),
        torch.cat((lo, knot, lo)),
        torch.cat((knot, hi1, hi0)),
    )
    w_all = cell_waste(T_all, *cols)
    Ta, Tb, T0 = T_all[:n], T_all[n:2 * n], T_all[2 * n:]
    wa, wb, w0 = w_all[:n], w_all[n:2 * n], w_all[2 * n:]
    T1 = torch.where(wa <= wb, Ta, Tb)
    w1 = torch.minimum(wa, wb)

    use1 = (w1 < w0) & (q > 0.0) & (r > 0.0)
    T = torch.where(use1, T1, T0)
    qs = torch.where(use1, q, 0.0)
    w = torch.where(use1, w1, w0)
    return T, qs, torch.clamp(w, max=1.0), T0, w0, T1, w1
