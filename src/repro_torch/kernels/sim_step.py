"""The device lane machine's hot step: plain PyTorch versions and the
CUDA kernel wrappers.

:func:`masked_primitive_update` runs one masked primitive per lane (fault
check, clock / saved / unsaved / period-work update, int32 outcome
bitfield) and, in device trace mode, refills the strike cursor of the
lanes that faulted.  :func:`masked_stream_advance` advances a renewal
stream cursor by one event where a mask is set.  Both wrap hand-written
CUDA kernels (``csrc/sim_step.cu``, built by :mod:`.build`) that replace
the reference's Pallas kernels of the same names.

:func:`masked_prediction_walk`, :func:`masked_strike_walk` and
:func:`masked_silent_walk` carry the lane machine's cursor loops in one
launch each: the prediction walk is the walk of the lookahead fault
cursor to the next visible true positive together with the skip over
predictions whose action point has passed (with fractional trust, both
streams thinned by per-event trust coins), the strike walk the
stale-fault cascade of the strike cursor, the silent walk the
consumption of latent (silent-error) strikes up to the clock.  Each lane
advances its cursor as far as its own stop condition needs, inside the
kernel, with no host sync; their plain versions, :func:`prediction_walk`,
:func:`strike_walk` and :func:`silent_walk`, are the same loops in masked
passes over all lanes, each pass's condition one host sync.  Every
wrapper updates its state arguments in place and returns them.

The host trace mode reads host-drawn event slabs laid out ``(events,
lanes)`` through per-lane int64 cursors; its three cursor loops are one
launch each too: :func:`masked_slab_prediction_skip` (the skip over
predictions whose action point has passed), :func:`masked_slab_strike_walk`
(a migration's cancel mark, then the stale-fault cascade) and
:func:`masked_slab_silent_walk` (latent strikes up to the clock), with
plain versions :func:`slab_prediction_skip`, :func:`slab_strike_walk` and
:func:`slab_silent_walk`.  Its primitive is :func:`masked_primitive_update`
without a stream, the trace-fed body, counted apart in
``.host_launches``.

The device-trace kernels come in two variants.  The single-law one takes one
``(kind, param)`` per launch and stream; the law-indexed one
(``kind="indexed"``, the mixed-law sweep) takes three more per-lane
inputs, the int32 law code and the ``s1`` / ``s2`` shape slots of
:func:`~repro_torch.core.events.law_table`, and draws each lane's gap
under its own law.  Each wrapper counts the launches of the two variants
apart: ``.launches`` and ``.indexed_launches``.

Every function the kernels compute also exists here as plain PyTorch:
the counter-based RNG (Threefry-2x32, SplitMix64, ``uniform24``), the
inverse-CDF gap transforms, :func:`stream_advance`,
:func:`primitive_update` and the three walks.  A wrapper given CPU tensors
runs the plain version; given CUDA tensors it launches its kernel or
raises.  torch has no ``>>`` for unsigned 64-bit integers on the CPU and
``>>`` on int64 is arithmetic, so the plain RNG works on int64 bit
patterns: multiplies wrap around and right shifts are masked to be
logical.  32-bit words travel as non-negative int64 values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.events import (
    _SM_GAMMA, _SM_MIX1, _SM_MIX2, _TF_PARITY, _TF_ROTATIONS, THREEFRY_ROUNDS,
    LAW_EXPONENTIAL, LAW_LOGNORMAL, LAW_UNIFORM, LAW_WEIBULL, STREAM_FAULT_GAP,
    STREAM_FP_GAP, STREAM_FP_TRUST, STREAM_TP_COIN, STREAM_TP_TRUST, law_constants,
    stream_key64_np,
)

__all__ = [
    "PRIM_NOOP", "PRIM_WORK", "PRIM_IDLE", "PRIM_CKPT", "PRIM_WORK_NC",
    "FLAG_FAULTED", "FLAG_OK", "FLAG_FIN", "FLAG_CKPT_OK", "FLAG_REG",
    "threefry2x32", "splitmix64", "uniform24", "stream_key",
    "counter_words", "counter_uniform", "counter_uniform2",
    "law_constants", "gap_transform", "gap_transform_indexed",
    "stream_advance", "primitive_update", "prediction_walk", "strike_walk",
    "silent_walk", "masked_stream_advance", "masked_primitive_update",
    "masked_prediction_walk", "masked_strike_walk", "masked_silent_walk",
    "PREDICTION_CURSORS", "take", "slab_prediction_skip", "slab_strike_walk",
    "slab_silent_walk", "masked_slab_prediction_skip", "masked_slab_strike_walk",
    "masked_slab_silent_walk", "sample_slab_state",
    "cell_gather", "segment_cell_sums", "sample_lane_state", "SAMPLE_LAWS",
    "sample_lane_laws", "sample_walk_state", "lane_state_tensors",
]

#: primitive kinds (0-3 shared with repro_torch.core.batch_sim's _PR_* codes;
#: 4 is work not credited toward the regular period)
PRIM_NOOP, PRIM_WORK, PRIM_IDLE, PRIM_CKPT, PRIM_WORK_NC = 0, 1, 2, 3, 4

#: outcome bitfield
FLAG_FAULTED = 1  # a fault interrupted the primitive
FLAG_OK = 2  # primitive completed without fault
FLAG_FIN = 4  # the work segment finished the job
FLAG_CKPT_OK = 8  # a checkpoint committed (saved <- saved + unsaved)
FLAG_REG = 16  # ... and it was a *regular* (period-resetting) checkpoint

_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * 3.141592653589793


def _i64(c: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# --------------------------------------------------------------------------- #
# Counter-based RNG
# --------------------------------------------------------------------------- #
def threefry2x32(k0, k1, c0, c1, rounds: int = THREEFRY_ROUNDS):
    """Threefry-2x32 over 32-bit words held in int64 tensors (Random123
    layout; bit-identical to ``repro_torch.core.events.threefry2x32``)."""
    ks = (k0, k1, k0 ^ k1 ^ _TF_PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(rounds):
        r = _TF_ROTATIONS[(i // 4) % 2][i % 4]
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
        x1 = x1 ^ x0
        if i % 4 == 3:
            s = i // 4 + 1
            x0 = (x0 + ks[s % 3]) & _M32
            x1 = (x1 + ks[(s + 1) % 3] + s) & _M32
    return x0, x1


def splitmix64(key64: torch.Tensor, ctr: torch.Tensor):
    """Counter-indexed SplitMix64 draw ``mix(key64 + (ctr + 1) * GAMMA)``
    of an int64 key bit pattern: the (high, low) 32-bit output words."""
    z = key64 + (ctr.to(torch.int64) + 1) * _i64(_SM_GAMMA)
    z = (z ^ _shr(z, 30)) * _i64(_SM_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_SM_MIX2)
    z = z ^ _shr(z, 31)
    return _shr(z, 32), z & _M32


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> f64 uniforms in the open interval (0, 1): the top 24
    bits, centered by half an ulp."""
    return ((bits >> 8).to(torch.float64) + 0.5) * 2.0**-24


def stream_key(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """Pack a Threefry subkey pair into the SplitMix64 key ``(k0 << 32) |
    k1`` (an int64 bit pattern)."""
    return (k0 << 32) | k1


def counter_words(key: torch.Tensor, ctr: torch.Tensor):
    """Output words of draw ``ctr`` of the stream keyed ``key``."""
    return splitmix64(key, ctr)


def counter_uniform(key: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Draw ``ctr``'s uniform from the stream keyed ``key``."""
    return uniform24(counter_words(key, ctr)[0])


def counter_uniform2(key: torch.Tensor, ctr: torch.Tensor):
    """Both uniforms of one draw (the TP coin stream: word 0 is the
    predicted coin, word 1 the window-offset fraction)."""
    x0, x1 = counter_words(key, ctr)
    return uniform24(x0), uniform24(x1)


# --------------------------------------------------------------------------- #
# Inverse-CDF gap transform
# --------------------------------------------------------------------------- #
def gap_transform(kind: str, param: float, mean, x0, x1) -> torch.Tensor:
    """Inverse-CDF inter-arrival gap of one counter draw (f64).  Only the
    lognormal law consumes the second word (Box–Muller phase).  Clamped to
    the ``1e-9`` zero-gap guard."""
    law, p1, p2 = law_constants(kind, param)
    u = uniform24(x0)
    if law == LAW_EXPONENTIAL:
        g = -torch.log1p(-u) * mean
    elif law == LAW_WEIBULL:
        nlog = -torch.log1p(-u)
        # the reference compiler's static-exponent pow strength reductions
        if p2 == 2.0:
            p = nlog * nlog
        elif p2 == 0.5:
            p = torch.sqrt(nlog)
        else:
            p = torch.pow(nlog, p2)
        g = (mean * p1) * p
    elif law == LAW_LOGNORMAL:
        z = torch.sqrt(-2.0 * torch.log(u)) * torch.cos(_TWO_PI * uniform24(x1))
        g = torch.exp((torch.log(mean) - p2) + p1 * z)
    else:  # LAW_UNIFORM
        g = (2.0 * mean) * u
    return torch.clamp(g, min=1e-9)


def gap_transform_indexed(law, s1, s2, mean, x0, x1) -> torch.Tensor:
    """Law-indexed :func:`gap_transform`: ``law`` is the per-lane int32 law
    code, ``(s1, s2)`` the per-lane shape slots of
    :func:`~repro_torch.core.events.law_table` (the ``p1`` / ``p2`` of
    :func:`law_constants`).  Every family's expression is evaluated and
    one ``where`` chain selects, as the reference's
    ``gap_transform_indexed``; each branch is :func:`gap_transform`'s
    expression, with the ``s2 == 2.0`` / ``s2 == 0.5`` strength
    reductions as selects, so each law's lanes get the single-law bits."""
    u = uniform24(x0)
    nlog = -torch.log1p(-u)
    g_exp = nlog * mean
    p = torch.pow(nlog, s2)
    p = torch.where(s2 == 2.0, nlog * nlog, p)
    p = torch.where(s2 == 0.5, torch.sqrt(nlog), p)
    g_wei = (mean * s1) * p
    z = torch.sqrt(-2.0 * torch.log(u)) * torch.cos(_TWO_PI * uniform24(x1))
    g_log = torch.exp((torch.log(mean) - s2) + s1 * z)
    g_uni = (2.0 * mean) * u
    g = torch.where(
        law == LAW_WEIBULL, g_wei,
        torch.where(law == LAW_LOGNORMAL, g_log,
                    torch.where(law == LAW_UNIFORM, g_uni, g_exp)),
    )
    return torch.clamp(g, min=1e-9)


def stream_advance(mask, ctr, tm, key, mean, horizon, *, kind: str, param: float,
                   law=None, lp=None):
    """Advance a renewal-stream cursor ``(ctr, tm)`` by one event where
    ``mask``: draw gap ``ctr + 1``, accumulate the event date, retire the
    stream (``+inf``) past the horizon.  Returns new tensors.

    ``kind="indexed"`` draws through :func:`gap_transform_indexed`:
    ``law`` is the per-lane law code and ``lp`` the ``(s1, s2)`` slot
    pair (``param`` is ignored)."""
    c2 = ctr + 1
    x0, x1 = counter_words(key, c2)
    if kind == "indexed":
        g = gap_transform_indexed(law, lp[0], lp[1], mean, x0, x1)
    else:
        g = gap_transform(kind, param, mean, x0, x1)
    t2 = tm + g
    t2 = torch.where(t2 > horizon, math.inf, t2)
    return torch.where(mask, c2, ctr), torch.where(mask, t2, tm)


# --------------------------------------------------------------------------- #
# Masked primitive update
# --------------------------------------------------------------------------- #
def primitive_update(
    prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
    *, eps: float, reg_cont: int, stream=None, gap=None,
):
    """One masked primitive execution per lane.  ``target`` is already
    capped at job completion, ``ckend`` fixed from the pre-fault-resolution
    clock, ``nf`` each lane's next pending fault.  Returns ``(t, saved,
    unsaved, period_work, flags)`` as new tensors.

    With ``stream = (key, ctr, tm, mean, horizon)`` (``tm`` the strike
    cursor date, equal to ``nf``) and ``gap = (kind, param)``, the lanes
    that faulted draw their next fault and the advanced ``(ctr, tm)`` is
    appended to the returned tuple.  The law-indexed variant takes the
    8-tuple ``(key, ctr, tm, mean, horizon, law, s1, s2)`` and ``gap =
    ("indexed", 0.0)``."""
    creditb = prim == PRIM_WORK
    workm = creditb | (prim == PRIM_WORK_NC)
    idlem = prim == PRIM_IDLE
    ckm = prim == PRIM_CKPT
    res = workm | idlem | ckm

    faulted = ((workm | idlem) & (nf <= target)) | (ckm & (nf < ckend))
    ok = res & ~faulted

    t1 = torch.where(faulted, nf + DR, t)
    unsaved1 = torch.where(faulted, 0.0, unsaved)
    pw1 = torch.where(faulted, 0.0, pw)

    wok = workm & ok
    dt = target - t
    unsaved2 = torch.where(wok, unsaved1 + dt, unsaved1)
    pw2 = torch.where(wok & creditb, pw1 + dt, pw1)
    t2 = torch.where(wok, target, t1)
    fin = wok & (saved + unsaved2 >= W - eps)

    iok = idlem & ok
    t3 = torch.where(iok, target, t2)

    cok = ckm & ok
    t4 = torch.where(cok, ckend, t3)
    saved2 = torch.where(cok, saved + unsaved2, saved)
    unsaved3 = torch.where(cok, 0.0, unsaved2)
    reg = cok & (cont == reg_cont)
    pw3 = torch.where(reg, 0.0, pw2)

    i32 = torch.int32
    flags = (
        faulted.to(i32) * FLAG_FAULTED
        + ok.to(i32) * FLAG_OK
        + fin.to(i32) * FLAG_FIN
        + cok.to(i32) * FLAG_CKPT_OK
        + reg.to(i32) * FLAG_REG
    )
    if stream is None:
        return t4, saved2, unsaved3, pw3, flags
    skey, sctr, stm, smean, shorizon = stream[:5]
    law, lp = (stream[5], stream[6:8]) if len(stream) == 8 else (None, None)
    sctr, stm = stream_advance(
        faulted, sctr, stm, skey, smean, shorizon, kind=gap[0], param=gap[1],
        law=law, lp=lp,
    )
    return t4, saved2, unsaved3, pw3, flags, sctr, stm


# --------------------------------------------------------------------------- #
# The cursor walks
# --------------------------------------------------------------------------- #
#: the prediction cursors a walk updates, in argument order: the lookahead
#: fault cursor, the pending true-positive slot (window start, fault date,
#: fault counter) and the false-prediction cursor
PREDICTION_CURSORS = ("la_ctr", "la_time", "tp_t0", "tp_ft", "tp_ctr", "fp_ctr", "fp_time")


def _sync(tally):
    """The loop condition of a plain walk: ``tally.any`` (which counts the
    host syncs), or a bare ``bool(mask.any())``."""
    return tally.any if tally is not None else (lambda m: bool(m.any()))


def prediction_walk(
    mask, fp_mask, la_ctr, la_time, tp_t0, tp_ft, tp_ctr, fp_ctr, fp_time,
    f_key, f_mean, tc_key, recall, window, fp_key, fp_mean, horizon,
    *, f_gap, fp_gap, f_law=None, f_lp=None, fp_law=None, fp_lp=None,
    until=None, tt_key=None, ft_key=None, q_eff=None, tally=None,
):
    """Refill the prediction cursors (:data:`PREDICTION_CURSORS`).  Returns
    the seven as new tensors.

    Without ``until``: walk the lookahead fault cursor (keyed ``f_key``,
    mean ``f_mean``) to the next visible true positive where ``mask``
    (coin ``u < recall`` of the TP-coin stream ``tc_key`` and a finite
    date: ``tp_t0 = max(0, date - u_off * window)``; a cursor that dies
    past the horizon empties the slot to ``inf`` / ``nan``), and draw the
    next false prediction where ``fp_mask``.  With ``until = (t,
    lead_act)`` (``fp_mask`` None): on the lanes of ``mask``, consume from
    the merged (pending-TP, next-FP) head while its action point
    ``min(tp_t0, fp_time) - lead_act`` is before ``t``.

    Fractional trust (``tt_key``, ``ft_key`` and ``q_eff`` given, or all
    None): a true positive is visible only if also its trust coin
    ``counter_uniform(tt_key, ctr) < q_eff``, and the false-prediction
    draw repeats until a coin ``counter_uniform(ft_key, ctr) < q_eff`` or
    the stream's end.  Without them (trust q in {0, 1}) every drawn false
    prediction is visible: one draw.

    ``f_gap`` / ``fp_gap`` are each stream's ``(kind, param)``; a kind
    ``"indexed"`` takes that stream's per-lane ``*_law`` and ``*_lp = (s1,
    s2)``.  Masked passes over all lanes, each pass's condition one host
    sync through ``tally.any`` (:func:`_sync`)."""
    any_ = _sync(tally)
    trust = q_eff is not None

    def consume(use_tp, use_fp):
        nonlocal la_ctr, la_time, tp_t0, tp_ft, tp_ctr, fp_ctr, fp_time

        def draw_fp(act):
            return stream_advance(
                act, fp_ctr, fp_time, fp_key, fp_mean, horizon,
                kind=fp_gap[0], param=fp_gap[1], law=fp_law, lp=fp_lp,
            )

        if trust:
            act = use_fp
            while any_(act):
                fp_ctr, fp_time = draw_fp(act)
                vis = counter_uniform(ft_key, fp_ctr) < q_eff
                act = act & ~vis & torch.isfinite(fp_time)
        else:
            fp_ctr, fp_time = draw_fp(use_fp)
        act = use_tp
        # advance-then-check, ~1/(recall q) expected passes
        while any_(act):
            la_ctr, la_time = stream_advance(
                act, la_ctr, la_time, f_key, f_mean, horizon,
                kind=f_gap[0], param=f_gap[1], law=f_law, lp=f_lp,
            )
            u_coin, u_off = counter_uniform2(tc_key, la_ctr)
            vis = u_coin < recall
            if trust:
                vis = vis & (counter_uniform(tt_key, la_ctr) < q_eff)
            alive = torch.isfinite(la_time)
            good = act & vis & alive
            dead = act & ~alive
            tp_t0 = torch.where(
                good, torch.clamp(la_time - u_off * window, min=0.0), tp_t0
            ).masked_fill(dead, math.inf)
            tp_ft = torch.where(good, la_time, tp_ft).masked_fill(dead, math.nan)
            tp_ctr = torch.where(good, la_ctr, tp_ctr)
            act = act & ~(good | dead)

    if until is None:
        consume(mask, fp_mask)
    else:
        t, lead_act = until
        while True:
            adv = mask & (torch.minimum(tp_t0, fp_time) - lead_act < t)
            if not any_(adv):
                break
            use_tp = adv & (tp_t0 <= fp_time)
            consume(use_tp, adv & ~use_tp)
    return la_ctr, la_time, tp_t0, tp_ft, tp_ctr, fp_ctr, fp_time


def strike_walk(
    res, t, sf_ctr, sf_time, n_faults, DR, key, mean, horizon,
    *, kind: str, param: float, law=None, lp=None, cancels=None, tally=None,
):
    """Resolve stale faults on the lanes of ``res``: while the strike
    cursor ``(sf_ctr, sf_time)`` is dated before ``t`` (or, given the three
    ``cancels`` slots of a migration grid, its counter is cancelled), a
    fault within the repair window ``DR`` restarts the repair (``t = date
    + DR``, one more fault; cancelled faults are skipped), then the cursor
    draws its next fault.  Returns ``(t, sf_ctr, sf_time, n_faults)`` as
    new tensors.  ``kind="indexed"`` takes the per-lane ``law`` and ``lp =
    (s1, s2)``.  Masked passes, each pass's condition one host sync
    through ``tally.any``."""
    any_ = _sync(tally)
    while True:
        stale = sf_time < t
        if cancels is not None:
            cc = (sf_ctr == cancels[0]) | (sf_ctr == cancels[1]) | (sf_ctr == cancels[2])
            stepm = res & (cc | stale)
        else:
            stepm = res & stale
        if not any_(stepm):
            break
        hit = stepm & (sf_time >= t - DR)
        if cancels is not None:
            hit &= ~cc
        t = torch.where(hit, sf_time + DR, t)
        n_faults = n_faults + hit.to(torch.int64)
        sf_ctr, sf_time = stream_advance(
            stepm, sf_ctr, sf_time, key, mean, horizon, kind=kind, param=param,
            law=law, lp=lp,
        )
    return t, sf_ctr, sf_time, n_faults


def silent_walk(
    silr, t, sf_ctr, sf_time, corrupt, key, mean, horizon,
    *, kind: str, param: float, law=None, lp=None, tally=None,
):
    """Consume latent strikes on the lanes of ``silr`` (silent-error
    lanes that ran a primitive): while the strike cursor ``(sf_ctr,
    sf_time)`` is dated at or before ``t``, the strike corrupts the state
    silently (``corrupt = min(corrupt, date)``, the earliest latent
    corruption) and the cursor draws its next strike.  Returns ``(sf_ctr,
    sf_time, corrupt)`` as new tensors.  ``kind="indexed"`` takes the
    per-lane ``law`` and ``lp = (s1, s2)``.  Masked passes, each pass's
    condition one host sync through ``tally.any``."""
    any_ = _sync(tally)
    while True:
        hit = silr & (sf_time <= t)
        if not any_(hit):
            break
        corrupt = torch.where(hit, torch.minimum(corrupt, sf_time), corrupt)
        sf_ctr, sf_time = stream_advance(
            hit, sf_ctr, sf_time, key, mean, horizon, kind=kind, param=param,
            law=law, lp=lp,
        )
    return sf_ctr, sf_time, corrupt


# --------------------------------------------------------------------------- #
# The host trace mode's slab walks
# --------------------------------------------------------------------------- #
def take(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``slab[idx[l], l]`` for every lane ``l`` of an ``(events, lanes)``
    slab and int64 cursors ``idx``."""
    return slab.gather(0, idx.unsqueeze(0)).squeeze(0)


def slab_prediction_skip(mask, t, lead_act, P0, pi, *, tally=None):
    """On the lanes of ``mask``, advance the prediction cursor ``pi`` while
    the window start ``P0[pi]`` less ``lead_act`` is before ``t`` (the
    reference's host-mode skip loop).  A cursor stops at the slab's last
    row.  Returns the new ``pi``.  Masked passes, each pass's condition one
    host sync through ``tally.any``."""
    any_ = _sync(tally)
    last = P0.shape[0] - 1
    while True:
        adv = mask & (take(P0, pi) - lead_act < t) & (pi < last)
        if not any_(adv):
            return pi
        pi = pi + adv.to(pi.dtype)


def slab_strike_walk(res, t, fi, n_faults, rc, F, *, Fcancel=None, can=None,
                     ep_ft=None, tally=None):
    """The host trace mode's stale-fault cascade on the fault slab ``F``
    (the reference's host-mode ``s_cond`` / ``s_body``), with the
    migration cancel before it.

    With ``Fcancel`` (the bool cancel-mark slab of a migration chunk) and
    ``can`` / ``ep_ft``: on the lanes of ``can``, the first row at or
    after ``fi`` whose date is ``ep_ft`` and whose mark is clear gets its
    mark set (rows are sorted, so the search ends at the first later
    date); ``Fcancel`` is updated in place.  Then on the lanes of ``res``,
    while the fault at ``fi`` is before ``t`` or marked: an unmarked fault
    within the repair window ``rc`` restarts the repair (``t = date +
    rc``, one more fault), and ``fi`` moves on.  No cursor passes the
    slab's last row.  Returns ``(t, fi, n_faults)`` as new tensors.
    Masked passes, each pass's condition one host sync through
    ``tally.any``."""
    any_ = _sync(tally)
    last = F.shape[0] - 1
    if can is not None:
        lane = torch.arange(F.shape[1], device=F.device)
        flat = Fcancel.view(-1)
        j, act = fi, can
        while any_(act):
            v = take(F, j)
            cur = take(Fcancel, j)
            hit = act & (v == ep_ft) & ~cur
            flat.scatter_(0, j * F.shape[1] + lane, cur | hit)
            act = act & ~hit & (v <= ep_ft) & (j < last)
            j = j + act.to(j.dtype)
    while True:
        cf = take(F, fi)
        stale = cf < t
        if Fcancel is not None:
            cc = take(Fcancel, fi)
            stepm = res & (cc | stale) & (fi < last)
        else:
            stepm = res & stale & (fi < last)
        if not any_(stepm):
            return t, fi, n_faults
        hit = stepm & (cf >= t - rc)
        if Fcancel is not None:
            hit &= ~cc
        t = torch.where(hit, cf + rc, t)
        n_faults = n_faults + hit.to(n_faults.dtype)
        fi = fi + stepm.to(fi.dtype)


def slab_silent_walk(silr, t, fi, corrupt, F, *, tally=None):
    """On the lanes of ``silr``, while the fault at ``fi`` of the slab
    ``F`` is at or before ``t``: it corrupts the state silently
    (``corrupt = min(corrupt, date)``) and ``fi`` moves on (the
    reference's host-mode ``sc_cond`` / ``sc_body``).  No cursor passes
    the slab's last row.  Returns ``(fi, corrupt)`` as new tensors.
    Masked passes, each pass's condition one host sync through
    ``tally.any``."""
    any_ = _sync(tally)
    last = F.shape[0] - 1
    while True:
        cf = take(F, fi)
        hit = silr & (cf <= t) & (fi < last)
        if not any_(hit):
            return fi, corrupt
        corrupt = torch.where(hit, torch.minimum(corrupt, cf), corrupt)
        fi = fi + hit.to(fi.dtype)


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check(name: str, specs) -> torch.device:
    """Validate ``(arg_name, tensor, dtype[, numel])`` specs: one device,
    the stated dtypes, contiguous; an argument given ``numel`` has that
    many elements, any other is 1-D of the first argument's shape.
    Returns the device."""
    for arg, x, *_ in specs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
    dev = specs[0][1].device
    n = specs[0][1].shape
    for arg, x, dt, *numel in specs:
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected {dt}")
        if numel:
            if x.numel() != numel[0]:
                raise ValueError(
                    f"{name}: {arg} has {x.numel()} elements, expected {numel[0]}"
                )
        elif x.dim() != 1 or x.shape != n:
            raise ValueError(
                f"{name}: {arg} has shape {tuple(x.shape)}, expected {tuple(n)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        # the kernel launches on the current device's stream
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _stream_ptr(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _law_specs(kind: str, law, lp, prefix: str = "") -> list:
    """``_check`` specs of the law-indexed variant's three per-lane inputs
    (none for a single-law call, which must not pass them)."""
    if kind != "indexed":
        if law is not None or lp is not None:
            raise ValueError(f"{prefix}law / {prefix}lp belong to kind='indexed', "
                             f"not {kind!r}")
        return []
    if law is None or lp is None or len(lp) != 2:
        raise ValueError(f"kind='indexed' needs {prefix}law and {prefix}lp=(s1, s2)")
    return [(f"{prefix}law", law, torch.int32), (f"{prefix}s1", lp[0], torch.float64),
            (f"{prefix}s2", lp[1], torch.float64)]


def _law_args(gap, law, lp) -> tuple:
    """One stream's law arguments of a law-indexed walk entry point: the
    per-launch ``(law, p1, p2)`` and the per-lane ``(law, s1, s2)``
    pointers, null for a single-law stream."""
    if gap[0] == "indexed":
        return (LAW_EXPONENTIAL, 0.0, 0.0, law.data_ptr(), lp[0].data_ptr(),
                lp[1].data_ptr())
    return (*law_constants(*gap), None, None, None)


def masked_stream_advance(mask, ctr, tm, key, mean, horizon, *, kind: str, param: float,
                          law=None, lp=None):
    """Advance the renewal-stream cursor ``(ctr, tm)`` by one event where
    ``mask`` (:func:`stream_advance`), **in place**: ``ctr`` (int32) and
    ``tm`` (f64) are both inputs and outputs, and are returned.  ``mask``
    is bool, ``key`` int64, ``mean`` / ``horizon`` f64, all flat ``(L,)``.
    ``kind="indexed"`` also takes the per-lane ``law`` (int32) and ``lp =
    (s1, s2)`` (f64).

    CUDA tensors launch ``sim_step_stream_advance`` (its ``_indexed``
    variant for ``kind="indexed"``); CPU tensors run the plain version.
    ``masked_stream_advance.launches`` counts the single-law kernel's
    launches, ``.indexed_launches`` the law-indexed kernel's."""
    f64 = torch.float64
    dev = _check("masked_stream_advance", [
        ("mask", mask, torch.bool), ("ctr", ctr, torch.int32),
        ("tm", tm, f64), ("key", key, torch.int64),
        ("mean", mean, f64), ("horizon", horizon, f64),
    ] + _law_specs(kind, law, lp))
    if dev.type == "cpu":
        c2, t2 = stream_advance(
            mask, ctr, tm, key, mean, horizon, kind=kind, param=param,
            law=law, lp=lp,
        )
        ctr.copy_(c2)
        tm.copy_(t2)
        return ctr, tm
    from . import build

    lib = build.load("sim_step")
    args = (tm.numel(), mask.data_ptr(), ctr.data_ptr(), tm.data_ptr(),
            key.data_ptr(), mean.data_ptr(), horizon.data_ptr())
    if kind == "indexed":
        rc = lib.sim_step_stream_advance_indexed(
            *args, law.data_ptr(), lp[0].data_ptr(), lp[1].data_ptr(),
            _stream_ptr(dev),
        )
    else:
        rc = lib.sim_step_stream_advance(
            *args, *law_constants(kind, param), _stream_ptr(dev)
        )
    _raise_on("masked_stream_advance", rc)
    if tm.numel():
        if kind == "indexed":
            masked_stream_advance.indexed_launches += 1
        else:
            masked_stream_advance.launches += 1
    return ctr, tm


masked_stream_advance.launches = 0
masked_stream_advance.indexed_launches = 0


def masked_primitive_update(
    prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
    *, eps: float, reg_cont: int, stream=None, gap=None,
):
    """One masked primitive per lane (:func:`primitive_update`), **in
    place**: ``t``, ``saved``, ``unsaved`` and ``pw`` are both inputs and
    outputs.  Returns ``(t, saved, unsaved, pw, flags)`` with a fresh int32
    ``flags``.

    With ``stream = (key, ctr, tm, mean, horizon)`` and ``gap = (kind,
    param)`` (device trace mode), ``tm`` must be the tensor ``nf`` itself:
    the lanes that faulted refill the strike cursor, ``ctr`` and
    ``nf`` are updated in place too, and ``(ctr, nf)`` is appended to the
    returned tuple.  The law-indexed variant takes the 8-tuple ``(key,
    ctr, tm, mean, horizon, law, s1, s2)`` with ``gap = ("indexed",
    0.0)``.  prim / cont / ctr / law are int32, key int64, the rest f64,
    all flat ``(L,)``.

    Without a stream (the host trace mode: ``nf`` read off the host-drawn
    fault slab) it is the trace-fed body, the counterpart of the
    reference's ``_step_kernel``.

    CUDA tensors launch ``sim_step_primitive_update`` (its ``_indexed``
    variant for the 8-tuple); CPU tensors run the plain version.
    ``masked_primitive_update.launches`` counts the single-law kernel's
    launches with a stream, ``.indexed_launches`` the law-indexed
    kernel's, ``.host_launches`` the trace-fed launches (no stream)."""
    f64, i32 = torch.float64, torch.int32
    specs = [
        ("prim", prim, i32), ("cont", cont, i32), ("target", target, f64),
        ("ckend", ckend, f64), ("nf", nf, f64), ("t", t, f64),
        ("saved", saved, f64), ("unsaved", unsaved, f64), ("pw", pw, f64),
        ("W", W, f64), ("DR", DR, f64),
    ]
    indexed = False
    if stream is not None:
        if len(stream) not in (5, 8):
            raise ValueError("masked_primitive_update: stream must be a 5- or 8-tuple")
        skey, sctr, stm, smean, shorizon = stream[:5]
        if stm is not nf:
            raise ValueError(
                "masked_primitive_update: stream[2] must be the nf tensor"
            )
        indexed = gap[0] == "indexed"
        law, lp = (stream[5], stream[6:8]) if len(stream) == 8 else (None, None)
        specs += [
            ("key", skey, torch.int64), ("ctr", sctr, i32),
            ("mean", smean, f64), ("horizon", shorizon, f64),
        ] + _law_specs(gap[0], law, lp)
    dev = _check("masked_primitive_update", specs)
    if dev.type == "cpu":
        out = primitive_update(
            prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
            eps=eps, reg_cont=reg_cont, stream=stream, gap=gap,
        )
        for dst, src in zip((t, saved, unsaved, pw), out[:4]):
            dst.copy_(src)
        if stream is None:
            return t, saved, unsaved, pw, out[4]
        sctr.copy_(out[5])
        nf.copy_(out[6])
        return t, saved, unsaved, pw, out[4], sctr, nf
    from . import build

    lib = build.load("sim_step")
    flags = torch.empty_like(prim)
    head = (
        t.numel(), prim.data_ptr(), cont.data_ptr(), target.data_ptr(),
        ckend.data_ptr(), nf.data_ptr(), t.data_ptr(), saved.data_ptr(),
        unsaved.data_ptr(), pw.data_ptr(), W.data_ptr(), DR.data_ptr(),
        flags.data_ptr(), float(eps), int(reg_cont),
    )
    if indexed:
        rc = lib.sim_step_primitive_update_indexed(
            *head, skey.data_ptr(), sctr.data_ptr(), smean.data_ptr(),
            shorizon.data_ptr(), *(x.data_ptr() for x in stream[5:8]),
            _stream_ptr(dev),
        )
    else:
        if stream is None:
            law, p1, p2 = LAW_EXPONENTIAL, 0.0, 0.0
            gen, kptr, cptr, mptr, hptr = 0, None, None, None, None
        else:
            law, p1, p2 = law_constants(*gap)
            gen = 1
            kptr, cptr = skey.data_ptr(), sctr.data_ptr()
            mptr, hptr = smean.data_ptr(), shorizon.data_ptr()
        rc = lib.sim_step_primitive_update(
            *head, gen, kptr, cptr, mptr, hptr, law, p1, p2, _stream_ptr(dev),
        )
    _raise_on("masked_primitive_update", rc)
    if t.numel():
        if indexed:
            masked_primitive_update.indexed_launches += 1
        elif stream is None:
            masked_primitive_update.host_launches += 1
        else:
            masked_primitive_update.launches += 1
    if stream is None:
        return t, saved, unsaved, pw, flags
    return t, saved, unsaved, pw, flags, sctr, nf


masked_primitive_update.launches = 0
masked_primitive_update.indexed_launches = 0
masked_primitive_update.host_launches = 0


def masked_prediction_walk(
    mask, fp_mask, la_ctr, la_time, tp_t0, tp_ft, tp_ctr, fp_ctr, fp_time,
    f_key, f_mean, tc_key, recall, window, fp_key, fp_mean, horizon,
    *, f_gap, fp_gap, f_law=None, f_lp=None, fp_law=None, fp_lp=None,
    until=None, tt_key=None, ft_key=None, q_eff=None, tally=None,
):
    """:func:`prediction_walk`, **in place**: the seven cursors
    (:data:`PREDICTION_CURSORS`) are both inputs and outputs, and are
    returned.  ``mask`` / ``fp_mask`` are bool, the counters int32, the
    keys int64, the rest f64, all flat ``(L,)``; ``until = (t, lead_act)``
    goes with ``fp_mask=None``; the trust coins' ``tt_key`` / ``ft_key``
    (int64) and ``q_eff`` (f64) come all three or not at all.

    CUDA tensors launch ``sim_step_prediction_walk`` (its ``_indexed``
    variant when either stream's kind is ``"indexed"``): one launch, no
    host sync.  CPU tensors run the plain version, whose loop conditions
    go through ``tally.any``.  ``masked_prediction_walk.launches`` counts
    the single-law kernel's launches, ``.indexed_launches`` the
    law-indexed kernel's."""
    f64, i32, i64 = torch.float64, torch.int32, torch.int64
    cur = (la_ctr, la_time, tp_t0, tp_ft, tp_ctr, fp_ctr, fp_time)
    consts = (f_key, f_mean, tc_key, recall, window, fp_key, fp_mean, horizon)
    trust = (tt_key, ft_key, q_eff)
    specs = [("mask", mask, torch.bool)]
    if until is None:
        if fp_mask is None:
            raise ValueError("masked_prediction_walk: fp_mask is needed without until")
        specs.append(("fp_mask", fp_mask, torch.bool))
        t = lead_act = None
    else:
        if fp_mask is not None:
            raise ValueError("masked_prediction_walk: until=(t, lead_act) takes no fp_mask")
        t, lead_act = until
        specs += [("t", t, f64), ("lead_act", lead_act, f64)]
    specs += list(zip(PREDICTION_CURSORS, cur, (i32, f64, f64, f64, i32, i32, f64)))
    specs += list(zip(
        ("f_key", "f_mean", "tc_key", "recall", "window", "fp_key", "fp_mean", "horizon"),
        consts, (i64, f64, i64, f64, f64, i64, f64, f64),
    ))
    if any(x is not None for x in trust):
        if any(x is None for x in trust):
            raise ValueError("masked_prediction_walk: tt_key, ft_key and q_eff go together")
        specs += list(zip(("tt_key", "ft_key", "q_eff"), trust, (i64, i64, f64)))
    specs += _law_specs(f_gap[0], f_law, f_lp, "f_") + _law_specs(fp_gap[0], fp_law, fp_lp, "fp_")
    dev = _check("masked_prediction_walk", specs)
    if dev.type == "cpu":
        out = prediction_walk(
            mask, fp_mask, *cur, *consts, f_gap=f_gap, fp_gap=fp_gap, f_law=f_law,
            f_lp=f_lp, fp_law=fp_law, fp_lp=fp_lp, until=until, tt_key=tt_key,
            ft_key=ft_key, q_eff=q_eff, tally=tally,
        )
        for dst, src in zip(cur, out):
            dst.copy_(src)
        return cur
    from . import build

    lib = build.load("sim_step")
    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    head = (
        mask.numel(), mask.data_ptr(), ptr(fp_mask), ptr(t), ptr(lead_act),
        *(x.data_ptr() for x in cur), *(x.data_ptr() for x in consts),
        *(ptr(x) for x in trust),
    )
    indexed = "indexed" in (f_gap[0], fp_gap[0])
    if indexed:
        rc = lib.sim_step_prediction_walk_indexed(
            *head, *_law_args(f_gap, f_law, f_lp), *_law_args(fp_gap, fp_law, fp_lp),
            _stream_ptr(dev),
        )
    else:
        rc = lib.sim_step_prediction_walk(
            *head, *law_constants(*f_gap), *law_constants(*fp_gap), _stream_ptr(dev),
        )
    _raise_on("masked_prediction_walk", rc)
    if mask.numel():
        if indexed:
            masked_prediction_walk.indexed_launches += 1
        else:
            masked_prediction_walk.launches += 1
    return cur


masked_prediction_walk.launches = 0
masked_prediction_walk.indexed_launches = 0


def masked_strike_walk(
    res, t, sf_ctr, sf_time, n_faults, DR, key, mean, horizon,
    *, kind: str, param: float, law=None, lp=None, cancels=None, tally=None,
):
    """:func:`strike_walk`, **in place**: ``t``, ``sf_ctr`` (int32),
    ``sf_time`` and ``n_faults`` (int64) are both inputs and outputs, and
    are returned.  ``res`` is bool, ``key`` int64, ``DR`` / ``mean`` /
    ``horizon`` f64, ``cancels`` None or three int32 slots, all flat
    ``(L,)``.

    CUDA tensors launch ``sim_step_strike_walk`` (its ``_indexed`` variant
    for ``kind="indexed"``): one launch, no host sync.  CPU tensors run the
    plain version, whose loop condition goes through ``tally.any``.
    ``masked_strike_walk.launches`` counts the single-law kernel's
    launches, ``.indexed_launches`` the law-indexed kernel's."""
    f64, i32 = torch.float64, torch.int32
    specs = [
        ("res", res, torch.bool), ("t", t, f64), ("sf_ctr", sf_ctr, i32),
        ("sf_time", sf_time, f64), ("n_faults", n_faults, torch.int64),
        ("DR", DR, f64), ("key", key, torch.int64), ("mean", mean, f64),
        ("horizon", horizon, f64),
    ]
    if cancels is not None:
        if len(cancels) != 3:
            raise ValueError("masked_strike_walk: cancels must be three slots")
        specs += [(f"cancel{k}", c, i32) for k, c in enumerate(cancels)]
    specs += _law_specs(kind, law, lp)
    dev = _check("masked_strike_walk", specs)
    state = (t, sf_ctr, sf_time, n_faults)
    if dev.type == "cpu":
        out = strike_walk(
            res, t, sf_ctr, sf_time, n_faults, DR, key, mean, horizon, kind=kind,
            param=param, law=law, lp=lp, cancels=cancels, tally=tally,
        )
        for dst, src in zip(state, out):
            dst.copy_(src)
        return state
    from . import build

    lib = build.load("sim_step")
    head = (
        t.numel(), res.data_ptr(), *(x.data_ptr() for x in state),
        DR.data_ptr(), key.data_ptr(), mean.data_ptr(), horizon.data_ptr(),
        *((c.data_ptr() for c in cancels) if cancels is not None else (None,) * 3),
    )
    if kind == "indexed":
        rc = lib.sim_step_strike_walk_indexed(
            *head, law.data_ptr(), lp[0].data_ptr(), lp[1].data_ptr(), _stream_ptr(dev),
        )
    else:
        rc = lib.sim_step_strike_walk(*head, *law_constants(kind, param), _stream_ptr(dev))
    _raise_on("masked_strike_walk", rc)
    if t.numel():
        if kind == "indexed":
            masked_strike_walk.indexed_launches += 1
        else:
            masked_strike_walk.launches += 1
    return state


masked_strike_walk.launches = 0
masked_strike_walk.indexed_launches = 0


def masked_silent_walk(
    silr, t, sf_ctr, sf_time, corrupt, key, mean, horizon,
    *, kind: str, param: float, law=None, lp=None, tally=None,
):
    """:func:`silent_walk`, **in place**: ``sf_ctr`` (int32), ``sf_time``
    and ``corrupt`` (f64) are both inputs and outputs, and are returned.
    ``silr`` is bool, ``key`` int64, ``t`` / ``mean`` / ``horizon`` f64,
    all flat ``(L,)``.

    CUDA tensors launch ``sim_step_silent_walk`` (its ``_indexed`` variant
    for ``kind="indexed"``): one launch, no host sync.  CPU tensors run
    the plain version, whose loop condition goes through ``tally.any``.
    ``masked_silent_walk.launches`` counts the single-law kernel's
    launches, ``.indexed_launches`` the law-indexed kernel's."""
    f64 = torch.float64
    specs = [
        ("silr", silr, torch.bool), ("t", t, f64), ("sf_ctr", sf_ctr, torch.int32),
        ("sf_time", sf_time, f64), ("corrupt", corrupt, f64),
        ("key", key, torch.int64), ("mean", mean, f64), ("horizon", horizon, f64),
    ] + _law_specs(kind, law, lp)
    dev = _check("masked_silent_walk", specs)
    state = (sf_ctr, sf_time, corrupt)
    if dev.type == "cpu":
        out = silent_walk(silr, t, sf_ctr, sf_time, corrupt, key, mean, horizon,
                          kind=kind, param=param, law=law, lp=lp, tally=tally)
        for dst, src in zip(state, out):
            dst.copy_(src)
        return state
    from . import build

    lib = build.load("sim_step")
    head = (t.numel(), silr.data_ptr(), t.data_ptr(), *(x.data_ptr() for x in state),
            key.data_ptr(), mean.data_ptr(), horizon.data_ptr())
    if kind == "indexed":
        rc = lib.sim_step_silent_walk_indexed(
            *head, law.data_ptr(), lp[0].data_ptr(), lp[1].data_ptr(), _stream_ptr(dev),
        )
    else:
        rc = lib.sim_step_silent_walk(*head, *law_constants(kind, param), _stream_ptr(dev))
    _raise_on("masked_silent_walk", rc)
    if t.numel():
        if kind == "indexed":
            masked_silent_walk.indexed_launches += 1
        else:
            masked_silent_walk.launches += 1
    return state


masked_silent_walk.launches = 0
masked_silent_walk.indexed_launches = 0


def _check_slab(name: str, dev: torch.device, n: int, specs) -> None:
    """Validate ``(arg_name, slab, dtype)`` specs: 2-D ``(rows, n)`` with
    at least one row, contiguous, on ``dev``."""
    for arg, x, dt in specs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected {dt}")
        if x.dim() != 2 or x.shape[1] != n or x.shape[0] < 1:
            raise ValueError(
                f"{name}: {arg} has shape {tuple(x.shape)}, expected (rows, {n})"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")


def masked_slab_prediction_skip(mask, t, lead_act, P0, pi, *, tally=None):
    """:func:`slab_prediction_skip`, **in place**: ``pi`` (int64) is both
    input and output, and is returned.  ``mask`` is bool, ``t`` /
    ``lead_act`` f64, all flat ``(L,)``; ``P0`` is the f64 ``(rows, L)``
    slab.

    CUDA tensors launch ``sim_step_slab_prediction_skip``: one launch, no
    host sync.  CPU tensors run the plain version.
    ``masked_slab_prediction_skip.launches`` counts the launches."""
    f64 = torch.float64
    dev = _check("masked_slab_prediction_skip", [
        ("mask", mask, torch.bool), ("t", t, f64), ("lead_act", lead_act, f64),
        ("pi", pi, torch.int64),
    ])
    _check_slab("masked_slab_prediction_skip", dev, pi.numel(), [("P0", P0, f64)])
    if dev.type == "cpu":
        pi.copy_(slab_prediction_skip(mask, t, lead_act, P0, pi, tally=tally))
        return pi
    from . import build

    rc = build.load("sim_step").sim_step_slab_prediction_skip(
        pi.numel(), P0.shape[0], mask.data_ptr(), t.data_ptr(), lead_act.data_ptr(),
        P0.data_ptr(), pi.data_ptr(), _stream_ptr(dev),
    )
    _raise_on("masked_slab_prediction_skip", rc)
    if pi.numel():
        masked_slab_prediction_skip.launches += 1
    return pi


masked_slab_prediction_skip.launches = 0


def masked_slab_strike_walk(res, t, fi, n_faults, rc, F, *, Fcancel=None, can=None,
                            ep_ft=None, tally=None):
    """:func:`slab_strike_walk`, **in place**: ``t``, ``fi`` (int64) and
    ``n_faults`` (int64) are both inputs and outputs, and are returned;
    ``Fcancel`` (bool, the shape of ``F``) is updated in place.  ``res`` /
    ``can`` are bool, ``rc`` / ``ep_ft`` f64, all flat ``(L,)``; ``F`` is
    the f64 ``(rows, L)`` fault slab.  ``Fcancel``, ``can`` and ``ep_ft``
    come all three (a migration chunk) or not at all.

    CUDA tensors launch ``sim_step_slab_strike_walk``: one launch, no host
    sync.  CPU tensors run the plain version.
    ``masked_slab_strike_walk.launches`` counts the launches."""
    f64 = torch.float64
    specs = [
        ("res", res, torch.bool), ("t", t, f64), ("fi", fi, torch.int64),
        ("n_faults", n_faults, torch.int64), ("rc", rc, f64),
    ]
    mig = (Fcancel, can, ep_ft)
    if any(x is not None for x in mig):
        if any(x is None for x in mig):
            raise ValueError("masked_slab_strike_walk: Fcancel, can and ep_ft go together")
        specs += [("can", can, torch.bool), ("ep_ft", ep_ft, f64)]
    dev = _check("masked_slab_strike_walk", specs)
    slabs = [("F", F, f64)]
    if Fcancel is not None:
        slabs.append(("Fcancel", Fcancel, torch.bool))
        if Fcancel.shape != F.shape:
            raise ValueError("masked_slab_strike_walk: Fcancel is not the shape of F")
    _check_slab("masked_slab_strike_walk", dev, t.numel(), slabs)
    state = (t, fi, n_faults)
    if dev.type == "cpu":
        out = slab_strike_walk(res, t, fi, n_faults, rc, F, Fcancel=Fcancel, can=can,
                               ep_ft=ep_ft, tally=tally)
        for dst, src in zip(state, out):
            dst.copy_(src)
        return state
    from . import build

    ptr = lambda x: x.data_ptr() if x is not None else None  # noqa: E731
    code = build.load("sim_step").sim_step_slab_strike_walk(
        t.numel(), F.shape[0], res.data_ptr(), t.data_ptr(), fi.data_ptr(),
        n_faults.data_ptr(), rc.data_ptr(), F.data_ptr(), *(ptr(x) for x in mig),
        _stream_ptr(dev),
    )
    _raise_on("masked_slab_strike_walk", code)
    if t.numel():
        masked_slab_strike_walk.launches += 1
    return state


masked_slab_strike_walk.launches = 0


def masked_slab_silent_walk(silr, t, fi, corrupt, F, *, tally=None):
    """:func:`slab_silent_walk`, **in place**: ``fi`` (int64) and
    ``corrupt`` (f64) are both inputs and outputs, and are returned.
    ``silr`` is bool, ``t`` f64, all flat ``(L,)``; ``F`` is the f64
    ``(rows, L)`` fault slab.

    CUDA tensors launch ``sim_step_slab_silent_walk``: one launch, no host
    sync.  CPU tensors run the plain version.
    ``masked_slab_silent_walk.launches`` counts the launches."""
    f64 = torch.float64
    dev = _check("masked_slab_silent_walk", [
        ("silr", silr, torch.bool), ("t", t, f64), ("fi", fi, torch.int64),
        ("corrupt", corrupt, f64),
    ])
    _check_slab("masked_slab_silent_walk", dev, t.numel(), [("F", F, f64)])
    state = (fi, corrupt)
    if dev.type == "cpu":
        out = slab_silent_walk(silr, t, fi, corrupt, F, tally=tally)
        for dst, src in zip(state, out):
            dst.copy_(src)
        return state
    from . import build

    rc = build.load("sim_step").sim_step_slab_silent_walk(
        t.numel(), F.shape[0], silr.data_ptr(), t.data_ptr(), fi.data_ptr(),
        corrupt.data_ptr(), F.data_ptr(), _stream_ptr(dev),
    )
    _raise_on("masked_slab_silent_walk", rc)
    if t.numel():
        masked_slab_silent_walk.launches += 1
    return state


masked_slab_silent_walk.launches = 0


# --------------------------------------------------------------------------- #
# Cell multiplexing (fused experiment sweeps)
# --------------------------------------------------------------------------- #
def cell_gather(consts: dict, cidx: torch.Tensor, keys) -> dict:
    """Broadcast per-cell table rows to per-lane tensors: a copy of
    ``consts`` with every key of ``keys`` present in it gathered by the
    lane -> cell index ``cidx``."""
    out = dict(consts)
    for k in keys:
        if k in consts:
            out[k] = consts[k].index_select(0, cidx)
    return out


def segment_cell_sums(values, cidx: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Per-cell sums of per-lane columns: a ``(num_cells, len(values))``
    f64 matrix whose row ``c`` sums the lanes with ``cidx == c``.

    Deterministic on either device: the lanes are put in cell order by a
    stable sort and each cell's lanes summed in one fixed order
    (``segment_reduce``), so a sweep's stats are the same bits run after
    run (CUDA's ``index_add_`` adds by atomics in no fixed order, which
    moved the moments by ~1e-12 from one run to the next).  On the CPU the
    order is lane order, the sequential sum's."""
    x = torch.stack([v.to(torch.float64) for v in values], dim=-1)
    idx = cidx.to(torch.int64)
    order = torch.argsort(idx, stable=True)
    lengths = torch.bincount(idx, minlength=num_cells)
    if lengths.shape[0] != num_cells:
        raise ValueError(f"cidx entries must be in [0, {num_cells})")
    return torch.segment_reduce(x.index_select(0, order), "sum", lengths=lengths,
                                axis=0, unsafe=True)


# --------------------------------------------------------------------------- #
# Sample lane states (kernel checks and timings)
# --------------------------------------------------------------------------- #
def sample_lane_state(L: int, seed: int) -> dict:
    """Seeded NumPy lane states of the kind the lane machine hands the two
    kernels: every primitive kind, faults before and after the targets,
    finishing and non-finishing work, live and retiring streams, half the
    lanes masked.  ``key`` holds uint64 fault-stream keys."""
    rng = np.random.default_rng(seed)
    W = 8 * 86400.0
    t = rng.uniform(0.0, 1.2 * W, L)
    return {
        "prim": rng.integers(0, 5, L).astype(np.int32),
        "cont": rng.integers(-1, 9, L).astype(np.int32),
        "target": t + rng.uniform(0.0, 2e4, L),
        "ckend": t + 600.0,
        "nf": t + rng.uniform(-1e3, 2e4, L),
        "t": t,
        "saved": np.where(rng.random(L) < 0.5, W - rng.uniform(0.0, 2e4, L),
                          rng.uniform(0.0, W, L)),
        "unsaved": rng.uniform(0.0, 5e3, L),
        "pw": rng.uniform(0.0, 5e3, L),
        "W": np.full(L, W),
        "DR": np.full(L, 660.0),
        "key": stream_key64_np(seed, np.arange(L), STREAM_FAULT_GAP),
        "ctr": rng.integers(-1, 5000, L).astype(np.int32),
        "mean": rng.uniform(1e3, 2.5e5, L),
        "horizon": np.where(rng.random(L) < 0.9, 12 * W, t + 1e4),
        "mask": rng.random(L) < 0.5,
    }


#: the laws the law-indexed checks draw lanes from: every family, and both
#: Weibull strength reductions (k = 0.5 gives s2 = 2.0, k = 2.0 s2 = 0.5)
SAMPLE_LAWS = (("exponential", 0.0), ("weibull", 0.7), ("weibull", 0.5),
               ("weibull", 2.0), ("lognormal", 1.0), ("uniform", 0.0))


def sample_lane_laws(L: int, seed: int, block: int = 1) -> dict:
    """Seeded per-lane inputs of the law-indexed variant: each run of
    ``block`` lanes takes one law of :data:`SAMPLE_LAWS` (``block=1``
    mixes laws lane by lane; the sweep's lanes come in runs of one cell).
    ``pick`` is each lane's index into :data:`SAMPLE_LAWS`; ``law``,
    ``s1``, ``s2`` are :func:`law_constants`' values."""
    rng = np.random.default_rng(seed)
    pick = np.repeat(rng.integers(0, len(SAMPLE_LAWS), -(-L // block)), block)[:L]
    consts = np.array([law_constants(k, p) for k, p in SAMPLE_LAWS])
    return {"pick": pick, "law": consts[pick, 0].astype(np.int32),
            "s1": consts[pick, 1], "s2": consts[pick, 2]}


def sample_walk_state(L: int, seed: int) -> dict:
    """Seeded NumPy lane states of the kind the lane machine hands the
    walks: heads of the prediction cursors and strike dates before and
    after the clock (walks of many steps and of none), recall 0.3 or 0.85,
    windows 0 to 3000 s, exhausted lookahead cursors (date ``inf``, slot
    ``inf`` / ``nan``), lanes without false predictions (``fp_mean`` and
    ``fp_time`` ``inf``), horizons that retire cursors mid-walk, cancel
    slots on the strike cursor's counter and the next ones, and masks
    clear on about a third of the lanes; trust ``q_eff`` of 0, 0.3, 0.5
    or 1 with the trust-coin keys, and for the silent walk (on the strike
    walk's cursor) the mask ``silr`` and latent corruptions ``corrupt``,
    ``inf`` on half the lanes.  Keys are uint64 (``f_key``, ``tc_key``,
    ``fp_key``, ``tt_key``, ``ft_key``, and ``key`` of the strike and
    silent walks)."""
    rng = np.random.default_rng(seed)
    W = 8 * 86400.0
    t = rng.uniform(0.0, 1.2 * W, L)
    lanes = np.arange(L)
    horizon = np.where(rng.random(L) < 0.85, 12 * W, t + rng.uniform(0.0, 3e4, L))
    window = rng.choice([0.0, 600.0, 3000.0], L)
    la_time = t + rng.uniform(-4e4, 2e4, L)
    dead = rng.random(L) < 0.05
    la_time[dead] = np.inf
    tp_t0 = np.maximum(la_time - rng.random(L) * window, 0.0)
    no_fp = rng.random(L) < 0.1
    fp_time = np.where(no_fp, np.inf, t + rng.uniform(-5e4, 3e4, L))
    la_ctr = rng.integers(0, 3000, L).astype(np.int32)
    sf_ctr = rng.integers(0, 3000, L).astype(np.int32)

    def cancel(offset, p):
        return np.where(rng.random(L) < p, sf_ctr + offset, -1).astype(np.int32)

    out = {
        "mask": rng.random(L) < 0.7,
        "fp_mask": rng.random(L) < 0.5,
        "t": t,
        "lead_act": rng.choice([60.0, 600.0], L),
        "la_ctr": la_ctr,
        "la_time": la_time,
        "tp_t0": np.where(dead, np.inf, tp_t0),
        "tp_ft": np.where(dead, np.nan, la_time),
        "tp_ctr": la_ctr.copy(),
        "fp_ctr": rng.integers(0, 3000, L).astype(np.int32),
        "fp_time": fp_time,
        "f_key": stream_key64_np(seed, lanes, STREAM_FAULT_GAP),
        "f_mean": rng.uniform(2e3, 5e4, L),
        "tc_key": stream_key64_np(seed, lanes, STREAM_TP_COIN),
        "recall": rng.choice([0.3, 0.85], L),
        "window": window,
        "fp_key": stream_key64_np(seed, lanes, STREAM_FP_GAP),
        "fp_mean": np.where(no_fp, np.inf, rng.uniform(5e3, 1e5, L)),
        "horizon": horizon,
        "res": rng.random(L) < 0.8,
        "sf_ctr": sf_ctr,
        "sf_time": t + rng.uniform(-3e4, 5e3, L),
        "n_faults": rng.integers(0, 50, L).astype(np.int64),
        "DR": rng.choice([660.0, 3600.0], L),
        "key": stream_key64_np(seed + 1, lanes, STREAM_FAULT_GAP),
        "mean": rng.uniform(2e3, 5e4, L),
        "cancel0": cancel(0, 0.2),
        "cancel1": cancel(1, 0.2),
        "cancel2": cancel(3, 0.1),
    }
    # drawn after the keys above, which keep their values
    out.update(
        tt_key=stream_key64_np(seed, lanes, STREAM_TP_TRUST),
        ft_key=stream_key64_np(seed, lanes, STREAM_FP_TRUST),
        q_eff=rng.choice([0.0, 0.3, 0.5, 1.0], L),
        silr=rng.random(L) < 0.5,
        corrupt=np.where(rng.random(L) < 0.5, np.inf, t - rng.uniform(0.0, 5e4, L)),
    )
    return out


def sample_slab_state(L: int, E: int, seed: int) -> dict:
    """Seeded NumPy states of the kind the host trace mode hands the slab
    walks: ``(E, L)`` slabs of sorted dates with ``+inf`` past each lane's
    count (at least the last row; some lanes repeat a date), cursors at or
    before each lane's count, clocks before and well past the cursor's
    date (walks of many rows and of none), about 5% of the fault rows
    marked cancelled, cancelling lanes whose ``ep_ft`` is a later row's
    date (marked or not), a date between rows, or one before the cursor,
    and masks clear on about a third of the lanes."""
    rng = np.random.default_rng(seed)
    rows = np.arange(E)[:, None]

    def slab(mean):
        n = rng.integers(0, E, L)  # valid dates; row E - 1 is always +inf
        n = np.minimum(n, E - 1)
        d = np.cumsum(rng.exponential(mean, (E, L)), axis=0)
        rep = (rng.random(L) < 0.1) & (E > 1)  # a repeated date
        j = rng.integers(0, max(E - 1, 1), L)
        d[j[rep] + 1, np.flatnonzero(rep)] = d[j[rep], np.flatnonzero(rep)]
        return np.where(rows < n[None, :], d, np.inf), n

    F, nf = slab(3e3)
    P0, npr = slab(2e3)
    fi = rng.integers(0, nf + 1)
    pi = rng.integers(0, npr + 1)
    lanes = np.arange(L)
    base = np.where(np.isfinite(F[fi, lanes]), F[fi, lanes], 0.0)
    t = base + rng.uniform(-2e3, 3e4, L)
    ahead = np.minimum(fi + rng.integers(0, 6, L), E - 1)
    ep_ft = np.where(rng.random(L) < 0.7, F[ahead, lanes], base + 1.5)
    ep_ft = np.where(rng.random(L) < 0.1, base - 10.0, ep_ft)
    can = (rng.random(L) < 0.3) & np.isfinite(ep_ft)
    return {
        "F": F, "P0": P0, "fi": fi.astype(np.int64), "pi": pi.astype(np.int64),
        "t": t, "lead_act": rng.choice([60.0, 600.0], L),
        "mask": rng.random(L) < 0.7, "res": rng.random(L) < 0.7,
        "silr": rng.random(L) < 0.5,
        "rc": rng.choice([660.0, 3600.0], L),
        "n_faults": rng.integers(0, 50, L).astype(np.int64),
        "corrupt": np.where(rng.random(L) < 0.5, np.inf, t - rng.uniform(0.0, 5e4, L)),
        "Fcancel": (rng.random((E, L)) < 0.05) & np.isfinite(F),
        "can": can, "ep_ft": ep_ft,
    }


def lane_state_tensors(x: dict, device) -> dict:
    """:func:`sample_lane_state`'s (or :func:`sample_walk_state`'s, or
    :func:`sample_slab_state`'s) arrays
    as the wrappers take them, on ``device``: the uint64 keys as int64 bit
    patterns."""
    out = {}
    for k, v in x.items():
        v = np.array(v)
        if v.dtype == np.uint64:
            v = v.view(np.int64)
        out[k] = torch.from_numpy(v).to(device)
    return out
