"""Lane codes, per-lane parameter packing and the NumPy lane engine.

The port's copy of the reference ``repro.core.batch_sim``: the
strategy-mode codes, the lane phases, the primitive kinds, the
continuation codes with their phase tables, the per-lane parameter
packing and the host trace mode's trust filter :func:`_filter_trusted`,
which the device lane machine (:mod:`repro_torch.core.torch_sim`) runs
on; and :func:`simulate_batch`, the NumPy engine that advances one lane
per trace on the host (``_BatchEngine``, one primitive per live lane an
iteration, clean-period fast-forward, finished lanes repacked away).  It
is the oracle of the torch engine (``engine="batch"``): on the same
traces both give the same counters, and makespans within float rounding
(the fast-forward fuses k periods into one multiply).
``tests/test_torch_host.py`` holds every table here against the
reference, and ``tests/test_torch_host_engines.py`` the engine, bit for
bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Union

import numpy as np

from .events import BatchTraces, TraceSpec, pad_sentinel
from .simulator import _EPS, SimResult, Strategy
from .waste import Platform

__all__ = ["MODE_CODES", "BatchResult", "pad_lane_axis", "simulate_batch"]

#: strategy-mode codes shared with :class:`repro_torch.core.simulator.Strategy`
#: (the reference's two-level and silent codes keep their numbers)
MODE_CODES = {
    "none": 0, "exact": 1, "nockpt": 2, "withckpt": 3, "migration": 4,
    "two_level": 5, "silent": 6,
}
(
    _M_NONE, _M_EXACT, _M_NOCKPT, _M_WITHCKPT, _M_MIGRATION,
    _M_TWO_LEVEL, _M_SILENT,
) = range(7)

# lane phases (continuation points of the scalar engine's control flow)
_PH_MAIN = 0  # top of Algorithm 1's regular-mode loop
_PH_EP_START = 1  # trusted prediction popped; episode entry decision
_PH_EP_PRECKPT = 2  # pre-window proactive checkpoint pending
_PH_EP_NT2 = 3  # "no time" path: uncredited work to t0 pending
_PH_EP_NOCKPT = 4  # NoCkptI: uncredited work to t0 + I pending
_PH_EP_WC = 5  # WithCkptI in-window loop: next segment decision
_PH_EP_WC_CKPT = 6  # WithCkptI proactive checkpoint pending
_PH_DONE = 7  # job complete: lane parked until harvested

# primitive kinds (one per lane per iteration)
_PR_NOOP, _PR_WORK, _PR_IDLE, _PR_CKPT = 0, 1, 2, 3

# continuations applied when a primitive completes without fault
(
    _C_MAIN,  # back to regular mode
    _C_CKPTREG,  # regular ckpt done: act on a prediction that fell inside it?
    _C_POP_EP,  # work-to-action done: pop the prediction, start episode
    _C_PRECKPT,  # work to t0 - C done: take the pre-window checkpoint
    _C_MODE,  # episode head done: dispatch on strategy mode
    _C_NT2,  # degenerate credited work done: uncredited work to t0
    _C_MIG,  # migration idle done: count it, back to regular mode
    _C_WC_CKPT,  # in-window work segment done: proactive checkpoint
    _C_WC,  # in-window checkpoint done: loop
) = range(9)

#: continuation -> next phase; special codes (_C_CKPTREG, _C_POP_EP, _C_MODE,
#: _C_MIG) get the MAIN placeholder and are patched by dedicated handlers
_CONT2PH = np.array(
    [
        _PH_MAIN, _PH_MAIN, _PH_MAIN, _PH_EP_PRECKPT, _PH_MAIN,
        _PH_EP_NT2, _PH_MAIN, _PH_EP_WC_CKPT, _PH_EP_WC,
    ],
    dtype=np.int8,
)

#: strategy mode -> phase after the episode head (Instant returns to regular
#: mode, NoCkptI idles through the window, WithCkptI enters the T_P loop;
#: the two-level and silent rows of the reference are MAIN)
_MODE2PH = np.array(
    [_PH_MAIN, _PH_MAIN, _PH_EP_NOCKPT, _PH_EP_WC, _PH_MAIN,
     _PH_MAIN, _PH_MAIN],
    dtype=np.int8,
)


@dataclass
class BatchResult:
    """Per-lane results of a batch simulation (arrays of shape ``(L,)``)."""

    makespan: np.ndarray
    work: np.ndarray
    n_faults: np.ndarray
    n_proactive_ckpts: np.ndarray
    n_regular_ckpts: np.ndarray
    n_migrations: np.ndarray
    trace_exhausted: np.ndarray
    #: two-level disk-tier recoveries / silent-error detections per lane
    #: (zeros unless the lane runs the corresponding mode; ``None`` only on
    #: legacy hand-built results predating the two phase families)
    n_disk_recoveries: Optional[np.ndarray] = None
    n_detections: Optional[np.ndarray] = None

    @property
    def n_lanes(self) -> int:
        return int(self.makespan.shape[0])

    @property
    def waste(self) -> np.ndarray:
        return 1.0 - self.work / self.makespan

    def lane(self, i: int) -> SimResult:
        """Scalar :class:`SimResult` view of lane ``i``."""
        nd = self.n_disk_recoveries
        nv = self.n_detections
        return SimResult(
            makespan=float(self.makespan[i]),
            work=float(self.work[i]),
            n_faults=int(self.n_faults[i]),
            n_proactive_ckpts=int(self.n_proactive_ckpts[i]),
            n_regular_ckpts=int(self.n_regular_ckpts[i]),
            n_migrations=int(self.n_migrations[i]),
            trace_exhausted=bool(self.trace_exhausted[i]),
            n_disk_recoveries=int(nd[i]) if nd is not None else 0,
            n_detections=int(nv[i]) if nv is not None else 0,
        )

    def to_results(self) -> List[SimResult]:
        return [self.lane(i) for i in range(self.n_lanes)]


def _cell_lists(platform, strategy, L: int):
    """``L`` platforms and strategies: one of each broadcast, or the
    sequences checked for length ``L``."""
    plats = [platform] * L if isinstance(platform, Platform) else list(platform)
    strats = [strategy] * L if isinstance(strategy, Strategy) else list(strategy)
    if len(plats) != L or len(strats) != L:
        raise ValueError(
            f"platform/strategy length mismatch: {len(plats)}/{len(strats)} vs {L} lanes"
        )
    return plats, strats


def _lane_params(work, platform, strategy, L: int):
    """Per-lane (or per-cell) parameter columns ``(W, C, D, R, M, T_R,
    T_P, mode, q)``: the first nine columns of the reference packing."""
    plats, strats = _cell_lists(platform, strategy, L)
    W = np.broadcast_to(np.asarray(work, dtype=np.float64), (L,)).copy()
    C = np.array([p.C for p in plats], dtype=np.float64)
    D = np.array([p.D for p in plats], dtype=np.float64)
    R = np.array([p.R for p in plats], dtype=np.float64)
    M = np.array(
        [p.M if p.M is not None else p.C for p in plats], dtype=np.float64
    )
    T_R = np.array([s.T_R for s in strats], dtype=np.float64)
    T_P = np.array(
        [s.T_P if s.T_P is not None else np.nan for s in strats], dtype=np.float64
    )
    mode = np.array([MODE_CODES[s.mode] for s in strats], dtype=np.int8)
    q = np.array([s.q for s in strats], dtype=np.float64)
    return W, C, D, R, M, T_R, T_P, mode, q


def _tier_params(platforms, strategies):
    """Per-cell two-level and silent-error columns ``(C2, R2, V, fmem,
    rho, kv)``: the last six columns of the reference packing.  On every
    other mode's cells they are
    benign: a missing disk tier mirrors the memory one, f = 0 sends every
    failure to disk, rho = k_V = 1 make the nesting and verification
    strides degenerate."""
    C2 = np.array(
        [p.C2 if p.C2 is not None else p.C for p in platforms], dtype=np.float64
    )
    R2 = np.array(
        [p.R2 if p.R2 is not None else p.R for p in platforms], dtype=np.float64
    )
    V = np.array(
        [p.V if p.V is not None else p.C for p in platforms], dtype=np.float64
    )
    fmem = np.array(
        [p.f if p.f is not None else 0.0 for p in platforms], dtype=np.float64
    )
    rho = np.array(
        [s.rho if s.rho is not None else 1 for s in strategies], dtype=np.int64
    )
    kv = np.array(
        [s.k_V if s.k_V is not None else 1 for s in strategies], dtype=np.int64
    )
    return C2, R2, V, fmem, rho, kv


def pad_lane_axis(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad the lane axis of a 1-D or 2-D per-lane array to ``n`` lanes
    (padding lanes get ``fill``: a value that keeps them inert)."""
    if a.shape[0] == n:
        return a
    shape = (n - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)], axis=0)


def _filter_trusted(
    traces: BatchTraces,
    q: np.ndarray,
    mode: np.ndarray,
    rng: Optional[np.random.Generator],
):
    """The host trace mode's per-lane trust filter, as the reference's:
    mode "none", silent-error lanes and q <= 0 drop every prediction,
    q >= 1 keeps every one, and a fractional q flips one coin
    ``rng.random() < q`` per prediction slot (the whole ``(L, P)`` block
    in one draw; ``rng`` None is ``default_rng(0)``) and re-sorts the
    kept ones.  Returns ``(pred_t0, pred_fault, n_kept)``."""
    t0 = traces.pred_t0
    ft = traces.pred_fault
    n = traces.n_preds.astype(np.int64)
    # silent-error lanes never trust the fail-stop predictor
    q_eff = np.where((mode == _M_NONE) | (mode == _M_SILENT), 0.0, q)
    frac_any = bool(((q_eff > 0.0) & (q_eff < 1.0)).any())
    if not frac_any and not ((q_eff <= 0.0) & (n > 0)).any():
        return t0, ft, n  # nothing dropped
    cols = np.arange(t0.shape[1])[None, :]
    keep = cols < n[:, None]
    keep &= (q_eff > 0.0)[:, None]
    frac = (q_eff > 0.0) & (q_eff < 1.0)
    if frac.any():
        rng = rng or np.random.default_rng(0)
        keep &= ~frac[:, None] | (rng.random(t0.shape) < q_eff[:, None])
    t0 = np.where(keep, t0, np.inf)
    ft = np.where(keep, ft, np.nan)
    if frac.any():
        # a fractional lane drops a strict subset mid-row: re-compact
        order = np.argsort(t0, axis=1, kind="stable")
        t0 = np.take_along_axis(t0, order, axis=1)
        ft = np.take_along_axis(ft, order, axis=1)
    return t0, ft, keep.sum(axis=1).astype(np.int64)


class _BatchEngine:
    def __init__(
        self, W, C, D, R, M, T_R, T_P, mode, traces, p_t0, p_ft,
        C2=None, R2=None, V=None, fmem=None, rho=None, kv=None,
    ):
        L = W.shape[0]
        self.L = L
        self.W, self.C, self.D, self.R, self.M = W, C, D, R, M
        self.work_full = W.copy()
        self.T_R, self.T_P, self.mode = T_R, T_P, mode
        self.horizon = np.asarray(traces.horizon, dtype=np.float64)
        self.window = np.asarray(traces.window, dtype=np.float64)
        self.C2 = C2 if C2 is not None else C
        self.R2 = R2 if R2 is not None else R
        self.V = V if V is not None else C
        self.fmem = fmem if fmem is not None else np.zeros(L)
        self.rho = rho if rho is not None else np.ones(L, dtype=np.int64)
        self.kv = kv if kv is not None else np.ones(L, dtype=np.int64)

        # the cursors need an +inf sentinel column; generated batches carry
        # one already, so the arrays are adopted without copying (the engine
        # never writes them — lane-local mutation goes through Fcancel)
        F = pad_sentinel(traces.fault_times, traces.n_faults, np.inf)
        self.F = F
        self.Fcancel = np.zeros(F.shape, dtype=bool)
        self.P0 = pad_sentinel(p_t0, traces.n_preds, np.inf)
        self.Pft = pad_sentinel(p_ft, traces.n_preds, np.nan)
        # per-fault recovery-tier uniforms, aligned with F's columns (only
        # consulted on two-level lanes; the 1.0 pad means "disk")
        FT = getattr(traces, "fault_tier", None)
        if FT is None:
            FT = np.ones((L, 1))
        elif FT.shape[1] < F.shape[1]:
            FT = np.concatenate(
                [FT, np.ones((L, F.shape[1] - FT.shape[1]))], axis=1
            )
        self.Ftier = FT

        z = lambda dt: np.zeros(L, dtype=dt)
        self.t = z(np.float64)
        self.saved = z(np.float64)
        self.unsaved = z(np.float64)
        self.period_work = z(np.float64)
        self.na_saved = z(np.float64)
        self.ep_t0 = z(np.float64)
        self.ep_end = z(np.float64)
        self.ep_ft = np.full(L, np.nan)
        self.fi = z(np.int64)
        self.pi = z(np.int64)
        self.n_faults = z(np.int64)
        self.n_pro = z(np.int64)
        self.n_reg = z(np.int64)
        self.n_mig = z(np.int64)
        self.phase = z(np.int8)
        self.done = z(bool)
        self.exhausted = z(bool)
        # two-level lane state: work at the last disk checkpoint, memory
        # checkpoints since it, and the duration of the repair in progress
        # (faults during a repair restart the SAME repair: rc, not D+R)
        self.saved_d = z(np.float64)
        self.dk_ctr = z(np.int64)
        self.rc = (D + R).copy()
        # silent-error lane state: work at the last *verified* checkpoint,
        # unverified checkpoints since it, earliest latent corruption time
        self.saved_v = z(np.float64)
        self.ck_v = z(np.int64)
        self.corrupt = np.full(L, np.inf)
        self.n_disk = z(np.int64)
        self.n_det = z(np.int64)

        # finished lanes are harvested into these and repacked away, so the
        # iteration cost tracks the number of *live* lanes, not the batch size
        self.lane_id = np.arange(L)
        self.out_makespan = z(np.float64)
        self.out_n_faults = z(np.int64)
        self.out_n_pro = z(np.int64)
        self.out_n_reg = z(np.int64)
        self.out_n_mig = z(np.int64)
        self.out_exhausted = z(bool)
        self.out_n_disk = z(np.int64)
        self.out_n_det = z(np.int64)

    #: per-lane state sliced on repack (2-D trace arrays included)
    _LANE_ATTRS = (
        "W", "C", "D", "R", "M", "T_R", "T_P", "mode", "horizon", "window",
        "C2", "R2", "V", "fmem", "rho", "kv",
        "t", "saved", "unsaved", "period_work", "na_saved",
        "ep_t0", "ep_end", "ep_ft", "fi", "pi",
        "n_faults", "n_pro", "n_reg", "n_mig",
        "saved_d", "dk_ctr", "rc", "saved_v", "ck_v", "corrupt",
        "n_disk", "n_det",
        "phase", "done", "exhausted", "lane_id",
        "F", "Fcancel", "P0", "Pft", "Ftier",
    )

    def _derived(self) -> None:
        """Per-lane constants, recomputed whenever lanes are repacked."""
        self.lanes = np.arange(self.t.shape[0])
        self.DR = self.D + self.R
        self.DR2 = self.D + self.R2
        self.wpp = np.maximum(self.T_R - self.C, 1e-9)
        self.lead_act = np.where(self.mode == _M_MIGRATION, self.M, self.C)
        self.tp_eff_default = np.maximum(self.C, self.window)
        self.tl_m = self.mode == _M_TWO_LEVEL
        self.sil_m = self.mode == _M_SILENT
        self.has_tl = bool(self.tl_m.any())
        self.has_sil = bool(self.sil_m.any())

    def _harvest(self, rows: np.ndarray) -> None:
        ids = self.lane_id[rows]
        self.out_makespan[ids] = self.t[rows]
        self.out_n_faults[ids] = self.n_faults[rows]
        self.out_n_pro[ids] = self.n_pro[rows]
        self.out_n_reg[ids] = self.n_reg[rows]
        self.out_n_mig[ids] = self.n_mig[rows]
        self.out_exhausted[ids] = self.exhausted[rows]
        self.out_n_disk[ids] = self.n_disk[rows]
        self.out_n_det[ids] = self.n_det[rows]

    def _repack(self, keep: np.ndarray) -> None:
        for name in self._LANE_ATTRS:
            setattr(self, name, getattr(self, name)[keep])

    def run(self, max_iters: int = 50_000_000) -> BatchResult:
        it = 0
        self._derived()
        while True:
            live = self.t.shape[0]
            done = self.done
            n_done = int(np.count_nonzero(done))
            if n_done == live:
                self._harvest(done)
                break
            if n_done and (n_done * 2 >= live or live - n_done <= 16):
                self._harvest(done)
                self._repack(~done)
                self._derived()
            L = self.t.shape[0]
            lanes = self.lanes
            DR = self.DR
            wpp = self.wpp
            lead_act = self.lead_act
            tp_eff_default = self.tp_eff_default
            it += 1
            if it > max_iters:  # pragma: no cover
                raise RuntimeError("batch simulator did not converge")

            prim = np.zeros(L, dtype=np.int8)
            target = np.zeros(L)
            credit = np.zeros(L, dtype=bool)
            cont = np.full(L, -1, dtype=np.int8)
            occ = np.bincount(self.phase, minlength=8)

            # ---- regular-mode decisions -------------------------------- #
            if occ[_PH_MAIN]:
                mn = self.phase == _PH_MAIN
                idx = np.flatnonzero(mn)
                while idx.size:  # skip predictions whose action point passed
                    adv = (
                        self.P0[idx, self.pi[idx]] - lead_act[idx] < self.t[idx]
                    )
                    idx = idx[adv]
                    self.pi[idx] += 1
                na = self.P0[lanes, self.pi] - lead_act
                self._fast_forward(mn, na, lanes, wpp)
                # horizon check after fast-forward: ff'd periods never finish
                # the job, so a crossing is observed at this (real) loop top
                # exactly as the scalar engine would at a period boundary
                self.exhausted |= mn & (self.t > self.horizon)
                remaining = wpp - self.period_work
                ck = mn & (remaining <= _EPS)
                prim[ck] = _PR_CKPT
                cont[ck] = _C_CKPTREG
                self.na_saved[ck] = na[ck]
                wk_na = mn & ~ck & (na < self.t + remaining)
                prim[wk_na] = _PR_WORK
                target[wk_na] = na[wk_na]
                credit[wk_na] = True
                cont[wk_na] = _C_POP_EP
                wk_seg = mn & ~ck & ~wk_na
                prim[wk_seg] = _PR_WORK
                target[wk_seg] = (self.t + remaining)[wk_seg]
                credit[wk_seg] = True
                cont[wk_seg] = _C_MAIN

            # ---- episode entry ----------------------------------------- #
            if occ[_PH_EP_START]:
                eidx = np.flatnonzero(self.phase == _PH_EP_START)
                emig = self.mode[eidx] == _M_MIGRATION
                mig_i = eidx[emig]
                if mig_i.size:
                    # the predicted fault hits the vacated node: cancel it
                    ftv = self.ep_ft[mig_i]
                    can_i = mig_i[~np.isnan(ftv) & (ftv >= self.t[mig_i])]
                    if can_i.size:
                        rows = self.F[can_i]
                        cols = np.arange(rows.shape[1])[None, :]
                        match = (
                            (rows == self.ep_ft[can_i, None])
                            & (cols >= self.fi[can_i, None])
                            & ~self.Fcancel[can_i]
                        )
                        has = match.any(axis=1)
                        j = match.argmax(axis=1)
                        self.Fcancel[can_i[has], j[has]] = True
                    prim[mig_i] = _PR_IDLE
                    target[mig_i] = self.ep_t0[mig_i]
                    cont[mig_i] = _C_MIG
                rest_i = eidx[~emig]
                if rest_i.size:
                    d = self.ep_t0[rest_i] - self.C[rest_i]
                    tr = self.t[rest_i]
                    b1 = tr < d  # room for the pre-window checkpoint
                    b2 = ~b1 & (tr <= d)  # exactly at t0 - C
                    b3 = ~b1 & ~b2  # no time for the extra checkpoint
                    i1 = rest_i[b1]
                    prim[i1] = _PR_WORK
                    target[i1] = d[b1]
                    credit[i1] = True
                    cont[i1] = _C_PRECKPT
                    i2 = rest_i[b2]
                    prim[i2] = _PR_CKPT
                    cont[i2] = _C_MODE
                    i3 = rest_i[b3]
                    prim[i3] = _PR_WORK
                    target[i3] = tr[b3]  # max(t, t0 - C) == t here
                    credit[i3] = True
                    cont[i3] = _C_NT2

            # ---- pending episode primitives ---------------------------- #
            if occ[_PH_EP_PRECKPT]:
                i = np.flatnonzero(self.phase == _PH_EP_PRECKPT)
                prim[i] = _PR_CKPT
                cont[i] = _C_MODE

            if occ[_PH_EP_NT2]:
                i = np.flatnonzero(self.phase == _PH_EP_NT2)
                prim[i] = _PR_WORK
                target[i] = self.ep_t0[i]
                cont[i] = _C_MODE

            if occ[_PH_EP_NOCKPT]:
                i = np.flatnonzero(self.phase == _PH_EP_NOCKPT)
                prim[i] = _PR_WORK
                target[i] = self.ep_end[i]
                cont[i] = _C_MAIN

            if occ[_PH_EP_WC]:
                widx = np.flatnonzero(self.phase == _PH_EP_WC)
                over = self.t[widx] >= self.ep_end[widx] - _EPS
                self.phase[widx[over]] = _PH_MAIN  # window exhausted
                gidx = widx[~over]
                if gidx.size:
                    tp = self.T_P[gidx]
                    tp = np.where(np.isnan(tp), tp_eff_default[gidx], tp)
                    cg = self.C[gidx]
                    seg = np.minimum(
                        self.t[gidx] + (tp - cg), self.ep_end[gidx] - cg
                    )
                    wsel = seg > self.t[gidx]
                    iw = gidx[wsel]
                    prim[iw] = _PR_WORK
                    target[iw] = seg[wsel]
                    cont[iw] = _C_WC_CKPT
                    ik = gidx[~wsel]
                    prim[ik] = _PR_CKPT
                    cont[ik] = _C_WC

            if occ[_PH_EP_WC_CKPT]:
                i = np.flatnonzero(self.phase == _PH_EP_WC_CKPT)
                prim[i] = _PR_CKPT
                cont[i] = _C_WC

            # ---- execute one primitive per lane ------------------------ #
            workm = prim == _PR_WORK
            idlem = prim == _PR_IDLE
            ckm = prim == _PR_CKPT
            if workm.any():  # cap at job completion, pre-resolution clock
                remw = self.W - self.saved - self.unsaved
                target[workm] = np.minimum(target[workm], (self.t + remw)[workm])
            ckend = np.where(ckm, self.t + self.C, 0.0)
            # intent masks fixed with the end date: the rho-th regular ckpt
            # of a two-level lane is the disk tier (cost C + C2); the k_V-th
            # regular ckpt of a silent-error lane verifies (cost C + V).
            # Proactive ckpts hit the memory tier and never verify.
            reg_int = ckm & (cont == _C_CKPTREG)
            disk_int = reg_int & self.tl_m & (self.dk_ctr >= self.rho - 1)
            ver_int = reg_int & self.sil_m & (self.ck_v >= self.kv - 1)
            ckend[disk_int] += self.C2[disk_int]
            ckend[ver_int] += self.V[ver_int]

            # resolve stale faults (fault during downtime: recovery restarts;
            # rc is the duration of the repair in progress — D+R everywhere
            # except after a two-level disk recovery — and silent-error
            # strikes are not fail-stop events, so those lanes skip the
            # cascade entirely)
            res = workm | idlem | ckm
            idx = np.flatnonzero(res & ~self.sil_m)
            while idx.size:
                curf = self.F[idx, self.fi[idx]]
                curc = self.Fcancel[idx, self.fi[idx]]
                step = curc | (curf < self.t[idx])
                if not step.any():
                    break
                idx = idx[step]
                f = curf[step]
                hit = ~curc[step] & (f >= self.t[idx] - self.rc[idx])
                sub = idx[hit]
                self.n_faults[sub] += 1
                self.t[sub] = f[hit] + self.rc[sub]
                self.fi[idx] += 1
            nf = self.F[lanes, self.fi]
            # silent strikes never interrupt a primitive (latent until the
            # next verification): mask them out of the fail-stop check
            nf_k = np.where(self.sil_m, np.inf, nf) if self.has_sil else nf

            faulted = ((workm | idlem) & (nf_k <= target)) | (ckm & (nf_k < ckend))
            ok = res & ~faulted
            if faulted.any():
                if self.has_tl:
                    # tier coin consumed with the fault (column read before
                    # the cursor advances): u >= f sends recovery to disk
                    u = self.Ftier[lanes, self.fi]
                    disk = faulted & self.tl_m & (u >= self.fmem)
                    mem = faulted & self.tl_m & ~disk
                self.fi[faulted] += 1
                self.n_faults[faulted] += 1
                self.unsaved[faulted] = 0.0
                self.period_work[faulted] = 0.0
                self.t[faulted] = nf[faulted] + DR[faulted]
                self.phase[faulted] = _PH_MAIN
                if self.has_tl:
                    self.rc[mem] = DR[mem]
                    # disk-tier recovery: restart from the last disk ckpt
                    self.t[disk] = nf[disk] + self.DR2[disk]
                    self.saved[disk] = self.saved_d[disk]
                    self.dk_ctr[disk] = 0
                    self.rc[disk] = self.DR2[disk]
                    self.n_disk[disk] += 1

            wok = workm & ok
            if wok.any():
                dt = target - self.t
                self.unsaved[wok] += dt[wok]
                cw = wok & credit
                self.period_work[cw] += dt[cw]
                self.t[wok] = target[wok]
                fin = wok & (self.saved + self.unsaved >= self.W - _EPS)
                self.done[fin] = True
                self.phase[fin] = _PH_DONE
            if idlem.any():
                iok = idlem & ok
                self.t[iok] = target[iok]
            cok = ckm & ok
            if cok.any():
                self.t[cok] = ckend[cok]
                self.saved[cok] += self.unsaved[cok]
                self.unsaved[cok] = 0.0
                reg = cok & (cont == _C_CKPTREG)  # only regular ckpts use it
                self.n_pro[cok & ~reg] += 1
                self.n_reg[reg] += 1
                self.period_work[reg] = 0.0

            if self.has_tl and cok.any():
                # completed disk-tier ckpt: promote the durable frontier;
                # completed memory-tier regular ckpt: advance the nesting
                # counter (proactive ckpts hit the memory tier but do not)
                dk = cok & disk_int
                self.saved_d[dk] = self.saved[dk]
                self.dk_ctr[dk] = 0
                self.dk_ctr[
                    cok & self.tl_m & (cont == _C_CKPTREG) & ~disk_int
                ] += 1

            if self.has_sil:
                # consume latent strikes up to the new clock: they corrupt
                # state silently instead of interrupting the primitive
                sidx = np.flatnonzero(res & self.sil_m)
                while sidx.size:
                    curf = self.F[sidx, self.fi[sidx]]
                    hit = curf <= self.t[sidx]
                    if not hit.any():
                        break
                    sidx = sidx[hit]
                    self.corrupt[sidx] = np.minimum(
                        self.corrupt[sidx], curf[hit]
                    )
                    self.fi[sidx] += 1
                if cok.any():
                    vok = cok & ver_int
                    det = vok & np.isfinite(self.corrupt)
                    if det.any():
                        # verification caught a latent corruption: roll back
                        # past every unverified ckpt to the verified frontier
                        self.t[det] += DR[det]
                        self.saved[det] = self.saved_v[det]
                        self.period_work[det] = 0.0
                        self.ck_v[det] = 0
                        self.corrupt[det] = np.inf
                        self.n_faults[det] += 1
                        self.n_det[det] += 1
                    clean = vok & ~det
                    self.saved_v[clean] = self.saved[clean]
                    self.ck_v[clean] = 0
                    self.ck_v[
                        cok & self.sil_m & (cont == _C_CKPTREG) & ~ver_int
                    ] += 1

            # ---- continuations on success ------------------------------ #
            cidx = np.flatnonzero(ok & ~self.done)
            cc = cont[cidx]
            # simple continuations resolve through one phase lookup; the
            # special codes get a placeholder (MAIN) and are patched below
            self.phase[cidx] = _CONT2PH[cc]

            mig_idx = cidx[cc == _C_MIG]
            if mig_idx.size:
                self.n_mig[mig_idx] += 1

            mode_idx = cidx[cc == _C_MODE]
            if mode_idx.size:
                self.phase[mode_idx] = _MODE2PH[self.mode[mode_idx]]

            pop_idx = cidx[cc == _C_POP_EP]
            if pop_idx.size:
                self._pop_pred(pop_idx)
                self.phase[pop_idx] = _PH_EP_START

            ckr_idx = cidx[cc == _C_CKPTREG]
            if ckr_idx.size:
                # the action point fell inside the regular checkpoint: the
                # episode starts right after it completes (if still in the
                # future), else the prediction is consumed and dropped
                p0 = self.P0[ckr_idx, self.pi[ckr_idx]]
                take = (self.na_saved[ckr_idx] <= self.t[ckr_idx]) & np.isfinite(p0)
                tidx = ckr_idx[take]
                if tidx.size:
                    good = p0[take] >= self.t[tidx] - 1e-9
                    self._pop_pred(tidx)
                    self.phase[tidx[good]] = _PH_EP_START

        return BatchResult(
            makespan=self.out_makespan,
            work=self.work_full,
            n_faults=self.out_n_faults,
            n_proactive_ckpts=self.out_n_pro,
            n_regular_ckpts=self.out_n_reg,
            n_migrations=self.out_n_mig,
            trace_exhausted=self.out_exhausted,
            n_disk_recoveries=self.out_n_disk,
            n_detections=self.out_n_det,
        )

    def _fast_forward(
        self, mn: np.ndarray, na: np.ndarray, lanes: np.ndarray, wpp: np.ndarray
    ) -> None:
        """Collapse runs of *clean* regular periods into one array update.

        A period is clean when it is entered at a fresh checkpoint boundary
        (no partial period work, no unsaved work) and contains no fault, no
        prediction action point, and does not finish the job: the scalar
        engine then deterministically executes work(T_R - C) + checkpoint(C),
        advancing ``t`` by T_R and ``saved`` by T_R - C.  Fusing ``k`` such
        periods changes only float rounding (k fused multiplies vs k
        sequential adds, ~ulp-level drift on the makespan), never the event
        sequence.
        """
        idx = np.flatnonzero(
            mn & (self.period_work == 0.0) & (self.unsaved == 0.0)
        )
        if not idx.size:
            return
        fi = self.fi[idx]
        curf = self.F[idx, fi]
        keep = (curf >= self.t[idx]) & ~self.Fcancel[idx, fi]
        idx = idx[keep]
        if not idx.size:
            return
        curf = curf[keep]
        t = self.t[idx]
        t_r = self.T_R[idx]
        w = wpp[idx]
        na_i = na[idx]
        w_job = self.W[idx]
        sv = self.saved[idx]
        k_fault = np.floor((curf - t) / t_r)
        k_act = np.floor((na_i - t) / t_r)
        # a checkpoint ending exactly at the action point still triggers
        # the episode (na <= t at completion): exclude that period
        k_act = np.where(t + k_act * t_r >= na_i, k_act - 1.0, k_act)
        k_done = np.floor((w_job - sv - _EPS) / w)
        # the k-th period's work must not itself complete the job
        # (scalar done-check: saved + unsaved >= W - eps)
        k_done = np.where(sv + k_done * w >= w_job - _EPS, k_done - 1.0, k_done)
        k = np.minimum(np.minimum(k_fault, k_act), np.minimum(k_done, 4e15))
        if self.has_tl or self.has_sil:
            # never fuse across a disk-tier or verification checkpoint (they
            # cost more than C): cap the run at the current stride remainder
            cap = np.full(idx.shape[0], 4e15)
            tl = self.tl_m[idx]
            sl = self.sil_m[idx]
            cap[tl] = (self.rho[idx] - 1 - self.dk_ctr[idx])[tl]
            cap[sl] = (self.kv[idx] - 1 - self.ck_v[idx])[sl]
            k = np.minimum(k, np.maximum(cap, 0.0))
        ff = k >= 2.0
        if not ff.any():
            return
        idx = idx[ff]
        k = k[ff]
        self.t[idx] += k * self.T_R[idx]
        self.saved[idx] += k * wpp[idx]
        kk = k.astype(np.int64)
        self.n_reg[idx] += kk
        if self.has_tl:
            tl = self.tl_m[idx]
            self.dk_ctr[idx[tl]] += kk[tl]
        if self.has_sil:
            sl = self.sil_m[idx]
            self.ck_v[idx[sl]] += kk[sl]

    def _pop_pred(self, idx: np.ndarray) -> None:
        pi = self.pi[idx]
        t0v = self.P0[idx, pi]
        self.ep_t0[idx] = t0v
        self.ep_ft[idx] = self.Pft[idx, pi]
        self.ep_end[idx] = t0v + self.window[idx]
        self.pi[idx] = pi + 1


def simulate_batch(
    work,
    platform: Union[Platform, Sequence[Platform]],
    strategy: Union[Strategy, Sequence[Strategy]],
    traces: Union[BatchTraces, TraceSpec],
    rng: Optional[np.random.Generator] = None,
    max_iters: int = 50_000_000,
) -> BatchResult:
    """Simulate every lane of ``traces`` at once on the host.

    ``work``, ``platform`` and ``strategy`` are either shared by all lanes
    or per-lane sequences of length ``traces.n_lanes``.  ``rng`` is only
    consulted for fractional trust probabilities ``0 < q < 1``.  A
    :class:`TraceSpec` is replayed on the host first
    (:meth:`TraceSpec.materialize`)."""
    if isinstance(traces, TraceSpec):
        traces = traces.materialize()
    L = traces.n_lanes
    plats, strats = _cell_lists(platform, strategy, L)
    W, C, D, R, M, T_R, T_P, mode, q = _lane_params(work, plats, strats, L)
    C2, R2, V, fmem, rho, kv = _tier_params(plats, strats)
    p_t0, p_ft, _ = _filter_trusted(traces, q, mode, rng)
    tl = mode == _M_TWO_LEVEL
    if (
        tl.any()
        and float(fmem[tl].max()) > 0.0
        and getattr(traces, "fault_tier", None) is None
    ):
        raise ValueError(
            "two-level lanes with f > 0 need per-fault tier draws: generate "
            "traces with make_event_traces_batch(..., tier=True)"
        )
    eng = _BatchEngine(
        W, C, D, R, M, T_R, T_P, mode, traces, p_t0, p_ft,
        C2=C2, R2=R2, V=V, fmem=fmem, rho=rho, kv=kv,
    )
    return eng.run(max_iters=max_iters)
