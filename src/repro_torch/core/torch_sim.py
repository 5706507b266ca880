"""The device lane machine: the fused paper-grid Monte-Carlo sweep in
PyTorch, with its hot step in hand-written CUDA kernels.

:func:`simulate_batch_torch` is the port of the reference engine's
device trace mode (``repro.core.jax_sim._jit_run`` with a cell-indexed
:class:`~repro_torch.core.events.TraceSpec`).  A spec whose laws are
per-cell tuples (the mixed-law layout) ships each cell's law code and
shape slots as table columns, and every stream draw goes through the
kernels' law-indexed variant.  Every lane is
one Monte-Carlo run of one experiment cell; all lanes of a chunk advance
together, one primitive (work segment, idle segment, checkpoint) per
lane per outer iteration, with masked tensor updates.  A finished lane
goes inert (phase ``DONE`` masks every update), so shapes stay fixed.

Events are sampled on the device from per-lane counter-based streams
(the layout of ``repro_torch.core.events``): a strike cursor (the next
fault to hit), a lookahead cursor plus a pending true-positive slot (the
next *visible* predicted fault and its window start), and a
false-prediction cursor.  The strike cursor is primed by one launch of
:func:`~repro_torch.kernels.sim_step.masked_stream_advance` and refilled
inside the primitive-update kernel (:func:`~repro_torch.kernels.sim_step.
masked_primitive_update`).  Migration cancels the vacated node's
predicted fault by counter index in three slots; a fourth
*simultaneously pending* cancellation is dropped, exactly as in the
reference.  Two-level lanes (memory checkpoints nested in disk ones)
draw each fault's recovery tier from the tier-coin stream at the
pre-consumption strike counter; silent-error lanes take their strikes
off the fail-stop path (the strike cursor goes to the primitive update
masked to ``+inf``) and consume them as latent corruptions up to the
clock in a silent walk (:func:`~repro_torch.kernels.sim_step.
masked_silent_walk`), caught and rolled back at every ``k_V``-th
(verifying) checkpoint.  Migration, two-level and silent-error state and
ops run only on chunks that hold such lanes, and the trust coins of
fractional trust only on chunks with a ``0 < q < 1`` lane.

The reference's ``lax.while_loop``s over the cursors become walks, one
launch each, in which every lane advances its own cursor as far as its
own stop condition needs (:func:`~repro_torch.kernels.sim_step.
masked_prediction_walk`, :func:`~repro_torch.kernels.sim_step.
masked_strike_walk`): the TP-lookahead loop and the skip over passed
predictions are one prediction walk, the final pop of the merged head is
one more, and the stale-fault cascade is one strike walk (a silent-error
chunk adds the silent walk).  On the card an outer iteration is then
three cursor launches (four) and one primitive update, with no host sync
inside; the chunk's priming adds a stream advance and a prediction walk.  On the CPU the walks' plain versions run the loops as
masked passes over all lanes, each pass's condition one host sync
(``bool(mask.any())``), counted in :class:`_Tally`.  The reference's
``lax.cond`` gates are dropped: every update inside them is masked, so
running the bodies unconditionally gives identical results.  With trust
``q`` in {0, 1} the false-prediction loop is a single draw; with
``0 < q < 1`` the prediction walk thins both prediction streams by
per-event trust coins.  The outer
loop polls for termination every :data:`POLL` iterations (finished lanes
are inert; the poll is the card path's only host sync) and never runs
past ``max_iters``.

Work is f64 throughout; event counters are int64 and stream counters
int32, as in the reference's x64 packing.  The per-lane stream subkeys
are derived on the host with NumPy (:func:`tables_from_numpy`) and ship
as int64 bit patterns of the 64-bit SplitMix keys.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import batch_sim as B
from . import events as E
from .batch_sim import pad_lane_axis
from .events import TraceSpec
from .simulator import _EPS
from ..kernels.sim_step import (
    FLAG_CKPT_OK, FLAG_FAULTED, FLAG_FIN, FLAG_OK, FLAG_REG, PREDICTION_CURSORS,
    PRIM_WORK_NC, cell_gather, counter_uniform, masked_prediction_walk,
    masked_primitive_update, masked_silent_walk, masked_stream_advance,
    masked_strike_walk, segment_cell_sums,
)

__all__ = [
    "simulate_batch_torch",
    "CellSums",
    "LaneResult",
    "resolve_device",
    "default_chunk_lanes",
    "tables_from_numpy",
]

#: the outer loop checks for termination every POLL iterations
POLL = 8

#: chunk="auto": lanes resident at once (a whole paper grid fits one chunk
#: on the card; the CPU path exists for tests at small sizes)
_DEFAULT_CHUNK_CUDA = 1 << 20
_DEFAULT_CHUNK_CPU = 10240


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Without a device and without CUDA it raises; it never falls
    back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "port's plain PyTorch path on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def default_chunk_lanes(device: torch.device) -> int:
    """The lane count ``chunk="auto"`` resolves to on ``device``."""
    return _DEFAULT_CHUNK_CUDA if device.type == "cuda" else _DEFAULT_CHUNK_CPU


# --------------------------------------------------------------------------- #
# Host-side chunk packing (NumPy)
# --------------------------------------------------------------------------- #
def _chunk_state(sl: slice, n_pad: int, fdt, idt) -> dict:
    """Zeroed per-lane engine state of one chunk (padding lanes inert)."""
    n_real = sl.stop - sl.start
    phase = np.full(n_pad, B._PH_MAIN, np.int32)
    phase[n_real:] = B._PH_DONE  # padding lanes start inert
    zf = np.zeros(n_pad, fdt)
    zi = np.zeros(n_pad, idt)
    return {
        "t": zf, "saved": zf, "unsaved": zf, "period_work": zf,
        "na_saved": zf, "ep_t0": zf, "ep_end": zf,
        "n_faults": zi, "n_pro": zi, "n_reg": zi, "n_mig": zi,
        "phase": phase,
        "exhausted": np.zeros(n_pad, bool),
    }


def _stream_consts(spec: TraceSpec, sl: slice, n_pad: int) -> dict:
    """Per-lane RNG stream identity of one chunk: the two seed words and
    the two halves of the 64-bit stream id.  This layout is what makes
    results invariant to the chunk size."""

    def uvec(x):
        return pad_lane_axis(x, n_pad, 0).astype(np.uint32)

    stream = spec.stream[sl]
    return {
        "s0": uvec(np.full(stream.shape, spec.seed & 0xFFFFFFFF, np.int64)),
        "s1": uvec(
            np.full(stream.shape, (spec.seed >> 32) & 0xFFFFFFFF, np.int64)
        ),
        "sid_lo": uvec(stream & 0xFFFFFFFF),
        "sid_hi": uvec((stream >> 32) & 0xFFFFFFFF),
    }


#: consts keys shipped as per-cell tables and gathered by the lane -> cell
#: index on the device
_CELL_TABLE_KEYS = (
    "W", "C", "DR", "T_R", "T_P", "mode", "horizon", "window",
    "wpp", "lead_act", "tp_eff_default", "mtbf", "fp_mean", "recall", "q_eff",
)
#: ... the mixed-law columns (law code, s1 / s2 slots) of each stream
_LAW_TABLE_KEYS = ("fault_law", "fault_s1", "fault_s2", "fp_law", "fp_s1", "fp_s2")
#: ... and the two-level / silent-error columns
_TIER_TABLE_KEYS = ("C2", "DR2", "V", "fmem", "rho", "kv")


def _cell_tables(
    n_cells: int, n_tab: int, fdt,
    W, C, D, R, M, T_R, T_P, mode, horizon, window,
    mtbf, fp_mean, recall, q_eff, fault_laws=None, fp_laws=None, tier=None,
) -> dict:
    """Per-cell engine-parameter tables of a fused sweep: one row per
    cell plus ``n_tab - n_cells`` benign padding rows, each with a ``-1``
    horizon (row ``n_cells`` is the row padding lanes index).
    ``fault_laws`` / ``fp_laws`` (a :func:`~repro_torch.core.events.
    law_table` pair, mixed-law specs) add each stream's law code and
    ``s1`` / ``s2`` slot columns; padding rows are exponential with zero
    slots.  ``tier`` (the ``(C2, R2, V, fmem, rho, kv)`` of
    :func:`~repro_torch.core.batch_sim._tier_params`) adds the two-level
    and silent-error columns :data:`_TIER_TABLE_KEYS` (``DR2 = D + R2``);
    padding rows have zero extra costs, f = 0 and strides of 1."""

    def tab(x, fill=0.0, dt=None):
        a = np.full(n_tab, fill, dt or fdt)
        a[:n_cells] = np.asarray(x)
        return a

    Ch = tab(C, 1.0)
    Mh = tab(M, 1.0)
    modeh = tab(mode, 0, np.int32)
    T_Rh = tab(T_R, 2.0)
    windowh = tab(window)
    tables = {
        "W": tab(W, 1.0),
        "C": Ch,
        "DR": tab(np.asarray(D) + np.asarray(R)),
        "T_R": T_Rh,
        "T_P": tab(T_P, np.nan),
        "mode": modeh,
        "horizon": tab(horizon, -1.0),
        "window": windowh,
        "wpp": np.maximum(T_Rh - Ch, 1e-9).astype(fdt),
        "lead_act": np.where(modeh == B._M_MIGRATION, Mh, Ch).astype(fdt),
        "tp_eff_default": np.maximum(Ch, windowh).astype(fdt),
        "mtbf": tab(mtbf, 1.0),
        "fp_mean": tab(fp_mean, np.inf),
        "recall": tab(recall),
        "q_eff": tab(q_eff),
    }
    for prefix, laws in (("fault", fault_laws), ("fp", fp_laws)):
        if laws is not None:
            law, lp = laws
            tables.update({
                f"{prefix}_law": tab(law, 0, np.int32),
                f"{prefix}_s1": tab(lp[:, 1]),
                f"{prefix}_s2": tab(lp[:, 2]),
            })
    if tier is not None:
        C2, R2, V, fmem, rho, kv = tier
        tables.update(
            C2=tab(C2), DR2=tab(np.asarray(D) + np.asarray(R2)), V=tab(V),
            fmem=tab(fmem), rho=tab(rho, 1.0), kv=tab(kv, 1.0),
        )
    return tables


def _pack_chunk_spec_cells(
    tables: dict, spec: TraceSpec, cidx, pad_cell: int,
    sl: slice, n_pad: int, fdt, idt,
):
    """Chunk packing of the fused dispatch: the O(cells) tables (the law
    columns of a mixed-law spec among them), the per-lane int32 cell
    index and the RNG stream identity, plus the zeroed lane state."""
    state = _chunk_state(sl, n_pad, fdt, idt)
    consts = dict(tables)
    consts["cidx"] = pad_lane_axis(cidx[sl].astype(np.int32), n_pad, pad_cell)
    consts.update(_stream_consts(spec, sl, n_pad))
    return consts, state


_STREAM_WORDS = ("s0", "s1", "sid_lo", "sid_hi")

#: per-lane SplitMix key -> stream kind: the three every chunk draws, then
#: the recovery-tier coins (two-level chunks) and the two trust-coin
#: streams (chunks with fractional trust)
_KEY_KINDS = {
    "fg_key": E.STREAM_FAULT_GAP,
    "tc_key": E.STREAM_TP_COIN,
    "fp_key": E.STREAM_FP_GAP,
    "tier_key": E.STREAM_TIER,
    "tt_key": E.STREAM_TP_TRUST,
    "ft_key": E.STREAM_FP_TRUST,
}
_BASE_KEYS = ("fg_key", "tc_key", "fp_key")


def _to_device(arrays: dict, device) -> dict:
    # torch.tensor copies: packed arrays may share memory (the zeroed
    # state columns do), and the engine updates state in place
    return {k: torch.tensor(np.asarray(v), device=device) for k, v in arrays.items()}


def tables_from_numpy(consts: dict, device, keys=_BASE_KEYS) -> dict:
    """Packed chunk constants (NumPy, the reference packing) -> the
    port's tensors on ``device``.

    Tables and the lane -> cell index keep their dtypes.  The four uint32
    stream-identity words become the per-lane 64-bit SplitMix subkeys
    named in ``keys`` (:data:`_KEY_KINDS`; by default those of the
    fault-gap, TP-coin and false-prediction streams):
    ``threefry2x32(seed_words, (sid_lo, sid_hi << 4 | kind))`` packed
    ``high << 32 | low``, shipped as int64 bit patterns."""
    out = _to_device(
        {k: v for k, v in consts.items() if k not in _STREAM_WORDS}, device
    )
    s0, s1, lo, hi = (np.asarray(consts[k], np.uint32) for k in _STREAM_WORDS)
    for name in keys:
        kind = _KEY_KINDS[name]
        k0, k1 = E.threefry2x32(s0, s1, lo, (hi << np.uint32(4)) | np.uint32(kind))
        key = (k0.astype(np.uint64) << np.uint64(32)) | k1.astype(np.uint64)
        out[name] = torch.tensor(key.view(np.int64), device=device)
    return out


# --------------------------------------------------------------------------- #
# Results
# --------------------------------------------------------------------------- #
#: column order of the per-cell segment reduction
(
    _CS_N, _CS_T, _CS_T2, _CS_WASTE, _CS_WASTE2, _CS_NF, _CS_NPRO,
    _CS_NREG, _CS_NMIG, _CS_EXH, _CS_DISK, _CS_DET, _CS_NOTDONE,
) = range(13)


@dataclass
class CellSums:
    """Per-cell Monte-Carlo sums of a fused sweep (``collect="stats"``):
    every field is an ``(n_cells,)`` array of sums over the cell's lanes,
    reduced on the device.  ``mean_*`` / ``ci95_*`` derive the summary
    statistics (CI via the ddof=1 sample variance)."""

    n: np.ndarray
    makespan_sum: np.ndarray
    makespan_sumsq: np.ndarray
    waste_sum: np.ndarray
    waste_sumsq: np.ndarray
    n_faults: np.ndarray
    n_proactive_ckpts: np.ndarray
    n_regular_ckpts: np.ndarray
    n_migrations: np.ndarray
    n_exhausted: np.ndarray
    n_disk_recoveries: np.ndarray
    n_detections: np.ndarray

    @property
    def n_cells(self) -> int:
        return int(self.n.shape[0])

    @staticmethod
    def _mean(s, n):
        with np.errstate(invalid="ignore", divide="ignore"):
            return s / n

    @staticmethod
    def _ci95(s, s2, n):
        with np.errstate(invalid="ignore", divide="ignore"):
            var = np.maximum(s2 - s * s / n, 0.0) / np.maximum(n - 1.0, 1.0)
            return np.where(n >= 2, 1.96 * np.sqrt(var / n), np.nan)

    @property
    def mean_waste(self) -> np.ndarray:
        return self._mean(self.waste_sum, self.n)

    @property
    def ci95_waste(self) -> np.ndarray:
        return self._ci95(self.waste_sum, self.waste_sumsq, self.n)

    @property
    def mean_makespan(self) -> np.ndarray:
        return self._mean(self.makespan_sum, self.n)

    @property
    def ci95_makespan(self) -> np.ndarray:
        return self._ci95(self.makespan_sum, self.makespan_sumsq, self.n)

    @classmethod
    def from_matrix(cls, cs: np.ndarray) -> "CellSums":
        return cls(
            n=cs[:, _CS_N], makespan_sum=cs[:, _CS_T],
            makespan_sumsq=cs[:, _CS_T2], waste_sum=cs[:, _CS_WASTE],
            waste_sumsq=cs[:, _CS_WASTE2], n_faults=cs[:, _CS_NF],
            n_proactive_ckpts=cs[:, _CS_NPRO],
            n_regular_ckpts=cs[:, _CS_NREG], n_migrations=cs[:, _CS_NMIG],
            n_exhausted=cs[:, _CS_EXH],
            n_disk_recoveries=cs[:, _CS_DISK],
            n_detections=cs[:, _CS_DET],
        )


@dataclass
class LaneResult:
    """Per-lane results (``collect="lanes"``), arrays of shape ``(L,)``."""

    makespan: np.ndarray
    work: np.ndarray
    n_faults: np.ndarray
    n_proactive_ckpts: np.ndarray
    n_regular_ckpts: np.ndarray
    n_migrations: np.ndarray
    trace_exhausted: np.ndarray
    n_disk_recoveries: np.ndarray
    n_detections: np.ndarray

    @property
    def waste(self) -> np.ndarray:
        return 1.0 - self.work / self.makespan


@dataclass
class _Tally:
    """Outer iterations and host syncs of one engine call."""

    iters: int = 0
    syncs: int = 0

    def any(self, mask: torch.Tensor) -> bool:
        self.syncs += 1
        return bool(mask.any())


# --------------------------------------------------------------------------- #
# The lane machine
# --------------------------------------------------------------------------- #
def _run_chunk(consts: dict, st: dict, *, gen, has_mig: bool, max_iters: int,
               eps: float, tally: _Tally, has_tl: bool = False,
               has_sil: bool = False, frac_q: bool = False) -> dict:
    """Run one packed chunk to completion (or ``max_iters``); returns the
    final lane state.  ``consts`` comes from :func:`tables_from_numpy`,
    ``st`` is the chunk's zeroed state on the same device.  ``gen`` is
    ``(fault kind, param, false-prediction kind, param)``; a kind
    ``"indexed"`` draws that stream with the law columns of ``consts``.

    ``has_mig`` / ``has_tl`` / ``has_sil`` say whether the chunk holds
    migration, two-level or silent-error lanes, and ``frac_q`` whether
    any lane trusts with ``0 < q < 1``: each adds its family's state and
    ops, which every other chunk does not run (two-level chunks need the
    tier columns and ``tier_key`` in ``consts``, fractional ones
    ``tt_key`` and ``ft_key``)."""
    c = cell_gather(consts, consts["cidx"],
                    _CELL_TABLE_KEYS + _LAW_TABLE_KEYS + _TIER_TABLE_KEYS)
    W, C, DR = c["W"], c["C"], c["DR"]
    T_R, T_P, mode = c["T_R"], c["T_P"], c["mode"]
    horizon, window = c["horizon"], c["window"]
    wpp, lead_act = c["wpp"], c["lead_act"]
    tp_eff_default = c["tp_eff_default"]
    mtbf, fp_mean = c["mtbf"], c["fp_mean"]
    recall, q_eff = c["recall"], c["q_eff"]
    fg_key, tc_key, fp_key = c["fg_key"], c["tc_key"], c["fp_key"]
    f_kind, f_param, fp_kind, fp_param = gen
    # law-indexed streams: per-lane law code and (s1, s2) slots
    f_law = f_lp = fp_law = fp_lp = None
    if f_kind == "indexed":
        f_law, f_lp = c["fault_law"], (c["fault_s1"], c["fault_s2"])
    if fp_kind == "indexed":
        fp_law, fp_lp = c["fp_law"], (c["fp_s1"], c["fp_s2"])
    dev = W.device
    inf, nan = math.inf, math.nan
    i64 = torch.int64
    CONT2PH = torch.tensor(B._CONT2PH, dtype=torch.int32, device=dev)
    MODE2PH = torch.tensor(B._MODE2PH, dtype=torch.int32, device=dev)
    is_mig = mode == B._M_MIGRATION
    tp_w = torch.where(torch.isnan(T_P), tp_eff_default, T_P) - C
    fault = dict(kind=f_kind, param=f_param, law=f_law, lp=f_lp)
    # two-level / silent-error constants
    if has_tl:
        tl_m = mode == B._M_TWO_LEVEL
        C2, DR2, fmem, rho = c["C2"], c["DR2"], c["fmem"], c["rho"]
        tier_key = c["tier_key"]
    if has_sil:
        sil_m = mode == B._M_SILENT
        V, kv = c["V"], c["kv"]
    trust = dict(tt_key=c["tt_key"], ft_key=c["ft_key"], q_eff=q_eff) if frac_q else {}

    s = dict(st)

    def predict(mask, fp_mask, until=None):
        """Refill the prediction cursors of ``s`` in place (one walk)."""
        masked_prediction_walk(
            mask, fp_mask, *(s[k] for k in PREDICTION_CURSORS),
            fg_key, mtbf, tc_key, recall, window, fp_key, fp_mean, horizon,
            f_gap=(f_kind, f_param), fp_gap=(fp_kind, fp_param), f_law=f_law,
            f_lp=f_lp, fp_law=fp_law, fp_lp=fp_lp, until=until, tally=tally,
            **trust,
        )

    # prime the cursors: first strike fault, first visible TP, first false
    # prediction; inert (padding) lanes never activate a stream
    phase = s["phase"]
    live = phase != B._PH_DONE

    def neg1():
        return torch.full_like(phase, -1)

    def zf():
        return torch.zeros_like(horizon)

    s.update(
        sf_ctr=neg1(), sf_time=zf(), la_ctr=neg1(), la_time=zf(),
        tp_t0=torch.full_like(horizon, inf), tp_ft=torch.full_like(horizon, nan),
        tp_ctr=neg1(), fp_ctr=neg1(), fp_time=zf(),
    )
    masked_stream_advance(live, s["sf_ctr"], s["sf_time"], fg_key, mtbf, horizon,
                          **fault)
    pvis = live & (q_eff > 0.0)
    fp_act = pvis & torch.isfinite(fp_mean)
    predict(pvis & (recall > 0.0), fp_act)
    s["fp_time"] = s["fp_time"].masked_fill(~fp_act, inf)
    if has_mig:
        s.update(
            ep_ft=torch.full_like(horizon, nan), ep_fctr=neg1(),
            cancel0=neg1(), cancel1=neg1(), cancel2=neg1(),
        )
    # the disk-recovery and detection counters ride along on every chunk;
    # rc is the length of the repair in progress (D + R2 after a disk
    # recovery), corrupt the date of the earliest latent corruption
    s.update(n_disk=torch.zeros_like(s["n_faults"]), n_det=torch.zeros_like(s["n_faults"]))
    if has_tl:
        s.update(saved_d=zf(), dk_ctr=zf(), rc=DR.clone())
    if has_sil:
        s.update(saved_v=zf(), ck_v=zf(), corrupt=torch.full_like(horizon, inf))

    def step():
        t = s["t"]
        saved, unsaved = s["saved"], s["unsaved"]
        period_work, na_saved = s["period_work"], s["na_saved"]
        ep_t0, ep_end = s["ep_t0"], s["ep_end"]
        phase = s["phase"]
        sf_ctr, sf_time = s["sf_ctr"], s["sf_time"]
        n_disk, n_det = s["n_disk"], s["n_det"]
        if has_tl:
            saved_d, dk_ctr, rc = s["saved_d"], s["dk_ctr"], s["rc"]
        if has_sil:
            saved_v, ck_v, corrupt = s["saved_v"], s["ck_v"], s["corrupt"]
        if has_mig:
            ep_ft, ep_fctr = s["ep_ft"], s["ep_fctr"]
            # retire cancel slots the strike cursor has passed
            cancels = [
                s[k].masked_fill(sf_ctr > s[k], -1)
                for k in ("cancel0", "cancel1", "cancel2")
            ]

            def is_cancelled(ctr):
                return (
                    (ctr == cancels[0]) | (ctr == cancels[1])
                    | (ctr == cancels[2])
                )

        prim = torch.zeros_like(phase)  # PRIM_NOOP
        target = torch.zeros_like(t)
        cont = torch.full_like(phase, -1)

        # ---- regular-mode decisions -------------------------------- #
        mn = phase == B._PH_MAIN
        # skip predictions whose action point passed: consume from the
        # merged (pending-TP, next-FP) head
        predict(mn, None, until=(t, lead_act))
        na = torch.minimum(s["tp_t0"], s["fp_time"]) - lead_act

        # clean-period fast-forward
        ffm = mn & (period_work == 0.0) & (unsaved == 0.0) & (sf_time >= t)
        if has_mig:
            ffm &= ~is_cancelled(sf_ctr)
        k_fault = torch.floor((sf_time - t) / T_R)
        k_act = torch.floor((na - t) / T_R)
        k_act = torch.where(t + k_act * T_R >= na, k_act - 1.0, k_act)
        k_done = torch.floor((W - saved - eps) / wpp)
        k_done = torch.where(
            saved + k_done * wpp >= W - eps, k_done - 1.0, k_done
        )
        k = torch.minimum(
            torch.minimum(k_fault, k_act), torch.clamp(k_done, max=4e15)
        )
        # never fuse across a disk-tier or verification checkpoint (they
        # cost more than C): cap the run at the current stride remainder
        if has_tl:
            k = torch.where(tl_m, torch.minimum(k, torch.clamp(rho - 1.0 - dk_ctr, min=0.0)), k)
        if has_sil:
            k = torch.where(sil_m, torch.minimum(k, torch.clamp(kv - 1.0 - ck_v, min=0.0)), k)
        ff = ffm & (k >= 2.0)
        t = torch.where(ff, t + k * T_R, t)
        saved = torch.where(ff, saved + k * wpp, saved)
        n_reg = s["n_reg"] + torch.where(ff, k, 0.0).to(i64)
        if has_tl:
            dk_ctr = torch.where(ff & tl_m, dk_ctr + k, dk_ctr)
        if has_sil:
            ck_v = torch.where(ff & sil_m, ck_v + k, ck_v)

        exhausted = s["exhausted"] | (mn & (t > horizon))
        remaining = wpp - period_work
        ck = mn & (remaining <= eps)
        prim = prim.masked_fill(ck, B._PR_CKPT)
        cont = cont.masked_fill(ck, B._C_CKPTREG)
        na_saved = torch.where(ck, na, na_saved)
        wk_na = mn & ~ck & (na < t + remaining)
        wk_seg = mn & ~ck & ~wk_na
        prim = prim.masked_fill(wk_na | wk_seg, B._PR_WORK)  # credited work
        target = torch.where(wk_na, na, torch.where(wk_seg, t + remaining, target))
        cont = cont.masked_fill(wk_na, B._C_POP_EP).masked_fill(wk_seg, B._C_MAIN)

        # ---- episode entry ----------------------------------------- #
        es = phase == B._PH_EP_START
        emig = es & is_mig
        if has_mig:
            # the predicted fault hits the vacated node: cancel it by
            # fault-counter index; slots fill and retire in fault order,
            # a fourth simultaneously-pending cancel is dropped
            can = emig & ~torch.isnan(ep_ft) & (ep_ft >= t)
            c0, c1, c2 = cancels
            f0 = c0 < 0
            f1 = ~f0 & (c1 < 0)
            f2 = ~f0 & ~f1 & (c2 < 0)
            cancels = [
                torch.where(can & f0, ep_fctr, c0),
                torch.where(can & f1, ep_fctr, c1),
                torch.where(can & f2, ep_fctr, c2),
            ]
        prim = prim.masked_fill(emig, B._PR_IDLE)
        target = torch.where(emig, ep_t0, target)
        cont = cont.masked_fill(emig, B._C_MIG)
        rest = es & ~is_mig
        d = ep_t0 - C
        b1 = rest & (t < d)  # room for the pre-window checkpoint
        b2 = rest & ~(t < d) & (t <= d)  # exactly at t0 - C
        b3 = rest & (t > d)  # no time for the extra checkpoint
        prim = prim.masked_fill(b2, B._PR_CKPT).masked_fill(b1 | b3, B._PR_WORK)
        target = torch.where(b1, d, torch.where(b3, t, target))
        cont = (
            cont.masked_fill(b1, B._C_PRECKPT).masked_fill(b2, B._C_MODE)
            .masked_fill(b3, B._C_NT2)
        )

        # ---- pending episode primitives ---------------------------- #
        pmk = phase == B._PH_EP_PRECKPT
        prim = prim.masked_fill(pmk, B._PR_CKPT)
        cont = cont.masked_fill(pmk, B._C_MODE)

        nt2 = phase == B._PH_EP_NT2
        prim = prim.masked_fill(nt2, PRIM_WORK_NC)
        target = torch.where(nt2, ep_t0, target)
        cont = cont.masked_fill(nt2, B._C_MODE)

        nck = phase == B._PH_EP_NOCKPT
        prim = prim.masked_fill(nck, PRIM_WORK_NC)
        target = torch.where(nck, ep_end, target)
        cont = cont.masked_fill(nck, B._C_MAIN)

        wc = phase == B._PH_EP_WC
        over = wc & (t >= ep_end - eps)
        phase = phase.masked_fill(over, B._PH_MAIN)  # window exhausted
        g = wc & ~over
        seg = torch.minimum(t + tp_w, ep_end - C)
        wsel = g & (seg > t)
        gk = g & ~wsel
        prim = prim.masked_fill(gk, B._PR_CKPT).masked_fill(wsel, PRIM_WORK_NC)
        target = torch.where(wsel, seg, target)
        cont = cont.masked_fill(gk, B._C_WC).masked_fill(wsel, B._C_WC_CKPT)

        wck = phase == B._PH_EP_WC_CKPT
        prim = prim.masked_fill(wck, B._PR_CKPT)
        cont = cont.masked_fill(wck, B._C_WC)

        # ---- execute one primitive per lane ------------------------ #
        workm = (prim == B._PR_WORK) | (prim == PRIM_WORK_NC)
        res = prim != B._PR_NOOP
        # cap at job completion, pre-resolution clock (scalar order of ops)
        target = torch.where(workm, torch.minimum(target, t + (W - saved - unsaved)), target)
        ckend = t + C
        # intent masks fixed with the end date: the rho-th regular
        # checkpoint of a two-level lane is the disk tier (cost C + C2), the
        # k_V-th regular checkpoint of a silent-error lane verifies (cost
        # C + V); proactive checkpoints hit the memory tier, never verify
        if has_tl or has_sil:
            reg_int = (prim == B._PR_CKPT) & (cont == B._C_CKPTREG)
        if has_tl:
            disk_int = reg_int & tl_m & (dk_ctr >= rho - 1.0)
            ckend = torch.where(disk_int, ckend + C2, ckend)
        if has_sil:
            ver_int = reg_int & sil_m & (ck_v >= kv - 1.0)
            ckend = torch.where(ver_int, ckend + V, ckend)

        # resolve stale faults (a fault during downtime restarts the
        # repair in progress, of length rc: D + R, or D + R2 after a disk
        # recovery); cancelled faults are skipped; silent-error strikes
        # are not fail-stop events, so those lanes skip the cascade
        t, sf_ctr, sf_time, n_faults = masked_strike_walk(
            res & ~sil_m if has_sil else res, t, sf_ctr, sf_time, s["n_faults"],
            rc if has_tl else DR, fg_key, mtbf, horizon,
            **fault, cancels=cancels if has_mig else None, tally=tally,
        )

        # the hot step: the struck fault is consumed and the strike cursor
        # refilled inside the kernel (nf IS the strike cursor's date).
        # Two-level and silent chunks hand the kernel a copy: sf_time keeps
        # the struck date (the disk recovery restarts from it) and the
        # silent lanes' cursor, masked to +inf in the copy (silent strikes
        # never interrupt a primitive, so the kernel leaves their counter
        # alone), is kept from it
        if has_tl:
            # the tier coin of the fault struck now: the pre-consumption
            # counter (the kernel advances sf_ctr in place)
            u_tier = counter_uniform(tier_key, sf_ctr)
        if has_sil:
            nf = sf_time.masked_fill(sil_m, inf)
        elif has_tl:
            nf = sf_time.clone()
        else:
            nf = sf_time
        stream = (fg_key, sf_ctr, nf, mtbf, horizon)
        if f_kind == "indexed":
            stream += (f_law, *f_lp)
        # (the refilled cursor lands in sf_ctr and nf, in place)
        t, saved, unsaved, period_work, flags = masked_primitive_update(
            prim, cont, target, ckend, nf,
            t, saved, unsaved, period_work, W, DR,
            eps=eps, reg_cont=int(B._C_CKPTREG),
            stream=stream, gap=(f_kind, f_param),
        )[:5]
        faulted = (flags & FLAG_FAULTED) != 0
        ok = (flags & FLAG_OK) != 0
        fin = (flags & FLAG_FIN) != 0
        cok = (flags & FLAG_CKPT_OK) != 0
        reg = (flags & FLAG_REG) != 0

        n_faults = n_faults + faulted.to(i64)
        phase = phase.masked_fill(faulted, B._PH_MAIN).masked_fill(fin, B._PH_DONE)
        n_pro = s["n_pro"] + (cok & ~reg).to(i64)
        n_reg = n_reg + reg.to(i64)

        if has_tl:
            # disk-tier recovery: restart from the last disk checkpoint (the
            # kernel applied the memory-tier rollback t = nf + DR)
            disk = faulted & tl_m & (u_tier >= fmem)
            mem = faulted & tl_m & ~disk
            t = torch.where(disk, sf_time + DR2, t)
            saved = torch.where(disk, saved_d, saved)
            dk_ctr = dk_ctr.masked_fill(disk, 0.0)
            rc = torch.where(mem, DR, torch.where(disk, DR2, rc))
            n_disk = n_disk + disk.to(i64)
            # a completed disk-tier checkpoint promotes the durable
            # frontier; a completed memory-tier regular one advances the
            # nesting counter (proactive checkpoints do not)
            dk = cok & disk_int
            saved_d = torch.where(dk, saved, saved_d)
            dk_ctr = dk_ctr.masked_fill(dk, 0.0)
            dk_ctr = torch.where(reg & tl_m & ~disk_int, dk_ctr + 1.0, dk_ctr)
        if has_sil:
            sf_time = torch.where(sil_m, sf_time, nf)
        elif has_tl:
            sf_time = nf

        if has_sil:
            # consume latent strikes up to the new clock: they corrupt the
            # state silently instead of interrupting the primitive
            sf_ctr, sf_time, corrupt = masked_silent_walk(
                res & sil_m, t, sf_ctr, sf_time, corrupt, fg_key, mtbf, horizon,
                **fault, tally=tally,
            )
            # verification caught a latent corruption: roll back past every
            # unverified checkpoint to the verified frontier
            vok = cok & ver_int
            det = vok & torch.isfinite(corrupt)
            t = torch.where(det, t + DR, t)
            saved = torch.where(det, saved_v, saved)
            period_work = period_work.masked_fill(det, 0.0)
            corrupt = corrupt.masked_fill(det, inf)
            n_faults = n_faults + det.to(i64)
            n_det = n_det + det.to(i64)
            saved_v = torch.where(vok & ~det, saved, saved_v)
            ck_v = ck_v.masked_fill(vok, 0.0)
            ck_v = torch.where(reg & sil_m & ~ver_int, ck_v + 1.0, ck_v)

        # ---- continuations on success ------------------------------ #
        cmask = ok & (phase != B._PH_DONE)
        cc = cont.clamp(0, CONT2PH.shape[0] - 1)
        phase = torch.where(cmask, CONT2PH.index_select(0, cc), phase)
        n_mig = s["n_mig"] + (cmask & (cont == B._C_MIG)).to(i64)
        modem = cmask & (cont == B._C_MODE)
        phase = torch.where(modem, MODE2PH.index_select(0, mode), phase)
        popm = cmask & (cont == B._C_POP_EP)
        ckr = cmask & (cont == B._C_CKPTREG)

        # pop the merged-head prediction into the episode registers and
        # refill the consumed cursor; for _C_CKPTREG (action point fell
        # inside the regular checkpoint) enter the episode only if the
        # window start is still current
        p0v = torch.minimum(s["tp_t0"], s["fp_time"])
        takep = ckr & (na_saved <= t) & torch.isfinite(p0v)
        good = takep & (p0v >= t - 1e-9)
        pop = popm | takep
        use_tp = pop & (s["tp_t0"] <= s["fp_time"])
        ep_t0 = torch.where(pop, p0v, ep_t0)
        ep_end = torch.where(pop, p0v + window, ep_end)
        phase = phase.masked_fill(popm | good, B._PH_EP_START)
        if has_mig:
            ep_ft = torch.where(
                pop, torch.where(use_tp, s["tp_ft"], nan), ep_ft
            )
            ep_fctr = torch.where(
                pop, s["tp_ctr"].masked_fill(~use_tp, -1), ep_fctr
            )
            s.update(ep_ft=ep_ft, ep_fctr=ep_fctr, cancel0=cancels[0],
                     cancel1=cancels[1], cancel2=cancels[2])
        predict(use_tp, pop & ~use_tp)

        s.update(
            t=t, saved=saved, unsaved=unsaved, period_work=period_work,
            na_saved=na_saved, ep_t0=ep_t0, ep_end=ep_end,
            n_faults=n_faults, n_pro=n_pro, n_reg=n_reg, n_mig=n_mig,
            phase=phase, exhausted=exhausted, sf_ctr=sf_ctr, sf_time=sf_time,
            n_disk=n_disk, n_det=n_det,
        )
        if has_tl:
            s.update(saved_d=saved_d, dk_ctr=dk_ctr, rc=rc)
        if has_sil:
            s.update(saved_v=saved_v, ck_v=ck_v, corrupt=corrupt)

    it = 0
    while it < max_iters:
        if it % POLL == 0 and not tally.any(s["phase"] != B._PH_DONE):
            break
        step()
        it += 1
    tally.iters += it
    return s


def _cell_sums(s: dict, W: torch.Tensor, cidx: torch.Tensor, n_seg: int) -> torch.Tensor:
    """The ``(n_seg, 13)`` per-cell Monte-Carlo sums of one finished chunk
    (``_CS_*`` column order)."""
    ft = s["t"]
    waste = 1.0 - W / ft
    return segment_cell_sums(
        [
            torch.ones_like(ft),  # lane count
            ft, ft * ft,  # makespan moments
            waste, waste * waste,  # waste moments
            s["n_faults"], s["n_pro"], s["n_reg"], s["n_mig"],
            s["exhausted"], s["n_disk"], s["n_det"],
            s["phase"] != B._PH_DONE,  # convergence
        ],
        cidx, n_seg,
    )


def _dist_static(d):
    """A stream's sampler: ``(kind, param)`` of one law, or ``("indexed",
    0.0)`` for a per-cell tuple of laws (which then ride the tables)."""
    if isinstance(d, tuple):
        for x in d:
            E.require_inverse_cdf(x)
        return "indexed", 0.0
    E.require_inverse_cdf(d)
    return d.kind, float(d.param)


def simulate_batch_torch(
    work_c,
    plats_c,
    strats_c,
    spec: TraceSpec,
    *,
    device=None,
    chunk="auto",
    max_iters: int = 5_000_000,
    collect: str = "stats",
    info: Optional[dict] = None,
):
    """Run a cell-indexed device-trace sweep through the lane machine.

    ``work_c`` / ``plats_c`` / ``strats_c`` describe the ``spec.n_cells``
    cells; ``spec`` maps the lanes onto them and carries the failure law:
    one :class:`~repro_torch.core.events.Distribution` (the single-law
    kernels) or a tuple of them, one per cell (the law-indexed kernels).
    Every strategy mode runs (two-level and silent-error cells among
    them), at any trust level.  Runs on CUDA unless ``device`` names
    another device (``device="cpu"`` runs the kernels' plain PyTorch
    versions).

    chunk       lanes resident at once ("auto": :func:`default_chunk_lanes`;
                None: all lanes).  Results do not depend on it, apart
                from the rounding of the per-cell float sums.
    collect     "stats" (default): per-cell :class:`CellSums` reduced on
                the device; "lanes": per-lane :class:`LaneResult`.
    info        a dict the call fills with its device, outer iterations
                (summed over chunks), host syncs and chunk count.
    """
    dev = resolve_device(device)
    if collect not in ("lanes", "stats"):
        raise ValueError(f"unknown collect {collect!r} (expected 'lanes' or 'stats')")
    if not isinstance(spec, TraceSpec):
        raise TypeError("simulate_batch_torch needs a cell-indexed TraceSpec")
    L, n_cells = spec.n_lanes, spec.n_cells
    cidx_g = spec.cell_index
    plats, strats = B._cell_lists(plats_c, strats_c, n_cells)
    W, C, D, R, M, T_R, T_P, mode, q = B._lane_params(work_c, plats, strats, n_cells)
    tl_c, sil_c = mode == B._M_TWO_LEVEL, mode == B._M_SILENT
    tier = B._tier_params(plats, strats) if (tl_c | sil_c).any() else None
    # no predictions on mode "none"; silent-error cells never trust the
    # fail-stop predictor; 0 < q < 1 thins both prediction streams by
    # trust coins
    q_eff = np.where((mode == B._M_NONE) | sil_c, 0.0, np.clip(q, 0.0, 1.0))
    frac_c = (q_eff > 0.0) & (q_eff < 1.0)
    f_kind, f_param = _dist_static(spec.fault_dist)
    fp_kind, fp_param = _dist_static(spec.false_pred_dist)
    gen = (f_kind, f_param, fp_kind, fp_param)
    n_tab = max(8, 1 << int(n_cells).bit_length())
    fdt, idt = np.float64, np.int64
    tables = _cell_tables(
        n_cells, n_tab, fdt, W, C, D, R, M, T_R, T_P, mode,
        spec.horizon, spec.window,
        spec.mtbf, spec.fp_mean, spec.recall, q_eff,
        fault_laws=E.law_table(spec.fault_dist) if f_kind == "indexed" else None,
        fp_laws=E.law_table(spec.false_pred_dist) if fp_kind == "indexed" else None,
        tier=tier,
    )
    if chunk == "auto":
        chunk = default_chunk_lanes(dev)
    chunk = max(L, 1) if chunk is None else min(int(chunk), max(L, 1))
    tally = _Tally()
    acc = torch.zeros(n_tab, 13, dtype=torch.float64, device=dev)
    outs = []
    n_chunks = 0
    for lo in range(0, L, chunk):
        sl = slice(lo, min(lo + chunk, L))
        n_chunks += 1
        consts, state = _pack_chunk_spec_cells(
            tables, spec, cidx_g, n_cells, sl, sl.stop - sl.start, fdt, idt
        )
        # each chunk runs the state and ops of the families it holds
        cells = cidx_g[sl]
        has_mig = bool((mode[cells] == B._M_MIGRATION).any())
        has_tl, has_sil = bool(tl_c[cells].any()), bool(sil_c[cells].any())
        frac_q = bool(frac_c[cells].any())
        keys = _BASE_KEYS + ("tier_key",) * has_tl + ("tt_key", "ft_key") * frac_q
        c = tables_from_numpy(consts, dev, keys)
        fin = _run_chunk(
            c, _to_device(state, dev), gen=gen, has_mig=has_mig, has_tl=has_tl,
            has_sil=has_sil, frac_q=frac_q, max_iters=max_iters, eps=float(_EPS),
            tally=tally,
        )
        if collect == "stats":
            Wl = c["W"].index_select(0, c["cidx"])
            acc += _cell_sums(fin, Wl, c["cidx"], n_tab)
        else:
            out = {
                k: fin[k].cpu().numpy()
                for k in ("t", "n_faults", "n_pro", "n_reg", "n_mig",
                          "exhausted", "n_disk", "n_det", "phase")
            }
            if not (out.pop("phase") == B._PH_DONE).all():
                raise RuntimeError("torch lane machine did not converge")
            outs.append(out)
    if info is not None:
        info.update(
            device=str(dev), outer_iters=tally.iters, host_syncs=tally.syncs,
            n_chunks=n_chunks,
        )
    if collect == "stats":
        cs = acc.cpu().numpy()
        if cs[:n_cells, _CS_NOTDONE].sum() != 0.0:
            raise RuntimeError("torch lane machine did not converge")
        return CellSums.from_matrix(cs[:n_cells])
    if not outs:
        z, zi = np.zeros(0), np.zeros(0, np.int64)
        return LaneResult(z, z, zi, zi, zi, zi, np.zeros(0, bool), zi, zi)
    cat = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return LaneResult(
        makespan=cat["t"],
        work=W[cidx_g],
        n_faults=cat["n_faults"],
        n_proactive_ckpts=cat["n_pro"],
        n_regular_ckpts=cat["n_reg"],
        n_migrations=cat["n_mig"],
        trace_exhausted=cat["exhausted"],
        n_disk_recoveries=cat["n_disk"],
        n_detections=cat["n_det"],
    )
