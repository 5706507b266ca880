"""The device lane machine: the fused paper-grid Monte-Carlo sweep in
PyTorch, with its hot step in hand-written CUDA kernels.

:func:`simulate_batch_torch` is the port of the reference engine
``repro.core.jax_sim._jit_run`` in both trace modes: the device trace mode
(a :class:`~repro_torch.core.events.TraceSpec`, events drawn on the device)
and the host trace mode (:class:`~repro_torch.core.events.BatchTraces`,
events drawn on the host with NumPy; see *Host trace mode* below).  A spec whose laws are
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

Host trace mode.  Trust is filtered on the host
(:func:`~repro_torch.core.batch_sim._filter_trusted`, one NumPy coin per
prediction at fractional q), then each chunk's events are packed as the
reference packs them (:func:`_pack_chunk`): per-lane parameters and
``(events, lanes)`` slabs of the fault dates ``F``, the merged prediction
window starts ``P0`` and their fault dates ``Pft`` (``+inf`` / ``nan``
padding) and, on two-level chunks, the tier coins ``Ftier`` (1.0
padding); each slab is cut to its chunk's widest lane plus the sentinel
row, and shipped to the card once, through pinned memory.  Every lane
reads its events through two int64 cursors, ``fi`` (the next fault) and
``pi`` (the next trusted prediction).  The cursor loops are one launch
each: :func:`~repro_torch.kernels.sim_step.masked_slab_prediction_skip`,
:func:`~repro_torch.kernels.sim_step.masked_slab_strike_walk` (which also
marks a migration's cancelled fault in the ``Fcancel`` slab: the search
from the lane's own cursor runs inside the kernel, so no ``(F, L)``
compare and no host sync) and, on silent-error chunks,
:func:`~repro_torch.kernels.sim_step.masked_slab_silent_walk`; the
primitive is :func:`~repro_torch.kernels.sim_step.masked_primitive_update`
without a stream (the trace-fed body).  The rest is the same masked glue
as in device mode, the pop a gather from the slabs.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, fields, replace
from contextlib import nullcontext
from typing import List, Optional, Union

import numpy as np
import torch

from . import batch_sim as B
from . import events as E
from .batch_sim import pad_lane_axis
from .events import BatchTraces, TraceSpec
from .simulator import _EPS, SimResult, Strategy
from .waste import Platform
from ..kernels.sim_step import (
    FLAG_CKPT_OK, FLAG_FAULTED, FLAG_FIN, FLAG_OK, FLAG_REG, PREDICTION_CURSORS,
    PRIM_WORK_NC, cell_gather, counter_uniform, masked_prediction_walk,
    masked_primitive_update, masked_silent_walk, masked_slab_prediction_skip,
    masked_slab_silent_walk, masked_slab_strike_walk, masked_stream_advance,
    masked_strike_walk, segment_cell_sums, take,
)

__all__ = [
    "simulate_batch_torch",
    "CellSums",
    "LaneResult",
    "resolve_device",
    "resolve_devices",
    "default_chunk_lanes",
    "tables_from_numpy",
]

#: the outer loop checks for termination every POLL iterations
POLL = 8

#: chunk="auto": lanes resident at once (a whole paper grid fits one chunk
#: on the card; the CPU path exists for tests at small sizes)
_DEFAULT_CHUNK_CUDA = 1 << 20
_DEFAULT_CHUNK_CPU = 10240
#: ... in host trace mode: the reference's CPU chunk, and on the card as
#: many lanes as fit this budget of slab bytes (between the reference's
#: accelerator chunk and the device mode's), so a paper grid's slabs go
#: in one chunk and its lane loop runs once
_DEFAULT_CHUNK_CPU_HOST = 5120
_HOST_CHUNK_CUDA_MIN = 16384
_HOST_SLAB_BUDGET_CUDA = 8 << 30


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


def resolve_devices(devices=None, device=None) -> List[torch.device]:
    """The device set a sweep's lanes are sharded over, by the reference's
    rules for ``devices=``: ``None`` is the one device of
    :func:`resolve_device` (``device=`` is that spelling, and passing both
    raises), ``"all"`` every CUDA device, an int ``n`` the first ``n``
    CUDA devices, and a sequence those devices (repeats allowed: two
    shards on one card)."""
    if devices is None:
        return [resolve_device(device)]
    if device is not None:
        raise ValueError("pass either device= or devices=, not both")
    n_cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if isinstance(devices, str):
        if devices != "all":
            raise ValueError(f"devices={devices!r} (expected 'all')")
        if not n_cuda:
            raise RuntimeError(
                "devices='all' found no CUDA device; name the devices, e.g. "
                "devices=['cpu'], to run the plain PyTorch path on the CPU"
            )
        return [torch.device("cuda", i) for i in range(n_cuda)]
    if isinstance(devices, int) and not isinstance(devices, bool):
        if not 1 <= devices <= n_cuda:
            raise ValueError(
                f"devices={devices} but this process has {n_cuda} CUDA device(s)"
            )
        return [torch.device("cuda", i) for i in range(devices)]
    devs = [resolve_device(d) for d in devices]
    if not devs:
        raise ValueError("devices= must name at least one device")
    return devs


def default_chunk_lanes(device: torch.device, trace_mode: str = "device",
                        lane_bytes: int = 0) -> int:
    """The lane count ``chunk="auto"`` resolves to on ``device``.  In host
    trace mode on the card it depends on ``lane_bytes``, the slab bytes of
    one lane: as many lanes as :data:`_HOST_SLAB_BUDGET_CUDA` holds, at
    least :data:`_HOST_CHUNK_CUDA_MIN` and at most the device mode's
    chunk."""
    if trace_mode == "device":
        return _DEFAULT_CHUNK_CUDA if device.type == "cuda" else _DEFAULT_CHUNK_CPU
    if device.type != "cuda":
        return _DEFAULT_CHUNK_CPU_HOST
    fit = _HOST_SLAB_BUDGET_CUDA // max(int(lane_bytes), 1)
    return int(min(max(fit, _HOST_CHUNK_CUDA_MIN), _DEFAULT_CHUNK_CUDA))


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


def _pack_scalar_chunk(
    sl: slice, n_pad: int, fdt, idt,
    W, C, D, R, M, T_R, T_P, mode, horizon, window, horizon_fill,
    cidx=None, pad_cell=0, tl=None, sil=None,
):
    """Per-lane scalar packing of one chunk (the host trace mode's): the
    engine constants of the lanes ``sl`` padded to ``n_pad`` with benign
    fills, the zeroed lane state and, given ``cidx``, the lane -> cell
    index (padding lanes on row ``pad_cell``).  ``tl`` = ``(C2, R2,
    fmem, rho)`` and ``sil`` = ``(V, kv)`` add the two-level and
    silent-error columns.  Returns ``(fvec, consts, state)``."""
    state = _chunk_state(sl, n_pad, fdt, idt)

    def fvec(x, fill=0.0):
        return pad_lane_axis(x[sl], n_pad, fill).astype(fdt)

    Ch = fvec(C, 1.0)
    Mh = fvec(M, 1.0)
    modeh = pad_lane_axis(mode[sl], n_pad, 0).astype(np.int32)
    T_Rh = fvec(T_R, 2.0)
    windowh = fvec(window)
    consts = {
        "W": fvec(W, 1.0),
        "C": Ch,
        "DR": fvec(D) + fvec(R),
        "T_R": T_Rh,
        "T_P": fvec(T_P, np.nan),
        "mode": modeh,
        "horizon": fvec(horizon, horizon_fill),
        "window": windowh,
        "wpp": np.maximum(T_Rh - Ch, 1e-9),
        "lead_act": np.where(modeh == B._M_MIGRATION, Mh, Ch),
        "tp_eff_default": np.maximum(Ch, windowh),
    }
    if tl is not None:
        C2a, R2a, fmema, rhoa = tl
        consts["C2"] = fvec(C2a)
        consts["DR2"] = fvec(D) + fvec(R2a)
        consts["fmem"] = fvec(fmema)
        consts["rho"] = fvec(rhoa, 1.0)
    if sil is not None:
        Va, kva = sil
        consts["V"] = fvec(Va)
        consts["kv"] = fvec(kva, 1.0)
    if cidx is not None:
        consts["cidx"] = pad_lane_axis(cidx[sl].astype(np.int32), n_pad, pad_cell)
    return fvec, consts, state


#: the host trace mode's event slabs
_SLABS = ("F", "P0", "Pft", "Ftier")


def _pack_chunk(
    has_migration: bool, sl: slice, n_pad: int, fdt, idt,
    W, C, D, R, M, T_R, T_P, mode, F, P0, Pft, horizon, window,
    cidx=None, pad_cell=0, tl=None, sil=None, Ftier=None, alloc=None,
):
    """Host trace mode packing of one chunk, as the reference packs it:
    :func:`_pack_scalar_chunk`'s per-lane parameters plus the event slabs
    ``F`` / ``P0`` / ``Pft`` (and ``Ftier`` on two-level chunks) in the
    ``(events, lanes)`` layout, padded with ``+inf`` / ``+inf`` / ``nan``
    (1.0), and the state's cursors ``fi`` / ``pi`` (int32 zeros) and, on
    migration chunks, ``ep_ft`` (``nan``) and the ``Fcancel`` marks.
    ``alloc(shape, dtype)``, when given, supplies each slab's buffer (the
    pinned staging buffers of a CUDA run); the transpose writes into
    it."""
    fvec, consts, state = _pack_scalar_chunk(
        sl, n_pad, fdt, idt,
        W, C, D, R, M, T_R, T_P, mode, horizon, window, np.inf,
        cidx=cidx, pad_cell=pad_cell, tl=tl, sil=sil,
    )

    def events(a):  # (n_pad, E) -> (E, n_pad)
        if alloc is None:
            return np.ascontiguousarray(a.T)
        out = alloc((a.shape[1], a.shape[0]), a.dtype)
        np.copyto(out, a.T)
        return out

    def lanes(a, fill):
        return pad_lane_axis(a[sl], n_pad, fill).astype(fdt, copy=False)

    consts.update(F=events(lanes(F, np.inf)), P0=events(lanes(P0, np.inf)),
                  Pft=events(lanes(Pft, np.nan)))
    if Ftier is not None:
        # per-fault recovery-tier coins, aligned column for column with F
        consts["Ftier"] = events(lanes(Ftier, 1.0))
    state["fi"] = np.zeros(n_pad, np.int32)
    state["pi"] = np.zeros(n_pad, np.int32)
    if has_migration:
        state["ep_ft"] = np.full(n_pad, np.nan, fdt)
        state["Fcancel"] = np.zeros(consts["F"].shape, bool)
    return consts, state


class _PinnedSlabs:
    """``alloc`` of :func:`_pack_chunk` on a CUDA run: each slab is
    staged in page-locked host memory (PyTorch's caching host allocator),
    and :meth:`ship` copies the chunk's slabs to the card once."""

    def __init__(self):
        self.bufs = {}

    def __call__(self, shape, dtype):
        buf = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                          pin_memory=True)
        arr = buf.numpy()
        self.bufs[arr.ctypes.data] = buf
        return arr

    def ship(self, arr: np.ndarray, device) -> torch.Tensor:
        return self.bufs[arr.ctypes.data].to(device, non_blocking=True)


def _host_lane_bytes(fw: int, pw: int, has_mig: bool, has_tl: bool) -> int:
    """Slab bytes of one lane: ``F`` (and ``Ftier``, the ``Fcancel``
    marks) over ``fw`` rows, ``P0`` and ``Pft`` over ``pw`` rows."""
    return fw * (8 + 8 * has_tl + has_mig) + pw * 16


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

    def as_matrix(self) -> np.ndarray:
        """The ``(n_cells, 12)`` f64 column matrix (``_CS_*`` order, minus
        the not-done flag): sums are plain f64 adds, so partial sweeps
        accumulate by matrix addition, as the resumable campaign's
        durable accumulator (:mod:`repro_torch.ft.campaign`) does chunk
        by chunk."""
        return np.stack(
            [np.asarray(getattr(self, f.name), np.float64) for f in fields(self)],
            axis=1,
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

    def to_results(self) -> List[SimResult]:
        """One scalar :class:`~repro_torch.core.simulator.SimResult` a
        lane, as the NumPy engine's ``BatchResult.to_results``."""
        return [
            SimResult(
                makespan=float(self.makespan[i]), work=float(self.work[i]),
                n_faults=int(self.n_faults[i]),
                n_proactive_ckpts=int(self.n_proactive_ckpts[i]),
                n_regular_ckpts=int(self.n_regular_ckpts[i]),
                n_migrations=int(self.n_migrations[i]),
                trace_exhausted=bool(self.trace_exhausted[i]),
                n_disk_recoveries=int(self.n_disk_recoveries[i]),
                n_detections=int(self.n_detections[i]),
            )
            for i in range(self.makespan.shape[0])
        ]


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
def _on(dev: torch.device):
    """Make ``dev`` the current CUDA device (the kernels launch on the
    current device's stream); a no-op context on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()


def _run_shards(machines, devs, max_iters: int, tally: _Tally) -> list:
    """Run the shards of one chunk to completion (or ``max_iters``) with
    their outer iterations interleaved: an iteration steps every live
    shard once, each on its own device, so shards on several cards run
    concurrently.  Every :data:`POLL` iterations the termination poll
    reads each live shard's flag (a host sync each) and drops the shards
    whose lanes are all done.  ``machines`` are :func:`_chunk_machine`'s
    ``(state, step)`` pairs, ``devs`` their devices; returns the final
    states."""
    live = list(range(len(machines)))
    it = 0
    while it < max_iters:
        if it % POLL == 0:
            live = [i for i in live
                    if tally.any(machines[i][0]["phase"] != B._PH_DONE)]
            if not live:
                break
        for i in live:
            with _on(devs[i]):
                machines[i][1]()
        it += 1
    tally.iters += it
    return [m[0] for m in machines]


def _run_chunk(consts, st, *, max_iters: int, tally: _Tally, devs=None, **kw):
    """Run one packed chunk to completion (or ``max_iters``) and return its
    final lane state.  ``consts`` / ``st`` are one shard's dicts, or lists
    of them, one a shard on the devices ``devs`` (then a list of final
    states comes back); ``kw`` are :func:`_chunk_machine`'s keywords."""
    if isinstance(consts, dict):
        return _run_chunk([consts], [st], max_iters=max_iters, tally=tally,
                          devs=devs, **kw)[0]
    devs = devs or [c["W"].device for c in consts]
    machines = []
    for c, s, d in zip(consts, st, devs):
        with _on(d):
            machines.append(_chunk_machine(c, s, tally=tally, **kw))
    return _run_shards(machines, devs, max_iters, tally)


def _chunk_machine(consts: dict, st: dict, *, gen, has_mig: bool, eps: float,
                   tally: _Tally, has_tl: bool = False, has_sil: bool = False,
                   frac_q: bool = False):
    """The lane machine of one packed chunk (or shard): primes the
    chunk's cursors and returns ``(state, step)``, where ``step()``
    advances every lane by one outer iteration and updates the ``state``
    dict in place (:func:`_run_shards` runs it).  ``st`` is the chunk's
    zeroed state on the device of ``consts``, which must be the current
    device while priming and stepping.

    Device trace mode: ``consts`` comes from :func:`tables_from_numpy`
    (cell tables and stream keys) and ``gen`` is ``(fault kind, param,
    false-prediction kind, param)``; a kind ``"indexed"`` draws that
    stream with the law columns of ``consts``.  Host trace mode (``consts``
    holds the slab ``"F"``): ``consts`` holds :func:`_pack_chunk`'s
    per-lane parameters and slabs, ``st`` its cursors (``gen`` and
    ``frac_q`` are unused: trust was filtered on the host).

    ``has_mig`` / ``has_tl`` / ``has_sil`` say whether the chunk holds
    migration, two-level or silent-error lanes, and ``frac_q`` whether
    any lane trusts with ``0 < q < 1``: each adds its family's state and
    ops, which every other chunk does not run (two-level chunks need the
    tier columns and ``tier_key`` (``Ftier``) in ``consts``, fractional
    ones ``tt_key`` and ``ft_key``)."""
    host = "F" in consts
    if host:
        c = consts
        F, P0, Pft, Ftier = (consts.get(k) for k in _SLABS)
    else:
        c = cell_gather(consts, consts["cidx"],
                        _CELL_TABLE_KEYS + _LAW_TABLE_KEYS + _TIER_TABLE_KEYS)
    W, C, DR = c["W"], c["C"], c["DR"]
    T_R, T_P, mode = c["T_R"], c["T_P"], c["mode"]
    horizon, window = c["horizon"], c["window"]
    wpp, lead_act = c["wpp"], c["lead_act"]
    tp_eff_default = c["tp_eff_default"]
    dev = W.device
    inf, nan = math.inf, math.nan
    i64 = torch.int64
    CONT2PH = torch.tensor(B._CONT2PH, dtype=torch.int32, device=dev)
    MODE2PH = torch.tensor(B._MODE2PH, dtype=torch.int32, device=dev)
    is_mig = mode == B._M_MIGRATION
    tp_w = torch.where(torch.isnan(T_P), tp_eff_default, T_P) - C
    # two-level / silent-error constants
    if has_tl:
        tl_m = mode == B._M_TWO_LEVEL
        C2, DR2, fmem, rho = c["C2"], c["DR2"], c["fmem"], c["rho"]
    if has_sil:
        sil_m = mode == B._M_SILENT
        V, kv = c["V"], c["kv"]

    s = dict(st)
    phase = s["phase"]

    def zf():
        return torch.zeros_like(horizon)

    if host:
        # int64 cursors into the slabs (the gathers' index type)
        s.update(fi=s["fi"].to(i64), pi=s["pi"].to(i64))
    else:
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
        fault = dict(kind=f_kind, param=f_param, law=f_law, lp=f_lp)
        if has_tl:
            tier_key = c["tier_key"]
        trust = dict(tt_key=c["tt_key"], ft_key=c["ft_key"], q_eff=q_eff) if frac_q else {}

        def predict(mask, fp_mask, until=None):
            """Refill the prediction cursors of ``s`` in place (one walk)."""
            masked_prediction_walk(
                mask, fp_mask, *(s[k] for k in PREDICTION_CURSORS),
                fg_key, mtbf, tc_key, recall, window, fp_key, fp_mean, horizon,
                f_gap=(f_kind, f_param), fp_gap=(fp_kind, fp_param), f_law=f_law,
                f_lp=f_lp, fp_law=fp_law, fp_lp=fp_lp, until=until, tally=tally,
                **trust,
            )

        # prime the cursors: first strike fault, first visible TP, first
        # false prediction; inert (padding) lanes never activate a stream
        live = phase != B._PH_DONE

        def neg1():
            return torch.full_like(phase, -1)

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
        n_disk, n_det = s["n_disk"], s["n_det"]
        if has_tl:
            saved_d, dk_ctr, rc = s["saved_d"], s["dk_ctr"], s["rc"]
        if has_sil:
            saved_v, ck_v, corrupt = s["saved_v"], s["ck_v"], s["corrupt"]
        if host:
            fi, pi = s["fi"], s["pi"]
            if has_mig:
                ep_ft, Fcancel = s["ep_ft"], s["Fcancel"]
        else:
            sf_ctr, sf_time = s["sf_ctr"], s["sf_time"]
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
        # skip predictions whose action point passed (host: the trusted
        # prediction cursor; device: consume from the merged (pending-TP,
        # next-FP) head); curf is the next pending fault
        if host:
            masked_slab_prediction_skip(mn, t, lead_act, P0, pi, tally=tally)
            na = take(P0, pi) - lead_act
            curf = take(F, fi)
        else:
            predict(mn, None, until=(t, lead_act))
            na = torch.minimum(s["tp_t0"], s["fp_time"]) - lead_act
            curf = sf_time

        # clean-period fast-forward
        ffm = mn & (period_work == 0.0) & (unsaved == 0.0) & (curf >= t)
        if has_mig:
            ffm &= ~(take(Fcancel, fi) if host else is_cancelled(sf_ctr))
        k_fault = torch.floor((curf - t) / T_R)
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
        mig_cancel = {}
        if has_mig:
            # the predicted fault hits the vacated node: cancel it
            can = emig & ~torch.isnan(ep_ft) & (ep_ft >= t)
            if host:
                # marked in Fcancel by the strike walk below, searching
                # from the lane's own cursor (nothing reads the marks in
                # between)
                mig_cancel = dict(Fcancel=Fcancel, can=can, ep_ft=ep_ft)
            else:
                # by fault-counter index; slots fill and retire in fault
                # order, a fourth simultaneously-pending cancel is dropped
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
        res_f = res & ~sil_m if has_sil else res
        rc_now = rc if has_tl else DR
        if host:
            t, fi, n_faults = masked_slab_strike_walk(
                res_f, t, fi, s["n_faults"], rc_now, F, tally=tally, **mig_cancel,
            )
            # the fault struck now (the primitive reads it off the slab)
            nf = take(F, fi)
            if has_tl:
                # its tier coin, at the pre-consumption cursor
                u_tier = take(Ftier, fi)
            struck = nf
            if has_sil:
                # silent strikes never interrupt a primitive
                nf = nf.masked_fill(sil_m, inf)
            # the trace-fed body: no stream to refill
            t, saved, unsaved, period_work, flags = masked_primitive_update(
                prim, cont, target, ckend, nf,
                t, saved, unsaved, period_work, W, DR,
                eps=eps, reg_cont=int(B._C_CKPTREG),
            )
        else:
            t, sf_ctr, sf_time, n_faults = masked_strike_walk(
                res_f, t, sf_ctr, sf_time, s["n_faults"], rc_now, fg_key, mtbf,
                horizon, **fault, cancels=cancels if has_mig else None, tally=tally,
            )
            # the hot step: the struck fault is consumed and the strike
            # cursor refilled inside the kernel (nf IS the strike cursor's
            # date).  Two-level and silent chunks hand the kernel a copy:
            # sf_time keeps the struck date (the disk recovery restarts
            # from it) and the silent lanes' cursor, masked to +inf in the
            # copy (silent strikes never interrupt a primitive, so the
            # kernel leaves their counter alone), is kept from it
            if has_tl:
                # the tier coin of the fault struck now: the
                # pre-consumption counter (the kernel advances sf_ctr)
                u_tier = counter_uniform(tier_key, sf_ctr)
            if has_sil:
                nf = sf_time.masked_fill(sil_m, inf)
            elif has_tl:
                nf = sf_time.clone()
            else:
                nf = sf_time
            struck = sf_time
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

        if host:
            fi = fi + faulted.to(i64)  # the struck fault is consumed
        n_faults = n_faults + faulted.to(i64)
        phase = phase.masked_fill(faulted, B._PH_MAIN).masked_fill(fin, B._PH_DONE)
        n_pro = s["n_pro"] + (cok & ~reg).to(i64)
        n_reg = n_reg + reg.to(i64)

        if has_tl:
            # disk-tier recovery: restart from the last disk checkpoint (the
            # kernel applied the memory-tier rollback t = nf + DR)
            disk = faulted & tl_m & (u_tier >= fmem)
            mem = faulted & tl_m & ~disk
            t = torch.where(disk, struck + DR2, t)
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
        if not host:
            if has_sil:
                sf_time = torch.where(sil_m, sf_time, nf)
            elif has_tl:
                sf_time = nf

        if has_sil:
            # consume latent strikes up to the new clock: they corrupt the
            # state silently instead of interrupting the primitive
            if host:
                fi, corrupt = masked_slab_silent_walk(res & sil_m, t, fi, corrupt, F,
                                                      tally=tally)
            else:
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

        # pop the next prediction into the episode registers (host: the
        # trusted-prediction cursor's; device: the merged head's, and the
        # consumed cursor is refilled); for _C_CKPTREG (action point fell
        # inside the regular checkpoint) enter the episode only if the
        # window start is still current
        p0v = take(P0, pi) if host else torch.minimum(s["tp_t0"], s["fp_time"])
        takep = ckr & (na_saved <= t) & torch.isfinite(p0v)
        good = takep & (p0v >= t - 1e-9)
        pop = popm | takep
        ep_t0 = torch.where(pop, p0v, ep_t0)
        ep_end = torch.where(pop, p0v + window, ep_end)
        phase = phase.masked_fill(popm | good, B._PH_EP_START)
        if host:
            if has_mig:
                ep_ft = torch.where(pop, take(Pft, pi), ep_ft)
                s.update(ep_ft=ep_ft)
            pi = pi + pop.to(i64)
            s.update(fi=fi, pi=pi)
        else:
            use_tp = pop & (s["tp_t0"] <= s["fp_time"])
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
            s.update(sf_ctr=sf_ctr, sf_time=sf_time)

        s.update(
            t=t, saved=saved, unsaved=unsaved, period_work=period_work,
            na_saved=na_saved, ep_t0=ep_t0, ep_end=ep_end,
            n_faults=n_faults, n_pro=n_pro, n_reg=n_reg, n_mig=n_mig,
            phase=phase, exhausted=exhausted, n_disk=n_disk, n_det=n_det,
        )
        if has_tl:
            s.update(saved_d=saved_d, dk_ctr=dk_ctr, rc=rc)
        if has_sil:
            s.update(saved_v=saved_v, ck_v=ck_v, corrupt=corrupt)

    return s, step


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


def _cell_layout(traces, cell_index, plats_c, strats_c, collect: str):
    """The lane -> cell index and cell count of a call: a cell-indexed
    spec's own; a per-lane spec's lanes each their own cell; host traces
    per-lane unless ``cell_index`` maps them onto the cells of
    ``plats_c`` / ``strats_c`` (the reference's rules)."""
    L = traces.n_lanes
    spec_celled = isinstance(traces, TraceSpec) and traces.cell_index is not None
    if cell_index is None and spec_celled:
        cell_index = traces.cell_index
    if collect == "stats" and cell_index is None:
        raise ValueError("collect='stats' requires cell_index")
    if isinstance(traces, TraceSpec) and not spec_celled and cell_index is not None:
        raise ValueError("cell_index with a TraceSpec requires the cell-indexed "
                         "layout (TraceSpec.cell_index)")
    if cell_index is None:
        return np.arange(L, dtype=np.int32), L
    cidx = np.asarray(cell_index, np.int32)
    if cidx.shape != (L,):
        raise ValueError(f"cell_index must have shape ({L},), got {cidx.shape}")
    if spec_celled:
        if traces.cell_index is not cell_index and not np.array_equal(traces.cell_index, cidx):
            raise ValueError("cell_index does not match traces.cell_index")
        n_cells = traces.n_cells
    else:
        for arg in (plats_c, strats_c):
            if not isinstance(arg, (Platform, Strategy)):
                n_cells = len(arg)
                break
        else:
            n_cells = int(cidx.max()) + 1 if L else 0
    if L and (cidx.min() < 0 or cidx.max() >= n_cells):
        raise ValueError(f"cell_index entries must be in [0, {n_cells})")
    return cidx, n_cells


def simulate_batch_torch(
    work_c,
    plats_c,
    strats_c,
    traces: Union[TraceSpec, BatchTraces],
    *,
    rng: Optional[np.random.Generator] = None,
    cell_index=None,
    device=None,
    devices=None,
    chunk="auto",
    max_iters: int = 5_000_000,
    collect: str = "stats",
    info: Optional[dict] = None,
):
    """Run a sweep through the lane machine.

    ``traces`` is a :class:`~repro_torch.core.events.TraceSpec` (device
    trace mode: events drawn on the device from per-lane counter streams;
    ``rng`` unused) or host-drawn :class:`~repro_torch.core.events.
    BatchTraces` (host trace mode: trust filtered on the host with
    ``rng``, events shipped as slabs).  ``cell_index`` maps each lane onto
    a cell: ``work_c`` / ``plats_c`` / ``strats_c`` then describe cells.
    It defaults to a cell-indexed spec's own; without one every lane is
    its own cell (``collect="stats"`` needs cells).  A spec's law is one
    :class:`~repro_torch.core.events.Distribution` (the single-law
    kernels) or a tuple of them, one per row (the law-indexed kernels).
    Every strategy mode runs (two-level and silent-error cells among
    them), at any trust level.  Runs on CUDA unless ``device`` names
    another device (``device="cpu"`` runs the kernels' plain PyTorch
    versions).

    devices     shard the lanes over a device set (:func:`resolve_devices`:
                None, "all", an int, or a sequence of devices, repeats
                allowed; ``device`` is the one-device spelling, and the
                two together raise).  Each chunk's lanes split into
                contiguous blocks, one a device, whose outer iterations
                interleave; per-lane results are those of one device, and
                the per-cell sums are summed once, in device order, at
                the end.
    chunk       lanes resident at once over all devices ("auto":
                :func:`default_chunk_lanes` of each device; None: all
                lanes).  Results do not depend on it, apart from the
                rounding of the per-cell float sums.
    collect     "stats" (default): per-cell :class:`CellSums` reduced on
                the device; "lanes": per-lane :class:`LaneResult`.
    info        a dict the call fills with its devices, trace mode, outer
                iterations (summed over chunks), host syncs and chunk
                count; in host trace mode also the host packing seconds,
                the slabs' host-to-device copy seconds (CUDA events on the
                card), the lane loops' wall seconds and the slab shapes
                and bytes of each shard.
    """
    devs = resolve_devices(devices, device)
    dev = devs[0]
    if collect not in ("lanes", "stats"):
        raise ValueError(f"unknown collect {collect!r} (expected 'lanes' or 'stats')")
    if not isinstance(traces, (TraceSpec, BatchTraces)):
        raise TypeError("simulate_batch_torch needs a TraceSpec or BatchTraces")
    host = isinstance(traces, BatchTraces)
    L = traces.n_lanes
    cidx_g, n_cells = _cell_layout(traces, cell_index, plats_c, strats_c, collect)
    plats, strats = B._cell_lists(plats_c, strats_c, n_cells)
    W, C, D, R, M, T_R, T_P, mode, q = B._lane_params(work_c, plats, strats, n_cells)
    tl_c, sil_c = mode == B._M_TWO_LEVEL, mode == B._M_SILENT
    tier = B._tier_params(plats, strats) if (tl_c | sil_c).any() else None
    n_tab = max(8, 1 << int(n_cells).bit_length())
    fdt, idt = np.float64, np.int64
    meta = {"trace_mode": "host" if host else "device"}
    if host:
        t_pack = time.monotonic()
        lane = dict(zip(("W", "C", "D", "R", "M", "T_R", "T_P", "mode", "q"),
                        (a[cidx_g] for a in (W, C, D, R, M, T_R, T_P, mode, q))))
        if tier is not None:
            lane.update(zip(("C2", "R2", "V", "fmem", "rho", "kv"),
                            (a[cidx_g] for a in tier)))
        p_t0, p_ft, _ = B._filter_trusted(traces, lane["q"], lane["mode"], rng)
        F = E.pad_sentinel(traces.fault_times, traces.n_faults, np.inf)
        P0 = E.pad_sentinel(p_t0, traces.n_preds, np.inf)
        Pft = E.pad_sentinel(p_ft, traces.n_preds, np.nan)
        Ftier = None
        if tl_c.any():
            Ftier = traces.fault_tier
            if Ftier is None:
                if float(tier[3][tl_c].max(initial=0.0)) > 0.0:
                    raise ValueError(
                        "two-level lanes with f > 0 need per-fault tier draws: "
                        "generate traces with make_event_traces_batch(..., tier=True)"
                    )
                Ftier = np.ones_like(traces.fault_times)
            Ftier = E.pad_sentinel(Ftier, traces.n_faults, 1.0)
        meta.update(pack_s=time.monotonic() - t_pack, copy_s=0.0, loop_s=0.0,
                    slab_bytes=0, slabs=[])
        lane_bytes = _host_lane_bytes(F.shape[1], P0.shape[1], bool(
            (mode == B._M_MIGRATION).any()), Ftier is not None)
    else:
        spec = traces
        if spec.cell_index is None:  # per-lane parameters: one cell a lane
            spec = replace(spec, cell_index=cidx_g)
        # no predictions on mode "none"; silent-error cells never trust
        # the fail-stop predictor; 0 < q < 1 thins both prediction streams
        # by trust coins
        q_eff = np.where((mode == B._M_NONE) | sil_c, 0.0, np.clip(q, 0.0, 1.0))
        frac_c = (q_eff > 0.0) & (q_eff < 1.0)
        f_kind, f_param = _dist_static(spec.fault_dist)
        fp_kind, fp_param = _dist_static(spec.false_pred_dist)
        gen = (f_kind, f_param, fp_kind, fp_param)
        tables = _cell_tables(
            n_cells, n_tab, fdt, W, C, D, R, M, T_R, T_P, mode,
            spec.horizon, spec.window,
            spec.mtbf, spec.fp_mean, spec.recall, q_eff,
            fault_laws=E.law_table(spec.fault_dist) if f_kind == "indexed" else None,
            fp_laws=E.law_table(spec.false_pred_dist) if fp_kind == "indexed" else None,
            tier=tier,
        )
        lane_bytes = 0
    if chunk == "auto":
        chunk = default_chunk_lanes(dev, meta["trace_mode"], lane_bytes) * len(devs)
    chunk = max(L, 1) if chunk is None else min(int(chunk), max(L, 1))
    tally = _Tally()
    # one accumulator a shard, summed once at the end in device order
    accs = [torch.zeros(n_tab, 13, dtype=torch.float64, device=d) for d in devs]
    outs = []
    n_chunks = 0
    copy_events = []
    for lo in range(0, L, chunk):
        hi = min(lo + chunk, L)
        n_chunks += 1
        # each chunk runs the state and ops of the families it holds, on
        # every shard
        cells = cidx_g[lo:hi]
        has_mig = bool((mode[cells] == B._M_MIGRATION).any())
        has_tl, has_sil = bool(tl_c[cells].any()), bool(sil_c[cells].any())
        # contiguous blocks of lanes, one a device (the last ones may be
        # short, or absent on a chunk of fewer lanes than devices)
        per = -(-(hi - lo) // len(devs))
        shards = [(di, slice(a, min(a + per, hi)))
                  for di, a in enumerate(range(lo, hi, per))]
        if host:
            # slabs cut to the chunk's widest lane and its sentinel row
            fw = int(traces.n_faults[lo:hi].max(initial=0)) + 1
            pw = int(traces.n_preds[lo:hi].max(initial=0)) + 1
        shard_c, shard_st = [], []
        for di, sl in shards:
            d = devs[di]
            n = sl.stop - sl.start
            with _on(d):
                if host:
                    t0 = time.monotonic()
                    pinned = _PinnedSlabs() if d.type == "cuda" else None
                    consts, state = _pack_chunk(
                        has_mig, sl, n, fdt, idt,
                        *(lane[k] for k in ("W", "C", "D", "R", "M", "T_R", "T_P", "mode")),
                        F[:, :fw], P0[:, :pw], Pft[:, :pw], traces.horizon, traces.window,
                        cidx=cidx_g, pad_cell=n_cells,
                        tl=(tuple(lane[k] for k in ("C2", "R2", "fmem", "rho"))
                            if has_tl else None),
                        sil=(lane["V"], lane["kv"]) if has_sil else None,
                        Ftier=Ftier[:, :fw] if has_tl else None, alloc=pinned,
                    )
                    state.pop("Fcancel", None)  # zeros: made on the device
                    meta["pack_s"] += time.monotonic() - t0
                    slabs = {k: consts.pop(k) for k in _SLABS if k in consts}
                    c = _to_device(consts, d)
                    t0 = time.monotonic()
                    if pinned is not None:
                        ev = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                        ev[0].record()
                        c.update({k: pinned.ship(v, d) for k, v in slabs.items()})
                        ev[1].record()
                        copy_events.append(ev)
                    else:
                        c.update({k: torch.from_numpy(v) for k, v in slabs.items()})
                        meta["copy_s"] += time.monotonic() - t0
                    st = _to_device(state, d)
                    if has_mig:
                        st["Fcancel"] = torch.zeros(c["F"].shape, dtype=torch.bool,
                                                    device=d)
                    nbytes = sum(v.nbytes for v in slabs.values()) + (
                        st["Fcancel"].numel() if has_mig else 0)
                    meta["slab_bytes"] += nbytes
                    meta["slabs"].append({**{k: list(v.shape) for k, v in slabs.items()},
                                          "bytes": nbytes})
                else:
                    consts, state = _pack_chunk_spec_cells(tables, spec, cidx_g, n_cells,
                                                           sl, n, fdt, idt)
                    frac_q = bool(frac_c[cells].any())
                    keys = _BASE_KEYS + ("tier_key",) * has_tl + ("tt_key", "ft_key") * frac_q
                    c = tables_from_numpy(consts, d, keys)
                    st = _to_device(state, d)
            shard_c.append(c)
            shard_st.append(st)
        kw = dict(has_mig=has_mig, has_tl=has_tl, has_sil=has_sil, max_iters=max_iters,
                  eps=float(_EPS), tally=tally)
        if not host:
            kw.update(gen=gen, frac_q=frac_q)
        else:
            kw.update(gen=None)
        sdevs = [devs[di] for di, _ in shards]
        t0 = time.monotonic()
        if len(shards) == 1:
            fins = [_run_chunk(shard_c[0], shard_st[0], devs=sdevs, **kw)]
        else:
            fins = _run_chunk(shard_c, shard_st, devs=sdevs, **kw)
        if host:
            meta["loop_s"] += time.monotonic() - t0
        for (di, _), c, fin in zip(shards, shard_c, fins):
            cidx_dev = c["cidx"]
            Wl = c["W"] if host else c["W"].index_select(0, cidx_dev)
            if collect == "stats":
                with _on(devs[di]):
                    accs[di] += _cell_sums(fin, Wl, cidx_dev, n_tab)
            else:
                out = {
                    k: fin[k].cpu().numpy()
                    for k in ("t", "n_faults", "n_pro", "n_reg", "n_mig",
                              "exhausted", "n_disk", "n_det", "phase")
                }
                if not (out.pop("phase") == B._PH_DONE).all():
                    raise RuntimeError("torch lane machine did not converge")
                outs.append(out)
    if copy_events:
        for d in set(d for d in devs if d.type == "cuda"):
            torch.cuda.synchronize(d)
        meta["copy_s"] = sum(a.elapsed_time(b) for a, b in copy_events) / 1e3
    if info is not None:
        info.update(
            device=str(dev), devices=[str(d) for d in devs], outer_iters=tally.iters,
            host_syncs=tally.syncs, n_chunks=n_chunks, **meta,
        )
    if collect == "stats":
        cs = accs[0].cpu().numpy()
        for a in accs[1:]:
            cs = cs + a.cpu().numpy()
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
