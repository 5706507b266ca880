"""Execution of experiment grids: the fused sweep on the device lane
machine, and the host engines that check it.

The runner flattens a :class:`~repro_torch.experiments.grid.GridSpec`
into engine lanes — one lane per (cell, run) pair — and, on the default
``engine="torch"``, advances the entire grid in one cell-multiplexed call
of :func:`repro_torch.core.torch_sim.simulate_batch_torch`: strategy,
period, checkpoint costs, predictor parameters and trust ship as
per-cell tables gathered on the device through an int32 per-lane cell
index.  Cells with identical trace parameters (MTBF, predictor, window,
horizon) share their traces — the paper's paired design, where every
strategy faces the same failures.

Two trace modes, as in the reference.  ``trace_mode="device"`` samples
events on the device from per-lane counter-based RNG streams; cells
sharing trace parameters share stream ids.  A grid mixing failure-law
families runs as one dispatch too (``dispatch="fused"``): the per-family
specs concatenate into one spec whose laws ride the cell tables, and the
kernels' law-indexed variant draws each lane under its own law;
``dispatch="perfamily"`` runs one call per family on the same
law-indexed sampler, the bit-exact control.  ``trace_mode="host"``
draws every group's traces on the host with NumPy
(:func:`~repro_torch.core.events.make_event_traces_batch`, from
``default_rng([seed, group])``: superposed ``n_components`` and
``stationary`` traces run only here) and ships them as slabs.

``dispatch="percell"`` launches one engine call per cell on the fused
run's own traces or streams, so per-cell results equal the fused run's
lane for lane in device trace mode, and in host mode for the trust
levels q in {0, 1} (a fractional q's host trust coins are drawn per
call).

The reference's host engines run the same lanes: ``engine="batch"`` the
NumPy lane engine (:func:`~repro_torch.core.batch_sim.simulate_batch`),
``engine="scalar"`` the scalar event loop on each lane's trace (the
oracle; device-mode streams reach both replayed on the host), and
``engine="legacy"`` the seed repository's pipeline (per-run traces from
:func:`~repro_torch.core.events.make_event_trace` and seeds ``seed +
1000 i + 17``, one cell at a time).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.batch_sim import simulate_batch
from ..core.engine import UNSET, EngineConfig, resolve_engine_config
from ..core.events import (
    BatchTraces,
    TraceSpec,
    make_event_trace,
    make_event_traces_batch,
    make_trace_spec,
)
from ..core.simulator import simulate
from ..core.torch_sim import resolve_devices, simulate_batch_torch
from .grid import CellResult, ExperimentCell, GridSpec, SweepResult

__all__ = ["run_grid", "run_cells", "FusedLayout", "build_fused_layout"]


def _group_cells(grid: GridSpec) -> List[Tuple[Tuple, List[int]]]:
    groups: Dict[Tuple, List[int]] = {}
    for ci, cell in enumerate(grid.cells):
        groups.setdefault(cell.group_key(), []).append(ci)
    return list(groups.items())


def _trace_key(cell: ExperimentCell) -> Tuple:
    """Cells with equal keys face identical traces (paired comparison).

    Keyed on the predictor's true parameters — not the strategy — so a
    mode-"none" baseline shares its fault stream with the
    prediction-following strategies it is compared against; the engine's
    trust filter hides the predictions from it."""
    return (
        cell.work,
        cell.horizon_factor,
        cell.platform.mu,
        cell.predictor.recall,
        cell.predictor.precision,
        cell.predictor.window,
        cell.predictor.lead,
    )


def _trace_slots(grid: GridSpec, cell_idx: List[int]):
    """Shared-trace layout of one group: cells mapping to the same
    :func:`_trace_key` share one *slot* of traces (stream ids), as wide as
    its widest cell; every cell takes the slot's first ``n_runs`` lanes.
    Returns ``(uniq_cells, cell_slot, slot_runs, slot_off, rows)``:
    each slot's first cell, each cell's slot, the slots' widths and
    offsets, and ``rows[lane]``, the lane's row in the unique pool."""
    cells = [grid.cells[ci] for ci in cell_idx]
    runs = [grid.cell_runs(ci) for ci in cell_idx]
    uniq: Dict[Tuple, int] = {}
    cell_slot = [uniq.setdefault(_trace_key(c), len(uniq)) for c in cells]
    uniq_cells: List[Optional[ExperimentCell]] = [None] * len(uniq)
    slot_runs = np.zeros(len(uniq), dtype=np.int64)
    for c, slot, r in zip(cells, cell_slot, runs):
        if uniq_cells[slot] is None:
            uniq_cells[slot] = c
        slot_runs[slot] = max(slot_runs[slot], r)
    slot_off = np.concatenate([[0], np.cumsum(slot_runs)])
    rows = (
        np.concatenate([slot_off[slot] + np.arange(r) for slot, r in zip(cell_slot, runs)])
        if cells else np.zeros(0, dtype=np.int64)
    )
    return uniq_cells, cell_slot, slot_runs, slot_off, rows


def _group_traces(grid: GridSpec, cell_idx: List[int], group_no: int) -> BatchTraces:
    """One group's host traces: one batched pass over the group's unique
    trace parameters from ``default_rng([seed, group_no])``, then the
    rows expanded to the cells' lanes."""
    uniq_cells, _, slot_runs, slot_off, rows = _trace_slots(grid, cell_idx)

    def rep(vals):
        return np.repeat(np.asarray(vals, dtype=np.float64), slot_runs)

    rng = np.random.default_rng([grid.seed, group_no])
    proto = grid.cells[cell_idx[0]]
    traces = make_event_traces_batch(
        rng,
        int(slot_off[-1]),
        horizon=rep([c.horizon_factor * c.work for c in uniq_cells]),
        mtbf=rep([c.platform.mu for c in uniq_cells]),
        recall=rep([c.predictor.recall for c in uniq_cells]),
        precision=rep([c.predictor.precision for c in uniq_cells]),
        window=rep([c.predictor.window for c in uniq_cells]),
        lead=rep([c.predictor.lead for c in uniq_cells]),
        fault_dist=proto.dist,
        false_pred_dist=proto.false_pred_dist,
        n_components=proto.n_components,
        stationary=proto.stationary,
        # recovery-tier uniforms for two-level cells; drawn after every
        # other draw, so they never perturb the group's traces
        tier=any(grid.cells[ci].strategy.mode == "two_level" for ci in cell_idx),
    )
    return traces.take(rows)


def _group_trace_spec(
    grid: GridSpec, cell_idx: List[int], stream_base: int
) -> Tuple[TraceSpec, int]:
    """The group's cell-indexed :class:`TraceSpec`: one parameter row per
    cell and globally unique stream ids per unique (trace parameters,
    run) pair, so cells sharing trace parameters share stream ids.
    Returns the spec and the next free stream id."""
    cells = [grid.cells[ci] for ci in cell_idx]
    runs = [grid.cell_runs(ci) for ci in cell_idx]
    proto = cells[0]
    if proto.n_components:
        raise ValueError(
            "trace_mode='device' does not support superposed component "
            "traces (n_components); use trace_mode='host'"
        )
    _, cell_slot, _, slot_off, _ = _trace_slots(grid, cell_idx)
    stream = np.concatenate(
        [
            stream_base + slot_off[slot] + np.arange(r, dtype=np.int64)
            for slot, r in zip(cell_slot, runs)
        ]
    )
    cidx = np.repeat(np.arange(len(cells), dtype=np.int32), runs)
    spec = make_trace_spec(
        stream.shape[0],
        horizon=[c.horizon_factor * c.work for c in cells],
        mtbf=[c.platform.mu for c in cells],
        recall=[c.predictor.recall for c in cells],
        precision=[c.predictor.precision for c in cells],
        window=[c.predictor.window for c in cells],
        lead=[c.predictor.lead for c in cells],
        fault_dist=proto.dist,
        false_pred_dist=proto.false_pred_dist,
        seed=grid.seed,
        stream=stream,
        cell_index=cidx,
    )
    return spec, stream_base + int(slot_off[-1])


def _run_legacy(grid: GridSpec) -> List[List]:
    """The seed repository's pipeline: per-run object traces
    (:func:`make_event_trace`) and the scalar engine, one trace per (cell,
    run), run ``i`` from ``default_rng(seed + 1000 i + 17)``."""
    out = []
    for ci, cell in enumerate(grid.cells):
        runs = []
        for i in range(grid.cell_runs(ci)):
            rng = np.random.default_rng(grid.seed + 1000 * i + 17)
            trace = make_event_trace(
                rng,
                horizon=cell.horizon_factor * cell.work,
                mtbf=cell.platform.mu,
                recall=cell.gen_recall,
                precision=cell.predictor.precision,
                window=cell.predictor.window,
                lead=cell.predictor.lead,
                fault_dist=cell.dist,
                false_pred_dist=cell.false_pred_dist,
                n_components=cell.n_components,
                stationary=cell.stationary,
            )
            runs.append(simulate(cell.work, cell.platform, cell.strategy, trace, rng))
        out.append(runs)
    return out


#: per-lane result fields of the host engines, assembled into CellResult
#: arrays (the port's rows also carry disk recoveries and detections)
_LANE_FIELDS = (
    "waste", "makespan", "n_faults", "n_proactive_ckpts",
    "n_regular_ckpts", "n_migrations", "trace_exhausted",
    "n_disk_recoveries", "n_detections",
)


def _lane_arrays(res) -> Dict[str, np.ndarray]:
    return {k: getattr(res, k) for k in _LANE_FIELDS}


def _scalar_lane_arrays(outs) -> Dict[str, np.ndarray]:
    return {k: np.array([getattr(r, k) for r in outs]) for k in _LANE_FIELDS}


def _cat_lane_arrays(parts: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    return {k: np.concatenate([p[k] for p in parts]) for k in _LANE_FIELDS}


@dataclass
class FusedLayout:
    """The fused dispatch's lane layout, deterministic in the grid: cells
    regrouped in trace-compatibility order (``cell_order``), per-cell
    lane counts and offsets, the per-cell engine tables, the lane -> cell
    index, and the trace source: one :class:`TraceSpec` per group (device
    trace mode) or one concatenated :class:`BatchTraces` (host mode)."""

    grid: GridSpec
    groups: List[Tuple[Tuple, List[int]]]
    cell_order: List[int]
    runs_o: np.ndarray  # (n_cells,) lanes per cell, cell_order order
    offs: np.ndarray  # (n_cells + 1,) lane offsets per cell
    specs: List[TraceSpec]  # device trace mode: one spec per group
    traces: Optional[BatchTraces]  # host trace mode: all lanes
    work_c: np.ndarray
    plats_c: List
    strats_c: List
    cidx: np.ndarray  # (n_lanes,) lane -> cell_order position

    @property
    def n_groups(self) -> int:
        return len(self.groups)

    @property
    def n_lanes(self) -> int:
        return int(self.offs[-1])

    def concat_spec(self) -> TraceSpec:
        """The one-dispatch spec: a multi-group grid concatenates its
        per-group specs into one cell-indexed spec (law-indexed sampler);
        a single-group grid keeps its law-specialized spec, with the same
        results and cheaper draws."""
        if not self.specs:
            raise ValueError("concat_spec requires trace_mode='device'")
        if len(self.specs) == 1:
            return self.specs[0]
        return TraceSpec.concat_cells(self.specs)

    def host_traces(self) -> BatchTraces:
        """Host event arrays for all lanes: the host mode's own, or the
        device streams replayed on the host."""
        if self.traces is not None:
            return self.traces
        return BatchTraces.concat([s.materialize() for s in self.specs])


def build_fused_layout(grid: GridSpec, trace_mode: str = "device") -> FusedLayout:
    """Assemble the fused dispatch's :class:`FusedLayout` for ``grid``:
    device specs with globally unique stream ids, or host traces drawn per
    group from ``grid.seed`` and concatenated (one engine call over all
    groups)."""
    groups = _group_cells(grid)
    cell_order: List[int] = [ci for _, idx in groups for ci in idx]
    runs_o = np.array([grid.cell_runs(ci) for ci in cell_order], np.int64)
    offs = np.concatenate([[0], np.cumsum(runs_o)])
    specs: List[TraceSpec] = []
    traces: Optional[BatchTraces] = None
    if trace_mode == "device":
        base = 0
        for _, idx in groups:
            spec, base = _group_trace_spec(grid, idx, base)
            specs.append(spec)
    else:
        traces = BatchTraces.concat(
            [_group_traces(grid, idx, gno) for gno, (_, idx) in enumerate(groups)]
        )
    work_c = np.asarray(
        [grid.cells[ci].work for ci in cell_order], dtype=np.float64
    )
    plats_c = [grid.cells[ci].platform for ci in cell_order]
    strats_c = [grid.cells[ci].strategy for ci in cell_order]
    cidx = np.repeat(np.arange(len(cell_order), dtype=np.int32), runs_o)
    return FusedLayout(
        grid=grid, groups=groups, cell_order=cell_order, runs_o=runs_o,
        offs=offs, specs=specs, traces=traces, work_c=work_c, plats_c=plats_c,
        strats_c=strats_c, cidx=cidx,
    )


def _stats_cell_result(cell: ExperimentCell, sums, i: int) -> CellResult:
    """One stats-backed CellResult row from device-reduced CellSums."""
    return CellResult.from_stats(
        cell,
        int(sums.n_exhausted[i]),
        sums.n[i],
        sums.mean_waste[i], sums.ci95_waste[i],
        sums.mean_makespan[i], sums.ci95_makespan[i],
        sums.n_faults[i] / sums.n[i],
        sums.n_proactive_ckpts[i] / sums.n[i],
        sums.n_regular_ckpts[i] / sums.n[i],
        sums.n_migrations[i] / sums.n[i],
        sums.n_disk_recoveries[i] / sums.n[i],
        sums.n_detections[i] / sums.n[i],
    )


def _lanes_cell_result(cell: ExperimentCell, res, sl: slice) -> CellResult:
    """One per-run CellResult row from the lanes ``sl`` of a LaneResult."""
    return CellResult(
        cell=cell,
        waste=res.waste[sl],
        makespan=res.makespan[sl],
        n_faults=res.n_faults[sl],
        n_proactive_ckpts=res.n_proactive_ckpts[sl],
        n_regular_ckpts=res.n_regular_ckpts[sl],
        n_migrations=res.n_migrations[sl],
        n_exhausted=int(np.count_nonzero(res.trace_exhausted[sl])),
        n_disk_recoveries=res.n_disk_recoveries[sl],
        n_detections=res.n_detections[sl],
    )


#: meta keys summed over a run's engine calls (host mode adds its own)
_SUMMED = ("outer_iters", "host_syncs", "n_chunks")
_HOST_SUMMED = ("pack_s", "copy_s", "loop_s", "slab_bytes")

#: the keyword spelling's defaults for the torch engine: the port's
#: run_grid took keywords only, with device trace mode and per-cell stats
#: reduced on the device (EngineConfig() says host traces and lanes)
_KEYWORD_DEFAULTS = {"trace_mode": "device", "collect": "stats"}


def _resolve_config(config, caller: str, **keywords) -> EngineConfig:
    """:func:`resolve_engine_config` with the keyword spelling's defaults:
    without an :class:`EngineConfig`, a torch run takes
    :data:`_KEYWORD_DEFAULTS` for the keywords it was not given."""
    explicit = isinstance(config, EngineConfig)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        cfg = resolve_engine_config(config, caller, **keywords)
    for w in caught:  # re-issued at the entry point's caller
        warnings.warn(w.message, w.category, stacklevel=3)
    if not explicit and cfg.engine == "torch":
        cfg = cfg.replace(**{k: v for k, v in _KEYWORD_DEFAULTS.items()
                             if keywords[k] is UNSET})
    return cfg


def run_grid(
    grid: GridSpec, config=None, *, device=None, engine=UNSET, chunk_lanes=UNSET,
    devices=UNSET, trace_mode=UNSET, dispatch=UNSET, collect=UNSET,
) -> SweepResult:
    """Execute every cell of ``grid`` and aggregate per-cell statistics.

    ``config`` is an :class:`~repro_torch.core.engine.EngineConfig` (or a
    bare engine name, the historical positional form); the engine
    keywords are its deprecated spelling.  **Defaults differ between the
    two spellings**: ``EngineConfig()`` is the torch engine on host traces
    with per-run results (``trace_mode="host"``, ``collect="lanes"``, the
    reference's defaults), while a call without an ``EngineConfig`` keeps
    the port's historical keyword defaults for the torch engine, device
    trace mode and per-cell stats (``trace_mode="device"``,
    ``collect="stats"``); the other engines take ``EngineConfig()``'s.

    engine       "torch" (the device lane machine), "batch" (NumPy lanes),
                 "scalar" (the event loop, the oracle) or "legacy" (the
                 seed pipeline, per cell, host traces only).
    device       the torch engine's one device: CUDA unless it names
                 another; without CUDA and without ``device`` it raises.
    devices      shard the torch engine's lanes over a device set (None,
                 "all", an int or a device sequence; not with ``device``):
                 per-lane results equal the one-device run's.
    chunk_lanes  lanes resident at once ("auto", an int, or None for all).
    collect      "stats" reduces per-cell moments on the device (torch
                 only); "lanes" returns per-run arrays.
    trace_mode   "device" samples events from counter streams (on the card
                 for the torch engine, replayed on the host by the others);
                 "host" draws them with NumPy (the only mode of superposed
                 ``n_components`` cells).
    dispatch     "fused" runs the whole grid in one call (in device mode a
                 grid of several failure-law families on the law-indexed
                 kernels, one family on the single-law ones); "perfamily"
                 (torch, device mode) one call per family on the
                 law-indexed kernels; "percell" one call per cell
                 (``collect="lanes"`` only; the legacy engine's only
                 granularity).

    A torch run's ``SweepResult.meta`` reports the devices, the trace
    mode, the dispatch and its calls, the sampler (device mode: "indexed"
    or "single-law"), the outer iterations, the host syncs and the chunk
    count (summed over calls); in host mode also the host generation
    seconds of the layout, the packing, copy and lane-loop seconds, the
    slab bytes, and each shard's slab shapes."""
    cfg = _resolve_config(
        config, "run_grid", engine=engine, chunk_lanes=chunk_lanes,
        devices=devices, trace_mode=trace_mode, dispatch=dispatch, collect=collect,
    )
    engine, chunk_lanes, devices = cfg.engine, cfg.chunk_lanes, cfg.devices
    trace_mode, dispatch, collect = cfg.trace_mode, cfg.dispatch, cfg.collect
    if engine not in ("batch", "scalar", "legacy", "torch"):
        raise ValueError(
            f"unknown engine {engine!r} "
            "(expected 'batch', 'torch', 'scalar' or 'legacy')"
        )
    if engine != "torch" and (devices is not None or device is not None):
        raise ValueError("devices=/device= require engine='torch'")
    if trace_mode not in ("host", "device"):
        raise ValueError(
            f"unknown trace_mode {trace_mode!r} (expected 'host' or 'device')"
        )
    if trace_mode == "device" and engine == "legacy":
        raise ValueError("trace_mode='device' requires a batched engine")
    if dispatch is None:
        dispatch = "percell" if engine == "legacy" else "fused"
    if dispatch not in ("fused", "percell", "perfamily"):
        raise ValueError(
            f"unknown dispatch {dispatch!r} "
            "(expected 'fused', 'perfamily' or 'percell')"
        )
    if engine == "legacy" and dispatch == "fused":
        raise ValueError("engine='legacy' is inherently per-cell")
    if dispatch == "perfamily" and not (engine == "torch" and trace_mode == "device"):
        raise ValueError(
            "dispatch='perfamily' requires engine='torch' and trace_mode='device'"
        )
    if collect not in ("lanes", "stats"):
        raise ValueError(f"unknown collect {collect!r} (expected 'lanes' or 'stats')")
    if collect == "stats" and engine != "torch":
        raise ValueError("collect='stats' requires engine='torch'")
    if collect == "stats" and dispatch == "percell":
        raise ValueError("collect='stats' requires dispatch='fused' or 'perfamily'")
    devs = resolve_devices(devices, device) if engine == "torch" else None
    t0 = time.monotonic()
    if engine == "legacy":
        return _legacy_sweep(grid, t0)
    layout = build_fused_layout(grid, trace_mode)
    if engine != "torch":
        return _host_sweep(layout, engine, trace_mode, dispatch, t0)
    meta: Dict = {"device": str(devs[0]), "devices": [str(d) for d in devs],
                  "trace_mode": trace_mode, "dispatch": dispatch,
                  "dispatches": 0, **dict.fromkeys(_SUMMED, 0)}
    if trace_mode == "host":
        meta.update(host_gen_s=time.monotonic() - t0, slabs=[],
                    **dict.fromkeys(_HOST_SUMMED, 0))
    cells: List[Optional[CellResult]] = [None] * len(grid.cells)

    def call(work, plats, strats, traces, **kw):
        info: Dict = {}
        res = simulate_batch_torch(work, plats, strats, traces, devices=devs,
                                   chunk=chunk_lanes, info=info, **kw)
        meta["dispatches"] += 1
        for k in _SUMMED + (_HOST_SUMMED if trace_mode == "host" else ()):
            meta[k] += info[k]
        if trace_mode == "host":
            meta["slabs"] += info["slabs"]
        return res

    if dispatch == "percell":
        # one call per cell, on the fused run's own traces or streams
        group_pos = np.cumsum([0] + [len(idx) for _, idx in layout.groups])
        expanded: Dict[int, TraceSpec] = {}
        for k, ci in enumerate(layout.cell_order):
            lo, hi = int(layout.offs[k]), int(layout.offs[k + 1])
            n_k = hi - lo
            if trace_mode == "device":
                g = int(np.searchsorted(group_pos, k, side="right")) - 1
                if g not in expanded:
                    expanded[g] = layout.specs[g].expand()
                glo = int(layout.offs[group_pos[g]])
                sub = expanded[g].take(np.arange(lo - glo, hi - glo))
            else:
                sub = layout.traces.take(np.arange(lo, hi))
            res = call(np.full(n_k, layout.work_c[k]), [layout.plats_c[k]] * n_k,
                       [layout.strats_c[k]] * n_k, sub, collect="lanes",
                       rng=np.random.default_rng([grid.seed, layout.n_groups, k]))
            cells[ci] = _lanes_cell_result(grid.cells[ci], res, slice(0, n_k))
    else:
        # (first cell position, traces, keywords) of each engine call
        if trace_mode == "host":
            calls = [(0, layout.traces, dict(
                cell_index=layout.cidx,
                rng=np.random.default_rng([grid.seed, layout.n_groups])))]
        elif dispatch == "fused":
            calls = [(0, layout.concat_spec(), {})]
        else:
            pos = np.cumsum([0] + [len(idx) for _, idx in layout.groups])
            calls = [(int(p), spec.indexed(), {}) for p, spec in zip(pos, layout.specs)]
        if not layout.n_lanes:
            calls = []
        if calls and trace_mode == "device":
            meta["sampler"] = ("indexed" if isinstance(calls[0][1].fault_dist, tuple)
                               else "single-law")
        for a, traces, kw in calls:
            b = len(layout.cell_order) if trace_mode == "host" else a + traces.n_cells
            res = call(layout.work_c[a:b], layout.plats_c[a:b], layout.strats_c[a:b],
                       traces, collect=collect, **kw)
            lane0 = int(layout.offs[a])
            for k in range(a, b):
                ci = layout.cell_order[k]
                if collect == "stats":
                    cells[ci] = _stats_cell_result(grid.cells[ci], res, k - a)
                else:
                    cells[ci] = _lanes_cell_result(grid.cells[ci], res, slice(
                        int(layout.offs[k]) - lane0, int(layout.offs[k + 1]) - lane0))
    return SweepResult(
        grid=grid, cells=cells, engine="torch",
        wall_time_s=time.monotonic() - t0, collect=collect,
        meta=meta,
    )


def _legacy_sweep(grid: GridSpec, t0: float) -> SweepResult:
    """``engine="legacy"``: :func:`_run_legacy`, one cell at a time."""
    cells = [
        _lanes_cell_result(cell, SimpleNamespace(**_scalar_lane_arrays(runs)), slice(None))
        for cell, runs in zip(grid.cells, _run_legacy(grid))
    ]
    return SweepResult(
        grid=grid, cells=cells, engine="legacy",
        wall_time_s=time.monotonic() - t0, collect="lanes",
        meta={"trace_mode": "host", "dispatch": "percell", "dispatches": len(cells)},
    )


def _host_sweep(layout: FusedLayout, engine: str, trace_mode: str, dispatch: str,
                t0: float) -> SweepResult:
    """The host engines' sweep of ``layout``: ``"batch"`` (NumPy lanes) or
    ``"scalar"`` (the event loop), fused (one call over every lane) or one
    call per cell, on the layout's host traces (device-mode streams
    replayed on the host), with the reference's trust-coin generators."""
    grid = layout.grid
    traces = layout.host_traces()
    n_groups = layout.n_groups
    parts: List[Dict[str, np.ndarray]] = []
    if dispatch == "percell":
        for k in range(len(layout.cell_order)):
            lo, hi = int(layout.offs[k]), int(layout.offs[k + 1])
            n_k = hi - lo
            sub = traces.take(np.arange(lo, hi))
            if engine == "batch":
                parts.append(_lane_arrays(simulate_batch(
                    np.full(n_k, layout.work_c[k]), [layout.plats_c[k]] * n_k,
                    [layout.strats_c[k]] * n_k, sub,
                    rng=np.random.default_rng([grid.seed, n_groups, k]))))
            else:  # scalar: per-lane rng seeds match the fused path
                parts.append(_scalar_lane_arrays([
                    simulate(float(layout.work_c[k]), layout.plats_c[k],
                             layout.strats_c[k], sub.lane(j),
                             np.random.default_rng([grid.seed, n_groups, lo + j]))
                    for j in range(n_k)
                ]))
        dispatches = len(layout.cell_order)
    else:
        runs = layout.runs_o
        work_l = np.repeat(layout.work_c, runs)
        plats_l = [p for p, r in zip(layout.plats_c, runs) for _ in range(r)]
        strats_l = [s for s, r in zip(layout.strats_c, runs) for _ in range(r)]
        if engine == "batch":
            parts.append(_lane_arrays(simulate_batch(
                work_l, plats_l, strats_l, traces,
                rng=np.random.default_rng([grid.seed, n_groups]))))
        else:
            parts.append(_scalar_lane_arrays([
                simulate(float(work_l[i]), plats_l[i], strats_l[i], traces.lane(i),
                         np.random.default_rng([grid.seed, n_groups, i]))
                for i in range(traces.n_lanes)
            ]))
        dispatches = 1
    lanes = SimpleNamespace(**_cat_lane_arrays(parts))
    cells: List[Optional[CellResult]] = [None] * len(grid.cells)
    for k, ci in enumerate(layout.cell_order):
        sl = slice(int(layout.offs[k]), int(layout.offs[k + 1]))
        cells[ci] = _lanes_cell_result(grid.cells[ci], lanes, sl)
    return SweepResult(
        grid=grid, cells=cells, engine=engine,
        wall_time_s=time.monotonic() - t0, collect="lanes",
        meta={"trace_mode": trace_mode, "dispatch": dispatch, "dispatches": dispatches},
    )


def run_cells(
    cells: Sequence[ExperimentCell],
    n_runs: int = 100,
    seed: int = 0,
    config=None,
    *,
    device=None,
    engine=UNSET,
    chunk_lanes=UNSET,
    devices=UNSET,
    trace_mode=UNSET,
    dispatch=UNSET,
    collect=UNSET,
) -> SweepResult:
    """Build a :class:`GridSpec` of ``cells`` and run it: :func:`run_grid`
    with the same configuration (and the same two spellings)."""
    cfg = _resolve_config(
        config, "run_cells", engine=engine, chunk_lanes=chunk_lanes,
        devices=devices, trace_mode=trace_mode, dispatch=dispatch, collect=collect,
    )
    return run_grid(GridSpec(tuple(cells), n_runs=n_runs, seed=seed), cfg, device=device)
