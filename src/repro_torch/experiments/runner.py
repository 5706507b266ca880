"""Fused execution of experiment grids on the device lane machine.

The runner flattens a :class:`~repro_torch.experiments.grid.GridSpec`
into engine lanes — one lane per (cell, run) pair — and advances the
entire grid in one cell-multiplexed call of
:func:`repro_torch.core.torch_sim.simulate_batch_torch`: strategy,
period, checkpoint costs, predictor parameters and trust ship as
per-cell tables gathered on the device through an int32 per-lane cell
index, and events are sampled on the device from per-lane counter-based
RNG streams.  Cells with identical trace parameters (MTBF, predictor,
window, horizon) share their stream ids — the paper's paired design,
where every strategy faces the same failures.

A grid mixing failure-law families runs as one dispatch too
(``dispatch="fused"``): the per-family specs concatenate into one spec
whose laws ride the cell tables, and the kernels' law-indexed variant
draws each lane under its own law.  ``dispatch="perfamily"`` runs one
call per family on the same law-indexed sampler, the bit-exact control.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..core.events import TraceSpec, make_trace_spec
from ..core.torch_sim import resolve_device, simulate_batch_torch
from .grid import CellResult, ExperimentCell, GridSpec, SweepResult

__all__ = ["run_grid", "FusedLayout", "build_fused_layout"]


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
    :func:`_trace_key` share one *slot* of stream ids, as wide as its
    widest cell.  Returns ``(cell_slot, slot_off)``: each cell's slot and
    the slots' stream-id offsets."""
    uniq: Dict[Tuple, int] = {}
    cell_slot = [uniq.setdefault(_trace_key(grid.cells[ci]), len(uniq))
                 for ci in cell_idx]
    slot_runs = np.zeros(len(uniq), dtype=np.int64)
    for ci, slot in zip(cell_idx, cell_slot):
        slot_runs[slot] = max(slot_runs[slot], grid.cell_runs(ci))
    return cell_slot, np.concatenate([[0], np.cumsum(slot_runs)])


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
    cell_slot, slot_off = _trace_slots(grid, cell_idx)
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


@dataclass
class FusedLayout:
    """The fused dispatch's lane layout, deterministic in the grid: cells
    regrouped in trace-compatibility order (``cell_order``), per-cell
    lane counts and offsets, the per-cell engine tables, the lane -> cell
    index, and one :class:`TraceSpec` per failure-law group."""

    grid: GridSpec
    groups: List[Tuple[Tuple, List[int]]]
    cell_order: List[int]
    runs_o: np.ndarray  # (n_cells,) lanes per cell, cell_order order
    offs: np.ndarray  # (n_cells + 1,) lane offsets per cell
    specs: List[TraceSpec]  # one spec per group
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
        if len(self.specs) == 1:
            return self.specs[0]
        return TraceSpec.concat_cells(self.specs)


def build_fused_layout(grid: GridSpec) -> FusedLayout:
    """Assemble the fused device-trace dispatch's :class:`FusedLayout`
    for ``grid`` (stream ids are globally unique across groups)."""
    groups = _group_cells(grid)
    cell_order: List[int] = [ci for _, idx in groups for ci in idx]
    runs_o = np.array([grid.cell_runs(ci) for ci in cell_order], np.int64)
    offs = np.concatenate([[0], np.cumsum(runs_o)])
    specs: List[TraceSpec] = []
    base = 0
    for _, idx in groups:
        spec, base = _group_trace_spec(grid, idx, base)
        specs.append(spec)
    work_c = np.asarray(
        [grid.cells[ci].work for ci in cell_order], dtype=np.float64
    )
    plats_c = [grid.cells[ci].platform for ci in cell_order]
    strats_c = [grid.cells[ci].strategy for ci in cell_order]
    cidx = np.repeat(np.arange(len(cell_order), dtype=np.int32), runs_o)
    return FusedLayout(
        grid=grid, groups=groups, cell_order=cell_order, runs_o=runs_o,
        offs=offs, specs=specs, work_c=work_c, plats_c=plats_c,
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


def run_grid(
    grid: GridSpec, *, device=None, chunk_lanes="auto", collect: str = "stats",
    dispatch: str = "fused",
) -> SweepResult:
    """Execute every cell of ``grid`` on the device lane machine and
    aggregate per-cell statistics.

    Runs on CUDA unless ``device`` names another device; without CUDA and
    without ``device`` it raises.  ``chunk_lanes`` caps the lanes
    resident at once ("auto", an int, or None for all).  ``collect``:
    "stats" reduces per-cell moments on the device; "lanes" returns
    per-run arrays.  ``dispatch``: "fused" runs the whole grid in one
    call (a grid of several failure-law families on the law-indexed
    kernels, one family on the single-law ones); "perfamily" runs one
    call per family on the law-indexed kernels, lane for lane the fused
    run's results.  ``SweepResult.meta`` reports the device, the dispatch
    and its calls, the sampler ("indexed" or "single-law"), the outer
    iterations, the host syncs and the chunk count (summed over calls)."""
    dev = resolve_device(device)
    if collect not in ("lanes", "stats"):
        raise ValueError(f"unknown collect {collect!r} (expected 'lanes' or 'stats')")
    if dispatch not in ("fused", "perfamily"):
        raise ValueError(
            f"unknown dispatch {dispatch!r} (expected 'fused' or 'perfamily')"
        )
    t0 = time.monotonic()
    layout = build_fused_layout(grid)
    # (first cell position, spec) of each engine call
    if dispatch == "fused":
        calls = [(0, layout.concat_spec())] if layout.n_lanes else []
    else:
        pos = np.cumsum([0] + [len(idx) for _, idx in layout.groups])
        calls = [(int(p), spec.indexed()) for p, spec in zip(pos, layout.specs)]
    meta: Dict = {"device": str(dev), "dispatch": dispatch,
                  "dispatches": len(calls), "outer_iters": 0,
                  "host_syncs": 0, "n_chunks": 0}
    if calls:
        meta["sampler"] = ("indexed" if isinstance(calls[0][1].fault_dist, tuple)
                           else "single-law")
    cells: List[Optional[CellResult]] = [None] * len(grid.cells)
    for a, spec in calls:
        b = a + spec.n_cells
        info: Dict = {}
        res = simulate_batch_torch(
            layout.work_c[a:b], layout.plats_c[a:b], layout.strats_c[a:b], spec,
            device=dev, chunk=chunk_lanes, collect=collect, info=info,
        )
        for k in ("outer_iters", "host_syncs", "n_chunks"):
            meta[k] += info[k]
        lane0 = int(layout.offs[a])
        for k in range(a, b):
            ci = layout.cell_order[k]
            if collect == "stats":
                cells[ci] = _stats_cell_result(grid.cells[ci], res, k - a)
                continue
            sl = slice(int(layout.offs[k]) - lane0, int(layout.offs[k + 1]) - lane0)
            cells[ci] = CellResult(
                cell=grid.cells[ci],
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
    return SweepResult(
        grid=grid, cells=cells, engine="torch",
        wall_time_s=time.monotonic() - t0, collect=collect,
        meta=meta,
    )
