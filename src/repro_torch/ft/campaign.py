"""Resumable, self-healing campaign runner: the paper applied to itself.

The port's copy of the reference's ``repro/ft/campaign.py``.  A fused
sweep of 10^5 lanes (:func:`repro_torch.experiments.run_grid`) is a
long-running job on a fallible platform, so it gets the same treatment
the paper gives HPC applications: :class:`CampaignRunner` owns the fused
chunk loop and periodically snapshots the *tiny* durable state (the
per-cell :class:`~repro_torch.core.torch_sim.CellSums` accumulator
matrix, the lane cursor, and the current chunk width) through the port's
:class:`~repro_torch.checkpoint.CheckpointStore` /
:class:`~repro_torch.checkpoint.AsyncCheckpointer`.  Counter-based RNG
streams make the snapshot O(cells): lane traces are a pure function of
``(grid.seed, lane)``, so resume replays *nothing*: it rebuilds the
:class:`~repro_torch.experiments.runner.FusedLayout` from the grid and
continues at the cursor, and the resumed run's
:class:`~repro_torch.experiments.grid.SweepResult` is bit-identical to
the uninterrupted run's.

The snapshot period is chosen online by the paper's own formula:
:func:`repro_torch.core.optimize` ("young") on a
:class:`~repro_torch.core.waste.Platform` whose ``C`` is the *measured*
snapshot cost (EWMA) and whose ``mu`` is the configured platform MTBF.
``ckpt_period`` overrides it (0 = snapshot every chunk).

Dispatch failures are classified at chunk boundaries
(:func:`repro_torch.ft.retry.classify_failure`) and recovered without
losing the campaign:

* **OOM** (``torch.OutOfMemoryError`` among them): halve
  ``chunk_lanes`` (results are chunk-size invariant) and retry under
  jittered exponential backoff;
* **device loss** (a sticky CUDA error among them): rebuild the dispatch
  on the surviving devices (results are device-count invariant);
* **persistent engine failure**: once the retry budget is exhausted,
  degrade ``engine="torch"`` to the NumPy ``"batch"`` engine for the rest
  of the campaign (same streams, host replay) and record the degradation
  in the result metadata.  After it nothing touches CUDA (dispatch,
  reduction, snapshots, result), so a campaign whose CUDA context died
  finishes on the host;
* **process kill**: nothing to do: the next incarnation resumes from the
  newest valid snapshot (:meth:`CheckpointStore.restore_latest` skips
  torn/corrupt ones), restored onto the CPU.

A kernel that cannot be built (:class:`~repro_torch.kernels.build.
KernelBuildError`) is fatal: it propagates, never degraded around.
Chaos testing hooks in at the same boundary: a :class:`~repro_torch.ft.
injection.ChaosInjector` fires deterministic synthetic kills / OOMs /
device losses so tests exercise every row of that matrix.
"""

from __future__ import annotations

import hashlib
import json
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np

from ..checkpoint.async_ckpt import AsyncCheckpointer
from ..checkpoint.store import CheckpointStore
from ..core.analytic import optimize
from ..core.batch_sim import simulate_batch
from ..core.engine import EngineConfig, resolve_engine_config
from ..core.torch_sim import (
    CellSums,
    _host_lane_bytes,
    default_chunk_lanes,
    resolve_devices,
    simulate_batch_torch,
)
from ..core.waste import Platform
from ..experiments.grid import CellResult, GridSpec, SweepResult
from ..experiments.runner import (
    _LANE_FIELDS,
    _lane_arrays,
    _lanes_cell_result,
    _stats_cell_result,
    FusedLayout,
    build_fused_layout,
)
from .injection import ChaosInjector
from .retry import FailureKind, RetryPolicy, classify_failure

__all__ = ["CampaignConfig", "CampaignRunner", "run_campaign"]

#: RNG namespace tag of the campaign's per-chunk host-mode trust coins
#: (device trace mode draws trust from the lanes' own counter streams and
#: never touches this): seeds ``[grid.seed, n_groups, _RNG_TAG, lane_lo]``
#: are disjoint from every run_grid seed family by length and tag.
_RNG_TAG = 0x0C47


@dataclass
class CampaignConfig:
    """Durability/recovery knobs of a :class:`CampaignRunner`.

    ckpt_dir         checkpoint store root for the campaign snapshots.
    mtbf             assumed MTBF (seconds) of the platform *running the
                     campaign*: the ``mu`` of the snapshot-period
                     formula, not of the simulated platforms.
    ckpt_period      snapshot period override (seconds); ``0`` snapshots
                     at every chunk boundary, ``None`` lets
                     ``repro_torch.core.optimize("young")`` choose from
                     the measured snapshot cost and ``mtbf``.
    restore_cost     assumed R (seconds) of a campaign resume, for the
                     period formula.
    save_cost_prior  prior C (seconds) before the first measured save.
    keep             committed snapshots retained (older ones GC'd).
    async_snapshots  drain snapshots on a background thread
                     (:class:`AsyncCheckpointer`); the blocking cost is
                     then just the host copy, which is what feeds C.
    retry            shared :class:`RetryPolicy` for dispatch failures.
    min_chunk_lanes  floor of the OOM chunk-halving ladder.
    chaos            optional :class:`ChaosInjector` fired at every
                     chunk boundary (tests).
    """

    ckpt_dir: str
    mtbf: float = 3600.0
    ckpt_period: Optional[float] = None
    restore_cost: float = 1.0
    save_cost_prior: float = 0.05
    keep: int = 3
    async_snapshots: bool = True
    retry: RetryPolicy = field(default_factory=RetryPolicy)
    min_chunk_lanes: int = 8
    chaos: Optional[ChaosInjector] = None


def _grid_fingerprint(grid: GridSpec, trace_mode: str, collect: str) -> str:
    """Identity of (grid, trace source, result layout): a snapshot may
    only resume a campaign that would recompute the same lanes."""
    text = repr((grid, trace_mode, collect))
    return hashlib.sha256(text.encode()).hexdigest()[:16]


def _jsonable(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    return obj


class CampaignRunner:
    """Killable, resumable fused sweep (see module docstring).

    Parameters
    ----------
    grid      the :class:`GridSpec` to run.
    campaign  a :class:`CampaignConfig` (durability/recovery knobs).
    config    an :class:`~repro_torch.core.engine.EngineConfig`; must
              select ``engine="torch"`` (the degradation *target* is
              "batch").  ``chunk_lanes`` is the campaign's
              snapshot/recovery granularity: "auto" picks the engine's
              own chunk for the device set
              (:func:`~repro_torch.core.torch_sim.default_chunk_lanes`),
              ``None`` runs one chunk.  On the card "auto" is 2^20 lanes
              in device trace mode and an 8 GiB slab budget in host
              mode, so a paper grid runs as a single chunk with a single
              snapshot: a campaign that wants resumability names its
              chunk.
    device    the one-device spelling of ``config.devices`` (the two
              together raise): CUDA unless it names another device;
              without CUDA and without ``device="cpu"`` it raises.
    """

    def __init__(
        self,
        grid: GridSpec,
        campaign: CampaignConfig,
        config: Optional[EngineConfig] = None,
        *,
        device=None,
    ):
        cfg = resolve_engine_config(config, "CampaignRunner")
        cfg.validate()
        if cfg.engine != "torch":
            raise ValueError(
                "CampaignRunner requires engine='torch' (the batch engine "
                "is its degradation target, not a starting point)"
            )
        if cfg.dispatch not in (None, "fused"):
            raise ValueError("CampaignRunner only runs dispatch='fused'")
        self._devices = list(resolve_devices(cfg.devices, device))
        self.grid = grid
        self.cfg = cfg
        self.camp = campaign
        self.layout: FusedLayout = build_fused_layout(grid, cfg.trace_mode)
        self._fingerprint = _grid_fingerprint(
            grid, cfg.trace_mode, cfg.collect
        )

        if cfg.chunk_lanes == "auto":
            chunk = default_chunk_lanes(
                self._devices[0], cfg.trace_mode, self._lane_bytes()
            ) * len(self._devices)
        elif cfg.chunk_lanes is None:
            chunk = max(1, self.layout.n_lanes)
        else:
            chunk = int(cfg.chunk_lanes)
        self._chunk_lanes0 = max(1, chunk)

        self.store = CheckpointStore(campaign.ckpt_dir, codec="raw")
        self._async: Optional[AsyncCheckpointer] = (
            AsyncCheckpointer(self.store, keep=campaign.keep)
            if campaign.async_snapshots
            else None
        )

        n_cells = len(self.layout.cell_order)
        self._spec = (
            self.layout.concat_spec() if cfg.trace_mode == "device" else None
        )
        self._host_traces_cache = self.layout.traces  # device mode: lazy
        # mutable campaign state (the durable part of it is snapshotted)
        self._sums = np.zeros((n_cells, 12), np.float64)
        self._lane_parts: List[Dict[str, np.ndarray]] = []
        self._lanes_done = 0
        self._chunk_lanes = self._chunk_lanes0
        self._chunk_index = 0
        self._incarnation = 0
        self._degraded = False
        self._wall_prev = 0.0
        self._events: List[Dict] = []
        self._n_snapshots = 0
        self._c_est = campaign.save_cost_prior
        self._chunk_cost = 0.0  # EWMA of per-chunk wall cost
        self._wall_since_snap = 0.0
        self._snap_period = self._compute_period()

    def _lane_bytes(self) -> int:
        """Slab bytes of one lane in host trace mode (0 in device mode):
        what ``default_chunk_lanes`` sizes a host-mode chunk by."""
        tr = self.layout.traces
        if tr is None:
            return 0
        modes = {s.mode for s in self.layout.strats_c}
        return _host_lane_bytes(
            max(tr.fault_times.shape[1], int(tr.n_faults.max(initial=0)) + 1),
            max(tr.pred_t0.shape[1], int(tr.n_preds.max(initial=0)) + 1),
            "migration" in modes, "two_level" in modes,
        )

    # ------------------------------------------------------------------ #
    # snapshot period: the paper's formula on the campaign itself
    # ------------------------------------------------------------------ #
    def _compute_period(self) -> float:
        if self.camp.ckpt_period is not None:
            return float(self.camp.ckpt_period)
        plat = Platform(
            mu=self.camp.mtbf,
            C=max(self._c_est, 1e-4),
            D=0.0,
            R=self.camp.restore_cost,
        )
        # uncapped Young period from the measured snapshot cost: the
        # q=0 closed form; campaign faults are unpredicted kills
        return float(optimize("young", plat).T_R)

    # ------------------------------------------------------------------ #
    # durable state
    # ------------------------------------------------------------------ #
    def _state_tree(self) -> Dict[str, np.ndarray]:
        meta = {
            "fingerprint": self._fingerprint,
            "events": _jsonable(self._events),
            "n_snapshots": self._n_snapshots,
            "c_est": self._c_est,
        }
        blob = np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8
        ).copy()
        cursor = np.array(
            [
                self._lanes_done,
                self._chunk_lanes,
                self._chunk_index,
                self._incarnation,
                int(self._degraded),
            ],
            np.int64,
        )
        wall = np.array(
            [self._wall_prev + (time.monotonic() - self._t_start)], np.float64
        )
        # copies: the async drain serializes on a background thread while
        # the chunk loop keeps mutating the live accumulators
        tree = {
            "sums": self._sums.copy(),
            "cursor": cursor,
            "wall": wall,
            "meta": blob,
        }
        if self.cfg.collect == "lanes" and self._lane_parts:
            cat = {
                k: np.concatenate([p[k] for p in self._lane_parts])
                for k in _LANE_FIELDS
            }
            for k, v in cat.items():
                tree[f"lane/{k}"] = np.asarray(v).copy()
        return tree

    def _load_state(self, host: Dict[str, np.ndarray]) -> None:
        meta = json.loads(bytes(host["meta"].tobytes()).decode("utf-8"))
        if meta["fingerprint"] != self._fingerprint:
            raise ValueError(
                "refusing to resume: snapshot belongs to a different "
                f"campaign (fingerprint {meta['fingerprint']} != "
                f"{self._fingerprint})"
            )
        cur = np.asarray(host["cursor"], np.int64)
        self._lanes_done = int(cur[0])
        self._chunk_lanes = int(cur[1])
        self._chunk_index = int(cur[2])
        self._incarnation = int(cur[3]) + 1  # this process is the next life
        self._degraded = bool(cur[4])
        sums = np.asarray(host["sums"], np.float64)
        if sums.shape != self._sums.shape:
            raise ValueError(
                "refusing to resume: snapshot accumulator has shape "
                f"{sums.shape}, this build expects {self._sums.shape} "
                "(snapshot predates the two-level/silent stats columns "
                "— rerun the campaign with resume=False)"
            )
        self._sums = sums.copy()
        self._wall_prev = float(np.asarray(host["wall"])[0])
        self._events = list(meta["events"])
        self._n_snapshots = int(meta["n_snapshots"])
        self._c_est = float(meta["c_est"])
        self._lane_parts = []
        if self.cfg.collect == "lanes":
            if self._lanes_done and "lane/waste" not in host:
                raise ValueError(
                    "snapshot has no lane arrays but collect='lanes'"
                )
            if "lane/waste" in host:
                self._lane_parts = [
                    {k: np.asarray(host[f"lane/{k}"]) for k in _LANE_FIELDS}
                ]

    def _snapshot(self) -> None:
        tree = self._state_tree()
        step = self._lanes_done
        if self._async is not None:
            c_block = self._async.save(step, tree)
            cost = max(float(c_block), 1e-5)
        else:
            t0 = time.monotonic()
            self.store.save(step, tree)
            self.store.gc(keep=self.camp.keep)
            cost = max(time.monotonic() - t0, 1e-5)
        self._c_est = 0.7 * self._c_est + 0.3 * cost
        self._n_snapshots += 1
        self._wall_since_snap = 0.0
        self._snap_period = self._compute_period()

    def _try_resume(self) -> bool:
        # the campaign's state is host state: restore it onto the CPU, so
        # a resume touches no card (and survives a dead CUDA context)
        found = self.store.restore_latest(device="cpu")
        if found is None:
            return False
        step, tree = found
        self._load_state({k: v.numpy() for k, v in tree.items()})
        self._events.append(
            {
                "kind": "resume",
                "lanes_done": self._lanes_done,
                "chunk": self._chunk_index,
                "incarnation": self._incarnation,
            }
        )
        return True

    # ------------------------------------------------------------------ #
    # chunk dispatch + recovery
    # ------------------------------------------------------------------ #
    def _host_traces(self):
        if self._host_traces_cache is None:
            self._host_traces_cache = self.layout.host_traces()
        return self._host_traces_cache

    def _chunk_rng(self, lo: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.grid.seed, self.layout.n_groups, _RNG_TAG, lo]
        )

    def _dispatch_torch(self, lo: int, hi: int):
        lay = self.layout
        rows = np.arange(lo, hi)
        if self._spec is not None:
            return simulate_batch_torch(
                lay.work_c, lay.plats_c, lay.strats_c,
                self._spec.take(rows),
                chunk=None, devices=self._devices,
                collect=self.cfg.collect,
            )
        return simulate_batch_torch(
            lay.work_c, lay.plats_c, lay.strats_c,
            lay.traces.take(rows),
            rng=self._chunk_rng(lo),
            chunk=None, devices=self._devices,
            cell_index=lay.cidx[lo:hi], collect=self.cfg.collect,
        )

    def _dispatch_batch(self, lo: int, hi: int):
        lay = self.layout
        rows = np.arange(lo, hi)
        cidx_sub = lay.cidx[lo:hi]
        return simulate_batch(
            lay.work_c[cidx_sub],
            [lay.plats_c[k] for k in cidx_sub],
            [lay.strats_c[k] for k in cidx_sub],
            self._host_traces().take(rows),
            rng=self._chunk_rng(lo),
        )

    def _lanes_to_matrix(self, res, cidx_sub: np.ndarray) -> np.ndarray:
        """Host-side per-cell reduction of a degraded (batch-engine)
        chunk: the same 12 CellSums columns, np.add.at over lanes."""
        m = np.zeros_like(self._sums)
        zeros = np.zeros(cidx_sub.shape[0])
        nd = res.n_disk_recoveries
        nv = res.n_detections
        cols = (
            np.ones(cidx_sub.shape[0]),
            res.makespan, res.makespan ** 2,
            res.waste, res.waste ** 2,
            res.n_faults, res.n_proactive_ckpts, res.n_regular_ckpts,
            res.n_migrations, res.trace_exhausted,
            zeros if nd is None else nd,
            zeros if nv is None else nv,
        )
        for j, v in enumerate(cols):
            np.add.at(m[:, j], cidx_sub, np.asarray(v, np.float64))
        return m

    def _accumulate(self, out, lo: int, hi: int) -> None:
        cidx_sub = self.layout.cidx[lo:hi]
        if self.cfg.collect == "stats":
            if self._degraded:
                self._sums += self._lanes_to_matrix(out, cidx_sub)
            else:
                self._sums += out.as_matrix()
        else:
            self._lane_parts.append(_lane_arrays(out))

    def _run_chunk(self, lo: int) -> int:
        """Dispatch one chunk with chaos, classification and recovery;
        returns the new cursor (``hi`` of the committed chunk)."""
        camp, chaos = self.camp, self.camp.chaos
        attempt = 0
        while True:
            hi = min(lo + self._chunk_lanes, self.layout.n_lanes)
            engine = "batch" if self._degraded else "torch"
            try:
                if chaos is not None:
                    chaos.at_chunk_boundary(
                        self._chunk_index,
                        incarnation=self._incarnation,
                        attempt=attempt,
                        engine=engine,
                    )
                out = (
                    self._dispatch_batch(lo, hi)
                    if self._degraded
                    else self._dispatch_torch(lo, hi)
                )
            except Exception as exc:
                kind = classify_failure(exc)
                if kind is FailureKind.FATAL:
                    raise
                self._events.append(
                    {
                        "kind": kind.value,
                        "chunk": self._chunk_index,
                        "attempt": attempt,
                        "error": f"{type(exc).__name__}: {exc}"[:200],
                    }
                )
                attempt += 1
                ctr = self._chunk_index * 64 + attempt
                if attempt < camp.retry.max_attempts:
                    if kind is FailureKind.OOM and (
                        self._chunk_lanes > camp.min_chunk_lanes
                    ):
                        # allocation pressure: shrink the resident-lane
                        # footprint (results are chunk-size invariant)
                        self._chunk_lanes = max(
                            camp.min_chunk_lanes, self._chunk_lanes // 2
                        )
                        self._events.append(
                            {
                                "kind": "chunk_halved",
                                "chunk": self._chunk_index,
                                "chunk_lanes": self._chunk_lanes,
                            }
                        )
                    elif kind is FailureKind.DEVICE_LOSS and (
                        len(self._devices) > 1
                    ):
                        n_lost = min(
                            int(getattr(exc, "n_lost", 1)),
                            len(self._devices) - 1,
                        )
                        self._devices = self._devices[
                            : len(self._devices) - n_lost
                        ]
                        self._events.append(
                            {
                                "kind": "devices_shrunk",
                                "chunk": self._chunk_index,
                                "n_devices": len(self._devices),
                            }
                        )
                    camp.retry.pause(attempt - 1, ctr)
                    continue
                # retry budget exhausted: graceful degradation
                if not self._degraded:
                    self._degraded = True
                    attempt = 0
                    self._events.append(
                        {
                            "kind": "engine_degraded",
                            "chunk": self._chunk_index,
                            "from": "torch",
                            "to": "batch",
                        }
                    )
                    continue
                raise
            self._accumulate(out, lo, hi)
            return hi

    # ------------------------------------------------------------------ #
    def run(self, resume: Any = "auto") -> SweepResult:
        """Run (or resume) the campaign to completion.

        ``resume``: "auto" continues from the newest valid snapshot in
        ``ckpt_dir`` if one exists; True requires one; False starts
        fresh (existing snapshots are ignored and then overwritten)."""
        self._t_start = time.monotonic()
        if resume in ("auto", True):
            resumed = self._try_resume()
            if resume is True and not resumed:
                raise FileNotFoundError(
                    f"no resumable snapshot in {self.camp.ckpt_dir}"
                )
        n_lanes = self.layout.n_lanes
        while self._lanes_done < n_lanes:
            t0 = time.monotonic()
            hi = self._run_chunk(self._lanes_done)
            self._lanes_done = hi
            self._chunk_index += 1
            dt = time.monotonic() - t0
            self._chunk_cost = (
                dt if self._chunk_cost == 0.0
                else 0.7 * self._chunk_cost + 0.3 * dt
            )
            self._wall_since_snap += dt
            # snapshot when the accumulated at-risk wall time reaches the
            # optimize()-chosen period (always at period 0)
            if (
                self._lanes_done >= n_lanes
                or self._snap_period <= 0.0
                or self._wall_since_snap + 0.5 * self._chunk_cost
                >= self._snap_period
            ):
                self._snapshot()
        if self._async is not None:
            self._async.wait()  # surface drain errors; final is durable
        return self._result()

    # ------------------------------------------------------------------ #
    def _result(self) -> SweepResult:
        lay = self.layout
        cells: List[Optional[CellResult]] = [None] * len(self.grid.cells)
        if self.cfg.collect == "stats":
            sums = CellSums.from_matrix(self._sums)
            for k, ci in enumerate(lay.cell_order):
                cells[ci] = _stats_cell_result(self.grid.cells[ci], sums, k)
        else:
            lanes = SimpleNamespace(**{
                k: np.concatenate([p[k] for p in self._lane_parts])
                for k in _LANE_FIELDS
            })
            for k, ci in enumerate(lay.cell_order):
                sl = slice(int(lay.offs[k]), int(lay.offs[k + 1]))
                cells[ci] = _lanes_cell_result(self.grid.cells[ci], lanes, sl)
        wall = self._wall_prev + (time.monotonic() - self._t_start)
        meta = {
            "dispatch": "fused",
            "campaign": _jsonable(
                {
                    "ckpt_dir": self.camp.ckpt_dir,
                    "incarnation": self._incarnation,
                    "n_snapshots": self._n_snapshots,
                    "snapshot_period_s": self._snap_period,
                    "snapshot_cost_est_s": self._c_est,
                    "chunk_lanes_final": self._chunk_lanes,
                    "n_devices_final": len(self._devices),
                    "engine_degraded": self._degraded,
                    "events": self._events,
                }
            ),
        }
        return SweepResult(
            grid=self.grid, cells=cells,
            engine="batch" if self._degraded else "torch",
            wall_time_s=wall, collect=self.cfg.collect,
            meta=meta,
        )


def run_campaign(
    grid: GridSpec,
    campaign: CampaignConfig,
    config: Optional[EngineConfig] = None,
    resume: Any = "auto",
    *,
    device=None,
) -> SweepResult:
    """One-call convenience: build a :class:`CampaignRunner` and run it."""
    return CampaignRunner(grid, campaign, config, device=device).run(
        resume=resume
    )
