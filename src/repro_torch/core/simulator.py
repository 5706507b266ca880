"""Discrete-event simulator of checkpointing strategies under fault traces.

The port's copy of the reference ``repro.core.simulator``: the strategy
descriptions and constructors, BestPeriod's period-multiplier grid, and
the scalar engine of the paper's Section 5 (``_Engine``, Algorithm 1 with
the W_reg bookkeeping: work credited toward the interrupted regular
period survives proactive episodes, and the "no time for an extra
checkpoint" path credits only ``max(0, t0 - C - ckpt_end)``, line 12).
A job of ``work`` seconds runs on a platform of checkpoint cost C,
downtime D and recovery R; faults and (true or false) predictions come
from an :class:`~repro_torch.core.events.EventTrace`; the strategy sets
the regular period T_R, the trust probability q and what to do inside a
prediction window (Instant / NoCkptI / WithCkptI), or migrates (Section
3.4); :func:`simulate` reports the makespan and the waste ``1 - work /
makespan``.

:func:`simulate_many` runs ``n_runs`` traces through one of the engines
of :class:`~repro_torch.core.engine.EngineConfig`: ``"torch"`` (the
device lane machine, per-run results), ``"batch"`` (the NumPy lanes) or
``"scalar"`` (this event loop, the oracle), and
:func:`best_period_search` (BestPeriod) brute-forces the regular period
on identical traces.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from . import periods as P
from .engine import UNSET, EngineConfig, resolve_engine_config
from .events import Distribution, EventTrace, exponential
from .waste import Platform, PredictorModel

#: absolute time tolerance (seconds) — periods are O(10^3) s, so 1 us is
#: far below any modelled quantity yet far above float64 residuals.
_EPS = 1e-6

__all__ = [
    "Strategy",
    "young",
    "daly",
    "exact_prediction",
    "instant",
    "nockpt",
    "withckpt",
    "migration",
    "two_level",
    "silent",
    "SimResult",
    "simulate",
    "simulate_many",
    "best_period_search",
    "PERIOD_GRID",
]

#: BestPeriod's default period-multiplier grid (Section 5)
PERIOD_GRID = (0.25, 0.4, 0.6, 0.8, 1.0, 1.25, 1.6, 2.0, 3.0, 4.0)


@dataclass(frozen=True)
class Strategy:
    """An operating point of the scheduling algorithm.

    mode:
      "none"      ignore all predictions (Young / Daly / BestPeriod baselines)
      "exact"     Section 3 — proactive checkpoint right before the predicted
                  date (for window traces: act on t0, return to regular; this
                  is also the Instant strategy of Section 4)
      "nockpt"    Section 4 — no checkpoints inside the window
      "withckpt"  Section 4 — proactive period T_P inside the window
      "migration" Section 3.4 — migrate (cost M) instead of checkpointing
      "two_level" beyond-paper — memory-tier checkpoints of period T_R
                  nested in disk-tier checkpoints every ``rho``-th period
                  (see waste.waste_two_level)
      "silent"    beyond-paper — latent corruptions, verification every
                  ``k_V``-th checkpoint (see waste.waste_silent)
    """

    name: str
    T_R: float
    q: float = 0.0
    mode: str = "none"
    T_P: Optional[float] = None
    #: two-level nesting stride (every rho-th regular ckpt is disk-tier)
    rho: Optional[int] = None
    #: silent-error verification stride (every k_V-th regular ckpt verifies)
    k_V: Optional[int] = None


def young(platform: Platform) -> Strategy:
    """Uncapped Young period sqrt(2 mu C) (the simulation baseline)."""
    return Strategy("Young", P._t_extr(platform.mu, platform.C), q=0.0, mode="none")


def daly(platform: Platform) -> Strategy:
    return Strategy(
        "Daly", P._t_daly(platform.mu, platform.R, platform.C), q=0.0, mode="none"
    )


def _t1(platform: Platform, pred: PredictorModel) -> float:
    """Uncapped T_extr^{1} = sqrt(2 mu C / (1 - r)) — Section 5 uses the
    uncapped value to mimic a real execution."""
    return P._t_extr(platform.mu, platform.C, pred.recall, 1.0)


def exact_prediction(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("ExactPrediction", _t1(platform, pred), q=1.0, mode="exact")


def instant(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("Instant", _t1(platform, pred), q=1.0, mode="exact")


def nockpt(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("NoCkptI", _t1(platform, pred), q=1.0, mode="nockpt")


def withckpt(platform: Platform, pred: PredictorModel) -> Strategy:
    tp = P._t_p_opt(platform.C, pred.precision, pred.window, pred.e_f)
    if tp is None:  # window cannot hold a checkpoint: degenerate to NoCkptI
        return Strategy("WithCkptI", _t1(platform, pred), q=1.0, mode="nockpt")
    return Strategy(
        "WithCkptI", _t1(platform, pred), q=1.0, mode="withckpt", T_P=tp[0]
    )


def migration(platform: Platform, pred: PredictorModel) -> Strategy:
    return Strategy("Migration", _t1(platform, pred), q=1.0, mode="migration")


def two_level(platform: Platform, pred: Optional[PredictorModel] = None) -> Strategy:
    """Two-level checkpointing at the corrected joint extremizers: memory
    period T_m, disk stride rho = round(T_d / T_m) (>= 1 by the T_d >= T_m
    constraint of :func:`~repro_torch.core.periods.two_level_periods`)."""
    C2 = platform.C2 if platform.C2 is not None else platform.C
    R2 = platform.R2 if platform.R2 is not None else platform.R
    f = platform.f if platform.f is not None else 0.0
    r = pred.recall if pred is not None else 0.0
    q = 1.0 if pred is not None and r > 0.0 else 0.0
    p = pred.precision if pred is not None else 1.0
    t_m, t_d = P.two_level_periods(
        platform.mu, platform.C, C2, f, r, q, p, platform.D, platform.R, R2
    )
    return Strategy(
        "TwoLevel", t_m, q=q, mode="two_level", rho=max(1, round(t_d / t_m))
    )


def silent(platform: Platform) -> Strategy:
    """Silent-error strategy: verified checkpoints every k_V-th period (the
    predictor never fires on latent corruptions, so q = 0 always)."""
    V = platform.V if platform.V is not None else platform.C
    t, k = P.silent_period(platform.mu, platform.C, V, platform.D, platform.R)
    return Strategy("Silent", t, q=0.0, mode="silent", k_V=k)


# --------------------------------------------------------------------------- #
# Simulation engine
# --------------------------------------------------------------------------- #
@dataclass
class SimResult:
    makespan: float
    work: float
    n_faults: int
    n_proactive_ckpts: int
    n_regular_ckpts: int
    n_migrations: int
    trace_exhausted: bool = False
    #: two-level disk-tier recoveries / silent-error detections (zero
    #: unless the strategy runs the corresponding mode)
    n_disk_recoveries: int = 0
    n_detections: int = 0

    @property
    def waste(self) -> float:
        return 1.0 - self.work / self.makespan


class _Engine:
    def __init__(
        self,
        work: float,
        platform: Platform,
        strategy: Strategy,
        trace: EventTrace,
        rng: np.random.Generator,
    ):
        self.W = work
        self.C = platform.C
        self.D = platform.D
        self.R = platform.R
        self.M = platform.M if platform.M is not None else platform.C
        self.strat = strategy
        self.t = 0.0
        self.saved = 0.0
        self.unsaved = 0.0
        self.period_work = 0.0
        self.done = False
        self.n_faults = 0
        self.n_pro = 0
        self.n_reg = 0
        self.n_mig = 0

        # two-level state: durable frontier, memory ckpts since it, and the
        # duration of the repair in progress (a fault during a repair
        # restarts the SAME repair — rc, not D+R)
        self.tl = strategy.mode == "two_level"
        self.sil = strategy.mode == "silent"
        self.C2 = platform.C2 if platform.C2 is not None else platform.C
        self.R2 = platform.R2 if platform.R2 is not None else platform.R
        self.V = platform.V if platform.V is not None else platform.C
        self.fmem = platform.f if platform.f is not None else 0.0
        self.rho = strategy.rho if strategy.rho is not None else 1
        self.kv = strategy.k_V if strategy.k_V is not None else 1
        self.saved_d = 0.0
        self.dk_ctr = 0
        self.rc = self.D + self.R
        # silent-error state: verified frontier, unverified ckpts since it,
        # earliest latent corruption time
        self.saved_v = 0.0
        self.ck_v = 0
        self.corrupt = math.inf
        self.n_disk = 0
        self.n_det = 0

        self.fault_times: List[float] = [f.time for f in trace.faults]
        # per-fault recovery-tier uniforms (u >= f sends recovery to disk;
        # the 1.0 default means "disk" and keeps legacy traces valid)
        self.tiers: List[float] = [
            getattr(f, "tier_u", 1.0) for f in trace.faults
        ]
        self.fi = 0
        # Trust decisions are drawn per prediction (probability q).  Silent
        # lanes never trust: a latent corruption is not a fail-stop event,
        # so the fail-stop predictor has nothing to predict.
        preds = trace.predictions
        if strategy.mode in ("none", "silent") or strategy.q <= 0.0:
            self.preds = []
        elif strategy.q >= 1.0:
            self.preds = list(preds)
        else:
            self.preds = [pr for pr in preds if rng.random() < strategy.q]
        self.pi = 0
        self.horizon = trace.horizon
        self.exhausted = False

    # -- event peeking ------------------------------------------------------ #
    def _next_fault(self) -> float:
        if self.sil:
            # silent strikes never interrupt a primitive (latent until the
            # next verification): consumed by _consume_silent instead
            return math.inf
        while self.fi < len(self.fault_times) and self.fault_times[self.fi] < self.t:
            # fault during downtime/recovery: recovery restarts (rc is the
            # duration of the repair in progress — D+R everywhere except
            # after a two-level disk recovery)
            f = self.fault_times[self.fi]
            if f >= self.t - self.rc:
                self.n_faults += 1
                self.t = f + self.rc
            self.fi += 1
        return (
            self.fault_times[self.fi] if self.fi < len(self.fault_times) else math.inf
        )

    def _consume_silent(self) -> None:
        """Consume latent strikes up to the current clock: they corrupt
        state silently instead of interrupting the primitive."""
        if not self.sil:
            return
        while self.fi < len(self.fault_times) and self.fault_times[self.fi] <= self.t:
            self.corrupt = min(self.corrupt, self.fault_times[self.fi])
            self.fi += 1

    def _next_action(self) -> float:
        """Time at which the next trusted prediction requires action."""
        lead = self.M if self.strat.mode == "migration" else self.C
        while self.pi < len(self.preds) and self.preds[self.pi].t0 - lead < self.t:
            self.pi += 1  # too late to act on this prediction
        if self.pi >= len(self.preds):
            return math.inf
        return self.preds[self.pi].t0 - lead

    # -- primitive timeline operations -------------------------------------- #
    def _handle_fault(self, t_fault: float) -> None:
        self.n_faults += 1
        self.unsaved = 0.0
        self.period_work = 0.0
        if self.tl:
            # tier coin consumed with the fault (callers advanced fi past
            # the consumed column already): u >= f sends recovery to disk
            u = self.tiers[self.fi - 1] if self.fi - 1 < len(self.tiers) else 1.0
            if u >= self.fmem:
                # disk-tier recovery: restart from the last disk checkpoint
                self.t = t_fault + self.D + self.R2
                self.saved = self.saved_d
                self.dk_ctr = 0
                self.rc = self.D + self.R2
                self.n_disk += 1
                return
            self.rc = self.D + self.R
        self.t = t_fault + self.D + self.R

    def _work_until(self, t_target: float, credit_period: bool = True) -> bool:
        """Perform useful work from self.t to t_target.

        Caps at job completion.  Returns True if a fault interrupted."""
        remaining = self.W - self.saved - self.unsaved
        t_target = min(t_target, self.t + remaining)
        nf = self._next_fault()
        if nf <= t_target:
            self.fi += 1
            self._handle_fault(nf)
            return True
        dt = t_target - self.t
        self.unsaved += dt
        if credit_period:
            self.period_work += dt
        self.t = t_target
        self._consume_silent()
        if self.saved + self.unsaved >= self.W - _EPS:
            self.done = True
        return False

    def _idle_until(self, t_target: float) -> bool:
        """Idle (no useful work) until t_target.  True if faulted."""
        nf = self._next_fault()
        if nf <= t_target:
            self.fi += 1
            self._handle_fault(nf)
            return True
        self.t = t_target
        self._consume_silent()
        return False

    def _checkpoint(self, proactive: bool) -> bool:
        """Take a checkpoint; returns True if a fault aborted it.

        A fault at the exact completion instant does *not* abort the
        checkpoint (this realizes the exact-date prediction semantics where
        the checkpoint completes right when the fault strikes).

        The rho-th regular checkpoint of a two-level lane is the disk tier
        (cost C + C2); the k_V-th regular checkpoint of a silent-error lane
        verifies (cost C + V) and detects any latent corruption, rolling
        back past every unverified checkpoint to the verified frontier.
        Proactive checkpoints hit the memory tier and never verify."""
        cost = self.C
        disk_int = ver_int = False
        if not proactive:
            disk_int = self.tl and self.dk_ctr >= self.rho - 1
            ver_int = self.sil and self.ck_v >= self.kv - 1
            if disk_int:
                cost += self.C2
            if ver_int:
                cost += self.V
        end = self.t + cost
        nf = self._next_fault()
        if nf < end:
            self.fi += 1
            self._handle_fault(nf)
            return True
        self.t = end
        self.saved += self.unsaved
        self.unsaved = 0.0
        if proactive:
            self.n_pro += 1
        else:
            self.n_reg += 1
            self.period_work = 0.0
            if self.tl:
                if disk_int:
                    self.saved_d = self.saved
                    self.dk_ctr = 0
                else:
                    self.dk_ctr += 1
        self._consume_silent()
        if not proactive and self.sil:
            if ver_int:
                if math.isfinite(self.corrupt):
                    # verification caught a latent corruption: recover and
                    # roll back to the last verified checkpoint
                    self.t += self.D + self.R
                    self.saved = self.saved_v
                    self.period_work = 0.0
                    self.corrupt = math.inf
                    self.n_faults += 1
                    self.n_det += 1
                else:
                    self.saved_v = self.saved
                self.ck_v = 0
            else:
                self.ck_v += 1
        return False

    # -- proactive episodes (Section 4 strategies) --------------------------- #
    def _episode(self, pred) -> None:
        """Handle one trusted prediction, starting at t = t0 - C (or later if
        a regular checkpoint was running at the action point)."""
        t0, I = pred.t0, pred.window
        mode = self.strat.mode

        if mode == "migration":
            # Migrate during [t0 - M, t0]; the predicted fault (if real)
            # hits the *vacated* node, so it is cancelled up front — the
            # migration completes right when the fault was due (Section
            # 3.4); other faults can still interrupt the migration.
            if pred.fault_time is not None and pred.fault_time >= self.t:
                try:
                    idx = self.fault_times.index(pred.fault_time, self.fi)
                    self.fault_times.pop(idx)
                except ValueError:
                    pass
            if self._idle_until(t0):
                return
            self.n_mig += 1
            return

        # Pre-window checkpoint, as late as possible (Figure 1(a)).
        if self.t <= t0 - self.C:
            if self.t < t0 - self.C:
                if self._work_until(t0 - self.C):
                    return
                if self.done:
                    return
            if self._checkpoint(proactive=True):
                return
        else:
            # no time for the extra checkpoint (Figure 1(b)): work until t0,
            # crediting only max(0, t0 - C - now) to the period (Alg. 1 l.12)
            credit_until = max(self.t, t0 - self.C)
            if self._work_until(credit_until, credit_period=True):
                return
            if not self.done and self._work_until(t0, credit_period=False):
                return
            if self.done:
                return

        if mode in ("exact", "two_level"):
            # Instant: straight back to regular mode at t0.  Two-level
            # episodes behave the same — the proactive checkpoint above
            # hit the memory tier (cost C, no disk-stride advance), and a
            # disk-tier fault will ignore it and roll back to the durable
            # frontier anyway (see _handle_fault).
            return

        if mode == "nockpt":
            self._work_until(t0 + I, credit_period=False)
            return

        if mode == "withckpt":
            T_P = self.strat.T_P or max(self.C, I)
            end = t0 + I
            while self.t < end - _EPS and not self.done:
                seg = min(self.t + (T_P - self.C), end - self.C)
                if seg > self.t:
                    if self._work_until(seg, credit_period=False):
                        return
                    if self.done:
                        return
                if self._checkpoint(proactive=True):
                    return
            return

        raise ValueError(f"unknown mode {mode!r}")  # pragma: no cover

    # -- main loop ----------------------------------------------------------- #
    def run(self) -> SimResult:
        T_R, C = self.strat.T_R, self.C
        work_per_period = max(T_R - C, 1e-9)
        guard = 0
        while not self.done:
            guard += 1
            if guard > 50_000_000:  # pragma: no cover
                raise RuntimeError("simulator did not converge")
            if self.t > self.horizon:
                self.exhausted = True
            na = self._next_action()
            remaining_to_ckpt = work_per_period - self.period_work

            if remaining_to_ckpt <= _EPS:
                # Regular checkpoint due.  If the action point falls inside
                # the checkpoint, Algorithm 1's "no time" path applies: the
                # episode starts right after this checkpoint completes.
                if self._checkpoint(proactive=False):
                    continue
                if na <= self.t and self.pi < len(self.preds):
                    pred = self.preds[self.pi]
                    self.pi += 1
                    if pred.t0 >= self.t - 1e-9:
                        self._episode(pred)
                continue

            # Work segment until the next regular checkpoint.
            seg_end = self.t + remaining_to_ckpt
            if na < seg_end:
                if self._work_until(na):
                    continue
                if self.done:
                    break
                pred = self.preds[self.pi]
                self.pi += 1
                self._episode(pred)
                continue
            if self._work_until(seg_end):
                continue

        return SimResult(
            makespan=self.t,
            work=self.W,
            n_faults=self.n_faults,
            n_proactive_ckpts=self.n_pro,
            n_regular_ckpts=self.n_reg,
            n_migrations=self.n_mig,
            trace_exhausted=self.exhausted,
            n_disk_recoveries=self.n_disk,
            n_detections=self.n_det,
        )


def simulate(
    work: float,
    platform: Platform,
    strategy: Strategy,
    trace: EventTrace,
    rng: Optional[np.random.Generator] = None,
) -> SimResult:
    rng = rng or np.random.default_rng(0)
    return _Engine(work, platform, strategy, trace, rng).run()


def _traces_for(
    work: float,
    platform: Platform,
    strategy: Strategy,
    pred: PredictorModel,
    n_runs: int,
    rng: np.random.Generator,
    fault_dist: Optional[Distribution],
    false_pred_dist: Optional[Distribution],
    horizon_factor: float,
    n_components: Optional[int],
    stationary: bool,
):
    """The ``n_runs`` host traces of :func:`simulate_many` and BestPeriod:
    one batched draw, without predictions for a mode-"none" strategy."""
    from .events import make_event_traces_batch

    return make_event_traces_batch(
        rng,
        n_runs,
        horizon=horizon_factor * work,
        mtbf=platform.mu,
        recall=pred.recall if strategy.mode != "none" else 0.0,
        precision=pred.precision,
        window=pred.window,
        lead=pred.lead,
        fault_dist=fault_dist or exponential(),
        false_pred_dist=false_pred_dist,
        n_components=n_components,
        stationary=stationary,
    )


def simulate_many(
    work: float,
    platform: Platform,
    strategy: Strategy,
    pred: PredictorModel,
    n_runs: int = 100,
    seed: int = 0,
    fault_dist: Optional[Distribution] = None,
    false_pred_dist: Optional[Distribution] = None,
    horizon_factor: float = 12.0,
    n_components: Optional[int] = None,
    stationary: bool = False,
    engine=UNSET,
    devices=UNSET,
    trace_mode=UNSET,
    config: Optional[EngineConfig] = None,
    device=None,
) -> List[SimResult]:
    """Behaviour over ``n_runs`` random traces (paper: 100 runs).

    The traces are drawn in one batched pass from ``default_rng(seed)``
    (:func:`~repro_torch.core.events.make_event_traces_batch`) and run
    through the engine of ``config`` (:class:`~repro_torch.core.engine.
    EngineConfig`; the loose ``engine=`` / ``devices=`` /
    ``trace_mode=`` keywords are its deprecated spelling).  ``"torch"``
    (the default) advances them as lanes of the device lane machine
    (``collect="lanes"``; on CUDA unless ``device`` names another device,
    ``devices=`` shards the lanes with the same per-run results);
    ``"batch"`` as NumPy lanes on the host; ``"scalar"`` one by one
    through the scalar engine, run ``i`` with the trust coins of
    ``default_rng(seed + 1000 * i + 17)``: the oracle.

    ``trace_mode="device"`` builds a :class:`~repro_torch.core.events.
    TraceSpec` of counter-RNG streams instead, which the torch engine
    samples on the device and the others replay on the host; it needs an
    inverse-CDF law and no ``n_components``.  ``n_components`` draws each
    fault trace as the superposition of that many component renewals."""
    cfg = resolve_engine_config(
        config, "simulate_many",
        engine=engine, devices=devices, trace_mode=trace_mode,
    ).validate()
    engine, devices, trace_mode = cfg.engine, cfg.devices, cfg.trace_mode
    if cfg.collect != "lanes":
        raise ValueError("simulate_many returns per-run results; use "
                         "run_grid for collect='stats'")
    if device is not None and engine != "torch":
        raise ValueError("device= requires engine='torch'")
    rng = np.random.default_rng(seed)
    if trace_mode == "device":
        if n_components:
            raise ValueError(
                "trace_mode='device' does not support superposed component "
                "traces (n_components); use trace_mode='host'"
            )
        from .events import make_trace_spec

        traces = make_trace_spec(
            n_runs,
            horizon=horizon_factor * work,
            mtbf=platform.mu,
            recall=pred.recall if strategy.mode != "none" else 0.0,
            precision=pred.precision,
            window=pred.window,
            lead=pred.lead,
            fault_dist=fault_dist,
            false_pred_dist=false_pred_dist,
            seed=seed,
            # one cell for every run: stream i is run i, as the
            # reference's per-lane spec
            cell_index=np.zeros(n_runs, np.int32),
        )
    else:
        traces = _traces_for(
            work, platform, strategy, pred, n_runs, rng, fault_dist,
            false_pred_dist, horizon_factor, n_components, stationary,
        )
    if engine == "batch":
        from .batch_sim import simulate_batch

        return simulate_batch(work, platform, strategy, traces, rng=rng).to_results()
    if engine == "torch":
        from .torch_sim import simulate_batch_torch

        return simulate_batch_torch(
            work, platform, strategy, traces, rng=rng, device=device,
            devices=devices, chunk=cfg.chunk_lanes, collect="lanes",
        ).to_results()
    if engine == "scalar":
        if trace_mode == "device":
            traces = traces.materialize()
        return [
            simulate(
                work, platform, strategy, traces.lane(i),
                np.random.default_rng(seed + 1000 * i + 17),
            )
            for i in range(n_runs)
        ]
    raise ValueError(
        f"unknown engine {engine!r} (expected 'batch', 'torch' or 'scalar')"
    )


def _best_period_search(
    work: float,
    platform: Platform,
    base: Strategy,
    pred: PredictorModel,
    n_runs: int = 20,
    seed: int = 0,
    fault_dist: Optional[Distribution] = None,
    grid: Sequence[float] = PERIOD_GRID,
    config: Optional[EngineConfig] = None,
    device=None,
    info: Optional[dict] = None,
) -> tuple[float, float]:
    """BestPeriod (Section 5): brute-force the regular period.

    Every period multiplier of ``grid`` runs on the same ``n_runs`` host
    traces (drawn from ``default_rng(seed)``) in one engine call of
    ``len(grid) * n_runs`` lanes.  ``engine="torch"`` makes it one
    cell-multiplexed ``collect="stats"`` dispatch on the device lane
    machine (one cell a period, the lane -> cell index
    ``repeat(arange(periods), n_runs)``; ``devices=`` shards the lanes):
    the mean wastes come back as per-cell sums reduced on the device.
    ``engine="batch"`` runs the same lanes through the NumPy engine; both
    see identical traces, so they agree on the argmin and the waste
    agrees to float rounding.  Without CUDA and without ``device`` the
    torch engine raises (there is no fallback to the batch engine).

    Each candidate is rebuilt from five fields of ``base`` (name, period,
    q, mode, T_P), as the reference rebuilds it: a two-level base loses
    its disk stride ``rho`` and a silent base its verification stride
    ``k_V`` (both become 1).  ``info``, given a dict and the torch
    engine, receives the call's outer iterations, host syncs and chunks.

    Returns ``(best_T_R, best_mean_waste)``."""
    cfg = (config if config is not None else EngineConfig()).validate()
    engine, devices = cfg.engine, cfg.devices
    if engine not in ("batch", "torch"):
        raise ValueError(
            f"unknown engine {engine!r} (expected 'batch' or 'torch')"
        )
    if cfg.trace_mode != "host":
        raise ValueError("best_period_search generates host traces only")
    if device is not None and engine != "torch":
        raise ValueError("device= requires engine='torch'")
    rng = np.random.default_rng(seed)
    traces = _traces_for(
        work, platform, base, pred, n_runs, rng, fault_dist, None, 12.0,
        None, False,
    )
    periods = [max(platform.C * 1.01, base.T_R * m) for m in grid]
    if engine == "torch":
        from .torch_sim import simulate_batch_torch

        strats_c = [
            Strategy(base.name, t_r, base.q, base.mode, base.T_P)
            for t_r in periods
        ]
        cidx = np.repeat(np.arange(len(periods), dtype=np.int32), n_runs)
        sums = simulate_batch_torch(
            [work] * len(periods), [platform] * len(periods), strats_c,
            traces.tile(len(grid)), rng=rng, cell_index=cidx,
            collect="stats", device=device, devices=devices,
            chunk=cfg.chunk_lanes, info=info,
        )
        mean_waste = sums.mean_waste
    else:
        from .batch_sim import simulate_batch

        strats: List[Strategy] = []
        for t_r in periods:
            strats.extend(
                [Strategy(base.name, t_r, base.q, base.mode, base.T_P)]
                * n_runs
            )
        res = simulate_batch(
            work, platform, strats, traces.tile(len(grid)), rng=rng
        )
        mean_waste = res.waste.reshape(len(grid), n_runs).mean(axis=1)
    gi = int(np.argmin(mean_waste))
    return periods[gi], float(mean_waste[gi])


def best_period_search(
    work: float,
    platform: Platform,
    base: Strategy,
    pred: PredictorModel,
    n_runs: int = 20,
    seed: int = 0,
    fault_dist: Optional[Distribution] = None,
    grid: Sequence[float] = PERIOD_GRID,
    engine=UNSET,
    devices=UNSET,
    config: Optional[EngineConfig] = None,
    device=None,
) -> tuple[float, float]:
    """Deprecated spelling of the simulated period search: use
    :func:`repro_torch.core.optimize` with ``method="search"``, or pass
    ``config=EngineConfig(...)`` for the engine knobs."""
    warnings.warn(
        "repro_torch.core.best_period_search() is deprecated; use "
        "repro_torch.core.optimize(..., method='search')",
        DeprecationWarning,
        stacklevel=2,
    )
    cfg = resolve_engine_config(
        config, "best_period_search", engine=engine, devices=devices,
    )
    return _best_period_search(
        work, platform, base, pred, n_runs=n_runs, seed=seed,
        fault_dist=fault_dist, grid=grid, config=cfg, device=device,
    )
