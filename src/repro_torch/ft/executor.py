"""FaultTolerantExecutor: the paper's checkpointing policy wrapped around a
real (or simulated) training loop.

The executor owns the step loop and decides, between steps:

1. **Periodic checkpointing** at the paper's optimal period
   ``T = sqrt(2 mu C / (1 - r q))`` — recomputed online as the measured
   checkpoint cost ``C`` and the observed predictor quality (r, p) drift;
2. **Proactive actions** on trusted predictions (probability q in {0,1}
   chosen by the closed-form policy): a checkpoint timed to finish at the
   window start (strategies Instant / NoCkptI / WithCkptI), or a
   migration to a spare (Section 3.4, via ElasticManager);
3. **Recovery** from injected faults: downtime D, restore the newest
   durable checkpoint (memory buddy tier first, disk tier as fallback),
   replay the data stream deterministically from the restored step.

Every second of the run is attributed in a :class:`WasteLedger`
(useful / checkpoint / proactive / lost work / downtime / recovery /
migration), so the empirical waste is directly comparable to the paper's
analytic formula — the paper's validation methodology, live on the real
system.

Time is pluggable: ``SimClock`` runs platform-days in milliseconds for
policy tests; ``WallClock`` measures a real training run (on the card, or
on the CPU).

This is the port's copy of the reference's ``ft/executor.py``, on the
port's ``optimize(method="analytic")``, ``periods``, ``waste_exact``,
predictor, ``ft.injection`` and ``ft.retry``: the restore ladder
classifies the card's failures (a sticky CUDA error, an out-of-memory, a
kernel that will not build or launch) through the port's
``classify_failure``.  It also records which tier served each restore
(``restore_events``).

The state is a value: the executor never writes into it, and it hands
``save_state(state)`` to the checkpointer, whose ``save`` must copy what
it keeps before it returns.  The default ``save_state`` is the identity,
so the executor relies on that copy: the port's ``AsyncCheckpointer.save``
snapshots every leaf to host memory before it returns (the drain writes
the copy), and ``BuddyMemoryCheckpoint.save`` copies every leaf to the
CPU.  The train step (``repro_torch.launch.steps.build_train_step``)
returns new tensors, so a state that a restore tier hands back is not
changed by the steps that follow either.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..core import periods as P
from ..core.analytic import optimize
from ..core.predictor import OnlinePredictor, estimate_recall_precision
from ..core.waste import Platform, PredictorModel, waste_exact
from .injection import FaultInjector, SimulatedFault
from .retry import FailureKind, RetryPolicy, classify_failure

__all__ = [
    "SimClock",
    "WallClock",
    "WasteLedger",
    "RunReport",
    "FaultTolerantExecutor",
]

#: minimum observations behind an estimated ratio (TP + FP for the
#: precision estimate, TP + FN for recall) before it may influence
#: re-optimization — below this the prior holds
_MIN_PRED_EVIDENCE = 3


class SimClock:
    def __init__(self, t0: float = 0.0):
        self.t = t0

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


class WallClock:
    def __init__(self):
        self._t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self._t0

    def advance(self, dt: float) -> None:  # wall time advances by itself
        pass


@dataclass
class WasteLedger:
    useful: float = 0.0
    ckpt: float = 0.0
    proactive_ckpt: float = 0.0
    lost_work: float = 0.0
    downtime: float = 0.0
    recovery: float = 0.0
    migration: float = 0.0

    def total(self) -> float:
        return (
            self.useful
            + self.ckpt
            + self.proactive_ckpt
            + self.lost_work
            + self.downtime
            + self.recovery
            + self.migration
        )

    def waste(self) -> float:
        t = self.total()
        return 1.0 - self.useful / t if t > 0 else 0.0

    def as_dict(self) -> Dict[str, float]:
        return {
            "useful": self.useful,
            "ckpt": self.ckpt,
            "proactive_ckpt": self.proactive_ckpt,
            "lost_work": self.lost_work,
            "downtime": self.downtime,
            "recovery": self.recovery,
            "migration": self.migration,
            "waste": self.waste(),
        }


@dataclass
class RunReport:
    steps_done: int
    ledger: WasteLedger
    n_faults: int
    n_restores: int
    n_proactive: int
    n_periodic: int
    n_migrations: int
    period_T: float
    q: int
    analytic_waste: float
    c_estimate: float

    def summary(self) -> str:
        l = self.ledger
        return (
            f"steps={self.steps_done} faults={self.n_faults} "
            f"restores={self.n_restores} periodic_ckpts={self.n_periodic} "
            f"proactive={self.n_proactive} migrations={self.n_migrations} "
            f"T={self.period_T:.0f}s q={self.q} "
            f"waste={l.waste():.4f} (analytic {self.analytic_waste:.4f})"
        )


class FaultTolerantExecutor:
    """See module docstring.

    Parameters
    ----------
    step_fn       (state, step:int) -> state.  Raises SimulatedFault via
                  the injector's check or naturally.
    save_state    state -> pytree to checkpoint (e.g. params+opt+step);
                  the identity by default (the checkpointer copies, see
                  the module docstring)
    load_state    (state, restored_pytree, step) -> state
    platform      Platform (mu, C prior, D, R, M)
    predictor     OnlinePredictor or None
    pred_model    PredictorModel prior (r, p, lead, window)
    checkpointer  object with .save(step, tree) -> C_block seconds and
                  .durable_step / .wait(); or None for simulated cost
    restore_fn    (step:int) -> pytree, used on recovery (None in pure
                  simulation mode)
    restore_tiers ordered restore sources, each (step:int) -> pytree —
                  e.g. [memory_tier, disk_tier].  A failing tier is
                  retried under the shared retry/backoff classifier
                  (:mod:`repro_torch.ft.retry`), then the next tier is tried,
                  then an *older* checkpointed step — every failed
                  attempt is charged to the ledger's recovery bucket
                  (and the re-lost work to lost_work).  Defaults to
                  ``[restore_fn]``.
    restore_retry RetryPolicy for the restore ladder (injectable sleep
                  for tests; sim-clock time is charged instead of
                  sleeping when ``clock`` is a SimClock)
    injector      FaultInjector or None
    clock         SimClock (simulated costs) or WallClock (measured)
    step_time     simulated seconds per step (SimClock mode)
    strategy      "auto" | "young" | "exact" | "nockpt" | "withckpt" |
                  "migration"
    elastic       ElasticManager or None (required for "migration")
    """

    def __init__(
        self,
        *,
        step_fn: Callable[[Any, int], Any],
        state: Any,
        platform: Platform,
        pred_model: Optional[PredictorModel] = None,
        predictor: Optional[OnlinePredictor] = None,
        checkpointer: Any = None,
        save_state: Callable[[Any], Any] = lambda s: s,
        load_state: Callable[[Any, Any, int], Any] = lambda s, t, k: t,
        restore_fn: Optional[Callable[[int], Any]] = None,
        restore_tiers: Optional[List[Callable[[int], Any]]] = None,
        restore_retry: Optional[RetryPolicy] = None,
        injector: Optional[FaultInjector] = None,
        clock: Optional[Any] = None,
        step_time: float = 1.0,
        strategy: str = "auto",
        elastic: Any = None,
        adapt_period: bool = True,
    ):
        self.step_fn = step_fn
        self.state = state
        self.platform = platform
        self.pred_model = pred_model or PredictorModel(0.0, 1.0)
        self.predictor = predictor
        self.checkpointer = checkpointer
        self.save_state = save_state
        self.load_state = load_state
        self.restore_fn = restore_fn
        if restore_tiers is not None:
            self.restore_tiers = list(restore_tiers)
        else:
            self.restore_tiers = [restore_fn] if restore_fn is not None else []
        self.restore_retry = restore_retry or RetryPolicy()
        self.injector = injector
        self.clock = clock or SimClock()
        self.sim = isinstance(self.clock, SimClock)
        self.step_time = step_time
        self.strategy = strategy
        self.elastic = elastic
        self.adapt_period = adapt_period

        self.ledger = WasteLedger()
        self.c_est = platform.C
        self.n_faults = 0
        self.n_restores = 0
        self.n_proactive = 0
        self.n_periodic = 0
        self.n_migrations = 0
        self.tp_obs = 0
        self.fp_obs = 0
        self.fn_obs = 0

        self._last_ckpt_step = 0
        self._ckpt_history: List[int] = [0]  # steps with a restore point
        self._restore_ctr = 0  # deterministic backoff counter
        #: per restore: the fault's ordinal, the step restored, the tier
        #: that served it (its index in ``restore_tiers``) and the failed
        #: attempts before it
        self.restore_events: List[Dict[str, int]] = []
        self._work_since_ckpt = 0.0
        self._pending: List[Any] = []  # trusted predictions not yet acted on
        self._window_until = -math.inf  # NoCkptI: suppress periodic ckpts
        self._policy = self._compute_policy()

    # ------------------------------------------------------------------ #
    # policy
    # ------------------------------------------------------------------ #
    def _observed_model(self) -> PredictorModel:
        if self.tp_obs + self.fp_obs + self.fn_obs >= 20:
            r, p = estimate_recall_precision(self.tp_obs, self.fp_obs, self.fn_obs)
            # blend with prior to avoid early noise — but each ratio only
            # once its own denominator has evidence: a degenerate 0.0
            # estimate (no predictions observed, or no faults observed)
            # must not swing the re-optimized policy off the prior
            if self.tp_obs + self.fn_obs >= _MIN_PRED_EVIDENCE:
                r = 0.5 * r + 0.5 * self.pred_model.recall
            else:
                r = self.pred_model.recall
            if self.tp_obs + self.fp_obs >= _MIN_PRED_EVIDENCE:
                p = 0.5 * p + 0.5 * self.pred_model.precision
            else:
                p = self.pred_model.precision
            return PredictorModel(r, p, self.pred_model.lead, self.pred_model.window)
        return self.pred_model

    def _compute_policy(self) -> P.OptimalPolicy:
        plat = Platform(
            mu=self.platform.mu,
            C=self.c_est,
            D=self.platform.D,
            R=self.platform.R,
            M=self.platform.M,
        )
        pm = self._observed_model()
        if self.strategy == "young" or self.predictor is None:
            # uncapped Young period (the Section 5 practice; matches sims)
            return optimize("young", plat, pm)
        name = "best" if self.strategy == "auto" else self.strategy
        if name in ("best", "exact", "nockpt", "withckpt", "migration"):
            return optimize(name, plat, pm)
        raise ValueError(self.strategy)

    # ------------------------------------------------------------------ #
    # actions
    # ------------------------------------------------------------------ #
    def _do_checkpoint(self, step: int, proactive: bool) -> None:
        t0 = self.clock.now()
        if self.checkpointer is not None:
            c_block = self.checkpointer.save(step, self.save_state(self.state))
            if self.sim:
                self.clock.advance(self.platform.C)
                cost = self.platform.C
            else:
                cost = c_block
            # EWMA of the measured blocking cost feeds the period formula
            if not self.sim:
                self.c_est = 0.7 * self.c_est + 0.3 * max(c_block, 1e-4)
        else:
            self.clock.advance(self.platform.C)
            cost = self.platform.C
        if proactive:
            self.ledger.proactive_ckpt += cost
            self.n_proactive += 1
        else:
            self.ledger.ckpt += cost
            self.n_periodic += 1
        self._last_ckpt_step = step
        if step not in self._ckpt_history:
            self._ckpt_history.append(step)
        self._work_since_ckpt = 0.0
        if self.adapt_period:
            self._policy = self._compute_policy()

    def _do_migration(self, step: int, pred) -> None:
        cost = self.platform.M or self.c_est
        if self.elastic is not None:
            self.elastic.migrate(reason="prediction")
        if self.sim:
            self.clock.advance(cost)
        self.ledger.migration += cost
        self.n_migrations += 1
        if pred.fault_time is not None and self.injector is not None:
            self.injector.cancel(pred.fault_time)

    def _handle_fault(self, step: int, fault: SimulatedFault) -> int:
        self.n_faults += 1
        if fault.predicted:
            self.tp_obs += 1
        else:
            self.fn_obs += 1
        # lost work: everything since the last durable checkpoint
        self.ledger.lost_work += self._work_since_ckpt
        self._work_since_ckpt = 0.0
        if self.sim:
            self.clock.advance(self.platform.D)
        self.ledger.downtime += self.platform.D
        t0 = self.clock.now()
        restored_step = self._last_ckpt_step
        if self.restore_tiers:
            if self.checkpointer is not None and hasattr(
                self.checkpointer, "wait"
            ):
                try:
                    self.checkpointer.wait()
                except Exception:
                    pass
            tree, restored_step = self._restore_with_fallback(restored_step)
            self.state = self.load_state(self.state, tree, restored_step)
        if self.sim:
            self.clock.advance(self.platform.R)
            self.ledger.recovery += self.platform.R
        else:
            self.ledger.recovery += self.clock.now() - t0 + self.platform.D * 0
        self.n_restores += 1
        return restored_step

    def _restore_with_fallback(self, step: int) -> Tuple[Any, int]:
        """Restore ``step`` through the tier ladder, newest-first.

        Per candidate step: every tier in order, each with
        ``restore_retry.max_attempts`` classified/backed-off attempts
        (FATAL skips straight to the next tier).  A failing attempt
        costs a restore — ``platform.R`` on the sim clock, charged to
        the recovery bucket (wall clocks measure it for real).  When a
        candidate step is abandoned entirely, the work between it and
        the next-older restore point is re-lost.  Raises the last error
        if nothing restores."""
        candidates = sorted(
            {s for s in self._ckpt_history if s <= step}, reverse=True
        ) or [step]
        pol = self.restore_retry
        last_err: Optional[Exception] = None
        failed = 0
        for ci, cand in enumerate(candidates):
            if ci:
                # falling back to an older restore point re-loses the
                # work in between (paper: the recovery term grows)
                self.ledger.lost_work += (
                    (candidates[ci - 1] - cand) * self.step_time
                )
            for ti, tier in enumerate(self.restore_tiers):
                for attempt in range(pol.max_attempts):
                    try:
                        tree = tier(cand)
                    except Exception as e:  # classified below
                        last_err = e
                        failed += 1
                        self._restore_ctr += 1
                        # the failed attempt consumed a restore's time
                        if self.sim:
                            self.clock.advance(self.platform.R)
                            self.ledger.recovery += self.platform.R
                        if classify_failure(e) is FailureKind.FATAL:
                            break  # this tier cannot serve this step
                        dt = pol.backoff(attempt, self._restore_ctr)
                        if self.sim:
                            self.clock.advance(dt)
                            self.ledger.recovery += dt
                        else:
                            pol.sleep(dt)
                        continue
                    self.restore_events.append({"fault": self.n_faults, "step": cand,
                                                "tier": ti, "failed_attempts": failed})
                    # a failed attempt's traceback holds this frame, and the
                    # frame the tree: drop the error, or the cycle keeps the
                    # restored state (tens of GB on a card) alive until a
                    # garbage collection
                    last_err = None
                    return tree, cand
        if last_err is not None:
            raise last_err
        raise IOError(f"no restore tier could serve step {step}")

    # ------------------------------------------------------------------ #
    # main loop
    # ------------------------------------------------------------------ #
    def run(self, n_steps: int, start_step: int = 0) -> RunReport:
        step = start_step
        q = self._policy.q
        while step < n_steps:
            now = self.clock.now()

            # 1) ingest predictions
            if self.predictor is not None and q:
                for ev in self.predictor.poll(now):
                    self._pending.append(ev)

            # 2) proactive actions due?  act when now >= t0 - C (as late as
            #    possible, paper Figure 1(a))
            acted = False
            still = []
            for ev in self._pending:
                act_at = ev.t0 - (
                    self.platform.M
                    if self.strategy == "migration"
                    else self.c_est
                )
                if now >= act_at:
                    if ev.t0 + ev.window < now:
                        # stale (e.g. we were in recovery): drop; count FP if
                        # it never materialized
                        if ev.fault_time is None:
                            self.fp_obs += 1
                        continue
                    if self.strategy == "migration":
                        self._do_migration(step, ev)
                    else:
                        self._do_checkpoint(step, proactive=True)
                        if self._policy.strategy in ("nockpt", "withckpt"):
                            self._window_until = ev.t0 + ev.window
                    if ev.fault_time is None:
                        self.fp_obs += 1
                    acted = True
                else:
                    still.append(ev)
            self._pending = still

            # 3) periodic checkpoint due? (suppressed inside a NoCkptI window)
            work_target = max(self._policy.T_R - self.c_est, self.step_time)
            in_window = now < self._window_until
            t_p = self._policy.T_P
            if in_window and self._policy.strategy == "withckpt" and t_p:
                if self._work_since_ckpt >= max(t_p - self.c_est, self.step_time):
                    self._do_checkpoint(step, proactive=True)
            elif not in_window and self._work_since_ckpt >= work_target:
                self._do_checkpoint(step, proactive=False)

            # 4) one training step
            t0 = self.clock.now()
            try:
                if self.injector is not None:
                    self.injector.check(t0)
                self.state = self.step_fn(self.state, step)
                if self.sim:
                    self.clock.advance(self.step_time)
                    dt = self.step_time
                else:
                    dt = self.clock.now() - t0
                self.ledger.useful += dt
                self._work_since_ckpt += dt
                step += 1
            except SimulatedFault as f:
                if self.sim and f.time > t0:
                    # part of the step ran before the fault
                    ran = min(self.step_time, max(f.time - t0, 0.0))
                    self.clock.advance(ran)
                    self.ledger.lost_work += ran
                step = self._handle_fault(step, f)

        if self.checkpointer is not None and hasattr(self.checkpointer, "wait"):
            self.checkpointer.wait()

        pm = self._observed_model()
        analytic = waste_exact(
            self._policy.T_R,
            q,
            self.c_est,
            self.platform.D,
            self.platform.R,
            self.platform.mu,
            pm.recall,
            pm.precision,
        )
        return RunReport(
            steps_done=step,
            ledger=self.ledger,
            n_faults=self.n_faults,
            n_restores=self.n_restores,
            n_proactive=self.n_proactive,
            n_periodic=self.n_periodic,
            n_migrations=self.n_migrations,
            period_T=self._policy.T_R,
            q=q,
            analytic_waste=float(analytic),
            c_estimate=self.c_est,
        )
