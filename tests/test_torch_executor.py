"""The port's fault-tolerant executor (``repro_torch.ft``: the executor,
its clocks and ledger, elasticity, the predictor) against the reference's
``repro.ft`` on the CPU: every test of ``tests/test_ft_executor.py`` and
``tests/test_elastic.py`` on the port, the ledgers, counts and periods of
both executors under ``SimClock`` on the same traces (rel 1e-12), the
reference's real-training recovery test on the port's model (through the
disk tier and through the memory tier), and the train CLI
(``python -m repro_torch.launch.train``) in a subprocess on the CPU.
"""

import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import events as REV
from repro.core.predictor import SimulatedPredictor as RSimulatedPredictor
from repro.core.waste import Platform as RPlatform
from repro.core.waste import PredictorModel as RPredictorModel
from repro import ft as RFT
from repro_torch import configs
from repro_torch import ft as PFT
from repro_torch.checkpoint import (
    AsyncCheckpointer,
    BuddyMemoryCheckpoint,
    CheckpointStore,
    latest_step,
)
from repro_torch.checkpoint.store import map_with_keys
from repro_torch.core import predictor as PRED
from repro_torch.core.events import EventTrace, FaultEvent, make_event_trace
from repro_torch.core.predictor import SimulatedPredictor
from repro_torch.core.waste import Platform, PredictorModel
from repro_torch.data import SyntheticLMDataset
from repro_torch.ft import (
    ElasticManager,
    FaultInjector,
    FaultTolerantExecutor,
    RetryPolicy,
    SimClock,
    StragglerDetector,
    WallClock,
)
from repro_torch.launch import train as TR
from repro_torch.launch.steps import build_model, build_train_step
from repro_torch.models import RuntimeFlags
from repro_torch.optim import adamw_init

MN = 60.0
ROOT = Path(__file__).resolve().parent.parent


def _sim(pkg: str, strategy="auto", recall=0.85, precision=0.82, seed=0, steps_days=15.0,
         window=300.0, mu_mn=1000):
    """The reference test's ``_sim_executor`` on either package's classes
    (``pkg`` "port" or "ref"); returns (executor, report, trace)."""
    if pkg == "port":
        Plat, PM, mk, Pred, Inj, Ex, Clock = (Platform, PredictorModel, make_event_trace,
                                              SimulatedPredictor, FaultInjector,
                                              FaultTolerantExecutor, SimClock)
    else:
        Plat, PM, mk, Pred, Inj, Ex, Clock = (RPlatform, RPredictorModel, REV.make_event_trace,
                                              RSimulatedPredictor, RFT.FaultInjector,
                                              RFT.FaultTolerantExecutor, RFT.SimClock)
    plat = Plat(mu=mu_mn * MN, C=10 * MN, D=1 * MN, R=10 * MN, M=5 * MN)
    pm = PM(recall, precision, window=window, lead=3600.0)
    trace = mk(np.random.default_rng(seed), horizon=steps_days * 86400 * 4, mtbf=plat.mu,
               recall=recall, precision=precision, window=window, lead=3600.0)
    ex = Ex(step_fn=lambda s, k: s, state=0, platform=plat, pred_model=pm,
            predictor=Pred(trace, pm) if recall > 0 else None, injector=Inj(trace),
            clock=Clock(), step_time=30.0, strategy=strategy)
    return ex, ex.run(int(steps_days * 86400 / 30.0)), trace


def _sim_executor(**kw):
    ex, rep, _ = _sim("port", **kw)
    return ex, rep


# --------------------------------------------------------------------------- #
# The port against the reference under SimClock, on the same traces
# --------------------------------------------------------------------------- #
SIM_CASES = [
    dict(),
    dict(seed=1),
    dict(strategy="young", recall=0.0, seed=1),
    dict(seed=2),
    dict(strategy="young", recall=0.0, seed=3),
    dict(strategy="migration", seed=4),
    dict(strategy="young", recall=0.0, seed=4),
    dict(seed=5, window=0.0),
    dict(strategy="exact", seed=6, steps_days=5.0),
    dict(strategy="nockpt", seed=7, steps_days=5.0),
    dict(strategy="withckpt", seed=8, steps_days=5.0, mu_mn=300),
]


def _case_id(kw) -> str:
    return "-".join(f"{k}{v}" for k, v in kw.items()) or "default"


@pytest.mark.parametrize("kw", SIM_CASES, ids=_case_id)
def test_sim_ledger_counts_and_period_equal_reference(kw):
    ex, rep, trace = _sim("port", **kw)
    rex, rrep, rtrace = _sim("ref", **kw)
    assert [f.time for f in trace.faults] == [f.time for f in rtrace.faults]
    assert [(p.t0, p.fault_time) for p in trace.predictions] == \
           [(p.t0, p.fault_time) for p in rtrace.predictions]
    for name in ("steps_done", "n_faults", "n_restores", "n_proactive", "n_periodic",
                 "n_migrations", "q"):
        assert getattr(rep, name) == getattr(rrep, name), name
    for name in ("period_T", "analytic_waste", "c_estimate"):
        assert getattr(rep, name) == pytest.approx(getattr(rrep, name), rel=1e-12, abs=0), name
    got, want = rep.ledger.as_dict(), rrep.ledger.as_dict()
    assert list(got) == list(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=0), k
    assert (ex.tp_obs, ex.fp_obs, ex.fn_obs) == (rex.tp_obs, rex.fp_obs, rex.fn_obs)
    assert rep.summary() == rrep.summary()


def test_restore_ladder_ledger_equals_reference():
    """A memory tier that fails twice, then the disk tier, with backoff on
    the sim clock: the same ledger and state as the reference's."""
    def run(pkg):
        ns = RFT if pkg == "ref" else PFT
        Plat = RPlatform if pkg == "ref" else Platform
        Trace = REV.EventTrace if pkg == "ref" else EventTrace
        Fault = REV.FaultEvent if pkg == "ref" else FaultEvent
        calls = []

        def memory(step):
            calls.append(("mem", step))
            raise IOError("buddy peer unreachable")

        def disk(step):
            calls.append(("disk", step))
            return f"disk@{step}"

        ex = ns.FaultTolerantExecutor(
            step_fn=lambda s, k: s, state="init", platform=Plat(mu=200.0, C=2.0, D=0.5, R=3.0),
            restore_tiers=[memory, disk],
            restore_retry=ns.RetryPolicy(max_attempts=2, base=0.25, jitter=0.5, seed=3,
                                         sleep=lambda s: None),
            load_state=lambda st, tree, k: tree,
            injector=ns.FaultInjector(Trace(horizon=1e9, faults=[Fault(40.5), Fault(77.2)],
                                            predictions=[])),
            clock=ns.SimClock(), step_time=1.0, strategy="young")
        rep = ex.run(120)
        return ex, rep, calls

    ex, rep, calls = run("port")
    rex, rrep, rcalls = run("ref")
    assert calls == rcalls and ex.state == rex.state
    for k, v in rrep.ledger.as_dict().items():
        assert rep.ledger.as_dict()[k] == pytest.approx(v, rel=1e-12, abs=0), k
    assert [e["tier"] for e in ex.restore_events] == [1, 1]
    assert [e["failed_attempts"] for e in ex.restore_events] == [2, 2]


def test_restore_ladder_keeps_no_restored_state_alive():
    """A restore served after a failed tier must not keep the restored
    state alive once the steps have replaced it: the failed attempt's
    traceback holds the ladder's frame, and the frame held the tree, a
    reference cycle that kept each restored training state (tens of GB on
    a card) until a garbage collection.  Checked with the collector off."""
    import gc
    import weakref

    restored = []

    def memory(step):
        raise KeyError("no replica in memory")

    def disk(step):
        tree = {"w": torch.full((4,), float(step))}
        restored.append(weakref.ref(tree["w"]))
        return tree

    ex = PFT.FaultTolerantExecutor(
        step_fn=lambda s, k: {"w": s["w"] + 1.0}, state={"w": torch.zeros(4)},
        platform=Platform(mu=200.0, C=2.0, D=0.5, R=3.0), restore_tiers=[memory, disk],
        restore_retry=PFT.RetryPolicy(max_attempts=1, sleep=lambda s: None),
        injector=PFT.FaultInjector(EventTrace(horizon=1e9, faults=[FaultEvent(40.5),
                                                                   FaultEvent(77.2)],
                                              predictions=[])),
        clock=PFT.SimClock(), step_time=1.0, strategy="young")
    gc.disable()
    try:
        ex.run(120)
        assert len(restored) == 2
        assert all(w() is None for w in restored), "a restored state outlived its steps"
    finally:
        gc.enable()


# --------------------------------------------------------------------------- #
# tests/test_ft_executor.py on the port
# --------------------------------------------------------------------------- #
class TestSimulatedPolicy:
    def test_waste_below_analytic_bound(self):
        ex, rep = _sim_executor()
        assert rep.ledger.waste() <= rep.analytic_waste * 1.1

    def test_prediction_reduces_waste(self):
        _, rep_pred = _sim_executor(strategy="auto", seed=1)
        _, rep_young = _sim_executor(strategy="young", recall=0.0, seed=1)
        assert rep_pred.ledger.waste() < rep_young.ledger.waste()

    def test_proactive_checkpoints_taken(self):
        _, rep = _sim_executor(seed=2)
        assert rep.n_proactive > 0
        assert rep.q == 1

    def test_young_mode_has_no_proactive(self):
        _, rep = _sim_executor(strategy="young", recall=0.0, seed=3)
        assert rep.n_proactive == 0 and rep.n_migrations == 0

    def test_migration_cancels_predicted_faults(self):
        ex, rep = _sim_executor(strategy="migration", seed=4)
        assert rep.n_migrations > 0
        _, rep_y = _sim_executor(strategy="young", recall=0.0, seed=4)
        assert rep.n_faults < rep_y.n_faults

    def test_period_matches_unified_formula(self):
        ex, rep = _sim_executor(seed=5, window=0.0)
        t_pred = math.sqrt(2 * ex.platform.mu * ex.c_est / (1 - 0.85))
        assert rep.period_T == pytest.approx(t_pred, rel=0.25)
        assert rep.period_T > math.sqrt(2 * ex.platform.mu * ex.c_est) * 1.5


class TestOnlineEstimation:
    def test_zero_evidence_precision_is_zero(self):
        r, p = PRED.estimate_recall_precision(0, 0, 25)
        assert r == 0.0 and p == 0.0
        r, p = PRED.estimate_recall_precision(3, 1, 1)
        assert r == pytest.approx(0.75) and p == pytest.approx(0.75)

    def test_zero_true_faults_recall_is_zero(self):
        assert PRED.estimate_recall_precision(0, 5, 0) == (0.0, 0.0)
        assert PRED.estimate_recall_precision(0, 0, 0) == (0.0, 0.0)

    def _ex(self, seed):
        plat = Platform(mu=1000 * MN, C=10 * MN, D=1 * MN, R=10 * MN)
        pm = PredictorModel(0.85, 0.82, window=300.0, lead=3600.0)
        trace = make_event_trace(np.random.default_rng(seed), horizon=1e6, mtbf=plat.mu,
                                 recall=0.85, precision=0.82, window=300.0, lead=3600.0)
        return FaultTolerantExecutor(step_fn=lambda s, k: s, state=0, platform=plat,
                                     pred_model=pm, predictor=SimulatedPredictor(trace, pm),
                                     clock=SimClock(), strategy="auto"), pm

    def test_reoptimization_gated_on_prediction_evidence(self):
        ex, pm = self._ex(0)
        ex.fn_obs = 25
        obs = ex._observed_model()
        assert obs.precision == pytest.approx(pm.precision)
        assert obs.recall < pm.recall
        ex.tp_obs, ex.fp_obs = 4, 2
        assert ex._observed_model().precision < pm.precision

    def test_recall_gated_symmetrically(self):
        ex, pm = self._ex(1)
        ex.fp_obs = 20
        obs = ex._observed_model()
        assert obs.recall == pytest.approx(pm.recall)
        assert obs.precision < pm.precision


class TestPredictorPresets:
    def test_table3_presets_equal_reference(self):
        from repro.core import predictor as RPRED

        assert list(PRED.TABLE3_PREDICTORS) == list(RPRED.TABLE3_PREDICTORS)
        for name, want in RPRED.TABLE3_PREDICTORS.items():
            got = PRED.predictor_preset(name)
            assert (got.recall, got.precision, got.lead, got.window) == \
                   (want.recall, want.precision, want.lead, want.window), name
        with pytest.raises(KeyError, match="unknown predictor preset"):
            PRED.predictor_preset("nope")

    def test_simulated_predictor_generate_and_poll_equal_reference(self):
        from repro.core import predictor as RPRED

        pm, rpm = PredictorModel(0.7, 0.4, window=600.0), RPredictorModel(0.7, 0.4, window=600.0)
        sp, tr = SimulatedPredictor.generate(pm, mtbf=3000.0, horizon=2e5, seed=9)
        rsp, rtr = RPRED.SimulatedPredictor.generate(rpm, mtbf=3000.0, horizon=2e5, seed=9)
        assert [f.time for f in tr.faults] == [f.time for f in rtr.faults]
        for now in (0.0, 1e4, 5e4, 5e4, 2e5):
            got, want = sp.poll(now), rsp.poll(now)
            assert [(e.t0, e.fault_time) for e in got] == [(e.t0, e.fault_time) for e in want]


def _train_state(model, seed=0):
    params = model.init(torch.Generator().manual_seed(seed))
    return {"params": params, "opt": adamw_init(params)}


class _Both:
    """The memory tier and the disk tier behind one checkpointer."""

    def __init__(self, memory, disk):
        self.memory, self.disk = memory, disk

    def save(self, step, tree):
        return self.memory.save(step, tree) + self.disk.save(step, tree)

    def wait(self):
        self.disk.wait()


class TestRealTrainingRecovery:
    """The port's CPU model + real checkpoints: the loss trajectory after an
    injected fault + restore matches a fault-free run (deterministic resume
    of the data pipeline), through the disk tier and through the memory
    tier."""

    def _run(self, tmp_path, inject: bool, tier: str, n_steps=12):
        cfg = configs.get("smollm-135m").reduced()
        model = build_model(cfg, RuntimeFlags(dense_attn_max=256))
        state = _train_state(model)
        inner = build_train_step(model, lr=1e-3)
        data = SyntheticLMDataset(cfg.vocab_size, 32, 4, seed=5)
        losses = {}

        def step_fn(st, k):
            batch = {kk: torch.from_numpy(v) for kk, v in data.batch(k).items()}
            p, o, m = inner(st["params"], st["opt"], batch)
            losses[k] = float(m["loss"])
            return {"params": p, "opt": o}

        store = CheckpointStore(str(tmp_path / f"{tier}-{inject}"))
        memory = BuddyMemoryCheckpoint(n_nodes=2)
        ckpt = AsyncCheckpointer(store)
        if tier == "memory":
            ckpt = _Both(memory, ckpt)
        injector = None
        if inject:
            injector = FaultInjector(EventTrace(horizon=1e9, faults=[FaultEvent(6.5)],
                                                predictions=[]))
        used = []

        def disk_restore(step_k):
            used.append("disk")
            s = latest_step(store.root)
            if s is None:
                return _train_state(model)
            return store.restore(s, target=state)

        def memory_restore(step_k):
            used.append("memory")
            got = memory.restore(0, lost=True)
            if got is None:
                return _train_state(model)
            return map_with_keys(lambda _, x: x.clone(), got[1])

        plat = Platform(mu=1e9 if not inject else 50.0, C=2.0, D=0.1, R=0.1)
        ex = FaultTolerantExecutor(
            step_fn=step_fn, state=state, platform=plat, checkpointer=ckpt,
            restore_tiers=[disk_restore if tier == "disk" else memory_restore],
            load_state=lambda st, tree, k: tree, injector=injector, clock=SimClock(),
            step_time=1.0, strategy="young")
        rep = ex.run(n_steps)
        return losses, rep, used

    @pytest.mark.parametrize("tier", ["disk", "memory"])
    def test_recovery_replays_identically(self, tmp_path, tier):
        ref_losses, _, _ = self._run(tmp_path, inject=False, tier=tier)
        inj_losses, rep, used = self._run(tmp_path, inject=True, tier=tier)
        assert rep.n_restores >= 1 and used == [tier]
        last = max(ref_losses)
        assert inj_losses[last] == pytest.approx(ref_losses[last], rel=1e-5)


class TestRestoreTiers:
    def _executor(self, tiers, mu=200.0):
        plat = Platform(mu=mu, C=2.0, D=0.5, R=3.0)
        trace = EventTrace(horizon=1e9, faults=[FaultEvent(40.5)], predictions=[])
        return FaultTolerantExecutor(
            step_fn=lambda s, k: s, state="init", platform=plat, restore_tiers=tiers,
            restore_retry=RetryPolicy(max_attempts=2, base=0.25, jitter=0.0,
                                      sleep=lambda s: None),
            load_state=lambda st, tree, k: tree, injector=FaultInjector(trace),
            clock=SimClock(), step_time=1.0, strategy="young")

    def test_memory_tier_down_falls_to_disk(self):
        calls = []

        def memory_tier(step):
            calls.append(("mem", step))
            raise IOError("buddy peer unreachable")

        def disk_tier(step):
            calls.append(("disk", step))
            return f"disk@{step}"

        ex = self._executor([memory_tier, disk_tier])
        rep = ex.run(60)
        assert rep.n_restores == 1 and ex.state.startswith("disk@")
        assert [c[0] for c in calls].count("mem") == 2
        assert rep.ledger.recovery >= 2 * 3.0 + 3.0

    def test_flaky_tier_recovers_via_retry(self):
        attempts = []

        def flaky(step):
            attempts.append(step)
            if len(attempts) == 1:
                raise IOError("transient read failure")
            return f"mem@{step}"

        ex = self._executor([flaky])
        rep = ex.run(60)
        assert ex.state.startswith("mem@") and len(attempts) == 2
        assert rep.ledger.recovery >= 3.0 + 3.0

    def test_fallback_to_older_step_relosts_work(self):
        newest = [None]

        def tier(step):
            if step == newest[0]:
                raise IOError("shard torn")
            return f"ok@{step}"

        ex = self._executor([tier])
        orig = ex._restore_with_fallback

        def spy(step):
            newest[0] = step
            return orig(step)

        ex._restore_with_fallback = spy
        rep = ex.run(60)
        assert rep.n_restores == 1
        assert int(ex.state.split("@")[1]) < newest[0]
        assert rep.ledger.lost_work > 0

    def test_all_tiers_dead_raises_last_error(self):
        def dead(step):
            raise IOError("gone")

        with pytest.raises(IOError, match="gone"):
            self._executor([dead]).run(60)

    def test_fatal_restore_error_skips_tier_immediately(self):
        calls = []

        def broken(step):
            calls.append("broken")
            raise ValueError("shape mismatch")

        def good(step):
            calls.append("good")
            return f"ok@{step}"

        ex = self._executor([broken, good])
        ex.run(60)
        assert calls.count("broken") == 1 and ex.state.startswith("ok@")

    def test_restore_fn_still_works_as_single_tier(self):
        ex = self._executor(None)
        ex.restore_fn = lambda step: f"legacy@{step}"
        ex.restore_tiers = [ex.restore_fn]
        rep = ex.run(60)
        assert rep.n_restores == 1 and ex.state.startswith("legacy@")

    @pytest.mark.parametrize("msg,tries", [
        ("CUDA error: an illegal memory access was encountered", 2),  # sticky: retried
        ("CUDA out of memory. Tried to allocate 2.00 GiB", 2),
        ("kernel launch failed (cudaError 209)", 1),  # neither OOM nor sticky: FATAL
    ])
    def test_card_failures_classified_on_the_ladder(self, msg, tries):
        calls = []

        def card(step):
            calls.append(step)
            raise RuntimeError(msg)

        ex = self._executor([card, lambda step: f"disk@{step}"])
        ex.run(60)
        assert len(calls) == tries and ex.state.startswith("disk@")


class TestElastic:
    def test_spare_pool_swap(self):
        em = ElasticManager(n_nodes=8, n_spares=2)
        ev = em.migrate(node=3, reason="prediction")
        assert not ev["shrunk"] and em.world_size == 8
        em.migrate(node=5)
        ev3 = em.migrate(node=7)
        assert ev3["shrunk"] and em.world_size == 7

    def test_straggler_detector(self):
        det = StragglerDetector(n_ranks=4, window=8, threshold=1.5, patience=2)
        rng = np.random.default_rng(0)
        flagged = []
        for t in range(40):
            for r in range(4):
                dt = 1.0 + rng.normal(0, 0.02)
                if r == 2 and t > 10:
                    dt *= 2.5
                det.record(r, dt)
            flagged = det.check()
        assert flagged == [2]

    def test_no_false_positives_when_uniform(self):
        det = StragglerDetector(n_ranks=4, window=8)
        rng = np.random.default_rng(1)
        for _t in range(40):
            for r in range(4):
                det.record(r, 1.0 + rng.normal(0, 0.05))
        assert det.check() == []


# --------------------------------------------------------------------------- #
# tests/test_elastic.py on the port, and against the reference
# --------------------------------------------------------------------------- #
class TestElasticManager:
    def test_initial_pools(self):
        em = ElasticManager(n_nodes=4, n_spares=2)
        assert em.active == {0, 1, 2, 3} and em.spares == [4, 5]
        assert em.retired == set() and em.world_size == 4

    def test_migrate_explicit_node_spare_accounting(self):
        em = ElasticManager(n_nodes=4, n_spares=2)
        ev = em.migrate(node=1, reason="prediction")
        assert ev["kind"] == "migration" and ev["from"] == 1 and ev["to"] == 4
        assert not ev["shrunk"]
        assert 1 in em.retired and 1 not in em.active
        assert 4 in em.active and em.spares == [5] and em.world_size == 4

    def test_spares_consumed_in_order(self):
        em = ElasticManager(n_nodes=3, n_spares=2)
        assert em.migrate(node=0)["to"] == 3
        assert em.migrate(node=1)["to"] == 4

    def test_migrate_default_picks_an_active_node(self):
        em = ElasticManager(n_nodes=2, n_spares=1)
        ev = em.migrate()
        assert ev["from"] in {0, 1} and ev["from"] in em.retired

    def test_shrink_when_spares_exhausted(self):
        em = ElasticManager(n_nodes=3, n_spares=1)
        em.migrate(node=0)
        ev = em.migrate(node=1)
        assert ev["kind"] == "shrink" and ev["shrunk"] and ev["to"] is None
        assert em.world_size == 2

    def test_lose_node_is_failure_reason(self):
        em = ElasticManager(n_nodes=4, n_spares=1)
        ev = em.lose_node(2)
        assert ev["reason"] == "failure" and ev["from"] == 2
        assert not ev["shrunk"] and em.world_size == 4

    def test_events_log_ordered(self):
        em = ElasticManager(n_nodes=3, n_spares=1, migration_cost=123.0)
        em.migrate(node=0, reason="prediction")
        em.lose_node(1)
        assert [e["kind"] for e in em.events] == ["migration", "shrink"]
        assert [e["reason"] for e in em.events] == ["prediction", "failure"]
        assert all(e["cost"] == 123.0 for e in em.events)

    def test_event_log_equals_reference(self):
        em, rem = ElasticManager(5, 2, 40.0), RFT.ElasticManager(5, 2, 40.0)
        for node in (None, 3, 0, 4, None):
            assert em.migrate(node) == rem.migrate(node)
        assert em.lose_node(1) == rem.lose_node(1)
        assert (em.active, em.spares, em.retired) == (rem.active, rem.spares, rem.retired)


class TestStragglerDetector:
    def _feed(self, det, times_by_rank, rounds):
        for _ in range(rounds):
            for r, t in times_by_rank.items():
                det.record(r, t)

    def test_needs_window_of_evidence(self):
        det = StragglerDetector(n_ranks=2, window=8, patience=1)
        det.record(0, 1.0)
        det.record(1, 9.0)
        assert det.check() == []

    def test_needs_two_ranks_reporting(self):
        det = StragglerDetector(n_ranks=4, window=4, patience=1)
        self._feed(det, {0: 5.0}, rounds=4)
        assert det.check() == []

    def test_patience_gates_flagging(self):
        det = StragglerDetector(n_ranks=3, window=4, threshold=1.5, patience=3)
        self._feed(det, {0: 1.0, 1: 1.0, 2: 4.0}, rounds=4)
        assert det.check() == [] and det.check() == [] and det.check() == [2]

    def test_strikes_reset_when_rank_recovers(self):
        det = StragglerDetector(n_ranks=2, window=4, threshold=1.5, patience=2)
        self._feed(det, {0: 1.0, 1: 4.0}, rounds=4)
        assert det.check() == []
        self._feed(det, {0: 1.0, 1: 1.0}, rounds=4)
        assert det.check() == []
        self._feed(det, {0: 1.0, 1: 4.0}, rounds=4)
        assert det.check() == []
        assert det.check() == [1]

    def test_threshold_is_relative_to_global_median(self):
        det = StragglerDetector(n_ranks=3, window=4, threshold=2.0, patience=1)
        self._feed(det, {0: 1.0, 1: 1.0, 2: 1.8}, rounds=4)
        assert det.check() == []

    def test_multiple_stragglers(self):
        det = StragglerDetector(n_ranks=5, window=4, threshold=1.5, patience=1)
        self._feed(det, {0: 1.0, 1: 1.0, 2: 1.0, 3: 3.0, 4: 5.0}, rounds=4)
        assert sorted(det.check()) == [3, 4]

    def test_noisy_uniform_fleet_stays_clean(self):
        det = StragglerDetector(n_ranks=6, window=8, patience=2)
        rng = np.random.default_rng(3)
        for _ in range(50):
            for r in range(6):
                det.record(r, 1.0 + rng.normal(0.0, 0.05))
            assert det.check() == []

    def test_flags_equal_reference(self):
        det, rdet = StragglerDetector(4, window=6, patience=2), RFT.StragglerDetector(
            4, window=6, patience=2)
        rng = np.random.default_rng(4)
        for t in range(30):
            for r in range(4):
                dt = 1.0 + rng.normal(0, 0.1) + (2.0 if r == 1 and t > 8 else 0.0)
                det.record(r, dt)
                rdet.record(r, dt)
            assert det.check() == rdet.check()


def test_wall_clock_measures_and_sim_clock_advances():
    wc, sc = WallClock(), SimClock(5.0)
    wc.advance(100.0)
    assert 0.0 <= wc.now() < 100.0
    sc.advance(2.5)
    assert sc.now() == 7.5


# --------------------------------------------------------------------------- #
# The train driver and its CLI on the CPU
# --------------------------------------------------------------------------- #
def _cli(*args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_train_cli_on_the_cpu_reports_waste():
    p = _cli("--device", "cpu", "--steps", "10", "--inject-faults", "--predictor",
             "paper-accurate", "--fault-mtbf", "0.3")
    assert p.returncode == 0, p.stderr[-2000:]
    assert "== run report ==" in p.stdout and "on cpu" in p.stdout
    waste = float(p.stdout.split("waste=")[1].split()[0])
    assert 0.0 <= waste < 1.0
    assert "step     0 loss" in p.stdout


def test_train_cli_without_device_and_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the CLI would run on it")
    p = _cli("--steps", "2")
    assert p.returncode != 0
    assert "device='cpu'" in p.stderr


def test_train_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = configs.get("smollm-135m").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.train(cfg, steps=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TR.make_train_state(cfg, build_model(cfg))


def test_int8_disk_restore_keeps_the_second_moments():
    """Under ``--codec int8`` the driver stores AdamW's second moments raw:
    coded, the small entries of a block come back 0 and the next updates
    divide ``m`` by ``eps``.  ``rwkv6-7b.reduced()`` on phase 51's schedule
    (a memory, then a disk restore of step 4): the last of 8 losses within
    2e-3 of the fault-free run's (measured 8.4e-4; 6.1e-3 with the moments
    coded), the steps before the disk restore bit-equal."""
    cfg = configs.get("rwkv6-7b").reduced()
    kw = dict(steps=8, batch=8, seq=64, seed=3, codec="int8", memory_tier=True,
              correlated_every=2, predictor="paper-accurate", sim_step_s=0.32,
              device="cpu", log=lambda s: None)
    clean = TR.train(cfg, inject_faults=False, fault_mtbf=1e9, **kw)
    hit = TR.train(cfg, inject_faults=True, fault_mtbf=2.5, **kw)
    assert [(r["step"], r["tier"]) for r in hit["restores"]] == [(4, "memory"), (4, "disk")]
    assert [hit["losses"][k] for k in range(4)] == [clean["losses"][k] for k in range(4)]
    assert abs(hit["losses"][7] - clean["losses"][7]) <= 2e-3 * abs(clean["losses"][7])


def _chip_smoke():
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _smoke_schedules():
    cs = _chip_smoke()
    out = {"train_path": (cs.TRAIN_STEPS, cs.TRAIN_MTBF, cs.TRAIN_SIM_STEP_S, cs.TRAIN_SEED)}
    for fam, kw in cs.SSM_TRAIN.items():
        out[fam] = (kw["steps"], kw["mtbf"], kw["sim_step_s"], cs.SSM_TRAIN_SEED)
    return out, cs.TRAIN_CORRELATED_EVERY


@pytest.mark.parametrize("run", ["train_path", "rwkv", "jamba"])
def test_sim_clock_fault_schedule_of_the_chip_smoke_runs(tmp_path, run, monkeypatch):
    """``train(sim_step_s=...)``: the faulted runs of ``chip_smoke.py``'s
    phases 39 and 51 (their steps, MTBF, simulated step and seed) save and
    restore at the same steps whatever a step takes on the wall clock, and
    restore once from the memory tier and once from the disk (phase 51:
    after a single save), as the phases require.  The schedule depends on
    the seeded trace and the simulated clock only, so a tiny model on the
    CPU replays the card's."""
    import time as _time

    schedules, corr = _smoke_schedules()
    steps, mtbf, sim_step_s, seed = schedules[run]
    cfg = configs.get("smollm-135m").reduced()

    def once(delay):
        real = TR.build_train_step

        def slow_step(*a, **k):
            inner = real(*a, **k)

            def step(*b):
                _time.sleep(delay)
                return inner(*b)
            return step

        monkeypatch.setattr(TR, "build_train_step", slow_step)
        res = TR.train(cfg, steps=steps, batch=1, seq=8, seed=seed, codec="int8",
                       memory_tier=True, correlated_every=corr, inject_faults=True,
                       fault_mtbf=mtbf, predictor="paper-accurate", strategy="auto",
                       sim_step_s=sim_step_s, device="cpu", log=lambda s: None)
        return ([s["step"] for s in res["saves"]],
                [(r["step"], r["tier"]) for r in res["restores"]], res)

    saves, restores, res = once(0.0)
    again = once(0.01)
    assert (saves, restores) == again[:2]
    rep = res["report"]
    assert rep.n_faults >= 2 and rep.n_restores == rep.n_faults
    tiers = [t for _, t in restores]
    assert "memory" in tiers and "disk" in tiers
    assert res["clock_s"] >= steps * sim_step_s  # simulated seconds, not the wall's
    if run != "train_path":
        assert len(saves) == 1
    assert sorted(res["losses"]) == list(range(steps))
