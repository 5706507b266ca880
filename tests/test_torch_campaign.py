"""The port's resumable campaign runner (``repro_torch.ft.campaign`` and
its CLI ``repro_torch.experiments.campaign``) on the CPU, against the
reference's ``repro.ft.run_campaign``.

* Equivalence: on the reference tests' ``small_grid()`` (4 validation
  cells, 30 runs, seed 7, chunk 25) and ``scenario_grid()`` (two-level +
  silent cells), in both trace modes, the campaign's per-cell sums are
  the reference campaign's (the integer columns exact, the moments rtol
  1e-9), and with ``collect="lanes"`` its per-lane results (integers
  exact, waste rtol 1e-9).
* Chaos: under the same ``ChaosInjector`` schedules (``oom_at``,
  ``device_loss_at``, ``jax_fail_at`` read as ``torch_fail_at``, the
  fuzz seeds 1000-1001) the event sequences are the reference's (kinds,
  chunks, attempts, chunk widths; "jax" read as "torch").
* Snapshots: after chunk k the durable ``sums`` / ``cursor`` leaves are
  the reference's.
* Every test of the reference's ``tests/test_campaign.py``, on the port
  with ``device="cpu"`` (``--device cpu`` for the SIGKILL CLI test), with
  the reference's assertions.
* The card's failures: a ``KernelBuildError``, or a wrapper's launch
  failure that is neither out of memory nor sticky, propagates through
  ``run_campaign`` instead of degrading, a sticky CUDA error retries then
  degrades, a wrapper's ``(cudaError 2)`` halves the chunk; the entry
  points raise without CUDA unless given the CPU.

Every call into ``repro`` sits inside ``jax.enable_x64(True)``; snapshots
are synchronous wherever events are compared (an asynchronous drain races
the in-process kill).
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import repro.ft as RF
from repro.checkpoint.store import CheckpointStore as RCheckpointStore
from repro.core.engine import EngineConfig as REngineConfig
from repro.experiments.grid import GridSpec as RGridSpec
from repro.experiments.paper_grid import paper_grid_cells as ref_paper
from repro.experiments.paper_grid import silent_grid_cells as ref_silent
from repro.experiments.paper_grid import two_level_grid_cells as ref_two_level
from repro_torch.checkpoint.store import CheckpointStore
from repro_torch.core import optimize
from repro_torch.core.engine import EngineConfig
from repro_torch.core.torch_sim import CellSums, default_chunk_lanes
from repro_torch.core.waste import Platform
from repro_torch.experiments import run_grid
from repro_torch.experiments.grid import GridSpec
from repro_torch.experiments.paper_grid import (
    paper_grid_cells,
    silent_grid_cells,
    two_level_grid_cells,
)
from repro_torch.ft import (
    CampaignConfig,
    CampaignKilled,
    CampaignRunner,
    ChaosInjector,
    RetryPolicy,
    run_campaign,
)
from repro_torch.ft import campaign as campaign_mod
from repro_torch.kernels.build import KernelBuildError, KernelLaunchError

#: chaos-fuzz budget, as the reference's test
N_FUZZ = int(os.environ.get("REPRO_CHAOS_EXAMPLES", "2"))

CHUNK = 25
CPU = "cpu"
MOMENTS = (1, 2, 3, 4)  # makespan, makespan^2, waste, waste^2 sums
INTS = (0, 5, 6, 7, 8, 9, 10, 11)  # n, counters, exhaustion, disk, detections
RTOL = 1e-9


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def small_grid(n_runs=30, seed=7, n_cells=4):
    cells = paper_grid_cells("validation")[:n_cells]
    return GridSpec(cells=tuple(cells), n_runs=n_runs, seed=seed)


def ref_small_grid(n_runs=30, seed=7, n_cells=4):
    cells = ref_paper("validation")[:n_cells]
    return RGridSpec(cells=tuple(cells), n_runs=n_runs, seed=seed)


def scenario_grid(n_runs=30, seed=13):
    """A small mixed scenario grid: two-level (untrusted) + silent cells,
    exercising the DISK/DET statistics columns through the campaign."""
    cells = tuple(two_level_grid_cells("validation")[:2]) + tuple(
        silent_grid_cells("validation")[:2]
    )
    return GridSpec(cells=cells, n_runs=n_runs, seed=seed)


def ref_scenario_grid(n_runs=30, seed=13):
    cells = tuple(ref_two_level("validation")[:2]) + tuple(ref_silent("validation")[:2])
    return RGridSpec(cells=cells, n_runs=n_runs, seed=seed)


GRIDS = {"small": (small_grid, ref_small_grid), "scenario": (scenario_grid, ref_scenario_grid)}


def cfg(trace_mode="device", collect="stats", chunk=CHUNK, **kw):
    return EngineConfig(
        engine="torch", trace_mode=trace_mode, collect=collect,
        chunk_lanes=chunk, **kw,
    )


def ref_cfg(trace_mode="device", collect="stats", chunk=CHUNK):
    return REngineConfig(
        engine="jax", trace_mode=trace_mode, collect=collect, chunk_lanes=chunk,
    )


def nosleep():
    return RetryPolicy(sleep=lambda s: None)


def key_vec(res):
    return np.stack(
        [
            [c.mean_waste for c in res.cells],
            [c.mean_makespan for c in res.cells],
            [c.mean_faults for c in res.cells],
            [c.mean_regular_ckpts for c in res.cells],
        ]
    )


def sums_agree(got: np.ndarray, want: np.ndarray) -> None:
    """The 12 CellSums columns: counts exact, moments within RTOL."""
    assert got.shape == want.shape == (got.shape[0], 12)
    np.testing.assert_array_equal(got[:, INTS], want[:, INTS])
    np.testing.assert_allclose(got[:, MOMENTS], want[:, MOMENTS], rtol=RTOL)


def events_of(res_or_list):
    """Comparable events: the error text dropped, "jax" read as "torch"."""
    ev = (res_or_list.meta["campaign"]["events"] if hasattr(res_or_list, "meta")
          else res_or_list)
    out = []
    for e in ev:
        e = {k: v for k, v in e.items() if k != "error"}
        out.append({k: ("torch" if v == "jax" else v) for k, v in e.items()})
    return out


def port_runner(grid, d, c, **camp):
    return CampaignRunner(grid, CampaignConfig(ckpt_dir=str(d), **camp), c, device=CPU)


def ref_runner(grid, d, c, **camp):
    return RF.CampaignRunner(grid, RF.CampaignConfig(ckpt_dir=str(d), **camp), c)


@pytest.fixture(scope="module")
def grid():
    return small_grid()


@pytest.fixture(scope="module")
def ref_device(grid):
    return run_grid(grid, cfg("device"), device=CPU)


# --------------------------------------------------------------------------- #
# The port against the reference
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("which", sorted(GRIDS))
@pytest.mark.parametrize("trace_mode", ["device", "host"])
def test_sums_match_reference(tmp_path, which, trace_mode):
    make, ref_make = GRIDS[which]
    port = port_runner(make(), tmp_path / "p", cfg(trace_mode), ckpt_period=0.0,
                       async_snapshots=False)
    ref = ref_runner(ref_make(), tmp_path / "r", ref_cfg(trace_mode), ckpt_period=0.0,
                     async_snapshots=False)
    a, b = port.run(), ref.run()
    sums_agree(port._sums, ref._sums)
    assert port._sums[:, 0].sum() == make().n_lanes
    pa, pb = a.meta["campaign"], b.meta["campaign"]
    for k in ("incarnation", "n_snapshots", "chunk_lanes_final", "n_devices_final",
              "engine_degraded"):
        assert pa[k] == pb[k], k
    assert a.engine == "torch" and b.engine == "jax"


@pytest.mark.parametrize("which", sorted(GRIDS))
@pytest.mark.parametrize("trace_mode", ["device", "host"])
def test_lanes_match_reference(tmp_path, which, trace_mode):
    make, ref_make = GRIDS[which]
    a = run_campaign(make(), CampaignConfig(ckpt_dir=str(tmp_path / "p"), ckpt_period=0.0),
                     cfg(trace_mode, "lanes"), device=CPU)
    b = RF.run_campaign(ref_make(), RF.CampaignConfig(ckpt_dir=str(tmp_path / "r"),
                                                      ckpt_period=0.0),
                        ref_cfg(trace_mode, "lanes"))
    for pc, rc in zip(a.cells, b.cells):
        assert pc.cell.label == rc.cell.label
        for k in ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations"):
            np.testing.assert_array_equal(getattr(pc, k), getattr(rc, k))
        assert pc.n_exhausted == rc.n_exhausted
        np.testing.assert_allclose(pc.waste, rc.waste, rtol=RTOL)
        np.testing.assert_allclose(pc.makespan, rc.makespan, rtol=RTOL)


@pytest.mark.parametrize("trace_mode", ["device", "host"])
@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_snapshot_leaves_match_reference(tmp_path, trace_mode, k):
    """Killed at chunk k (sync snapshots), each store's newest snapshot
    holds the reference's ``sums`` and ``cursor`` after chunk k-1."""
    p, r = tmp_path / "p", tmp_path / "r"
    with pytest.raises(CampaignKilled):
        port_runner(small_grid(), p, cfg(trace_mode), ckpt_period=0.0,
                    async_snapshots=False, chaos=ChaosInjector(kill_at=(k,))).run()
    with pytest.raises(RF.CampaignKilled):
        ref_runner(ref_small_grid(), r, ref_cfg(trace_mode), ckpt_period=0.0,
                   async_snapshots=False, chaos=RF.ChaosInjector(kill_at=(k,))).run()
    step, got = CheckpointStore(str(p)).restore_latest(device=CPU)
    rstep, want = RCheckpointStore(str(r), codec="raw").restore_latest()
    assert step == rstep == k * CHUNK
    np.testing.assert_array_equal(got["cursor"].numpy(), np.asarray(want["cursor"]))
    assert got["cursor"].numpy().tolist() == [k * CHUNK, CHUNK, k, 0, 0]
    sums_agree(got["sums"].numpy(), np.asarray(want["sums"]))


CHAOS = {
    "oom_at": (dict(oom_at=(1,)), dict(oom_at=(1,))),
    "device_loss_at": (dict(device_loss_at=(2,)), dict(device_loss_at=(2,))),
    "engine_fail_at": (dict(torch_fail_at=1), dict(jax_fail_at=1)),
    "engine_fail_first_attempts": (dict(torch_fail_at=2, torch_fail_persistent=False),
                                   dict(jax_fail_at=2, jax_fail_persistent=False)),
    "oom_then_kill": (dict(oom_at=(0,), kill_at=(3,)), dict(oom_at=(0,), kill_at=(3,))),
}


@pytest.mark.parametrize("name", sorted(CHAOS))
def test_chaos_events_match_reference(tmp_path, name):
    kw, ref_kw = CHAOS[name]
    port_ev, ref_ev = [], []
    for side, run, killed, chaos in (
        ("p", lambda d, ch: port_runner(small_grid(), d, cfg("host"), ckpt_period=0.0,
                                        async_snapshots=False, retry=nosleep(),
                                        chaos=ch).run(),
         CampaignKilled, ChaosInjector(**kw)),
        ("r", lambda d, ch: ref_runner(ref_small_grid(), d, ref_cfg("host"),
                                       ckpt_period=0.0, async_snapshots=False,
                                       retry=RF.RetryPolicy(sleep=lambda s: None),
                                       chaos=ch).run(),
         RF.CampaignKilled, RF.ChaosInjector(**ref_kw)),
    ):
        for _ in range(3):
            try:
                res = run(tmp_path / side, chaos)
                break
            except killed:
                continue
        (port_ev if side == "p" else ref_ev).append(res)
    a, b = port_ev[0], ref_ev[0]
    assert events_of(a) == events_of(b)
    assert events_of(a), "the schedule fired nothing"
    np.testing.assert_allclose(key_vec(a), key_vec(b), rtol=RTOL)


@pytest.mark.parametrize("fuzz_seed", [1000, 1001])
def test_chaos_fuzz_events_match_reference(tmp_path, fuzz_seed):
    """The reference's fuzz storm (kills, OOMs, device losses under a fire
    budget) across incarnations: the same events, the same result."""
    results = {}
    for side in ("p", "r"):
        if side == "p":
            chaos = ChaosInjector(seed=fuzz_seed, p_kill=0.25, p_oom=0.2,
                                  p_device_loss=0.15, max_fires=5)
            killed = CampaignKilled
            make = lambda: port_runner(small_grid(), tmp_path / side, cfg("device"),  # noqa: E731
                                       ckpt_period=0.0, async_snapshots=False,
                                       retry=nosleep(), chaos=chaos)
        else:
            chaos = RF.ChaosInjector(seed=fuzz_seed, p_kill=0.25, p_oom=0.2,
                                     p_device_loss=0.15, max_fires=5)
            killed = RF.CampaignKilled
            make = lambda: ref_runner(ref_small_grid(), tmp_path / side,  # noqa: E731
                                      ref_cfg("device"), ckpt_period=0.0,
                                      async_snapshots=False,
                                      retry=RF.RetryPolicy(sleep=lambda s: None),
                                      chaos=chaos)
        res = None
        for _ in range(chaos.max_fires + 2):
            try:
                res = make().run()
                break
            except killed:
                continue
        assert res is not None
        results[side] = (res, chaos.n_fires)
    assert results["p"][1] == results["r"][1]
    results = {k: v[0] for k, v in results.items()}
    assert events_of(results["p"]) == events_of(results["r"])
    np.testing.assert_allclose(key_vec(results["p"]), key_vec(results["r"]), rtol=RTOL)


# --------------------------------------------------------------------------- #
# The reference's tests/test_campaign.py, on the port
# --------------------------------------------------------------------------- #
class TestCampaignEquivalence:
    def test_matches_run_grid_device(self, tmp_path, grid, ref_device):
        res = run_campaign(
            grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0),
            cfg("device"), device=CPU,
        )
        np.testing.assert_array_equal(key_vec(ref_device), key_vec(res))
        camp = res.meta["campaign"]
        assert camp["n_snapshots"] >= grid.n_lanes // CHUNK
        assert not camp["engine_degraded"]

    def test_lanes_collect_matches_run_grid(self, tmp_path, grid):
        ref = run_grid(grid, cfg("device", collect="lanes"), device=CPU)
        res = run_campaign(
            grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0),
            cfg("device", collect="lanes"), device=CPU,
        )
        for rc, cc in zip(ref.cells, res.cells):
            np.testing.assert_array_equal(rc.waste, cc.waste)
            np.testing.assert_array_equal(rc.makespan, cc.makespan)

    def test_period_none_uses_optimize(self, tmp_path, grid):
        mtbf = 1800.0
        res = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path), mtbf=mtbf, restore_cost=2.0),
            cfg("device"), device=CPU,
        )
        camp = res.meta["campaign"]
        want = optimize(
            "young",
            Platform(mu=mtbf, C=max(camp["snapshot_cost_est_s"], 1e-4), D=0.0, R=2.0),
        ).T_R
        assert camp["snapshot_period_s"] == pytest.approx(want)
        assert camp["snapshot_period_s"] > 0


class TestKillResume:
    @pytest.mark.parametrize("trace_mode", ["device", "host"])
    def test_kill_at_every_boundary_is_bit_exact(self, tmp_path, grid, trace_mode):
        c = cfg(trace_mode)
        base = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path / "base"), ckpt_period=0.0,
                           async_snapshots=False),
            c, device=CPU,
        )
        n_chunks = -(-grid.n_lanes // CHUNK)
        for k in range(n_chunks):
            d = str(tmp_path / f"{trace_mode}_{k}")
            camp = CampaignConfig(
                ckpt_dir=d, ckpt_period=0.0, async_snapshots=False,
                chaos=ChaosInjector(kill_at=(k,)),
            )
            with pytest.raises(CampaignKilled):
                run_campaign(grid, camp, c, device=CPU)
            res = run_campaign(
                grid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0, async_snapshots=False),
                c, device=CPU,
            )
            np.testing.assert_array_equal(key_vec(base), key_vec(res))
            if k > 0:  # every prior boundary was durable before the kill
                ev = res.meta["campaign"]["events"]
                assert any(e["kind"] == "resume" for e in ev)

    def test_kill_resume_lanes_collect(self, tmp_path, grid):
        c = cfg("device", collect="lanes")
        base = run_campaign(
            grid, CampaignConfig(ckpt_dir=str(tmp_path / "b"), ckpt_period=0.0),
            c, device=CPU,
        )
        d = str(tmp_path / "k")
        with pytest.raises(CampaignKilled):
            run_campaign(
                grid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0,
                               chaos=ChaosInjector(kill_at=(3,))),
                c, device=CPU,
            )
        res = run_campaign(grid, CampaignConfig(ckpt_dir=d, ckpt_period=0.0), c,
                           device=CPU)
        for bc, cc in zip(base.cells, res.cells):
            np.testing.assert_array_equal(bc.waste, cc.waste)

    def test_fingerprint_mismatch_refuses_resume(self, tmp_path, grid):
        d = str(tmp_path)
        with pytest.raises(CampaignKilled):
            run_campaign(
                grid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0,
                               chaos=ChaosInjector(kill_at=(2,))),
                cfg("device"), device=CPU,
            )
        other = small_grid(seed=8)
        with pytest.raises(ValueError, match="fingerprint"):
            run_campaign(
                other, CampaignConfig(ckpt_dir=d, ckpt_period=0.0),
                cfg("device"), resume=True, device=CPU,
            )

    def test_resume_true_requires_snapshot(self, tmp_path, grid):
        with pytest.raises(FileNotFoundError):
            run_campaign(
                grid, CampaignConfig(ckpt_dir=str(tmp_path)),
                cfg("device"), resume=True, device=CPU,
            )

    def test_sigkill_subprocess_resume(self, tmp_path):
        """The real thing: the CLI process dies on SIGKILL mid-campaign
        (no atexit, no flush) and a fresh process resumes bit-exactly."""
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(os.path.dirname(__file__), "..", "src"),
             env.get("PYTHONPATH", "")]
        )
        common = [
            sys.executable, "-m", "repro_torch.experiments.campaign",
            "--preset", "validation", "--limit-cells", "3",
            "--n-runs", "20", "--seed", "5",
            "--chunk-lanes", str(CHUNK), "--ckpt-period", "0", "--device", "cpu",
        ]
        ref = str(tmp_path / "ref.json")
        subprocess.run(
            common + ["--ckpt-dir", str(tmp_path / "r"), "--out", ref],
            env=env, check=True, timeout=300,
        )
        proc = subprocess.run(
            common + [
                "--ckpt-dir", str(tmp_path / "k"),
                "--chaos-kill-at", "2", "--chaos-kill-mode", "sigkill",
            ],
            env=env, timeout=300,
        )
        assert proc.returncode in (-9, 137)
        out = str(tmp_path / "resumed.json")
        subprocess.run(
            [sys.executable, "-m", "repro_torch.experiments.campaign",
             "--resume", str(tmp_path / "k"), "--out", out, "--device", "cpu"],
            env=env, check=True, timeout=300,
        )
        with open(ref) as f:
            a = json.load(f)
        with open(out) as f:
            b = json.load(f)
        keys = ("label", "mean_waste", "mean_makespan", "mean_faults")
        assert [[c[k] for k in keys] for c in a["cells"]] == (
            [[c[k] for k in keys] for c in b["cells"]]
        )
        assert b["meta"]["campaign"]["incarnation"] >= 1


class TestScenarioCampaign:
    """Kill/resume + snapshot-matrix coverage of the two scenario families
    (two-level checkpointing, silent errors)."""

    @pytest.fixture(scope="class")
    def sgrid(self):
        return scenario_grid()

    @pytest.mark.parametrize("trace_mode", ["device", "host"])
    def test_kill_resume_scenario_bit_exact(self, tmp_path, sgrid, trace_mode):
        c = cfg(trace_mode)
        ref = run_grid(sgrid, c, device=CPU)
        base = run_campaign(
            sgrid,
            CampaignConfig(ckpt_dir=str(tmp_path / "base"), ckpt_period=0.0,
                           async_snapshots=False),
            c, device=CPU,
        )
        np.testing.assert_array_equal(key_vec(ref), key_vec(base))
        for k in (1, 3):
            d = str(tmp_path / f"{trace_mode}_{k}")
            with pytest.raises(CampaignKilled):
                run_campaign(
                    sgrid,
                    CampaignConfig(ckpt_dir=d, ckpt_period=0.0, async_snapshots=False,
                                   chaos=ChaosInjector(kill_at=(k,))),
                    c, device=CPU,
                )
            res = run_campaign(
                sgrid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0, async_snapshots=False),
                c, device=CPU,
            )
            np.testing.assert_array_equal(key_vec(base), key_vec(res))
            ev = res.meta["campaign"]["events"]
            assert any(e["kind"] == "resume" for e in ev)

    def test_snapshot_matrix_carries_scenario_columns(self, tmp_path, sgrid):
        """The campaign accumulator is the full 12-column CellSums matrix:
        disk-tier recoveries on the two-level cells, silent detections on
        the silent cells, zero cross-talk."""
        runner = CampaignRunner(
            sgrid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0),
            cfg("device"), device=CPU,
        )
        runner.run()
        assert runner._sums.shape == (len(sgrid.cells), 12)
        sums = CellSums.from_matrix(runner._sums)
        disk = np.asarray(sums.n_disk_recoveries)
        det = np.asarray(sums.n_detections)
        assert (disk[:2] > 0).all()  # two-level cells hit the disk tier
        assert (det[2:] > 0).all()  # silent cells detect corruptions
        assert (disk[2:] == 0).all() and (det[:2] == 0).all()
        np.testing.assert_array_equal(sums.as_matrix(), runner._sums)

    def test_pre_scenario_snapshot_shape_refused(self, tmp_path, sgrid):
        """A snapshot written before the DISK/DET columns existed (10-col
        accumulator) must be refused, not silently mis-summed."""
        d = str(tmp_path)
        with pytest.raises(CampaignKilled):
            run_campaign(
                sgrid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0, async_snapshots=False,
                               chaos=ChaosInjector(kill_at=(2,))),
                cfg("device"), device=CPU,
            )
        store = CheckpointStore(d, codec="raw")
        step, tree = store.restore_latest(device=CPU)
        tree["sums"] = tree["sums"][:, :10]
        store.save(step + 1, tree)
        with pytest.raises(ValueError, match="refusing to resume"):
            run_campaign(
                sgrid, CampaignConfig(ckpt_dir=d, ckpt_period=0.0),
                cfg("device"), resume=True, device=CPU,
            )


class TestChaosRecovery:
    def test_oom_halves_chunk_and_completes(self, tmp_path, grid, ref_device):
        res = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0, retry=nosleep(),
                           chaos=ChaosInjector(oom_at=(1,))),
            cfg("device"), device=CPU,
        )
        camp = res.meta["campaign"]
        kinds = [e["kind"] for e in camp["events"]]
        assert "oom" in kinds and "chunk_halved" in kinds
        assert camp["chunk_lanes_final"] == CHUNK // 2
        # partition changed -> f64 summation order changed: allclose
        np.testing.assert_allclose(key_vec(ref_device), key_vec(res), rtol=1e-9)

    @pytest.mark.parametrize("devices", [None, ["cpu", "cpu"]], ids=["one", "two"])
    def test_device_loss_completes_bit_exact(self, tmp_path, grid, ref_device, devices):
        res = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0, retry=nosleep(),
                           chaos=ChaosInjector(device_loss_at=(2,))),
            cfg("device", devices=devices), device=None if devices else CPU,
        )
        camp = res.meta["campaign"]
        kinds = [e["kind"] for e in camp["events"]]
        assert "device_loss" in kinds
        if devices:
            # two shards: the dispatch shrank and the result is still
            # bit-exact (device-count invariance)
            assert "devices_shrunk" in kinds
            assert camp["n_devices_final"] < len(devices)
        np.testing.assert_array_equal(key_vec(ref_device), key_vec(res))

    def test_persistent_torch_failure_degrades_to_batch(self, tmp_path, grid, ref_device):
        res = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0, retry=nosleep(),
                           chaos=ChaosInjector(torch_fail_at=1)),
            cfg("device"), device=CPU,
        )
        camp = res.meta["campaign"]
        assert camp["engine_degraded"]
        assert res.engine == "batch"
        kinds = [e["kind"] for e in camp["events"]]
        assert "engine_degraded" in kinds
        assert kinds.count("transient") >= 2  # retried before degrading
        # host replay of the same counter streams: statistically equal
        np.testing.assert_allclose(key_vec(ref_device)[0], key_vec(res)[0], rtol=0.35)

    def test_degraded_state_survives_kill(self, tmp_path, grid):
        """Degradation is durable: a campaign killed *after* degrading
        resumes on the batch engine, bit-identical to an uninterrupted
        degraded run."""
        c = cfg("device")
        base = run_campaign(
            grid,
            CampaignConfig(ckpt_dir=str(tmp_path / "b"), ckpt_period=0.0, retry=nosleep(),
                           chaos=ChaosInjector(torch_fail_at=0)),
            c, device=CPU,
        )
        assert base.meta["campaign"]["engine_degraded"]
        d = str(tmp_path / "k")
        with pytest.raises(CampaignKilled):
            run_campaign(
                grid,
                CampaignConfig(ckpt_dir=d, ckpt_period=0.0, retry=nosleep(),
                               chaos=ChaosInjector(torch_fail_at=0, kill_at=(3,))),
                c, device=CPU,
            )
        res = run_campaign(grid, CampaignConfig(ckpt_dir=d, ckpt_period=0.0), c,
                           device=CPU)
        assert res.meta["campaign"]["engine_degraded"]
        np.testing.assert_array_equal(key_vec(base), key_vec(res))

    @pytest.mark.parametrize("fuzz_seed", range(N_FUZZ))
    def test_chaos_fuzz_converges(self, tmp_path, grid, ref_device, fuzz_seed):
        """Probabilistic kill/OOM/device-loss storms (bounded fire budget):
        the campaign always completes across incarnations and the result
        stays equal to the plain sweep (bit-exact unless an OOM changed
        the chunk partition)."""
        chaos = ChaosInjector(
            seed=1000 + fuzz_seed, p_kill=0.25, p_oom=0.2,
            p_device_loss=0.15, max_fires=5,
        )
        camp = CampaignConfig(
            ckpt_dir=str(tmp_path), ckpt_period=0.0, retry=nosleep(), chaos=chaos,
        )
        res = None
        for _ in range(chaos.max_fires + 2):
            try:
                res = CampaignRunner(grid, camp, cfg("device"), device=CPU).run()
                break
            except CampaignKilled:
                continue
        assert res is not None, "campaign never completed under chaos"
        np.testing.assert_allclose(key_vec(ref_device), key_vec(res), rtol=1e-9)


# --------------------------------------------------------------------------- #
# The card's failures, classified inside the campaign
# --------------------------------------------------------------------------- #
def _failing(exc, times=None):
    """A stand-in ``simulate_batch_torch`` that raises ``exc`` (the first
    ``times`` calls, or every call) and then runs the real one."""
    real = campaign_mod.simulate_batch_torch
    calls = {"n": 0}

    def fake(*args, **kw):
        calls["n"] += 1
        if times is None or calls["n"] <= times:
            raise exc
        return real(*args, **kw)

    return fake, calls


@pytest.mark.parametrize("msg", [
    "nvcc failed for ['sim_step']:\nerror: identifier undefined",
    "nvcc failed for ['sim_step']:\nout of memory (cudaError 700)",
    "nvcc not found: the port's CUDA kernels build on a machine with the CUDA toolkit",
])
def test_kernel_build_error_propagates(tmp_path, grid, monkeypatch, msg):
    """A kernel that does not build is fatal: no retry, no degradation to
    the NumPy engine that would hide it."""
    fake, calls = _failing(KernelBuildError(msg))
    monkeypatch.setattr(campaign_mod, "simulate_batch_torch", fake)
    runner = CampaignRunner(grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0,
                                                 retry=nosleep()), cfg("host"), device=CPU)
    with pytest.raises(KernelBuildError):
        runner.run()
    assert calls["n"] == 1 and not runner._degraded and runner._events == []


@pytest.mark.parametrize("exc", [
    KernelLaunchError("masked_primitive_update", 200),
    KernelLaunchError("masked_slab_strike_walk", 209),
    RuntimeError("masked_primitive_update: kernel launch failed (cudaError 200)"),
], ids=["launch_error:200", "launch_error:209", "launch_text:200"])
def test_kernel_launch_error_propagates(tmp_path, grid, monkeypatch, exc):
    """A kernel the card cannot run (an image for another architecture, a
    bad launch configuration) is the kernel's fault: it propagates at the
    first attempt and the campaign never leaves the card for the NumPy
    engine, which would hide it."""
    fake, calls = _failing(exc)
    monkeypatch.setattr(campaign_mod, "simulate_batch_torch", fake)
    runner = CampaignRunner(grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0,
                                                 retry=nosleep()), cfg("device"), device=CPU)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        runner.run()
    assert calls["n"] == 1 and not runner._degraded and runner._events == []


def test_sticky_cuda_error_retries_then_degrades(tmp_path, grid, monkeypatch):
    """A device-side assert poisons the context: every torch attempt fails,
    each a device loss, then the campaign finishes on the NumPy engine,
    the same lanes as an undisturbed host-mode campaign."""
    c = cfg("host")
    base = run_campaign(grid, CampaignConfig(ckpt_dir=str(tmp_path / "b"), ckpt_period=0.0,
                                             async_snapshots=False), c, device=CPU)
    fake, calls = _failing(RuntimeError(
        "CUDA error: device-side assert triggered\nCompile with TORCH_USE_CUDA_DSA"))
    monkeypatch.setattr(campaign_mod, "simulate_batch_torch", fake)
    res = run_campaign(grid, CampaignConfig(ckpt_dir=str(tmp_path / "k"), ckpt_period=0.0,
                                            async_snapshots=False, retry=nosleep()),
                       c, device=CPU)
    camp = res.meta["campaign"]
    kinds = [e["kind"] for e in camp["events"]]
    assert kinds == ["device_loss"] * 4 + ["engine_degraded"]
    assert calls["n"] == 4 and res.engine == "batch" and camp["engine_degraded"]
    np.testing.assert_allclose(key_vec(base), key_vec(res), rtol=1e-12)
    np.testing.assert_array_equal(key_vec(base)[2:], key_vec(res)[2:])


def test_wrapper_oom_halves_chunk(tmp_path, grid, ref_device, monkeypatch):
    fake, calls = _failing(RuntimeError(
        "masked_primitive_update: kernel launch failed (cudaError 2)"), times=1)
    monkeypatch.setattr(campaign_mod, "simulate_batch_torch", fake)
    res = run_campaign(grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0,
                                            retry=nosleep()), cfg("device"), device=CPU)
    camp = res.meta["campaign"]
    assert [e["kind"] for e in camp["events"]] == ["oom", "chunk_halved"]
    assert camp["chunk_lanes_final"] == CHUNK // 2 and not camp["engine_degraded"]
    np.testing.assert_allclose(key_vec(ref_device), key_vec(res), rtol=1e-9)


# --------------------------------------------------------------------------- #
# Devices, chunks, refusals
# --------------------------------------------------------------------------- #
def test_entry_points_need_cuda_or_the_cpu(tmp_path, grid, monkeypatch):
    import torch

    from repro_torch.experiments import campaign as cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    camp = CampaignConfig(ckpt_dir=str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CampaignRunner(grid, camp, cfg("device"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_campaign(grid, camp, cfg("device"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--preset", "validation", "--limit-cells", "1", "--n-runs", "2",
                  "--ckpt-dir", str(tmp_path / "cli")])
    with pytest.raises(ValueError, match="device= or devices="):
        CampaignRunner(grid, camp, cfg("device", devices=["cpu"]), device=CPU)


def test_cli_device_is_not_persisted(tmp_path, capsys):
    from repro_torch.experiments import campaign as cli

    d = str(tmp_path / "c")
    assert cli.main(["--preset", "validation", "--limit-cells", "2", "--n-runs", "5",
                     "--chunk-lanes", "4", "--ckpt-period", "0", "--ckpt-dir", d,
                     "--device", "cpu", "--sync-snapshots"]) == 0
    assert "engine torch" in capsys.readouterr().out
    with open(os.path.join(d, "campaign_cli.json")) as f:
        params = json.load(f)
    assert "device" not in params and params["chunk_lanes"] == "4"


def test_refusals(tmp_path, grid):
    camp = CampaignConfig(ckpt_dir=str(tmp_path))
    with pytest.raises(ValueError, match="engine='torch'"):
        CampaignRunner(grid, camp, EngineConfig(engine="batch"), device=CPU)
    with pytest.raises(ValueError, match="dispatch='fused'"):
        CampaignRunner(grid, camp, cfg("device", dispatch="perfamily"), device=CPU)


@pytest.mark.parametrize("trace_mode", ["device", "host"])
def test_auto_chunk_is_the_engines(tmp_path, grid, trace_mode):
    """"auto" is ``default_chunk_lanes`` of the device (and, in host mode,
    of one lane's slab bytes): the small grid is one chunk, one snapshot."""
    import torch

    runner = CampaignRunner(grid, CampaignConfig(ckpt_dir=str(tmp_path), ckpt_period=0.0),
                            cfg(trace_mode, chunk="auto"), device=CPU)
    assert runner._chunk_lanes0 == default_chunk_lanes(torch.device(CPU), trace_mode,
                                                       runner._lane_bytes())
    res = runner.run()
    assert res.meta["campaign"]["n_snapshots"] == 1
    np.testing.assert_allclose(key_vec(res), key_vec(run_grid(grid, cfg(trace_mode),
                                                              device=CPU)), rtol=1e-12)
    assert (runner._lane_bytes() > 0) == (trace_mode == "host")
