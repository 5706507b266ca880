"""End-to-end fault-tolerant training driver (the port of the reference's
``launch/train.py``).

Wires every substrate together: config -> model -> data pipeline ->
AdamW -> checkpoint tiers -> the paper's prediction-aware checkpointing
policy (:class:`repro_torch.ft.FaultTolerantExecutor` on the wall clock).
The model trains on one device, the card unless the caller names the CPU;
the weights are random from ``--seed``, the data
:class:`repro_torch.data.SyntheticLMDataset`.

Checkpoints go to an :class:`~repro_torch.checkpoint.AsyncCheckpointer`
over a :class:`~repro_torch.checkpoint.CheckpointStore` with ``--codec``
(``raw``, as the reference; ``int8`` or ``int8_delta`` encode the f32
leaves on the device, except the AdamW second moments, stored raw;
``int8_delta`` codes each save's difference from the run's first
checkpoint), and with
``--memory-tier`` first to a
:class:`~repro_torch.checkpoint.BuddyMemoryCheckpoint`.  A fault restores
the step the executor names through the tiers in order: the buddy's
replica (the failed node's own RAM is gone), then the disk, then, for
step 0, a fresh state from the seed.  ``--correlated-every K`` makes
every K-th restore of a checkpoint lose the buddy's replica too (a
correlated failure of two nodes), so the disk tier serves it.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --steps 200 --inject-faults --predictor paper-accurate
(on the card; ``--device cpu`` runs the plain PyTorch path on the CPU,
``--full`` the published config instead of ``.reduced()``).
"""

from __future__ import annotations

import argparse
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import configs
from ..checkpoint import AsyncCheckpointer, BuddyMemoryCheckpoint, CheckpointStore
from ..checkpoint.store import map_with_keys
from ..configs.base import ArchConfig
from ..core.events import make_event_trace
from ..core.predictor import SimulatedPredictor, predictor_preset
from ..core.torch_sim import resolve_device
from ..core.waste import Platform, PredictorModel
from ..data.pipeline import SyntheticLMDataset
from ..ft import FaultInjector, FaultTolerantExecutor, SimClock, WallClock
from ..models.layers import RuntimeFlags
from ..optim.adamw import adamw_init
from .steps import build_model, build_train_step

__all__ = ["make_train_state", "train", "main", "CODECS"]

CODECS = ("raw", "int8", "int8_delta")


def _second_moment(key: str) -> bool:
    """AdamW's second moments (``v``; the 8-bit state's ``v_s`` block
    scales): stored raw under the int8 codecs.  Coded, a block's entries
    below half a code step of its absmax come back 0, and the next update
    divides ``m`` by ``sqrt(0) + eps`` (on an H100, the loss of a 4-layer
    RWKV6-7B three steps after such a restore moved by 7.8%)."""
    return key.rsplit("/", 1)[-1] in ("v", "v_s")

#: the tiers' names, in their order on the restore ladder
TIERS = ("memory", "disk", "initial")


def make_train_state(cfg: ArchConfig, model, seed: int = 0, device=None) -> dict:
    """``{"params", "opt"}``: random parameters from a ``torch.Generator``
    seeded with ``seed`` on ``device`` (CUDA unless the caller names the
    CPU; without CUDA and without a device it raises) and zero AdamW
    moments (int8 for ``cfg.optimizer == "adamw8bit"``)."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    params = model.init(g)
    return {"params": params, "opt": adamw_init(params, quantize=cfg.optimizer == "adamw8bit")}


class _Checkpointer:
    """The executor's checkpointer: the memory tier (if any), then the
    asynchronous disk tier.  ``save`` returns the two blocking costs'
    sum; ``saves`` records each save's step, ``c_block`` per tier and,
    once drained, the disk's ``c_full``."""

    def __init__(self, disk: AsyncCheckpointer, memory: Optional[BuddyMemoryCheckpoint],
                 delta: bool):
        self.disk = disk
        self.memory = memory
        self.delta = delta
        self.base = None  # int8_delta: the first checkpoint as the disk decodes it
        self.saves: List[Dict[str, float]] = []
        self.steps = set()

    def _drained(self) -> None:
        self.disk.wait()
        if self.saves and "c_full" not in self.saves[-1]:
            m = self.disk.metrics
            self.saves[-1].update(c_full=m["c_full"], disk_bytes=m["stored_bytes"])

    def save(self, step: int, tree) -> float:
        self._drained()
        rec = {"step": step, "c_block_memory": 0.0}
        if self.memory is not None:
            rec["c_block_memory"] = self.memory.save(step, tree)
        rec["c_block_disk"] = self.disk.save(step, tree, prev_tree=self.base)
        if self.delta and self.base is None:
            # later saves code their delta from this checkpoint as a
            # restore decodes it, so saves and restores add the same base.
            # The second moments are stored raw and need no base
            self._drained()
            self.base = map_with_keys(lambda k, x: None if _second_moment(k) else x,
                                      self.disk.store.restore(step, target=tree))
        rec["c_block"] = rec["c_block_memory"] + rec["c_block_disk"]
        self.saves.append(rec)
        self.steps.add(step)
        return rec["c_block"]

    def wait(self) -> None:
        self._drained()


def train(cfg: ArchConfig, *, steps: int = 100, batch: int = 8, seq: int = 128,
          lr: float = 3e-4, micro: int = 1, seed: int = 0, ckpt_dir: Optional[str] = None,
          codec: str = "raw", memory_tier: bool = False,
          correlated_every: int = 0, inject_faults: bool = False, fault_mtbf: float = 20.0,
          predictor: Optional[str] = None, strategy: str = "auto",
          flags: Optional[RuntimeFlags] = None, device=None, sim_step_s: Optional[float] = None,
          log: Callable[[str], None] = print) -> dict:
    """Train ``cfg`` for ``steps`` steps under the executor on ``device``
    (the current CUDA device by default; without CUDA and without
    ``device`` it raises before building anything).  ``flags`` default to
    the reference driver's ``RuntimeFlags(dense_attn_max=512)``.  Faults
    (with ``inject_faults``) come from ``make_event_trace`` with mean
    ``fault_mtbf`` wall seconds, drawn from ``np.random.default_rng(seed +
    7)``; ``predictor`` names a Table-3 preset whose predictions the
    executor acts on (without one it runs Young's period).

    ``sim_step_s`` runs the executor on a :class:`~repro_torch.ft.SimClock`
    instead of the wall clock: each step counts ``sim_step_s`` seconds and
    each checkpoint, downtime and restore the platform's priors (C 0.5, D
    0.2, R 0.5 s), so faults, predictions and saves fall at the same steps
    on every host.  The steps, saves and restores still run for real;
    ``step_s`` and ``saves`` hold their measured times, and the report's
    ledger the simulated ones.

    Returns ``report`` (the executor's :class:`~repro_torch.ft.RunReport`),
    ``losses`` (step -> loss, the last run of each step), ``step_s``
    (``(step, seconds)`` of every completed step, replays included),
    ``saves`` (per checkpoint: step, ``c_block`` of each tier, the disk's
    ``c_full`` and bytes), ``restores`` (per restore: fault ordinal, step,
    tier name, failed attempts), ``fault_times``, ``wall_s``, ``clock_s``
    (the executor's clock at the end: ``wall_s`` or the simulated time),
    ``c_estimate``, ``period_T`` and ``device``."""
    if codec not in CODECS:
        raise ValueError(f"codec {codec!r} is not one of {CODECS}")
    dev = resolve_device(device)
    model = build_model(cfg, flags or RuntimeFlags(dense_attn_max=512))
    state = make_train_state(cfg, model, seed, dev)
    inner = build_train_step(model, lr=lr, total_steps=steps, micro_batches=micro)
    data = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
                              seed=seed, frontend_prefix=cfg.frontend_prefix if cfg.frontend
                              else 0, d_model=cfg.d_model)
    own_dir = ckpt_dir is None
    root = tempfile.mkdtemp(prefix="repro_torch_train_") if own_dir else ckpt_dir
    store = CheckpointStore(root, codec=codec,
                            raw_keys=_second_moment if codec != "raw" else None)
    memory = BuddyMemoryCheckpoint(n_nodes=2) if memory_tier else None
    ckpt = _Checkpointer(AsyncCheckpointer(store, keep=3), memory, codec == "int8_delta")

    losses: Dict[int, float] = {}
    step_s: List[tuple] = []

    def step_fn(st, k):
        t0 = time.perf_counter()
        b = {kk: torch.from_numpy(v).to(dev) for kk, v in data.batch(k).items()}
        params, opt, metrics = inner(st["params"], st["opt"], b)
        losses[k] = float(metrics["loss"])
        step_s.append((k, time.perf_counter() - t0))
        if k % 10 == 0:
            log(f"step {k:5d} loss {losses[k]:.4f} gnorm {float(metrics['grad_norm']):.3f}")
        return {"params": params, "opt": opt}

    # -- fault tolerance wiring (the reference driver's priors) ----------- #
    plat = Platform(mu=fault_mtbf, C=0.5, D=0.2, R=0.5, M=0.3)
    pm = sim_pred = injector = None
    fault_times: List[float] = []
    if inject_faults:
        preset = predictor_preset(predictor) if predictor else PredictorModel(0.0, 1.0)
        pm = PredictorModel(preset.recall, preset.precision, lead=5.0,
                            window=min(preset.window, 2.0))
        trace = make_event_trace(np.random.default_rng(seed + 7), horizon=steps * 5.0 + 600,
                                 mtbf=plat.mu, recall=pm.recall, precision=pm.precision,
                                 window=pm.window, lead=pm.lead)
        fault_times = [f.time for f in trace.faults]
        injector = FaultInjector(trace)
        if predictor:
            sim_pred = SimulatedPredictor(trace, pm)

    ckpt_restores = [0]

    def memory_restore(step):
        if step in ckpt.steps:
            ckpt_restores[0] += 1
            if correlated_every and ckpt_restores[0] % correlated_every == 0:
                raise KeyError(f"fault {ex.n_faults} took the node and its buddy: "
                               "no replica in memory")
        got = memory.restore(0, lost=True)  # the failed node's own RAM is gone
        if got is None or got[0] != step:
            raise KeyError(f"the memory tier holds no checkpoint of step {step}")
        return map_with_keys(lambda _, x: x.to(dev, copy=True), got[1])

    def disk_restore(step):
        if step not in ckpt.steps:
            raise KeyError(f"no checkpoint of step {step} on disk")
        return store.restore(step, target=ex.state, prev_tree=ckpt.base)

    def initial_restore(step):
        if step != 0:
            raise KeyError(f"the initial state is step 0, not {step}")
        return make_train_state(cfg, model, seed, dev)

    tiers = ([memory_restore] if memory_tier else []) + [disk_restore, initial_restore]
    tier_names = list(TIERS if memory_tier else TIERS[1:])
    ex = FaultTolerantExecutor(
        step_fn=step_fn, state=state, platform=plat, pred_model=pm, predictor=sim_pred,
        checkpointer=ckpt, restore_tiers=tiers if inject_faults else None,
        injector=injector, clock=WallClock() if sim_step_s is None else SimClock(),
        step_time=1.0 if sim_step_s is None else sim_step_s,
        strategy=strategy if sim_pred else "young",
    )
    t0 = time.monotonic()
    try:
        report = ex.run(steps)
    finally:
        ckpt.wait()
        if own_dir:
            shutil.rmtree(root, ignore_errors=True)
    wall = time.monotonic() - t0
    restores = [dict(e, tier=tier_names[e["tier"]]) for e in ex.restore_events]
    return {"report": report, "losses": losses, "step_s": step_s, "saves": ckpt.saves,
            "restores": restores, "fault_times": fault_times, "wall_s": wall,
            "clock_s": ex.clock.now(),
            "c_estimate": report.c_estimate, "period_T": report.period_T,
            "device": str(dev)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one, removed at the end)")
    ap.add_argument("--codec", default="raw", choices=CODECS)
    ap.add_argument("--memory-tier", action="store_true",
                    help="buddy memory checkpoints, the first restore tier")
    ap.add_argument("--correlated-every", type=int, default=0,
                    help="every K-th restore of a checkpoint also loses the buddy's replica")
    ap.add_argument("--inject-faults", action="store_true")
    ap.add_argument("--fault-mtbf", type=float, default=20.0, help="seconds")
    ap.add_argument("--predictor", default=None, help="Table-3 preset name")
    ap.add_argument("--strategy", default="auto")
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    res = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                micro=args.micro, seed=args.seed, ckpt_dir=args.ckpt_dir, codec=args.codec,
                memory_tier=args.memory_tier, correlated_every=args.correlated_every,
                inject_faults=args.inject_faults, fault_mtbf=args.fault_mtbf,
                predictor=args.predictor, strategy=args.strategy, device=dev)
    report = res["report"]
    print("\n== run report ==")
    print(report.summary())
    print("ledger:", {k: round(v, 2) for k, v in report.ledger.as_dict().items()})
    print("restores:", [(r["step"], r["tier"]) for r in res["restores"]])
    print(f"wall time: {res['wall_s']:.1f}s on {res['device']}; "
          f"final loss: {res['losses'].get(args.steps - 1)}")
    return res


if __name__ == "__main__":
    main()
