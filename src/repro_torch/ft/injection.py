"""Fault injection: executor-level simulated faults and campaign-level
chaos.

The port's copy of the reference's ``repro/ft/injection.py``.  Real fleet
faults land as SIGTERMs / node-health events between or during steps;
here they surface as :class:`SimulatedFault` raised at step boundaries
when the (simulated or wall) clock crosses a fault time from an
:class:`EventTrace`, the same trace generator the paper's simulator uses.

:class:`ChaosInjector` is the campaign-level counterpart: it fires
process kills, synthetic OOMs, device losses and persistent engine
failures at *chunk boundaries* of a :class:`~repro_torch.ft.campaign.
CampaignRunner` sweep, from the repo's deterministic counter-based RNG
(:func:`repro_torch.core.events.splitmix64`, the reference's draws bit
for bit), so every chaos schedule is replayable from its seed.  The
synthetic exceptions carry the message fragments the runtime uses, so
they route through the production :func:`repro_torch.ft.retry.
classify_failure` classifier.  The reference's "jax" engine is "torch"
here: :class:`SyntheticTorchFailure`, ``torch_fail_at`` and
``torch_fail_persistent``.
"""

from __future__ import annotations

import os
import signal
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from ..core.events import EventTrace, splitmix64, uniform24

__all__ = [
    "SimulatedFault",
    "FaultInjector",
    "CampaignKilled",
    "SyntheticOOM",
    "SyntheticDeviceLoss",
    "SyntheticTorchFailure",
    "ChaosInjector",
]


class SimulatedFault(RuntimeError):
    def __init__(self, time: float, predicted: bool):
        super().__init__(f"injected fault at t={time:.1f}s (predicted={predicted})")
        self.time = time
        self.predicted = predicted


class FaultInjector:
    """Raises when execution crosses the next fault time."""

    def __init__(self, trace: EventTrace, cancelled: Optional[set] = None):
        self.fault_times: List[float] = [f.time for f in trace.faults]
        self.predicted = [f.predicted for f in trace.faults]
        self._i = 0
        self.cancelled = cancelled if cancelled is not None else set()

    def cancel(self, fault_time: float) -> None:
        """Migration vacated the node: this fault no longer hits us."""
        self.cancelled.add(fault_time)

    def peek(self) -> Optional[float]:
        while self._i < len(self.fault_times) and (
            self.fault_times[self._i] in self.cancelled
        ):
            self._i += 1
        if self._i >= len(self.fault_times):
            return None
        return self.fault_times[self._i]

    def check(self, now: float) -> None:
        """Raise if a fault occurred at or before ``now``."""
        nxt = self.peek()
        if nxt is not None and nxt <= now:
            predicted = self.predicted[self._i]
            self._i += 1
            raise SimulatedFault(nxt, predicted)


# ---------------------------------------------------------------------- #
# campaign-level chaos
# ---------------------------------------------------------------------- #
class CampaignKilled(BaseException):
    """Process death injected at a chunk boundary (``kill_mode="raise"``).

    Deliberately a :class:`BaseException`: recovery code that catches
    ``Exception`` (the retry classifier) must NOT be able to swallow a
    simulated process death — only the test harness catches it, exactly
    as only the OS observes a real SIGKILL."""

    def __init__(self, chunk: int):
        super().__init__(f"campaign killed at chunk boundary {chunk}")
        self.chunk = chunk


class SyntheticOOM(RuntimeError):
    """Chaos allocation failure; classifies as ``FailureKind.OOM``."""

    def __init__(self, chunk: int):
        super().__init__(
            f"RESOURCE_EXHAUSTED: synthetic chaos OOM at chunk {chunk} "
            "(out of memory while trying to allocate lane buffers)"
        )
        self.chunk = chunk


class SyntheticDeviceLoss(RuntimeError):
    """Chaos device loss; classifies as ``FailureKind.DEVICE_LOSS``.

    ``n_lost`` is how many devices of the current set dropped (the
    campaign rebuilds its dispatch on the survivors)."""

    def __init__(self, chunk: int, n_lost: int = 1):
        super().__init__(
            f"DEVICE_LOST: synthetic chaos device loss at chunk {chunk} "
            f"({n_lost} device(s) dropped from the dispatch set)"
        )
        self.chunk = chunk
        self.n_lost = n_lost


class SyntheticTorchFailure(RuntimeError):
    """Chaos engine failure with no recognizable status code; classifies
    as ``FailureKind.TRANSIENT`` and — fired persistently — exhausts the
    retry budget, forcing the engine="torch" -> "batch" degradation."""

    def __init__(self, chunk: int):
        super().__init__(
            f"synthetic persistent torch engine failure at chunk {chunk}"
        )
        self.chunk = chunk


@dataclass
class ChaosInjector:
    """Deterministic chunk-boundary chaos for campaign sweeps.

    Two firing modes compose:

    * **scheduled** — ``kill_at`` / ``oom_at`` / ``device_loss_at`` name
      chunk indices (fired once, in incarnation 0, on the first attempt
      of that chunk: a retry or a resumed process proceeds past them,
      which is what lets tests assert the recovery completed);
      ``torch_fail_at`` fires from that chunk index onward on *every*
      attempt while the engine is still "torch" (a persistent engine bug),
      or on first attempts only with ``torch_fail_persistent=False``.
    * **probabilistic** — ``p_kill`` / ``p_oom`` / ``p_device_loss`` are
      per-chunk-boundary firing probabilities drawn from the SplitMix64
      counter stream keyed on ``(seed, incarnation, chunk)``: the same
      seed replays the same chaos, while a resumed incarnation sees
      fresh draws (so a kill is not deterministically re-fired forever).
      ``max_fires`` bounds the total probabilistic fires (fuzz budget).

    ``kill_mode`` selects how process death is simulated: ``"raise"``
    raises :class:`CampaignKilled` (in-process tests), ``"sigkill"``
    sends the hosting process a real ``SIGKILL`` (subprocess tests — no
    atexit handlers, no flushes, exactly a preemption)."""

    seed: int = 0
    p_kill: float = 0.0
    p_oom: float = 0.0
    p_device_loss: float = 0.0
    kill_at: Sequence[int] = ()
    oom_at: Sequence[int] = ()
    device_loss_at: Sequence[int] = ()
    torch_fail_at: Optional[int] = None
    torch_fail_persistent: bool = True
    kill_mode: str = "raise"
    max_fires: Optional[int] = None
    #: (chunk, kind) pairs already fired by this injector instance
    fired: Set[Tuple[int, str]] = field(default_factory=set)
    n_fires: int = 0

    def __post_init__(self):
        if self.kill_mode not in ("raise", "sigkill"):
            raise ValueError(
                f"unknown kill_mode {self.kill_mode!r} "
                "(expected 'raise' or 'sigkill')"
            )

    # ------------------------------------------------------------------ #
    def _u(self, incarnation: int, chunk: int, slot: int) -> float:
        """One deterministic U(0,1) draw per (incarnation, chunk, slot)."""
        ctr = (
            ((incarnation & 0xFFFF) << 40)
            | ((chunk & 0xFFFFFFFF) << 8)
            | (slot & 0xFF)
        )
        hi, _lo = splitmix64(
            np.uint64(self.seed & 0xFFFFFFFFFFFFFFFF), np.uint64(ctr)
        )
        return float(uniform24(hi))

    def _kill(self, chunk: int) -> None:
        if self.kill_mode == "sigkill":
            os.kill(os.getpid(), signal.SIGKILL)  # pragma: no cover
        raise CampaignKilled(chunk)

    def _budget_ok(self) -> bool:
        return self.max_fires is None or self.n_fires < self.max_fires

    # ------------------------------------------------------------------ #
    def at_chunk_boundary(
        self,
        chunk: int,
        *,
        incarnation: int = 0,
        attempt: int = 0,
        engine: str = "torch",
    ) -> None:
        """Fire chaos (by raising) for the chunk about to be dispatched.

        ``attempt`` is the dispatch attempt of this chunk (0 = first);
        ``engine`` is the campaign's *current* engine, so a persistent
        torch failure stops firing once the campaign degraded to "batch"
        (the synthetic bug lives in the torch path)."""
        # persistent engine failure: every attempt while still on torch
        if (
            self.torch_fail_at is not None
            and engine == "torch"
            and chunk >= self.torch_fail_at
            and (self.torch_fail_persistent or attempt == 0)
        ):
            raise SyntheticTorchFailure(chunk)
        if attempt:
            return  # scheduled/probabilistic chaos fires once per chunk
        if incarnation == 0:
            if chunk in self.kill_at and (chunk, "kill") not in self.fired:
                self.fired.add((chunk, "kill"))
                self._kill(chunk)
            if chunk in self.oom_at and (chunk, "oom") not in self.fired:
                self.fired.add((chunk, "oom"))
                raise SyntheticOOM(chunk)
            if chunk in self.device_loss_at and (
                chunk, "devloss"
            ) not in self.fired:
                self.fired.add((chunk, "devloss"))
                raise SyntheticDeviceLoss(chunk)
        if self.p_kill and self._budget_ok() and (
            self._u(incarnation, chunk, 0) < self.p_kill
        ):
            self.n_fires += 1
            self._kill(chunk)
        if self.p_oom and self._budget_ok() and (
            self._u(incarnation, chunk, 1) < self.p_oom
        ):
            self.n_fires += 1
            raise SyntheticOOM(chunk)
        if self.p_device_loss and self._budget_ok() and (
            self._u(incarnation, chunk, 2) < self.p_device_loss
        ):
            self.n_fires += 1
            raise SyntheticDeviceLoss(chunk)
