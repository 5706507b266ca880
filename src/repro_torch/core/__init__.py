"""Host model of the paper (platforms, strategies, traces, the closed-form
waste models and their optimal periods), the device lane machine
:func:`repro_torch.core.torch_sim.simulate_batch_torch`, which runs
device-drawn (:class:`TraceSpec`) and host-drawn (:class:`BatchTraces`,
:func:`make_event_traces_batch`) traces, and the host engines that check
it: the NumPy lane engine :func:`simulate_batch` and the scalar event
loop :func:`simulate`.

:class:`EngineConfig` selects the engine of :func:`simulate_many`,
BestPeriod (``optimize(method="search")``, :func:`best_period_search`)
and ``repro_torch.experiments.run_grid``.  :func:`optimize` /
:func:`optimize_cells` (:mod:`.analytic`) are the period optimizer's
entry points: the paper's case analyses on the host, the batched Newton
solve on the card, or the simulated search."""

from .analytic import PolicyTable, optimize, optimize_cells
from .batch_sim import BatchResult, simulate_batch
from .engine import EngineConfig
from .events import (
    BatchTraces,
    EventTrace,
    FaultEvent,
    PredictionEvent,
    TraceSpec,
    make_event_trace,
    make_event_traces_batch,
    make_fault_trace,
)
from .periods import OptimalPolicy
from .simulator import (
    SimResult,
    Strategy,
    best_period_search,
    simulate,
    simulate_many,
)
from .waste import Platform, PredictorModel

__all__ = [
    "BatchResult",
    "BatchTraces",
    "EngineConfig",
    "EventTrace",
    "FaultEvent",
    "OptimalPolicy",
    "Platform",
    "PolicyTable",
    "PredictionEvent",
    "PredictorModel",
    "SimResult",
    "Strategy",
    "TraceSpec",
    "best_period_search",
    "make_event_trace",
    "make_event_traces_batch",
    "make_fault_trace",
    "optimize",
    "optimize_cells",
    "simulate",
    "simulate_batch",
    "simulate_many",
]
