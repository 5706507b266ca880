"""Host model of the paper (platforms, strategies, traces, the closed-form
waste models and their optimal periods) and the device lane machine
:func:`repro_torch.core.torch_sim.simulate_batch_torch`, which runs
device-drawn (:class:`TraceSpec`) and host-drawn (:class:`BatchTraces`,
:func:`make_event_traces_batch`) traces.

:func:`optimize` / :func:`optimize_cells` (:mod:`.analytic`) are the
period optimizer's entry points: the paper's case analyses on the host,
or the batched Newton solve on the card."""

from .analytic import PolicyTable, optimize, optimize_cells
from .events import BatchTraces, TraceSpec, make_event_traces_batch
from .periods import OptimalPolicy
from .waste import Platform, PredictorModel

__all__ = [
    "BatchTraces",
    "OptimalPolicy",
    "Platform",
    "PolicyTable",
    "PredictorModel",
    "TraceSpec",
    "make_event_traces_batch",
    "optimize",
    "optimize_cells",
]
