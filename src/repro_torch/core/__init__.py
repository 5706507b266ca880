"""Host model of the paper (platforms, strategies, traces, the closed-form
waste models and their optimal periods) and the device lane machine
:func:`repro_torch.core.torch_sim.simulate_batch_torch`.

:func:`optimize` / :func:`optimize_cells` (:mod:`.analytic`) are the
period optimizer's entry points: the paper's case analyses on the host,
or the batched Newton solve on the card."""

from .analytic import PolicyTable, optimize, optimize_cells
from .periods import OptimalPolicy
from .waste import Platform, PredictorModel

__all__ = [
    "OptimalPolicy",
    "Platform",
    "PolicyTable",
    "PredictorModel",
    "optimize",
    "optimize_cells",
]
