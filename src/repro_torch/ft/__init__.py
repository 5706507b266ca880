"""Fault-tolerance runtime of the port: the paper's prediction-aware
checkpointing policy driving a real training loop
(:class:`FaultTolerantExecutor`, with its clocks and waste ledger), fault
injection, elastic migration and straggler detection, and the resumable
campaign runner that applies the same checkpointing calculus to the
sweeps themselves, its chaos injection, and the failure classifier with
its retry policy (which also knows the CUDA card's failures)."""

from .executor import FaultTolerantExecutor, RunReport, SimClock, WallClock, WasteLedger
from .injection import (
    CampaignKilled,
    ChaosInjector,
    FaultInjector,
    SimulatedFault,
    SyntheticDeviceLoss,
    SyntheticOOM,
    SyntheticTorchFailure,
)
from .elastic import ElasticManager, StragglerDetector
from .retry import FailureKind, RetryPolicy, classify_failure
from .campaign import CampaignConfig, CampaignRunner, run_campaign

__all__ = [
    "FaultTolerantExecutor",
    "RunReport",
    "SimClock",
    "WallClock",
    "WasteLedger",
    "ElasticManager",
    "StragglerDetector",
    "FaultInjector",
    "SimulatedFault",
    "CampaignKilled",
    "ChaosInjector",
    "SyntheticOOM",
    "SyntheticDeviceLoss",
    "SyntheticTorchFailure",
    "FailureKind",
    "RetryPolicy",
    "classify_failure",
    "CampaignConfig",
    "CampaignRunner",
    "run_campaign",
]
