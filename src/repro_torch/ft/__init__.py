"""Fault-tolerance runtime of the port: the resumable campaign runner that
applies the paper's checkpointing calculus to the sweeps themselves, its
chaos injection, and the failure classifier with its retry policy (which
also knows the CUDA card's failures)."""

from .injection import (
    CampaignKilled,
    ChaosInjector,
    FaultInjector,
    SimulatedFault,
    SyntheticDeviceLoss,
    SyntheticOOM,
    SyntheticTorchFailure,
)
from .retry import FailureKind, RetryPolicy, classify_failure
from .campaign import CampaignConfig, CampaignRunner, run_campaign

__all__ = [
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
