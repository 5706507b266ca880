"""Engine selection for the simulation entry points, in one place.

The port's copy of the reference's ``EngineConfig``: one frozen dataclass
of the engine knobs, threaded through :func:`repro_torch.core.
simulate_many`, :func:`repro_torch.core.simulator.best_period_search`,
``optimize(method="search")`` and :func:`repro_torch.experiments.
run_grid`.  The loose ``engine=`` / ``devices=`` / ``trace_mode=`` /
``dispatch=`` / ``collect=`` / ``chunk_lanes=`` keywords are still taken,
per call, through a deprecation shim that builds the same config.

The engines: ``"torch"`` (the default) is the device lane machine
:func:`repro_torch.core.torch_sim.simulate_batch_torch`, on CUDA unless
the caller names another device; ``"batch"`` the NumPy lane engine
:func:`repro_torch.core.batch_sim.simulate_batch`; ``"scalar"`` the
scalar event loop :func:`repro_torch.core.simulator.simulate`, the
oracle; ``"legacy"`` the per-run pipeline of the seed repository (grid
sweeps only).  The reference's ``"jax"`` engine reads ``"torch"`` here,
and the reference's ``mesh`` field has no counterpart: torch has no
device-mesh object, and ``devices=`` names the device set.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, fields, replace
from typing import Any, Dict, Optional, Union

__all__ = ["EngineConfig", "resolve_engine_config", "UNSET"]


class _Unset:
    """Sentinel telling "not passed" from a legitimate ``None``
    (``chunk_lanes=None`` means "one engine call", ``devices=None`` means
    "the default device")."""

    __slots__ = ()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return "<unset>"


#: module-wide "keyword not passed" sentinel of the deprecation shims
UNSET = _Unset()


@dataclass(frozen=True)
class EngineConfig:
    """How to run a batch of simulations.

    engine       "torch" (the device lane machine), "batch" (NumPy
                 lanes), "scalar" (the reference event loop) or "legacy"
                 (the seed pipeline; grid sweeps only).
    trace_mode   "host" (event arrays drawn with NumPy) or "device"
                 (counter-RNG :class:`~repro_torch.core.events.TraceSpec`
                 streams, sampled inside the torch engine and replayed on
                 the host by the others).
    dispatch     grid sweeps only: "fused" / "perfamily" / "percell"
                 (None picks the engine's default granularity).
    collect      "lanes" (per-run results) or "stats" (per-cell
                 statistics reduced on the device; torch engine only).
    devices      shard lanes over a device set (torch engine only): None,
                 "all", an int, or an explicit device sequence.
    chunk_lanes  lanes resident on the device per engine call ("auto", an
                 int, or None for one single call).
    """

    engine: str = "torch"
    trace_mode: str = "host"
    dispatch: Optional[str] = None
    collect: str = "lanes"
    devices: Any = None
    chunk_lanes: Union[int, str, None] = "auto"

    def validate(self) -> "EngineConfig":
        """Check the cross-field rules every entry point shares (each
        entry point also restricts ``engine`` to the set it supports)."""
        if self.engine != "torch" and self.devices is not None:
            raise ValueError("devices= requires engine='torch'")
        if self.trace_mode not in ("host", "device"):
            raise ValueError(
                f"unknown trace_mode {self.trace_mode!r} "
                "(expected 'host' or 'device')"
            )
        if self.collect not in ("lanes", "stats"):
            raise ValueError(
                f"unknown collect {self.collect!r} "
                "(expected 'lanes' or 'stats')"
            )
        if self.collect == "stats" and self.engine != "torch":
            raise ValueError("collect='stats' requires engine='torch'")
        return self

    def replace(self, **changes) -> "EngineConfig":
        return replace(self, **changes)


_FIELD_NAMES = tuple(f.name for f in fields(EngineConfig))


def resolve_engine_config(
    config: Union[EngineConfig, str, None],
    caller: str,
    **legacy,
) -> EngineConfig:
    """Merge a ``config=`` argument with the loose engine keywords.

    ``config`` may be an :class:`EngineConfig`, ``None`` (defaults plus
    the loose keywords) or a bare engine name (the old signatures took
    ``engine`` as the first optional positional).  Loose keywords arrive
    valued or :data:`UNSET`; passing any of them issues a
    :class:`DeprecationWarning` naming the replacement, and combining
    them with an explicit :class:`EngineConfig` is an error."""
    if isinstance(config, str):
        if legacy.get("engine", UNSET) is not UNSET:
            raise ValueError(
                f"{caller}: engine given both positionally and as engine="
            )
        legacy["engine"] = config
        config = None
    provided: Dict[str, Any] = {
        k: v for k, v in legacy.items() if v is not UNSET
    }
    unknown = set(provided) - set(_FIELD_NAMES)
    if unknown:  # pragma: no cover - programming error guard
        raise TypeError(f"{caller}: unknown engine kwargs {sorted(unknown)}")
    if config is None:
        if provided:
            warnings.warn(
                f"{caller}: the {sorted(provided)} keyword(s) are "
                "deprecated; pass config=EngineConfig(...) instead",
                DeprecationWarning,
                stacklevel=3,
            )
        return EngineConfig(**provided)
    if not isinstance(config, EngineConfig):
        raise TypeError(
            f"{caller}: config must be an EngineConfig, an engine name or "
            f"None, got {type(config).__name__}"
        )
    if provided:
        raise ValueError(
            f"{caller}: pass either config=EngineConfig(...) or the legacy "
            f"{sorted(provided)} keyword(s), not both"
        )
    return config
