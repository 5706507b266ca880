"""Shared helpers of the paper drivers (CSV lines: name,us_per_call,derived).

Every :func:`emit` line is also recorded in :data:`RECORDS`, the
reference harness's record list, so a caller can compare or dump them.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List

#: records of the current run: {"name", "us_per_call", "derived"}
RECORDS: List[Dict] = []

#: the engines a driver runs on (``EngineConfig.engine``)
ENGINES = ("torch", "batch", "scalar", "legacy")


def reset_records() -> None:
    RECORDS.clear()


def emit(name: str, us_per_call: float, derived) -> None:
    RECORDS.append(
        {"name": name, "us_per_call": round(us_per_call, 1), "derived": derived}
    )
    if not isinstance(derived, str):
        derived = json.dumps(derived, separators=(",", ":"))
    print(f"{name},{us_per_call:.1f},{derived}", flush=True)


def engine_kwargs(engine: str, device) -> dict:
    """``run_cells`` keywords of a driver run: the engine's
    :class:`~repro_torch.core.engine.EngineConfig` (host-drawn traces,
    per-run results) and, for the torch engine, its device."""
    from ..core.engine import EngineConfig

    kw = {"config": EngineConfig(engine=engine)}
    if engine == "torch":
        kw["device"] = device
    elif device is not None:
        raise ValueError(f"--device applies to the torch engine, not {engine!r}")
    return kw


def parser(doc: str, quick: bool = True) -> argparse.ArgumentParser:
    """The drivers' command line: ``--quick`` (where the driver has a
    quick size), ``--engine``, ``--device``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    if quick:
        ap.add_argument("--quick", action="store_true", help="the reference's quick size")
    ap.add_argument("--engine", choices=ENGINES, default="torch")
    ap.add_argument("--device", default=None,
                    help="the torch engine's device (default: CUDA; 'cpu' runs "
                         "the plain PyTorch path)")
    return ap
