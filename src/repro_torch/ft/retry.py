"""Failure classification and deterministic retry/backoff.

The port's copy of the reference's ``repro/ft/retry.py``.  One classifier
serves the campaign runner's chunk-boundary dispatch retries
(:mod:`repro_torch.ft.campaign`): a dispatch failure is mapped to a
:class:`FailureKind` by exception type and message, and a
:class:`RetryPolicy` prices the retry: jittered exponential backoff with
a bounded attempt budget.

Every pattern and type of the reference is kept (XLA writes its status
codes into the message text, and the synthetic chaos exceptions carry
the same fragments), and the classifier also knows how a CUDA card
fails, checked before them:

* :class:`~repro_torch.kernels.build.KernelBuildError` (``nvcc`` missing
  or failing, a library that does not load) is ``FATAL``: retrying cannot
  build a kernel, and degrading to the NumPy engine would hide it;
* the CUDA runtime's *sticky* errors (an illegal address, a launch
  failure, a device-side assert, an uncorrectable ECC error, a busy or
  missing device) leave the CUDA context unusable: ``DEVICE_LOSS``, by
  type where the installed torch has ``torch.AcceleratorError``, else by
  message, and the port's kernel wrappers' ``(cudaError N)`` codes;
* ``torch.OutOfMemoryError`` and a wrapper's ``(cudaError 2)`` are
  ``OOM``;
* a wrapper's launch failure with any other code
  (:class:`~repro_torch.kernels.build.KernelLaunchError`, or its
  ``(cudaError N)`` text) is ``FATAL``: an image the card cannot run or a
  bad launch configuration is the kernel's fault, which retrying cannot
  mend and degrading would hide.

The jitter is drawn from the repo's counter-based SplitMix64 stream
(:func:`repro_torch.core.events.splitmix64`), not wall-clock entropy, so
a resumed campaign replays the *same* backoff schedule as the run it
replaces; the draws are the reference's bit for bit.
"""

from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable

import numpy as np
import torch

from ..core.events import splitmix64, uniform24
from ..kernels.build import KernelBuildError, KernelLaunchError

__all__ = ["FailureKind", "classify_failure", "RetryPolicy"]


class FailureKind(Enum):
    #: allocation pressure: shrink the resident-lane footprint and retry
    OOM = "oom"
    #: a device dropped out: rebuild the dispatch on the survivors
    DEVICE_LOSS = "device_loss"
    #: unknown runtime error: retry as-is under the backoff budget
    TRANSIENT = "transient"
    #: programming/config error: never retried, propagate immediately
    FATAL = "fatal"


#: message fragments the XLA runtime uses for allocation failures
_OOM_PATTERNS = (
    "RESOURCE_EXHAUSTED",
    "RESOURCE EXHAUSTED",
    "Resource exhausted",
    "Out of memory",
    "out of memory",
    "OOM",
)

#: message fragments for device health failures
_DEVICE_LOSS_PATTERNS = (
    "DEVICE_LOST",
    "device lost",
    "Device lost",
    "device is lost",
    "device unavailable",
    "NCCL",
)

#: exception types that signal a bug or bad configuration, not a fault
_FATAL_TYPES = (TypeError, ValueError, KeyError, AttributeError, IndexError)

#: the CUDA runtime's sticky errors (the context is unusable after one),
#: as torch words them ...
_CUDA_STICKY_PATTERNS = (
    "illegal memory access",
    "unspecified launch failure",
    "device-side assert triggered",
    "uncorrectable ECC error",
    "busy or unavailable",
    "no CUDA-capable device",
)
#: ... and as the port's kernel wrappers report them, ``(cudaError N)``:
#: illegal address, launch failure, assert, ECC, busy, no device
_CUDA_STICKY_CODES = frozenset((700, 719, 710, 214, 46, 100))
#: cudaErrorMemoryAllocation
_CUDA_OOM_CODE = 2
_CUDA_CODE = re.compile(r"\(cudaError (\d+)\)")


def _cuda_code(exc: BaseException, msg: str):
    if isinstance(exc, KernelLaunchError):
        return exc.code
    m = _CUDA_CODE.search(msg)
    return int(m.group(1)) if m else None


def classify_failure(exc: BaseException) -> FailureKind:
    """Map an exception raised by a dispatch (or restore) to a
    :class:`FailureKind`.  Synthetic chaos exceptions carry the same
    message fragments as their real counterparts, so they classify
    through this one function: the recovery paths under test are the
    production paths."""
    kind = getattr(exc, "failure_kind", None)
    if isinstance(kind, FailureKind):
        return kind
    if isinstance(exc, KernelBuildError):
        return FailureKind.FATAL
    msg = f"{type(exc).__name__}: {exc}"
    code = _cuda_code(exc, msg)
    sticky_type = getattr(torch, "AcceleratorError", None)
    if (
        (sticky_type is not None and isinstance(exc, sticky_type))
        or any(p in msg for p in _CUDA_STICKY_PATTERNS)
        or code in _CUDA_STICKY_CODES
    ):
        return FailureKind.DEVICE_LOSS
    if isinstance(exc, torch.OutOfMemoryError) or code == _CUDA_OOM_CODE:
        return FailureKind.OOM
    if code is not None:
        return FailureKind.FATAL
    if any(p in msg for p in _DEVICE_LOSS_PATTERNS):
        return FailureKind.DEVICE_LOSS
    if any(p in msg for p in _OOM_PATTERNS):
        return FailureKind.OOM
    if isinstance(exc, _FATAL_TYPES):
        return FailureKind.FATAL
    return FailureKind.TRANSIENT


@dataclass
class RetryPolicy:
    """Jittered exponential backoff with a bounded per-site budget.

    ``max_attempts`` counts tries of one logical operation (a chunk
    dispatch); attempt ``k`` (0-based) sleeps
    ``base * factor**k * (1 + jitter * u)`` where ``u ~ U(0,1)`` comes
    from the seeded SplitMix64 counter stream: deterministic given
    (seed, counter), so schedules replay bit-exactly across resumes.
    ``sleep`` is injectable for tests."""

    max_attempts: int = 4
    base: float = 0.05
    factor: float = 2.0
    jitter: float = 0.5
    seed: int = 0
    sleep: Callable[[float], None] = field(default=time.sleep, repr=False)

    def backoff(self, attempt: int, counter: int) -> float:
        """Backoff duration (seconds) before retry ``attempt``."""
        hi, _lo = splitmix64(np.uint64(self.seed & 0xFFFFFFFFFFFFFFFF),
                             np.uint64(counter & 0xFFFFFFFFFFFFFFFF))
        u = float(uniform24(hi))
        return self.base * (self.factor ** attempt) * (1.0 + self.jitter * u)

    def pause(self, attempt: int, counter: int) -> float:
        """Sleep the backoff for (attempt, counter); returns the
        duration so callers can attribute the stall."""
        dt = self.backoff(attempt, counter)
        self.sleep(dt)
        return dt
