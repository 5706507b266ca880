"""Lane codes and per-lane parameter packing of the batch engines.

The port's copy of the parts of the reference ``repro.core.batch_sim``
that the device lane machine (:mod:`repro_torch.core.torch_sim`) runs on:
the strategy-mode codes, the lane phases, the primitive kinds, the
continuation codes with their phase tables, and the per-lane parameter
packing.  ``tests/test_torch_host.py`` holds every table here against
the reference.
"""

from __future__ import annotations

import numpy as np

from .simulator import Strategy
from .waste import Platform

__all__ = ["MODE_CODES", "pad_lane_axis"]

#: strategy-mode codes shared with :class:`repro_torch.core.simulator.Strategy`
#: (the reference's two-level and silent codes keep their numbers)
MODE_CODES = {
    "none": 0, "exact": 1, "nockpt": 2, "withckpt": 3, "migration": 4,
    "two_level": 5, "silent": 6,
}
(
    _M_NONE, _M_EXACT, _M_NOCKPT, _M_WITHCKPT, _M_MIGRATION,
    _M_TWO_LEVEL, _M_SILENT,
) = range(7)

# lane phases (continuation points of the scalar engine's control flow)
_PH_MAIN = 0  # top of Algorithm 1's regular-mode loop
_PH_EP_START = 1  # trusted prediction popped; episode entry decision
_PH_EP_PRECKPT = 2  # pre-window proactive checkpoint pending
_PH_EP_NT2 = 3  # "no time" path: uncredited work to t0 pending
_PH_EP_NOCKPT = 4  # NoCkptI: uncredited work to t0 + I pending
_PH_EP_WC = 5  # WithCkptI in-window loop: next segment decision
_PH_EP_WC_CKPT = 6  # WithCkptI proactive checkpoint pending
_PH_DONE = 7  # job complete: lane parked until harvested

# primitive kinds (one per lane per iteration)
_PR_NOOP, _PR_WORK, _PR_IDLE, _PR_CKPT = 0, 1, 2, 3

# continuations applied when a primitive completes without fault
(
    _C_MAIN,  # back to regular mode
    _C_CKPTREG,  # regular ckpt done: act on a prediction that fell inside it?
    _C_POP_EP,  # work-to-action done: pop the prediction, start episode
    _C_PRECKPT,  # work to t0 - C done: take the pre-window checkpoint
    _C_MODE,  # episode head done: dispatch on strategy mode
    _C_NT2,  # degenerate credited work done: uncredited work to t0
    _C_MIG,  # migration idle done: count it, back to regular mode
    _C_WC_CKPT,  # in-window work segment done: proactive checkpoint
    _C_WC,  # in-window checkpoint done: loop
) = range(9)

#: continuation -> next phase; special codes (_C_CKPTREG, _C_POP_EP, _C_MODE,
#: _C_MIG) get the MAIN placeholder and are patched by dedicated handlers
_CONT2PH = np.array(
    [
        _PH_MAIN, _PH_MAIN, _PH_MAIN, _PH_EP_PRECKPT, _PH_MAIN,
        _PH_EP_NT2, _PH_MAIN, _PH_EP_WC_CKPT, _PH_EP_WC,
    ],
    dtype=np.int8,
)

#: strategy mode -> phase after the episode head (Instant returns to regular
#: mode, NoCkptI idles through the window, WithCkptI enters the T_P loop;
#: the two-level and silent rows of the reference are MAIN)
_MODE2PH = np.array(
    [_PH_MAIN, _PH_MAIN, _PH_EP_NOCKPT, _PH_EP_WC, _PH_MAIN,
     _PH_MAIN, _PH_MAIN],
    dtype=np.int8,
)


def _lane_params(work, platform, strategy, L: int):
    """Per-lane (or per-cell) parameter columns ``(W, C, D, R, M, T_R,
    T_P, mode, q)``: the first nine columns of the reference packing."""
    plats = [platform] * L if isinstance(platform, Platform) else list(platform)
    strats = [strategy] * L if isinstance(strategy, Strategy) else list(strategy)
    if len(plats) != L or len(strats) != L:
        raise ValueError(
            f"platform/strategy length mismatch: {len(plats)}/{len(strats)} vs {L} lanes"
        )
    W = np.broadcast_to(np.asarray(work, dtype=np.float64), (L,)).copy()
    C = np.array([p.C for p in plats], dtype=np.float64)
    D = np.array([p.D for p in plats], dtype=np.float64)
    R = np.array([p.R for p in plats], dtype=np.float64)
    M = np.array(
        [p.M if p.M is not None else p.C for p in plats], dtype=np.float64
    )
    T_R = np.array([s.T_R for s in strats], dtype=np.float64)
    T_P = np.array(
        [s.T_P if s.T_P is not None else np.nan for s in strats], dtype=np.float64
    )
    mode = np.array([MODE_CODES[s.mode] for s in strats], dtype=np.int8)
    q = np.array([s.q for s in strats], dtype=np.float64)
    return W, C, D, R, M, T_R, T_P, mode, q


def _tier_params(platforms, strategies):
    """Per-cell two-level and silent-error columns ``(C2, R2, V, fmem,
    rho, kv)``: the last six columns of the reference packing, which only
    the analytic layer reads.  On every other mode's cells they are
    benign: a missing disk tier mirrors the memory one, f = 0 sends every
    failure to disk, rho = k_V = 1 make the nesting and verification
    strides degenerate."""
    C2 = np.array(
        [p.C2 if p.C2 is not None else p.C for p in platforms], dtype=np.float64
    )
    R2 = np.array(
        [p.R2 if p.R2 is not None else p.R for p in platforms], dtype=np.float64
    )
    V = np.array(
        [p.V if p.V is not None else p.C for p in platforms], dtype=np.float64
    )
    fmem = np.array(
        [p.f if p.f is not None else 0.0 for p in platforms], dtype=np.float64
    )
    rho = np.array(
        [s.rho if s.rho is not None else 1 for s in strategies], dtype=np.int64
    )
    kv = np.array(
        [s.k_V if s.k_V is not None else 1 for s in strategies], dtype=np.int64
    )
    return C2, R2, V, fmem, rho, kv


def pad_lane_axis(a: np.ndarray, n: int, fill) -> np.ndarray:
    """Pad the lane axis of a 1-D or 2-D per-lane array to ``n`` lanes
    (padding lanes get ``fill``: a value that keeps them inert)."""
    if a.shape[0] == n:
        return a
    shape = (n - a.shape[0],) + a.shape[1:]
    return np.concatenate([a, np.full(shape, fill, dtype=a.dtype)], axis=0)
