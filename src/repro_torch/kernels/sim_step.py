"""The device lane machine's hot step: plain PyTorch versions and the two
CUDA kernel wrappers.

:func:`masked_primitive_update` runs one masked primitive per lane (fault
check, clock / saved / unsaved / period-work update, int32 outcome
bitfield) and, in device trace mode, refills the strike cursor of the
lanes that faulted.  :func:`masked_stream_advance` advances a renewal
stream cursor by one event where a mask is set.  Both wrap hand-written
CUDA kernels (``csrc/sim_step.cu``, built by :mod:`.build`) that replace
the reference's Pallas kernels of the same names; both update their state
arguments in place and return them.

Both kernels come in two variants.  The single-law one takes one
``(kind, param)`` per launch; the law-indexed one (``kind="indexed"``,
the mixed-law sweep) takes three more per-lane inputs, the int32 law
code and the ``s1`` / ``s2`` shape slots of
:func:`~repro_torch.core.events.law_table`, and draws each lane's gap
under its own law.  Each wrapper counts the launches of the two
variants apart: ``.launches`` and ``.indexed_launches``.

Every function the kernels compute also exists here as plain PyTorch:
the counter-based RNG (Threefry-2x32, SplitMix64, ``uniform24``), the
inverse-CDF gap transforms, :func:`stream_advance` and
:func:`primitive_update`.  A wrapper given CPU tensors runs the plain
version; given CUDA tensors it launches its kernel or raises.  torch has
no ``>>`` for unsigned 64-bit integers on the CPU and ``>>`` on int64 is
arithmetic, so the plain RNG works on int64 bit patterns: multiplies wrap
around and right shifts are masked to be logical.  32-bit words travel
as non-negative int64 values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.events import (
    _SM_GAMMA, _SM_MIX1, _SM_MIX2, _TF_PARITY, _TF_ROTATIONS, THREEFRY_ROUNDS,
    LAW_EXPONENTIAL, LAW_LOGNORMAL, LAW_UNIFORM, LAW_WEIBULL, STREAM_FAULT_GAP,
    law_constants, stream_key64_np,
)

__all__ = [
    "PRIM_NOOP", "PRIM_WORK", "PRIM_IDLE", "PRIM_CKPT", "PRIM_WORK_NC",
    "FLAG_FAULTED", "FLAG_OK", "FLAG_FIN", "FLAG_CKPT_OK", "FLAG_REG",
    "threefry2x32", "splitmix64", "uniform24", "stream_key",
    "counter_words", "counter_uniform", "counter_uniform2",
    "law_constants", "gap_transform", "gap_transform_indexed",
    "stream_advance", "primitive_update",
    "masked_stream_advance", "masked_primitive_update",
    "cell_gather", "segment_cell_sums", "sample_lane_state", "SAMPLE_LAWS",
    "sample_lane_laws", "lane_state_tensors",
]

#: primitive kinds (0-3 shared with repro_torch.core.batch_sim's _PR_* codes;
#: 4 is work not credited toward the regular period)
PRIM_NOOP, PRIM_WORK, PRIM_IDLE, PRIM_CKPT, PRIM_WORK_NC = 0, 1, 2, 3, 4

#: outcome bitfield
FLAG_FAULTED = 1  # a fault interrupted the primitive
FLAG_OK = 2  # primitive completed without fault
FLAG_FIN = 4  # the work segment finished the job
FLAG_CKPT_OK = 8  # a checkpoint committed (saved <- saved + unsaved)
FLAG_REG = 16  # ... and it was a *regular* (period-resetting) checkpoint

_M32 = 0xFFFFFFFF
_TWO_PI = 2.0 * 3.141592653589793


def _i64(c: int) -> int:
    """The int64 bit pattern of an unsigned 64-bit constant."""
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


# --------------------------------------------------------------------------- #
# Counter-based RNG
# --------------------------------------------------------------------------- #
def threefry2x32(k0, k1, c0, c1, rounds: int = THREEFRY_ROUNDS):
    """Threefry-2x32 over 32-bit words held in int64 tensors (Random123
    layout; bit-identical to ``repro_torch.core.events.threefry2x32``)."""
    ks = (k0, k1, k0 ^ k1 ^ _TF_PARITY)
    x0 = (c0 + ks[0]) & _M32
    x1 = (c1 + ks[1]) & _M32
    for i in range(rounds):
        r = _TF_ROTATIONS[(i // 4) % 2][i % 4]
        x0 = (x0 + x1) & _M32
        x1 = ((x1 << r) & _M32) | (x1 >> (32 - r))
        x1 = x1 ^ x0
        if i % 4 == 3:
            s = i // 4 + 1
            x0 = (x0 + ks[s % 3]) & _M32
            x1 = (x1 + ks[(s + 1) % 3] + s) & _M32
    return x0, x1


def splitmix64(key64: torch.Tensor, ctr: torch.Tensor):
    """Counter-indexed SplitMix64 draw ``mix(key64 + (ctr + 1) * GAMMA)``
    of an int64 key bit pattern: the (high, low) 32-bit output words."""
    z = key64 + (ctr.to(torch.int64) + 1) * _i64(_SM_GAMMA)
    z = (z ^ _shr(z, 30)) * _i64(_SM_MIX1)
    z = (z ^ _shr(z, 27)) * _i64(_SM_MIX2)
    z = z ^ _shr(z, 31)
    return _shr(z, 32), z & _M32


def uniform24(bits: torch.Tensor) -> torch.Tensor:
    """32-bit words -> f64 uniforms in the open interval (0, 1): the top 24
    bits, centered by half an ulp."""
    return ((bits >> 8).to(torch.float64) + 0.5) * 2.0**-24


def stream_key(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """Pack a Threefry subkey pair into the SplitMix64 key ``(k0 << 32) |
    k1`` (an int64 bit pattern)."""
    return (k0 << 32) | k1


def counter_words(key: torch.Tensor, ctr: torch.Tensor):
    """Output words of draw ``ctr`` of the stream keyed ``key``."""
    return splitmix64(key, ctr)


def counter_uniform(key: torch.Tensor, ctr: torch.Tensor) -> torch.Tensor:
    """Draw ``ctr``'s uniform from the stream keyed ``key``."""
    return uniform24(counter_words(key, ctr)[0])


def counter_uniform2(key: torch.Tensor, ctr: torch.Tensor):
    """Both uniforms of one draw (the TP coin stream: word 0 is the
    predicted coin, word 1 the window-offset fraction)."""
    x0, x1 = counter_words(key, ctr)
    return uniform24(x0), uniform24(x1)


# --------------------------------------------------------------------------- #
# Inverse-CDF gap transform
# --------------------------------------------------------------------------- #
def gap_transform(kind: str, param: float, mean, x0, x1) -> torch.Tensor:
    """Inverse-CDF inter-arrival gap of one counter draw (f64).  Only the
    lognormal law consumes the second word (Box–Muller phase).  Clamped to
    the ``1e-9`` zero-gap guard."""
    law, p1, p2 = law_constants(kind, param)
    u = uniform24(x0)
    if law == LAW_EXPONENTIAL:
        g = -torch.log1p(-u) * mean
    elif law == LAW_WEIBULL:
        nlog = -torch.log1p(-u)
        # the reference compiler's static-exponent pow strength reductions
        if p2 == 2.0:
            p = nlog * nlog
        elif p2 == 0.5:
            p = torch.sqrt(nlog)
        else:
            p = torch.pow(nlog, p2)
        g = (mean * p1) * p
    elif law == LAW_LOGNORMAL:
        z = torch.sqrt(-2.0 * torch.log(u)) * torch.cos(_TWO_PI * uniform24(x1))
        g = torch.exp((torch.log(mean) - p2) + p1 * z)
    else:  # LAW_UNIFORM
        g = (2.0 * mean) * u
    return torch.clamp(g, min=1e-9)


def gap_transform_indexed(law, s1, s2, mean, x0, x1) -> torch.Tensor:
    """Law-indexed :func:`gap_transform`: ``law`` is the per-lane int32 law
    code, ``(s1, s2)`` the per-lane shape slots of
    :func:`~repro_torch.core.events.law_table` (the ``p1`` / ``p2`` of
    :func:`law_constants`).  Every family's expression is evaluated and
    one ``where`` chain selects, as the reference's
    ``gap_transform_indexed``; each branch is :func:`gap_transform`'s
    expression, with the ``s2 == 2.0`` / ``s2 == 0.5`` strength
    reductions as selects, so each law's lanes get the single-law bits."""
    u = uniform24(x0)
    nlog = -torch.log1p(-u)
    g_exp = nlog * mean
    p = torch.pow(nlog, s2)
    p = torch.where(s2 == 2.0, nlog * nlog, p)
    p = torch.where(s2 == 0.5, torch.sqrt(nlog), p)
    g_wei = (mean * s1) * p
    z = torch.sqrt(-2.0 * torch.log(u)) * torch.cos(_TWO_PI * uniform24(x1))
    g_log = torch.exp((torch.log(mean) - s2) + s1 * z)
    g_uni = (2.0 * mean) * u
    g = torch.where(
        law == LAW_WEIBULL, g_wei,
        torch.where(law == LAW_LOGNORMAL, g_log,
                    torch.where(law == LAW_UNIFORM, g_uni, g_exp)),
    )
    return torch.clamp(g, min=1e-9)


def stream_advance(mask, ctr, tm, key, mean, horizon, *, kind: str, param: float,
                   law=None, lp=None):
    """Advance a renewal-stream cursor ``(ctr, tm)`` by one event where
    ``mask``: draw gap ``ctr + 1``, accumulate the event date, retire the
    stream (``+inf``) past the horizon.  Returns new tensors.

    ``kind="indexed"`` draws through :func:`gap_transform_indexed`:
    ``law`` is the per-lane law code and ``lp`` the ``(s1, s2)`` slot
    pair (``param`` is ignored)."""
    c2 = ctr + 1
    x0, x1 = counter_words(key, c2)
    if kind == "indexed":
        g = gap_transform_indexed(law, lp[0], lp[1], mean, x0, x1)
    else:
        g = gap_transform(kind, param, mean, x0, x1)
    t2 = tm + g
    t2 = torch.where(t2 > horizon, math.inf, t2)
    return torch.where(mask, c2, ctr), torch.where(mask, t2, tm)


# --------------------------------------------------------------------------- #
# Masked primitive update
# --------------------------------------------------------------------------- #
def primitive_update(
    prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
    *, eps: float, reg_cont: int, stream=None, gap=None,
):
    """One masked primitive execution per lane.  ``target`` is already
    capped at job completion, ``ckend`` fixed from the pre-fault-resolution
    clock, ``nf`` each lane's next pending fault.  Returns ``(t, saved,
    unsaved, period_work, flags)`` as new tensors.

    With ``stream = (key, ctr, tm, mean, horizon)`` (``tm`` the strike
    cursor date, equal to ``nf``) and ``gap = (kind, param)``, the lanes
    that faulted draw their next fault and the advanced ``(ctr, tm)`` is
    appended to the returned tuple.  The law-indexed variant takes the
    8-tuple ``(key, ctr, tm, mean, horizon, law, s1, s2)`` and ``gap =
    ("indexed", 0.0)``."""
    creditb = prim == PRIM_WORK
    workm = creditb | (prim == PRIM_WORK_NC)
    idlem = prim == PRIM_IDLE
    ckm = prim == PRIM_CKPT
    res = workm | idlem | ckm

    faulted = ((workm | idlem) & (nf <= target)) | (ckm & (nf < ckend))
    ok = res & ~faulted

    t1 = torch.where(faulted, nf + DR, t)
    unsaved1 = torch.where(faulted, 0.0, unsaved)
    pw1 = torch.where(faulted, 0.0, pw)

    wok = workm & ok
    dt = target - t
    unsaved2 = torch.where(wok, unsaved1 + dt, unsaved1)
    pw2 = torch.where(wok & creditb, pw1 + dt, pw1)
    t2 = torch.where(wok, target, t1)
    fin = wok & (saved + unsaved2 >= W - eps)

    iok = idlem & ok
    t3 = torch.where(iok, target, t2)

    cok = ckm & ok
    t4 = torch.where(cok, ckend, t3)
    saved2 = torch.where(cok, saved + unsaved2, saved)
    unsaved3 = torch.where(cok, 0.0, unsaved2)
    reg = cok & (cont == reg_cont)
    pw3 = torch.where(reg, 0.0, pw2)

    i32 = torch.int32
    flags = (
        faulted.to(i32) * FLAG_FAULTED
        + ok.to(i32) * FLAG_OK
        + fin.to(i32) * FLAG_FIN
        + cok.to(i32) * FLAG_CKPT_OK
        + reg.to(i32) * FLAG_REG
    )
    if stream is None:
        return t4, saved2, unsaved3, pw3, flags
    skey, sctr, stm, smean, shorizon = stream[:5]
    law, lp = (stream[5], stream[6:8]) if len(stream) == 8 else (None, None)
    sctr, stm = stream_advance(
        faulted, sctr, stm, skey, smean, shorizon, kind=gap[0], param=gap[1],
        law=law, lp=lp,
    )
    return t4, saved2, unsaved3, pw3, flags, sctr, stm


# --------------------------------------------------------------------------- #
# Kernel wrappers
# --------------------------------------------------------------------------- #
def _check(name: str, specs) -> torch.device:
    """Validate ``(arg_name, tensor, dtype[, numel])`` specs: one device,
    the stated dtypes, contiguous; an argument given ``numel`` has that
    many elements, any other is 1-D of the first argument's shape.
    Returns the device."""
    for arg, x, *_ in specs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
    dev = specs[0][1].device
    n = specs[0][1].shape
    for arg, x, dt, *numel in specs:
        if x.device != dev:
            raise ValueError(f"{name}: {arg} is on {x.device}, expected {dev}")
        if x.dtype != dt:
            raise TypeError(f"{name}: {arg} has dtype {x.dtype}, expected {dt}")
        if numel:
            if x.numel() != numel[0]:
                raise ValueError(
                    f"{name}: {arg} has {x.numel()} elements, expected {numel[0]}"
                )
        elif x.dim() != 1 or x.shape != n:
            raise ValueError(
                f"{name}: {arg} has shape {tuple(x.shape)}, expected {tuple(n)}"
            )
        if not x.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    if dev.type == "cuda" and dev.index != torch.cuda.current_device():
        # the kernel launches on the current device's stream
        raise ValueError(f"{name}: tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _stream_ptr(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {rc})")


def _law_specs(kind: str, law, lp) -> list:
    """``_check`` specs of the law-indexed variant's three per-lane inputs
    (none for a single-law call, which must not pass them)."""
    if kind != "indexed":
        if law is not None or lp is not None:
            raise ValueError(f"law / lp belong to kind='indexed', not {kind!r}")
        return []
    if law is None or lp is None or len(lp) != 2:
        raise ValueError("kind='indexed' needs law and lp=(s1, s2)")
    return [("law", law, torch.int32), ("s1", lp[0], torch.float64),
            ("s2", lp[1], torch.float64)]


def masked_stream_advance(mask, ctr, tm, key, mean, horizon, *, kind: str, param: float,
                          law=None, lp=None):
    """Advance the renewal-stream cursor ``(ctr, tm)`` by one event where
    ``mask`` (:func:`stream_advance`), **in place**: ``ctr`` (int32) and
    ``tm`` (f64) are both inputs and outputs, and are returned.  ``mask``
    is bool, ``key`` int64, ``mean`` / ``horizon`` f64, all flat ``(L,)``.
    ``kind="indexed"`` also takes the per-lane ``law`` (int32) and ``lp =
    (s1, s2)`` (f64).

    CUDA tensors launch ``sim_step_stream_advance`` (its ``_indexed``
    variant for ``kind="indexed"``); CPU tensors run the plain version.
    ``masked_stream_advance.launches`` counts the single-law kernel's
    launches, ``.indexed_launches`` the law-indexed kernel's."""
    f64 = torch.float64
    dev = _check("masked_stream_advance", [
        ("mask", mask, torch.bool), ("ctr", ctr, torch.int32),
        ("tm", tm, f64), ("key", key, torch.int64),
        ("mean", mean, f64), ("horizon", horizon, f64),
    ] + _law_specs(kind, law, lp))
    if dev.type == "cpu":
        c2, t2 = stream_advance(
            mask, ctr, tm, key, mean, horizon, kind=kind, param=param,
            law=law, lp=lp,
        )
        ctr.copy_(c2)
        tm.copy_(t2)
        return ctr, tm
    from . import build

    lib = build.load("sim_step")
    args = (tm.numel(), mask.data_ptr(), ctr.data_ptr(), tm.data_ptr(),
            key.data_ptr(), mean.data_ptr(), horizon.data_ptr())
    if kind == "indexed":
        rc = lib.sim_step_stream_advance_indexed(
            *args, law.data_ptr(), lp[0].data_ptr(), lp[1].data_ptr(),
            _stream_ptr(dev),
        )
    else:
        rc = lib.sim_step_stream_advance(
            *args, *law_constants(kind, param), _stream_ptr(dev)
        )
    _raise_on("masked_stream_advance", rc)
    if tm.numel():
        if kind == "indexed":
            masked_stream_advance.indexed_launches += 1
        else:
            masked_stream_advance.launches += 1
    return ctr, tm


masked_stream_advance.launches = 0
masked_stream_advance.indexed_launches = 0


def masked_primitive_update(
    prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
    *, eps: float, reg_cont: int, stream=None, gap=None,
):
    """One masked primitive per lane (:func:`primitive_update`), **in
    place**: ``t``, ``saved``, ``unsaved`` and ``pw`` are both inputs and
    outputs.  Returns ``(t, saved, unsaved, pw, flags)`` with a fresh int32
    ``flags``.

    With ``stream = (key, ctr, tm, mean, horizon)`` and ``gap = (kind,
    param)`` (device trace mode), ``tm`` must be the tensor ``nf`` itself:
    the lanes that faulted refill the strike cursor, ``ctr`` and
    ``nf`` are updated in place too, and ``(ctr, nf)`` is appended to the
    returned tuple.  The law-indexed variant takes the 8-tuple ``(key,
    ctr, tm, mean, horizon, law, s1, s2)`` with ``gap = ("indexed",
    0.0)``.  prim / cont / ctr / law are int32, key int64, the rest f64,
    all flat ``(L,)``.

    CUDA tensors launch ``sim_step_primitive_update`` (its ``_indexed``
    variant for the 8-tuple); CPU tensors run the plain version.
    ``masked_primitive_update.launches`` counts the single-law kernel's
    launches, ``.indexed_launches`` the law-indexed kernel's."""
    f64, i32 = torch.float64, torch.int32
    specs = [
        ("prim", prim, i32), ("cont", cont, i32), ("target", target, f64),
        ("ckend", ckend, f64), ("nf", nf, f64), ("t", t, f64),
        ("saved", saved, f64), ("unsaved", unsaved, f64), ("pw", pw, f64),
        ("W", W, f64), ("DR", DR, f64),
    ]
    indexed = False
    if stream is not None:
        if len(stream) not in (5, 8):
            raise ValueError("masked_primitive_update: stream must be a 5- or 8-tuple")
        skey, sctr, stm, smean, shorizon = stream[:5]
        if stm is not nf:
            raise ValueError(
                "masked_primitive_update: stream[2] must be the nf tensor"
            )
        indexed = gap[0] == "indexed"
        law, lp = (stream[5], stream[6:8]) if len(stream) == 8 else (None, None)
        specs += [
            ("key", skey, torch.int64), ("ctr", sctr, i32),
            ("mean", smean, f64), ("horizon", shorizon, f64),
        ] + _law_specs(gap[0], law, lp)
    dev = _check("masked_primitive_update", specs)
    if dev.type == "cpu":
        out = primitive_update(
            prim, cont, target, ckend, nf, t, saved, unsaved, pw, W, DR,
            eps=eps, reg_cont=reg_cont, stream=stream, gap=gap,
        )
        for dst, src in zip((t, saved, unsaved, pw), out[:4]):
            dst.copy_(src)
        if stream is None:
            return t, saved, unsaved, pw, out[4]
        sctr.copy_(out[5])
        nf.copy_(out[6])
        return t, saved, unsaved, pw, out[4], sctr, nf
    from . import build

    lib = build.load("sim_step")
    flags = torch.empty_like(prim)
    head = (
        t.numel(), prim.data_ptr(), cont.data_ptr(), target.data_ptr(),
        ckend.data_ptr(), nf.data_ptr(), t.data_ptr(), saved.data_ptr(),
        unsaved.data_ptr(), pw.data_ptr(), W.data_ptr(), DR.data_ptr(),
        flags.data_ptr(), float(eps), int(reg_cont),
    )
    if indexed:
        rc = lib.sim_step_primitive_update_indexed(
            *head, skey.data_ptr(), sctr.data_ptr(), smean.data_ptr(),
            shorizon.data_ptr(), *(x.data_ptr() for x in stream[5:8]),
            _stream_ptr(dev),
        )
    else:
        if stream is None:
            law, p1, p2 = LAW_EXPONENTIAL, 0.0, 0.0
            gen, kptr, cptr, mptr, hptr = 0, None, None, None, None
        else:
            law, p1, p2 = law_constants(*gap)
            gen = 1
            kptr, cptr = skey.data_ptr(), sctr.data_ptr()
            mptr, hptr = smean.data_ptr(), shorizon.data_ptr()
        rc = lib.sim_step_primitive_update(
            *head, gen, kptr, cptr, mptr, hptr, law, p1, p2, _stream_ptr(dev),
        )
    _raise_on("masked_primitive_update", rc)
    if t.numel():
        if indexed:
            masked_primitive_update.indexed_launches += 1
        else:
            masked_primitive_update.launches += 1
    if stream is None:
        return t, saved, unsaved, pw, flags
    return t, saved, unsaved, pw, flags, sctr, nf


masked_primitive_update.launches = 0
masked_primitive_update.indexed_launches = 0


# --------------------------------------------------------------------------- #
# Cell multiplexing (fused experiment sweeps)
# --------------------------------------------------------------------------- #
def cell_gather(consts: dict, cidx: torch.Tensor, keys) -> dict:
    """Broadcast per-cell table rows to per-lane tensors: a copy of
    ``consts`` with every key of ``keys`` present in it gathered by the
    lane -> cell index ``cidx``."""
    out = dict(consts)
    for k in keys:
        if k in consts:
            out[k] = consts[k].index_select(0, cidx)
    return out


def segment_cell_sums(values, cidx: torch.Tensor, num_cells: int) -> torch.Tensor:
    """Per-cell sums of per-lane columns: a ``(num_cells, len(values))``
    f64 matrix whose row ``c`` sums the lanes with ``cidx == c``.

    On CUDA ``index_add_`` adds in no fixed order: columns holding integer
    values (lane counts, event counters) stay exact in f64, while the
    makespan and waste moments agree with a sequential sum only to
    rounding."""
    x = torch.stack([v.to(torch.float64) for v in values], dim=-1)
    out = torch.zeros(num_cells, x.shape[1], dtype=torch.float64, device=x.device)
    return out.index_add_(0, cidx, x)


# --------------------------------------------------------------------------- #
# Sample lane states (kernel checks and timings)
# --------------------------------------------------------------------------- #
def sample_lane_state(L: int, seed: int) -> dict:
    """Seeded NumPy lane states of the kind the lane machine hands the two
    kernels: every primitive kind, faults before and after the targets,
    finishing and non-finishing work, live and retiring streams, half the
    lanes masked.  ``key`` holds uint64 fault-stream keys."""
    rng = np.random.default_rng(seed)
    W = 8 * 86400.0
    t = rng.uniform(0.0, 1.2 * W, L)
    return {
        "prim": rng.integers(0, 5, L).astype(np.int32),
        "cont": rng.integers(-1, 9, L).astype(np.int32),
        "target": t + rng.uniform(0.0, 2e4, L),
        "ckend": t + 600.0,
        "nf": t + rng.uniform(-1e3, 2e4, L),
        "t": t,
        "saved": np.where(rng.random(L) < 0.5, W - rng.uniform(0.0, 2e4, L),
                          rng.uniform(0.0, W, L)),
        "unsaved": rng.uniform(0.0, 5e3, L),
        "pw": rng.uniform(0.0, 5e3, L),
        "W": np.full(L, W),
        "DR": np.full(L, 660.0),
        "key": stream_key64_np(seed, np.arange(L), STREAM_FAULT_GAP),
        "ctr": rng.integers(-1, 5000, L).astype(np.int32),
        "mean": rng.uniform(1e3, 2.5e5, L),
        "horizon": np.where(rng.random(L) < 0.9, 12 * W, t + 1e4),
        "mask": rng.random(L) < 0.5,
    }


#: the laws the law-indexed checks draw lanes from: every family, and both
#: Weibull strength reductions (k = 0.5 gives s2 = 2.0, k = 2.0 s2 = 0.5)
SAMPLE_LAWS = (("exponential", 0.0), ("weibull", 0.7), ("weibull", 0.5),
               ("weibull", 2.0), ("lognormal", 1.0), ("uniform", 0.0))


def sample_lane_laws(L: int, seed: int, block: int = 1) -> dict:
    """Seeded per-lane inputs of the law-indexed variant: each run of
    ``block`` lanes takes one law of :data:`SAMPLE_LAWS` (``block=1``
    mixes laws lane by lane; the sweep's lanes come in runs of one cell).
    ``pick`` is each lane's index into :data:`SAMPLE_LAWS`; ``law``,
    ``s1``, ``s2`` are :func:`law_constants`' values."""
    rng = np.random.default_rng(seed)
    pick = np.repeat(rng.integers(0, len(SAMPLE_LAWS), -(-L // block)), block)[:L]
    consts = np.array([law_constants(k, p) for k, p in SAMPLE_LAWS])
    return {"pick": pick, "law": consts[pick, 0].astype(np.int32),
            "s1": consts[pick, 1], "s2": consts[pick, 2]}


def lane_state_tensors(x: dict, device) -> dict:
    """:func:`sample_lane_state`'s arrays as the wrappers take them, on
    ``device``: the uint64 keys as int64 bit patterns."""
    out = {k: torch.from_numpy(np.array(v)) for k, v in x.items() if k != "key"}
    out["key"] = torch.from_numpy(np.ascontiguousarray(x["key"], np.uint64).view(np.int64))
    return {k: v.to(device) for k, v in out.items()}
