"""Trace specification and the counter-based RNG of the device trace mode.

The port's own copy of the parts of the reference ``repro.core.events``
that the fused paper-grid sweep and the server need: the Section
2.3 rate identities, the inter-arrival law descriptors (sampled on the
device through :mod:`repro_torch.kernels.sim_step`, and on the host with
NumPy for the scalar traces), the scalar merged trace
:func:`make_event_trace` (the server's wall-clock faults), the
NumPy Threefry-2x32 / SplitMix64 generators that derive each lane's
stream keys on the host, the cell-indexed :class:`TraceSpec` and its
mixed-law layout (:func:`law_table`, :func:`gap_transform_indexed_np`).

Stream layout (the reproducibility contract, shared with the reference):
lane ``i`` owns the 64-bit stream id ``spec.stream[i]``; its per-kind
subkey is ``threefry2x32(seed_words, (stream_lo, stream_hi << 4 | kind))``
packed into one 64-bit SplitMix key; draw ``n`` of a stream is
``splitmix64(key, n)``.  ``tests/test_torch_host.py`` holds every function
here against the reference bit for bit.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "Distribution",
    "exponential",
    "weibull",
    "lognormal",
    "uniform",
    "FaultEvent",
    "PredictionEvent",
    "EventTrace",
    "make_event_trace",
    "TraceSpec",
    "make_trace_spec",
    "law_constants",
    "law_table",
    "gap_transform_indexed_np",
    "require_inverse_cdf",
    "mu_np",
    "mu_p",
    "mu_e",
    "false_prediction_mtbf",
    "false_prediction_mtbf_batch",
    "threefry2x32",
    "splitmix64",
    "uniform24",
    "stream_subkey_np",
    "stream_key64_np",
]


# --------------------------------------------------------------------------- #
# Rate identities (Section 2.3)
# --------------------------------------------------------------------------- #
def mu_np(mu: float, r: float) -> float:
    """Mean time between *unpredicted* faults: mu / (1 - r)."""
    if r >= 1.0:
        return math.inf
    return mu / (1.0 - r)


def mu_p(mu: float, r: float, p: float) -> float:
    """Mean time between *predicted events* (true + false positives): p mu / r."""
    if r <= 0.0:
        return math.inf
    return p * mu / r


def mu_e(mu: float, r: float, p: float) -> float:
    """Mean time between events of any type: 1/mu_e = 1/mu_P + 1/mu_NP."""
    inv = 0.0
    mp = mu_p(mu, r, p)
    mnp = mu_np(mu, r)
    if math.isfinite(mp):
        inv += 1.0 / mp
    if math.isfinite(mnp):
        inv += 1.0 / mnp
    if inv == 0.0:
        return math.inf
    return 1.0 / inv


def false_prediction_mtbf(mu: float, r: float, p: float) -> float:
    """Mean inter-arrival time of *false* predictions: p mu / (r (1 - p))."""
    if r <= 0.0 or p >= 1.0:
        return math.inf
    return p * mu / (r * (1.0 - p))


def false_prediction_mtbf_batch(
    mtbf: np.ndarray, recall: np.ndarray, precision: np.ndarray
) -> np.ndarray:
    """Vectorized :func:`false_prediction_mtbf` (``+inf`` where no false
    predictions occur)."""
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        return np.where(
            (recall > 0.0) & (precision < 1.0),
            precision * mtbf / np.maximum(recall * (1.0 - precision), 1e-300),
            np.inf,
        )


# --------------------------------------------------------------------------- #
# Inter-arrival laws
# --------------------------------------------------------------------------- #
#: the families the device sampler implements, by launch code
LAW_EXPONENTIAL, LAW_WEIBULL, LAW_LOGNORMAL, LAW_UNIFORM = range(4)
LAW_INDEX = {
    "exponential": LAW_EXPONENTIAL,
    "weibull": LAW_WEIBULL,
    "lognormal": LAW_LOGNORMAL,
    "uniform": LAW_UNIFORM,
}


@dataclass(frozen=True)
class Distribution:
    """A positive inter-arrival law with a given mean, named by its family
    (``kind``) and shape (``param``: Weibull k, lognormal sigma).  The
    sweep samples it on the device (inverse CDF of a counter draw);
    :meth:`sample` draws on the host with the reference's NumPy calls, so
    a scalar trace equals the reference's at the same seed."""

    name: str
    kind: str
    param: float = 0.0

    def sample(self, rng: np.random.Generator, mean: float, n: int) -> np.ndarray:
        if self.kind == "exponential":
            return rng.exponential(mean, size=n)
        if self.kind == "weibull":
            # E[X] = scale * Gamma(1 + 1/k) = mean
            return mean / math.gamma(1.0 + 1.0 / self.param) * rng.weibull(self.param, size=n)
        if self.kind == "lognormal":
            # E[X] = exp(mu + sigma^2 / 2) = mean
            mu_ln = math.log(mean) - self.param * self.param / 2.0
            return rng.lognormal(mu_ln, self.param, size=n)
        if self.kind == "uniform":
            return rng.uniform(0.0, 2.0 * mean, size=n)  # U(0, 2 mean)
        raise ValueError(f"no host sampler for {self.name!r}")


def exponential() -> Distribution:
    return Distribution("exponential", "exponential")


def weibull(shape: float) -> Distribution:
    return Distribution(f"weibull(k={shape})", "weibull", shape)


def lognormal(sigma: float = 1.0) -> Distribution:
    return Distribution(f"lognormal(sigma={sigma})", "lognormal", sigma)


def uniform() -> Distribution:
    return Distribution("uniform", "uniform")


# --------------------------------------------------------------------------- #
# Scalar merged traces (host)
# --------------------------------------------------------------------------- #
@dataclass(order=True)
class FaultEvent:
    """A fault at absolute ``time``; ``predicted`` marks true positives."""

    time: float
    predicted: bool = field(default=False, compare=False)


@dataclass(order=True)
class PredictionEvent:
    """A prediction with window ``[t0, t0 + window]``, announced ``lead``
    before ``t0``; ``fault_time`` is None for false positives."""

    t0: float
    window: float = field(default=0.0, compare=False)
    fault_time: Optional[float] = field(default=None, compare=False)
    lead: float = field(default=math.inf, compare=False)


@dataclass
class EventTrace:
    """A merged trace of faults and predictions over ``[0, horizon]``."""

    horizon: float
    faults: List[FaultEvent]
    predictions: List[PredictionEvent]


def _arrival_times(rng: np.random.Generator, dist: Distribution, mean: float,
                   horizon: float) -> np.ndarray:
    """Cumulative renewal arrivals in (0, horizon], drawn in blocks."""
    if not math.isfinite(mean):
        return np.empty(0)
    times: List[float] = []
    t = 0.0
    expected = max(16, int(horizon / mean * 1.5) + 8)
    while t < horizon:
        block = np.maximum(dist.sample(rng, mean, expected), 1e-9)
        cum = t + np.cumsum(block)
        keep = cum[cum <= horizon]
        times.extend(keep.tolist())
        if len(keep) < len(cum):
            break
        t = float(cum[-1])
    return np.asarray(times)


def make_event_trace(
    rng: np.random.Generator,
    horizon: float,
    mtbf: float,
    recall: float,
    precision: float,
    window: float = 0.0,
    lead: float = math.inf,
    fault_dist: Optional[Distribution] = None,
    false_pred_dist: Optional[Distribution] = None,
) -> EventTrace:
    """The paper's merged trace (Section 5), drawn as the reference's
    ``make_event_trace`` draws it (single renewal stream): faults of mean
    ``mtbf``; each predicted with probability ``recall``, its window placed
    so that the fault is uniform inside it; false predictions of mean
    ``p mu / (r (1 - p))``; merged and sorted."""
    fault_dist = fault_dist or exponential()
    false_pred_dist = false_pred_dist or fault_dist
    faults = [FaultEvent(float(t)) for t in _arrival_times(rng, fault_dist, mtbf, horizon)]
    predictions: List[PredictionEvent] = []
    for f in faults:
        if rng.random() < recall:
            f.predicted = True
            offset = rng.uniform(0.0, window) if window > 0 else 0.0
            predictions.append(PredictionEvent(
                t0=max(0.0, f.time - offset), window=window, fault_time=f.time, lead=lead))
    fp_mean = false_prediction_mtbf(mtbf, recall, precision)
    for t in _arrival_times(rng, false_pred_dist, fp_mean, horizon):
        predictions.append(PredictionEvent(t0=float(t), window=window, fault_time=None, lead=lead))
    faults.sort()
    predictions.sort()
    return EventTrace(horizon=horizon, faults=faults, predictions=predictions)


# --------------------------------------------------------------------------- #
# Counter-based RNG (host side: subkey derivation)
# --------------------------------------------------------------------------- #
(
    STREAM_FAULT_GAP,  # fault inter-arrival time i
    STREAM_TP_COIN,  # fault i: word0 = predicted coin, word1 = window offset
    STREAM_FP_GAP,  # false-prediction inter-arrival time j
    STREAM_TP_TRUST,  # trust coin for fault i's prediction (0 < q < 1 only)
    STREAM_FP_TRUST,  # trust coin for false prediction j (0 < q < 1 only)
    STREAM_TIER,  # recovery-tier coin for fault i (two-level strategies)
) = range(6)

#: Threefry-2x32 key-schedule parity constant (Salmon et al., SC'11)
_TF_PARITY = 0x1BD11BDA
#: Threefry-2x32 rotation schedule (repeating groups of four rounds)
_TF_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Random123 default round count
THREEFRY_ROUNDS = 20

#: SplitMix64 constants (Vigna; Stafford Mix13 finalizer)
_SM_GAMMA = 0x9E3779B97F4A7C15
_SM_MIX1 = 0xBF58476D1CE4E5B9
_SM_MIX2 = 0x94D049BB133111EB


def threefry2x32(k0, k1, c0, c1, rounds: int = THREEFRY_ROUNDS):
    """Vectorized Threefry-2x32 block cipher over ``uint32`` words
    (Random123 layout: key injection after every fourth round)."""
    k0 = np.asarray(k0, np.uint32)
    k1 = np.asarray(k1, np.uint32)
    x0 = np.asarray(c0, np.uint32)
    x1 = np.asarray(c1, np.uint32)
    with np.errstate(over="ignore"):
        ks = (k0, k1, k0 ^ k1 ^ np.uint32(_TF_PARITY))
        x0 = x0 + ks[0]
        x1 = x1 + ks[1]
        for i in range(rounds):
            r = _TF_ROTATIONS[(i // 4) % 2][i % 4]
            x0 = x0 + x1
            x1 = (x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))
            x1 = x1 ^ x0
            if i % 4 == 3:
                s = i // 4 + 1
                x0 = x0 + ks[s % 3]
                x1 = x1 + ks[(s + 1) % 3] + np.uint32(s)
    return x0, x1


def splitmix64(key64, ctr):
    """Counter-indexed SplitMix64 draw: ``mix(key64 + (ctr + 1) * GAMMA)``
    as its (high, low) ``uint32`` words."""
    key64 = np.asarray(key64, np.uint64)
    with np.errstate(over="ignore"):
        z = key64 + (np.asarray(ctr, np.uint64) + np.uint64(1)) * np.uint64(
            _SM_GAMMA
        )
        z = (z ^ (z >> np.uint64(30))) * np.uint64(_SM_MIX1)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(_SM_MIX2)
        z = z ^ (z >> np.uint64(31))
    return (z >> np.uint64(32)).astype(np.uint32), z.astype(np.uint32)


def uniform24(bits, dtype=np.float64):
    """``uint32`` words -> uniforms in the open interval (0, 1): the top 24
    bits, centered by half an ulp."""
    return ((bits >> np.uint32(8)).astype(dtype) + dtype(0.5)) * dtype(2.0**-24)


def stream_subkey_np(seed: int, stream, kind: int):
    """Per-(lane-stream, kind) Threefry subkey pair: the seed splits into
    the two key words, the counter words carry the 64-bit stream id (high
    word shifted past the 4-bit kind tag)."""
    stream = np.asarray(stream, np.int64)
    s0 = np.uint32(seed & 0xFFFFFFFF)
    s1 = np.uint32((seed >> 32) & 0xFFFFFFFF)
    c0 = (stream & 0xFFFFFFFF).astype(np.uint32)
    c1 = ((((stream >> 32) << 4) | kind) & 0xFFFFFFFF).astype(np.uint32)
    return threefry2x32(s0, s1, c0, c1)


def stream_key64_np(seed: int, stream, kind: int) -> np.ndarray:
    """The 64-bit SplitMix stream key: the two Threefry subkey words packed
    ``(high << 32) | low``."""
    k0, k1 = stream_subkey_np(seed, stream, kind)
    return (k0.astype(np.uint64) << np.uint64(32)) | k1.astype(np.uint64)


# --------------------------------------------------------------------------- #
# Mixed-law layout: the failure law as per-cell data
# --------------------------------------------------------------------------- #
def require_inverse_cdf(dist: Distribution) -> None:
    """Raise unless ``dist`` names a family the device sampler supports."""
    if dist.kind not in LAW_INDEX:
        raise ValueError(
            f"distribution {dist.name!r} has no inverse-CDF kind; the device "
            "sampler supports exponential/weibull/lognormal/uniform"
        )


def law_constants(kind: str, param: float):
    """``(law, p1, p2)``: the law code and the two shape constants folded
    on the host in Python doubles, as the reference folds them — Weibull
    ``p1 = 1/Γ(1 + 1/k)``, ``p2 = 1/k``; lognormal ``p1 = σ``,
    ``p2 = σ²/2``; none for the exponential and uniform laws."""
    if kind not in LAW_INDEX:
        raise ValueError(f"unsupported gap kind {kind!r}")
    law = LAW_INDEX[kind]
    if law == LAW_WEIBULL:
        return law, 1.0 / math.gamma(1.0 + 1.0 / param), 1.0 / param
    if law == LAW_LOGNORMAL:
        return law, float(param), 0.5 * param * param
    return law, 0.0, 0.0


def law_table(dists):
    """Per-cell law table of a distribution sequence: ``(law, lp)`` with
    ``law`` an ``(n,)`` int32 law-code column and ``lp`` an ``(n, 4)`` f64
    row ``[param, s1, s2, 0]``, the slots ``s1`` / ``s2`` being
    :func:`law_constants`' ``p1`` / ``p2`` (the single-law sampler's
    constants, so the law-indexed sampler gives each law its bits) and
    ``param`` zero for the exponential and uniform laws."""
    dists = tuple(dists)
    law = np.zeros(len(dists), np.int32)
    lp = np.zeros((len(dists), 4), np.float64)
    for i, d in enumerate(dists):
        require_inverse_cdf(d)
        law[i], lp[i, 1], lp[i, 2] = law_constants(d.kind, d.param)
        if law[i] in (LAW_WEIBULL, LAW_LOGNORMAL):
            lp[i, 0] = d.param
    return law, lp


def gap_transform_indexed_np(law, s1, s2, mean, x0, x1):
    """Law-indexed inverse-CDF gap of counter draws (NumPy): ``law``
    selects the family per element, ``(s1, s2)`` are :func:`law_table`'s
    slots; all inputs broadcast.  Every family's expression is evaluated
    and a ``where`` chain selects, in the order of
    ``kernels.sim_step.gap_transform_indexed``.  Clamped to the ``1e-9``
    zero-gap guard."""
    u = uniform24(x0)
    nlog = -np.log1p(-u)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        g_exp = nlog * mean
        # NumPy's scalar pow fast paths (x ** 2.0 -> x * x, x ** 0.5 ->
        # sqrt), so a data-driven exponent gives the single-law bits
        p = np.power(nlog, s2)
        p = np.where(s2 == 2.0, nlog * nlog, p)
        p = np.where(s2 == 0.5, np.sqrt(nlog), p)
        g_wei = (np.asarray(mean) * s1) * p
        z = np.sqrt(-2.0 * np.log(u)) * np.cos(2.0 * np.pi * uniform24(x1))
        g_log = np.exp(np.log(mean) - s2 + s1 * z)
        g_uni = 2.0 * np.asarray(mean) * u
    g = np.where(
        law == LAW_WEIBULL, g_wei,
        np.where(law == LAW_LOGNORMAL, g_log,
                 np.where(law == LAW_UNIFORM, g_uni, g_exp)),
    )
    return np.maximum(g, 1e-9)


# --------------------------------------------------------------------------- #
# Trace specification
# --------------------------------------------------------------------------- #
#: one law for every cell, or a tuple of laws, one per cell row
Laws = Union[Distribution, tuple]


@dataclass
class TraceSpec:
    """A generative, cell-indexed trace batch: one parameter row per
    experiment cell, plus per-lane RNG stream ids and the lane -> cell
    index.  Lane ``i``'s faults and predictions are a pure function of
    ``(seed, stream[i])``; lanes sharing a stream id face identical traces
    (the paired experiment design).

    **Mixed-law layout**: ``fault_dist`` / ``false_pred_dist`` may each be
    a tuple of distributions, one per cell row.  The law then rides the
    cell tables as data (:func:`law_table`) and the engine draws through
    the law-indexed sampler, so a grid mixing laws runs as one dispatch.
    Build such specs with :meth:`concat_cells`, :meth:`indexed` or by
    passing distribution sequences to :func:`make_trace_spec`."""

    horizon: np.ndarray  # (n_cells,)
    mtbf: np.ndarray  # (n_cells,)
    recall: np.ndarray  # (n_cells,)
    precision: np.ndarray  # (n_cells,)
    window: np.ndarray  # (n_cells,)
    lead: np.ndarray  # (n_cells,)
    fault_dist: Laws
    false_pred_dist: Laws
    seed: int
    stream: np.ndarray  # (L,) int64 global RNG stream ids
    cell_index: np.ndarray  # (L,) int32 lane -> cell row

    @property
    def n_lanes(self) -> int:
        return int(self.stream.shape[0])

    @property
    def n_cells(self) -> int:
        return int(self.horizon.shape[0])

    @property
    def fp_mean(self) -> np.ndarray:
        """False-prediction mean inter-arrival, one row per cell."""
        return false_prediction_mtbf_batch(self.mtbf, self.recall, self.precision)

    @classmethod
    def concat_cells(cls, specs) -> "TraceSpec":
        """Concatenate cell-indexed specs (one per law family, disjoint
        stream ids, one seed) into one mixed-law spec: the cell tables
        stack, each lane's cell index is offset into the stacked table,
        and the per-cell law tuples make the law a data column.  Lanes
        keep their order and stream ids, so their events are unchanged."""
        specs = list(specs)
        if not specs:
            raise ValueError("concat_cells needs at least one spec")
        seed = specs[0].seed
        if any(s.seed != seed for s in specs):
            raise ValueError("concat_cells requires a shared seed")

        def rows(d, n):
            return tuple(d) if isinstance(d, tuple) else (d,) * n

        fd: list = []
        fpd: list = []
        ci = []
        off = 0
        for s in specs:
            fd += rows(s.fault_dist, s.n_cells)
            fpd += rows(s.false_pred_dist, s.n_cells)
            ci.append(s.cell_index.astype(np.int64) + off)
            off += s.n_cells

        def cat(name):
            return np.concatenate([getattr(s, name) for s in specs])

        return cls(
            horizon=cat("horizon"), mtbf=cat("mtbf"),
            recall=cat("recall"), precision=cat("precision"),
            window=cat("window"), lead=cat("lead"),
            fault_dist=tuple(fd), false_pred_dist=tuple(fpd),
            seed=seed, stream=cat("stream"),
            cell_index=np.concatenate(ci).astype(np.int32),
        )

    def indexed(self) -> "TraceSpec":
        """The same spec on the law-indexed sampler: a shared
        ``Distribution`` becomes the per-row tuple (identity when already
        tuple-valued).  The same streams, drawn through the law-indexed
        transform: the bit-exact control of the one-dispatch mixed-law
        run."""

        def tup(d):
            return d if isinstance(d, tuple) else (d,) * self.n_cells

        return replace(
            self,
            fault_dist=tup(self.fault_dist),
            false_pred_dist=tup(self.false_pred_dist),
        )


def _bc(x, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(x, dtype=np.float64), (n,)).copy()


def make_trace_spec(
    n_traces: int,
    horizon,
    mtbf,
    recall,
    precision,
    window=0.0,
    lead=math.inf,
    fault_dist: Union[Distribution, Sequence[Distribution], None] = None,
    false_pred_dist: Union[Distribution, Sequence[Distribution], None] = None,
    seed: int = 0,
    stream: Optional[Sequence[int]] = None,
    cell_index: Optional[Sequence[int]] = None,
) -> TraceSpec:
    """Build a cell-indexed :class:`TraceSpec`: the trace parameters
    describe cells (broadcast to ``max(cell_index) + 1`` rows) and the
    ``n_traces`` lanes map onto them by ``cell_index``.  ``stream``
    defaults to ``arange(n_traces)``; ``false_pred_dist`` defaults to the
    fault law.  Either law may also be a sequence of distributions, one
    per cell: the mixed-law layout."""
    L = int(n_traces)
    if stream is None:
        stream = np.arange(L, dtype=np.int64)
    else:
        stream = np.asarray(stream, dtype=np.int64)
        if stream.shape != (L,):
            raise ValueError(f"stream must have shape ({L},), got {stream.shape}")
    if cell_index is None:
        raise ValueError("the port supports the cell-indexed layout only")
    cell_index = np.asarray(cell_index, dtype=np.int32)
    if cell_index.shape != (L,):
        raise ValueError(
            f"cell_index must have shape ({L},), got {cell_index.shape}"
        )
    if L and cell_index.min() < 0:
        raise ValueError("cell_index entries must be >= 0")
    n_par = int(cell_index.max()) + 1 if L else 0

    def dists(d, name):
        if isinstance(d, Distribution):
            require_inverse_cdf(d)
            return d
        d = tuple(d)
        if len(d) != n_par:
            raise ValueError(
                f"{name} sequence must have one entry per cell ({n_par}), "
                f"got {len(d)}"
            )
        for x in d:
            require_inverse_cdf(x)
        return d

    fault_dist = dists(
        exponential() if fault_dist is None else fault_dist, "fault_dist"
    )
    false_pred_dist = dists(
        fault_dist if false_pred_dist is None else false_pred_dist,
        "false_pred_dist",
    )
    return TraceSpec(
        horizon=_bc(horizon, n_par),
        mtbf=_bc(mtbf, n_par),
        recall=_bc(recall, n_par),
        precision=_bc(precision, n_par),
        window=_bc(window, n_par),
        lead=_bc(lead, n_par),
        fault_dist=fault_dist,
        false_pred_dist=false_pred_dist,
        seed=int(seed),
        stream=stream,
        cell_index=cell_index,
    )
