"""Trace specification and the counter-based RNG of the device trace mode.

The port's own copy of the parts of the reference ``repro.core.events``
that the fused paper-grid sweep and the server need: the Section
2.3 rate identities, the inter-arrival law descriptors (sampled on the
device through :mod:`repro_torch.kernels.sim_step`, and on the host with
NumPy for the scalar traces), the scalar merged trace
:func:`make_event_trace` (the server's wall-clock faults), the
NumPy Threefry-2x32 / SplitMix64 generators that derive each lane's
stream keys on the host, the cell-indexed :class:`TraceSpec` and its
mixed-law layout (:func:`law_table`, :func:`gap_transform_indexed_np`),
and the host trace mode's batched traces: :class:`BatchTraces` (``(lanes,
events)`` arrays), :func:`make_event_traces_batch` (single renewal
streams, or the superposition of ``n_components`` component renewals,
fresh or stationary) and :meth:`TraceSpec.materialize`, the host replay
of the device streams.

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
    "BatchTraces",
    "pad_sentinel",
    "superposed_fault_times_batch",
    "make_event_traces_batch",
    "gap_transform_np",
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
    """A fault at absolute ``time``; ``predicted`` marks true positives.
    ``tier_u`` is the recovery-tier uniform of two-level strategies
    (``tier_u >= f`` sends the recovery to the disk tier; the 1.0 default
    means disk)."""

    time: float
    predicted: bool = field(default=False, compare=False)
    tier_u: float = field(default=1.0, compare=False)


@dataclass(order=True)
class PredictionEvent:
    """A prediction with window ``[t0, t0 + window]``, announced ``lead``
    before ``t0``; ``fault_time`` is None for false positives."""

    t0: float
    window: float = field(default=0.0, compare=False)
    fault_time: Optional[float] = field(default=None, compare=False)
    lead: float = field(default=math.inf, compare=False)

    @property
    def is_true_positive(self) -> bool:
        return self.fault_time is not None

    @property
    def announce_time(self) -> float:
        if math.isinf(self.lead):
            return -math.inf
        return self.t0 - self.lead


@dataclass
class EventTrace:
    """A merged trace of faults and predictions over ``[0, horizon]``."""

    horizon: float
    faults: List[FaultEvent]
    predictions: List[PredictionEvent]

    @property
    def n_true_positive(self) -> int:
        return sum(1 for p in self.predictions if p.is_true_positive)

    @property
    def n_false_positive(self) -> int:
        return sum(1 for p in self.predictions if not p.is_true_positive)

    @property
    def n_false_negative(self) -> int:
        return sum(1 for f in self.faults if not f.predicted)

    def empirical_recall(self) -> float:
        tp = self.n_true_positive
        fn = self.n_false_negative
        return tp / (tp + fn) if tp + fn else 0.0

    def empirical_precision(self) -> float:
        tp = self.n_true_positive
        fp = self.n_false_positive
        return tp / (tp + fp) if tp + fp else 0.0


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
# Batched traces (the host trace mode: one lane per trace)
# --------------------------------------------------------------------------- #
def pad_sentinel(
    a: np.ndarray,
    counts: np.ndarray,
    fill,
    round_pow2: bool = False,
    min_width: int = 1,
) -> np.ndarray:
    """Cursor-ready event array: at least one all-``fill`` column past
    every lane's ``counts[i]`` valid events (the engines' cursors stop on
    it instead of checking bounds).  Arrays already wide enough are
    returned as they are; ``round_pow2`` rounds the column count up to a
    power of two."""
    need = (int(counts.max()) if counts.size else 0) + 1
    need = max(need, min_width)
    if round_pow2:
        need = 1 << (need - 1).bit_length()
    if a.shape[1] >= need:
        return a
    pad = np.full((a.shape[0], need - a.shape[1]), fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=1)


@dataclass
class BatchTraces:
    """``n_traces`` merged event traces as padded 2-D arrays, one lane per
    trace and one column per event.  Rows are sorted in time; columns past
    a lane's event count hold ``+inf`` (``NaN`` in ``pred_fault``), and
    generated batches carry at least one such trailing column, the
    cursors' sentinel.  ``lane(i)`` is the scalar :class:`EventTrace` of
    lane ``i``."""

    horizon: np.ndarray  # (L,) per-lane horizon
    fault_times: np.ndarray  # (L, F) sorted fault dates, +inf padded
    fault_predicted: np.ndarray  # (L, F) bool, true-positive marks
    n_faults: np.ndarray  # (L,) valid fault count per lane
    pred_t0: np.ndarray  # (L, P) sorted window starts, +inf padded
    pred_fault: np.ndarray  # (L, P) matched fault date, NaN for false positives
    n_preds: np.ndarray  # (L,) valid prediction count per lane
    window: np.ndarray  # (L,) prediction-window length
    lead: np.ndarray  # (L,) announce lead
    #: (L, F) per-fault recovery-tier uniforms (two-level strategies;
    #: ``None`` on batches generated without ``tier=True``)
    fault_tier: Optional[np.ndarray] = None

    @property
    def n_lanes(self) -> int:
        return int(self.fault_times.shape[0])

    def lane(self, i: int) -> EventTrace:
        """Scalar :class:`EventTrace` view of lane ``i``."""
        nf = int(self.n_faults[i])
        npred = int(self.n_preds[i])
        tiers = (
            self.fault_tier[i, :nf] if self.fault_tier is not None else np.ones(nf)
        )
        faults = [
            FaultEvent(float(t), predicted=bool(p), tier_u=float(u))
            for t, p, u in zip(
                self.fault_times[i, :nf], self.fault_predicted[i, :nf], tiers
            )
        ]
        w, ld = float(self.window[i]), float(self.lead[i])
        preds = []
        for j in range(npred):
            ft = float(self.pred_fault[i, j])
            preds.append(PredictionEvent(
                t0=float(self.pred_t0[i, j]), window=w,
                fault_time=None if math.isnan(ft) else ft, lead=ld,
            ))
        return EventTrace(horizon=float(self.horizon[i]), faults=faults, predictions=preds)

    def tile(self, reps: int) -> "BatchTraces":
        """The whole batch ``reps`` times over (lanes [0..L), then [0..L)
        again, ...)."""
        return BatchTraces(
            horizon=np.tile(self.horizon, reps),
            fault_times=np.tile(self.fault_times, (reps, 1)),
            fault_predicted=np.tile(self.fault_predicted, (reps, 1)),
            n_faults=np.tile(self.n_faults, reps),
            pred_t0=np.tile(self.pred_t0, (reps, 1)),
            pred_fault=np.tile(self.pred_fault, (reps, 1)),
            n_preds=np.tile(self.n_preds, reps),
            window=np.tile(self.window, reps),
            lead=np.tile(self.lead, reps),
            fault_tier=(
                None if self.fault_tier is None else np.tile(self.fault_tier, (reps, 1))
            ),
        )

    def take(self, rows) -> "BatchTraces":
        """The batch whose lane ``i`` is lane ``rows[i]`` of this one (rows
        may repeat: cells sharing traces)."""
        rows = np.asarray(rows)
        return BatchTraces(
            horizon=self.horizon[rows],
            fault_times=self.fault_times[rows],
            fault_predicted=self.fault_predicted[rows],
            n_faults=self.n_faults[rows],
            pred_t0=self.pred_t0[rows],
            pred_fault=self.pred_fault[rows],
            n_preds=self.n_preds[rows],
            window=self.window[rows],
            lead=self.lead[rows],
            fault_tier=None if self.fault_tier is None else self.fault_tier[rows],
        )

    @staticmethod
    def concat(parts: Sequence["BatchTraces"]) -> "BatchTraces":
        """Stack batches into one, the event columns padded to the widest
        part; lanes without tier draws get the 1.0 (disk) fill."""

        def cat2(arrs: List[np.ndarray], fill) -> np.ndarray:
            width = max(a.shape[1] for a in arrs)
            padded = [
                a if a.shape[1] == width else np.concatenate(
                    [a, np.full((a.shape[0], width - a.shape[1]), fill, a.dtype)],
                    axis=1,
                )
                for a in arrs
            ]
            return np.concatenate(padded, axis=0)

        if any(p.fault_tier is not None for p in parts):
            tier = cat2(
                [p.fault_tier if p.fault_tier is not None else np.ones(p.fault_times.shape)
                 for p in parts],
                1.0,
            )
        else:
            tier = None
        return BatchTraces(
            horizon=np.concatenate([p.horizon for p in parts]),
            fault_times=cat2([p.fault_times for p in parts], np.inf),
            fault_predicted=cat2([p.fault_predicted for p in parts], False),
            n_faults=np.concatenate([p.n_faults for p in parts]),
            pred_t0=cat2([p.pred_t0 for p in parts], np.inf),
            pred_fault=cat2([p.pred_fault for p in parts], np.nan),
            n_preds=np.concatenate([p.n_preds for p in parts]),
            window=np.concatenate([p.window for p in parts]),
            lead=np.concatenate([p.lead for p in parts]),
            fault_tier=tier,
        )


def _arrival_times_batch(
    rng: np.random.Generator,
    dist: Distribution,
    means: np.ndarray,
    horizons: np.ndarray,
    max_block: int = 4_000_000,
) -> tuple:
    """Batched renewal arrivals in ``(0, horizon_i]`` per lane: ``(times
    (L, W) +inf padded, counts (L,))``, drawn as the reference draws them.
    Every law is a scale family, so gaps are drawn at mean 1 and scaled by
    the lane's mean.  A first ``(L, m)`` block is sized to the largest
    expected count; lanes short of their horizon then draw further blocks
    over just those lanes (ascending lane order) until every lane is past
    it.  Lanes of very different expected counts are split at the median
    first, each half drawn on its own."""
    means = np.asarray(means, dtype=np.float64)
    horizons = np.asarray(horizons, dtype=np.float64)
    L = means.shape[0]
    finite = np.isfinite(means) & (means > 0.0)
    if L == 0 or not finite.any():
        return np.empty((L, 0)), np.zeros(L, dtype=np.int64)
    expected = np.where(finite, horizons / means, 0.0)

    if L >= 8 and expected.max() > 4.0 * max(np.median(expected), 1.0):
        cut = np.median(expected)
        lo = np.flatnonzero(expected <= cut)
        hi = np.flatnonzero(expected > cut)
        t_lo, c_lo = _arrival_times_batch(rng, dist, means[lo], horizons[lo], max_block)
        t_hi, c_hi = _arrival_times_batch(rng, dist, means[hi], horizons[hi], max_block)
        width = max(t_lo.shape[1], t_hi.shape[1])
        out = np.full((L, width), np.inf)
        out[lo, : t_lo.shape[1]] = t_lo
        out[hi, : t_hi.shape[1]] = t_hi
        counts = np.zeros(L, dtype=np.int64)
        counts[lo] = c_lo
        counts[hi] = c_hi
        return out, counts

    cap = max(16, max_block // L)
    m = int(np.clip(expected.max() * 1.25 + 8, 16, cap))
    block = dist.sample(rng, 1.0, (L, m)) * means[:, None]
    block = np.maximum(block, 1e-9)  # zero-gap guard
    block[~finite] = np.inf
    times = np.cumsum(block, axis=1)
    keep = times <= horizons[:, None]  # monotone rows: the kept part is a prefix
    counts = keep.sum(axis=1).astype(np.int64)
    tail = times[:, -1]
    ex_lanes: List[np.ndarray] = []
    ex_times: List[np.ndarray] = []
    act = np.flatnonzero(finite & (tail <= horizons))
    tail = tail[act]
    while act.size:
        m = max(16, m // 3)
        sub = np.maximum(dist.sample(rng, 1.0, (act.size, m)) * means[act, None], 1e-9)
        sub_t = tail[:, None] + np.cumsum(sub, axis=1)
        sk = sub_t <= horizons[act, None]
        cnt = sk.sum(axis=1)
        ex_lanes.append(np.repeat(act, cnt))
        ex_times.append(sub_t[sk])  # row-major: grouped by lane, sorted
        counts[act] += cnt
        tail = sub_t[:, -1]
        live = tail <= horizons[act]
        act, tail = act[live], tail[live]
    width = int(counts.max(initial=0))
    out = np.full((L, max(width, times.shape[1])), np.inf)
    out[:, : times.shape[1]] = np.where(keep, times, np.inf)
    if ex_lanes:
        lanes_cat = np.concatenate(ex_lanes)
        times_cat = np.concatenate(ex_times)
        # a stable sort by lane turns (round, lane) order into per-lane runs
        order = np.argsort(lanes_cat, kind="stable")
        lanes_s = lanes_cat[order]
        base = keep.sum(axis=1)
        starts = np.concatenate([[0], np.cumsum(counts - base)[:-1]])
        pos = base[lanes_s] + np.arange(lanes_s.size) - starts[lanes_s]
        out[lanes_s, pos] = times_cat[order]
    return out[:, :width], counts


def superposed_fault_times_batch(
    rng: np.random.Generator,
    horizons: np.ndarray,
    mtbfs: np.ndarray,
    n_components: int,
    dist: Optional[Distribution] = None,
    stationary: bool = False,
) -> tuple:
    """Each lane's platform trace as the superposition of ``n_components``
    i.i.d. component renewal processes of MTBF ``n_components * mtbf``
    (Section 2.1: mu = mu_ind / N), every lane's component frontier
    advanced in one flattened sampling pass per round.  Fresh start: every
    component is new at t = 0 (for Weibull shapes below 1 the early
    platform hazard then diverges).  ``stationary=True`` draws each
    component's first arrival from the equilibrium (length-biased residual
    life) law instead, each lane from its own pool of unit-mean gaps (a
    pool shared between lanes would correlate the runs of a sweep).
    Returns ``(times (L, W) +inf padded and sorted, counts)``."""
    dist = dist or exponential()
    horizons = np.asarray(horizons, dtype=np.float64)
    mtbfs = np.asarray(mtbfs, dtype=np.float64)
    L = horizons.shape[0]
    mu_ind = mtbfs * n_components
    if stationary:
        # pool size: length-biased fidelity (ratio bias O(1/K)) against
        # the (block, K) memory of per-lane pools
        K = int(min(max(4 * n_components, 2048), 20000))
        first = np.empty((L, n_components))
        blk = max(1, 4_000_000 // K)
        for lo in range(0, L, blk):
            sl = slice(lo, min(lo + blk, L))
            nb = sl.stop - sl.start
            pool = np.maximum(dist.sample(rng, 1.0, (nb, K)), 1e-9)
            cdf = np.cumsum(pool / pool.sum(axis=1, keepdims=True), axis=1)
            cdf[:, -1] = 1.0  # guard the rounding shortfall
            rows = np.arange(nb)[:, None]
            u = rng.random((nb, n_components))
            # rows offset by 2 keep the flattened cdf sorted, so one
            # searchsorted inverts every lane's CDF at once
            idx = np.searchsorted(
                (cdf + 2.0 * rows).ravel(), (u + 2.0 * rows).ravel(), side="right",
            ).reshape(nb, n_components) - rows * K
            idx = np.minimum(idx, K - 1)
            gaps = pool[rows, idx] * mu_ind[sl][:, None]
            first[sl] = rng.uniform(0.0, 1.0, (nb, n_components)) * gaps
    else:
        first = dist.sample(rng, 1.0, (L, n_components)) * mu_ind[:, None]
    lane0, comp0 = np.nonzero(first < horizons[:, None])
    f_lane = lane0
    f_time = first[lane0, comp0]
    all_lanes = [f_lane]
    all_times = [f_time]
    while f_lane.size:
        gaps = np.maximum(dist.sample(rng, 1.0, f_lane.size) * mu_ind[f_lane], 1e-9)
        nxt = f_time + gaps
        keep = nxt < horizons[f_lane]
        f_lane = f_lane[keep]
        f_time = nxt[keep]
        all_lanes.append(f_lane)
        all_times.append(f_time)
    lanes_cat = np.concatenate(all_lanes)
    times_cat = np.concatenate(all_times)
    counts = np.bincount(lanes_cat, minlength=L).astype(np.int64)
    width = int(counts.max()) if lanes_cat.size else 0
    out = np.full((L, width), np.inf)
    order = np.lexsort((times_cat, lanes_cat))
    lanes_s = lanes_cat[order]
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(lanes_s.size) - starts[lanes_s]
    out[lanes_s, pos] = times_cat[order]
    return out, counts


def make_event_traces_batch(
    rng: np.random.Generator,
    n_traces: int,
    horizon,
    mtbf,
    recall,
    precision,
    window=0.0,
    lead=math.inf,
    fault_dist: Optional[Distribution] = None,
    false_pred_dist: Optional[Distribution] = None,
    n_components: Optional[int] = None,
    stationary: bool = False,
    tier: bool = False,
) -> BatchTraces:
    """The paper's merged traces (Section 5), one array pass per law
    instead of ``n_traces`` Python loops, drawn as the reference draws
    them: faults (a single renewal stream of mean ``mtbf``, or with
    ``n_components`` the superposition of :func:`superposed_fault_times_
    batch`), each predicted with probability ``recall`` and its window
    placed so that the fault is uniform inside it, false predictions of
    mean ``p mu / (r (1 - p))``, merged and sorted.  Every parameter
    broadcasts to ``(n_traces,)``.  ``tier=True`` draws the per-fault
    recovery-tier uniforms of two-level strategies, after every other
    draw (so the rest of the batch does not depend on it)."""
    L = int(n_traces)
    horizon = _bc(horizon, L)
    mtbf = _bc(mtbf, L)
    recall = _bc(recall, L)
    precision = _bc(precision, L)
    window = _bc(window, L)
    lead = _bc(lead, L)
    fault_dist = fault_dist or exponential()
    false_pred_dist = false_pred_dist or fault_dist

    if n_components:
        fault_times, n_faults = superposed_fault_times_batch(
            rng, horizon, mtbf, n_components, fault_dist, stationary
        )
    else:
        fault_times, n_faults = _arrival_times_batch(rng, fault_dist, mtbf, horizon)

    cols = np.arange(fault_times.shape[1])[None, :]
    valid = cols < n_faults[:, None]
    predicted = valid & (rng.random(fault_times.shape) < recall[:, None])

    # true-positive windows: the fault uniform inside [t0, t0 + I]
    offsets = rng.random(fault_times.shape) * window[:, None]
    tp_t0 = np.where(predicted, np.maximum(0.0, fault_times - offsets), np.inf)
    tp_ft = np.where(predicted, fault_times, np.nan)

    fp_mean = false_prediction_mtbf_batch(mtbf, recall, precision)
    fp_t0, n_fp = _arrival_times_batch(rng, false_pred_dist, fp_mean, horizon)

    t0, ft, n_preds = _merge_predictions(tp_t0, tp_ft, predicted, fp_t0, n_fp)
    # keep >= 1 trailing padding column: the cursors' sentinel
    fwidth = (int(n_faults.max()) if L else 0) + 1
    if fault_times.shape[1] < fwidth:
        fault_times = np.concatenate(
            [fault_times, np.full((L, fwidth - fault_times.shape[1]), np.inf)], axis=1,
        )
        predicted = np.concatenate(
            [predicted, np.zeros((L, fwidth - predicted.shape[1]), bool)], axis=1
        )
    return BatchTraces(
        horizon=horizon,
        fault_times=fault_times,
        fault_predicted=predicted[:, : fault_times.shape[1]],
        n_faults=n_faults,
        pred_t0=t0,
        pred_fault=ft,
        n_preds=n_preds,
        window=window,
        lead=lead,
        fault_tier=rng.random(fault_times.shape) if tier else None,
    )


def _merge_predictions(tp_t0, tp_ft, predicted, fp_t0, n_fp):
    """Merge the true-positive and false-prediction columns into one
    time-sorted prediction array (stable: ties keep true positives first),
    cut or padded to the widest lane plus one sentinel column: ``(t0,
    fault date, count)``."""
    L = tp_t0.shape[0]
    t0 = np.concatenate([tp_t0, fp_t0], axis=1)
    ft = np.concatenate([tp_ft, np.full(fp_t0.shape, np.nan)], axis=1)
    order = np.argsort(t0, axis=1, kind="stable")
    t0 = np.take_along_axis(t0, order, axis=1)
    ft = np.take_along_axis(ft, order, axis=1)
    n_preds = predicted.sum(axis=1).astype(np.int64) + n_fp
    pwidth = (int(n_preds.max()) if L else 0) + 1
    t0 = t0[:, :pwidth] if t0.shape[1] >= pwidth else np.concatenate(
        [t0, np.full((L, pwidth - t0.shape[1]), np.inf)], axis=1
    )
    ft = ft[:, :pwidth] if ft.shape[1] >= pwidth else np.concatenate(
        [ft, np.full((L, pwidth - ft.shape[1]), np.nan)], axis=1
    )
    return t0, ft, n_preds


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


def gap_transform_np(kind: str, param: float, mean, x0, x1):
    """Inverse-CDF inter-arrival gap of one counter draw (NumPy), as the
    reference's host replay computes it: ``x0`` / ``x1`` are the draw's
    two words (only the lognormal law reads the second, the Box–Muller
    phase); the same mean parameterization as :class:`Distribution` and
    the same ``1e-9`` zero-gap guard."""
    u = uniform24(x0)
    if kind == "exponential":
        g = -np.log1p(-u) * mean
    elif kind == "weibull":
        scale = 1.0 / math.gamma(1.0 + 1.0 / param)
        g = (np.asarray(mean) * scale) * (-np.log1p(-u)) ** (1.0 / param)
    elif kind == "lognormal":
        z = np.sqrt(-2.0 * np.log(u)) * np.cos(2.0 * np.pi * uniform24(x1))
        with np.errstate(over="ignore"):
            g = np.exp(np.log(mean) - 0.5 * param * param + param * z)
    elif kind == "uniform":
        g = 2.0 * np.asarray(mean) * u
    else:
        raise ValueError(
            "device trace generation supports exponential/weibull/"
            f"lognormal/uniform, got kind={kind!r}"
        )
    return np.maximum(g, 1e-9)


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
    """A generative trace batch: per-lane RNG stream ids and trace
    parameters.  Lane ``i``'s faults and predictions are a pure function
    of ``(seed, stream[i])``; lanes sharing a stream id face identical
    traces (the paired experiment design).

    **Cell-indexed layout** (the fused sweep): with ``cell_index`` set,
    the six parameter arrays hold one row per experiment cell and
    ``cell_index[i]`` names lane ``i``'s row.  Without it (the per-lane
    layout of :meth:`expand`) they hold one row per lane.

    **Mixed-law layout**: ``fault_dist`` / ``false_pred_dist`` may each be
    a tuple of distributions, one per row.  The law then rides the cell
    tables as data (:func:`law_table`) and the engine draws through the
    law-indexed sampler, so a grid mixing laws runs as one dispatch.
    Build such specs with :meth:`concat_cells`, :meth:`indexed` or by
    passing distribution sequences to :func:`make_trace_spec`.

    :meth:`materialize` replays the streams on the host into a
    :class:`BatchTraces`."""

    horizon: np.ndarray  # (n_cells,) | (L,)
    mtbf: np.ndarray  # (n_cells,) | (L,)
    recall: np.ndarray  # (n_cells,) | (L,)
    precision: np.ndarray  # (n_cells,) | (L,)
    window: np.ndarray  # (n_cells,) | (L,)
    lead: np.ndarray  # (n_cells,) | (L,)
    fault_dist: Laws
    false_pred_dist: Laws
    seed: int
    stream: np.ndarray  # (L,) int64 global RNG stream ids
    cell_index: Optional[np.ndarray] = None  # (L,) int32 lane -> cell row

    @property
    def n_lanes(self) -> int:
        return int(self.stream.shape[0])

    @property
    def n_cells(self) -> Optional[int]:
        """Cell-table row count (``None`` for the per-lane layout)."""
        if self.cell_index is None:
            return None
        return int(self.horizon.shape[0])

    @property
    def fp_mean(self) -> np.ndarray:
        """False-prediction mean inter-arrival, aligned with the parameter
        rows."""
        return false_prediction_mtbf_batch(self.mtbf, self.recall, self.precision)

    @staticmethod
    def _gather_dists(d, rows):
        """Row-gather a per-row law tuple (a shared law as it is)."""
        if isinstance(d, tuple):
            return tuple(d[int(r)] for r in rows)
        return d

    def expand(self) -> "TraceSpec":
        """Per-lane view of a cell-indexed spec (identity otherwise): the
        parameter rows gathered by ``cell_index``, the same streams."""
        if self.cell_index is None:
            return self
        ci = self.cell_index
        return TraceSpec(
            horizon=self.horizon[ci], mtbf=self.mtbf[ci],
            recall=self.recall[ci], precision=self.precision[ci],
            window=self.window[ci], lead=self.lead[ci],
            fault_dist=self._gather_dists(self.fault_dist, ci),
            false_pred_dist=self._gather_dists(self.false_pred_dist, ci),
            seed=self.seed, stream=self.stream,
        )

    def take(self, rows) -> "TraceSpec":
        """The spec whose lane ``i`` is lane ``rows[i]`` of this one (a
        cell-indexed spec keeps its cell table and re-maps lanes)."""
        rows = np.asarray(rows)
        if self.cell_index is not None:
            return replace(self, stream=self.stream[rows],
                           cell_index=self.cell_index[rows])
        return TraceSpec(
            horizon=self.horizon[rows], mtbf=self.mtbf[rows],
            recall=self.recall[rows], precision=self.precision[rows],
            window=self.window[rows], lead=self.lead[rows],
            fault_dist=self._gather_dists(self.fault_dist, rows),
            false_pred_dist=self._gather_dists(self.false_pred_dist, rows),
            seed=self.seed, stream=self.stream[rows],
        )

    def tile(self, reps: int) -> "TraceSpec":
        return self.take(np.tile(np.arange(self.n_lanes), reps))

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
        if any(s.cell_index is None for s in specs):
            raise ValueError("concat_cells requires cell-indexed specs")

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
        n = self.n_cells if self.cell_index is not None else self.n_lanes

        def tup(d):
            return d if isinstance(d, tuple) else (d,) * n

        return replace(
            self,
            fault_dist=tup(self.fault_dist),
            false_pred_dist=tup(self.false_pred_dist),
        )

    def _grow_stream(self, kind: int, means: np.ndarray, max_events: int):
        """Replay one gap stream of the per-lane layout to just past every
        lane's horizon: ``(times (L, W), valid (L, W), counts (L,))``.  The
        dates accumulate in the device cursors' sequential order, so they
        are the engine's bits."""
        L = self.n_lanes
        key = stream_key64_np(self.seed, self.stream, kind)
        dist = self.fault_dist if kind == STREAM_FAULT_GAP else self.false_pred_dist
        if isinstance(dist, tuple):  # mixed-law: per-lane law column
            law, lp = law_table(dist)
            law_c = law[:, None]
            s1_c, s2_c = lp[:, 1][:, None], lp[:, 2][:, None]
        with np.errstate(invalid="ignore"):
            expected = np.where(
                np.isfinite(means) & (means > 0), self.horizon / means, 0.0
            )
        K = int(np.clip(expected.max(initial=0.0) * 1.4 + 16, 16, max(max_events, 16)))
        # max_events floors the runaway guard, which scales with the
        # expected count
        cap = max(max_events, int(expected.max(initial=0.0) * 4) + 64)
        last = np.zeros(L)
        start = 0
        cols: List[np.ndarray] = []
        while True:
            ctr = np.broadcast_to(np.arange(start, start + K, dtype=np.int64), (L, K))
            x0, x1 = splitmix64(key[:, None], ctr)
            if isinstance(dist, tuple):
                gaps = gap_transform_indexed_np(law_c, s1_c, s2_c, means[:, None], x0, x1)
            else:
                gaps = gap_transform_np(dist.kind, dist.param, means[:, None], x0, x1)
            # seed the cumulative sum with `last`: later blocks keep the
            # cursor's (last + g1) + g2 association
            t = np.cumsum(np.concatenate([last[:, None], gaps], axis=1), axis=1)[:, 1:]
            cols.append(t)
            last = t[:, -1]
            if np.all(last > self.horizon):
                break
            start += K
            if start > cap:
                raise ValueError(
                    f"lane needs more than {cap} events to cover its "
                    "horizon; raise max_events"
                )
            K = max(16, K // 2)
        times = np.concatenate(cols, axis=1)
        valid = times <= self.horizon[:, None]
        return times, valid, valid.sum(axis=1).astype(np.int64)

    def materialize(self, max_events: int = 1 << 17) -> BatchTraces:
        """Replay the counter streams on the host into a
        :class:`BatchTraces`: the events the device engine samples (fault
        dates bit-identical), predictions time-sorted as in
        :func:`make_event_traces_batch` (the device cursor takes true
        positives in fault order), and the recovery-tier coins of every
        fault column.  Trust coins are not applied: host engines draw
        trust from their own generator."""
        if self.cell_index is not None:
            return self.expand().materialize(max_events=max_events)
        L = self.n_lanes
        fault_times, valid, n_faults = self._grow_stream(
            STREAM_FAULT_GAP, self.mtbf, max_events
        )
        W = fault_times.shape[1]
        ctr = np.broadcast_to(np.arange(W, dtype=np.int64), (L, W))
        ckey = stream_key64_np(self.seed, self.stream, STREAM_TP_COIN)
        cw0, cw1 = splitmix64(ckey[:, None], ctr)
        predicted = valid & (uniform24(cw0) < self.recall[:, None])
        off = uniform24(cw1) * self.window[:, None]
        tp_t0 = np.where(predicted, np.maximum(0.0, fault_times - off), np.inf)
        tp_ft = np.where(predicted, fault_times, np.nan)
        fault_times = np.where(valid, fault_times, np.inf)

        fp_times, fp_valid, n_fp = self._grow_stream(
            STREAM_FP_GAP, self.fp_mean, max_events
        )
        fp_t0 = np.where(fp_valid, fp_times, np.inf)
        t0, ft, n_preds = _merge_predictions(tp_t0, tp_ft, predicted, fp_t0, n_fp)

        fwidth = (int(n_faults.max()) if L else 0) + 1
        if fault_times.shape[1] < fwidth:
            fault_times = np.concatenate(
                [fault_times, np.full((L, fwidth - fault_times.shape[1]), np.inf)], axis=1,
            )
        else:
            fault_times = fault_times[:, :fwidth]
        # recovery-tier uniforms: counter draw i of the tier stream belongs
        # to fault column i
        tkey = stream_key64_np(self.seed, self.stream, STREAM_TIER)
        tctr = np.broadcast_to(
            np.arange(fault_times.shape[1], dtype=np.int64), fault_times.shape
        )
        fault_tier = uniform24(splitmix64(tkey[:, None], tctr)[0])
        return BatchTraces(
            horizon=self.horizon,
            fault_times=fault_times,
            fault_predicted=predicted[:, : fault_times.shape[1]],
            n_faults=n_faults,
            pred_t0=t0,
            pred_fault=ft,
            n_preds=n_preds,
            window=self.window,
            lead=self.lead,
            fault_tier=fault_tier,
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
