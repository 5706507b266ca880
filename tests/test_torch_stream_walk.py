"""The port's cursor walks (repro_torch.kernels.sim_step prediction_walk,
strike_walk and silent_walk, and their wrappers on the CPU) against
step-by-step loops built from the JAX reference's own ``stream_advance``,
``counter_uniform`` and ``counter_uniform2`` (repro.kernels.sim_step),
written as the reference engine writes them (``tp_consume``,
``fp_consume``, ``p_body``, ``s_body`` and ``sc_body`` of
repro.core.jax_sim), the prediction walk with and without the trust
coins of fractional trust.

Inputs are seeded lanes of ``sample_walk_state`` (exhausted cursors,
recall 0.3 and 0.85, trust 0, 0.3, 0.5 and 1, lanes with the mask clear,
cancel slots that match, latent corruptions) handed to both sides as
numpy.  Tolerances: counters, masks and fault
counts exact; dates rtol 1e-13 (the gap transform through libm versus XLA
transcendentals, as test_stream_advance_matches_jnp_and_pallas), with
``inf`` and ``nan`` in the same places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import sim_step as JK
from repro_torch.kernels import sim_step as K

L = 2048
#: (label, fault gap, false-prediction gap): every law, the law-indexed
#: sampler on both streams, and on the fault stream alone
LAWS = {
    "exponential": (("exponential", 0.0), ("exponential", 0.0)),
    "weibull": (("weibull", 0.7), ("weibull", 0.7)),
    "lognormal": (("lognormal", 1.0), ("exponential", 0.0)),
    "uniform": (("uniform", 0.0), ("uniform", 0.0)),
    "indexed": (("indexed", 0.0), ("indexed", 0.0)),
    "indexed_fault": (("indexed", 0.0), ("exponential", 0.0)),
}
DATES = ("la_time", "tp_t0", "tp_ft", "fp_time")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _state(seed: int) -> dict:
    """Walk lanes plus per-lane laws of each stream (numpy)."""
    x = K.sample_walk_state(L, seed)
    for prefix, s in (("f_", seed + 1), ("fp_", seed + 2)):
        laws = K.sample_lane_laws(L, s)
        x.update({f"{prefix}law": laws["law"], f"{prefix}s1": laws["s1"],
                  f"{prefix}s2": laws["s2"]})
    return x


def _law_kw(gap, x, prefix, conv):
    """A stream's law keywords: (kind, param) and, for "indexed", the lanes'
    law code and slots, converted by ``conv``."""
    kw = dict(kind=gap[0], param=gap[1])
    if gap[0] == "indexed":
        kw.update(law=conv(x[f"{prefix}law"]),
                  lp=(conv(x[f"{prefix}s1"]), conv(x[f"{prefix}s2"])))
    return kw


def _walk_kw(x, f_gap, fp_gap, conv):
    """The prediction walk's law keywords for the port's functions."""
    f, fp = _law_kw(f_gap, x, "f_", conv), _law_kw(fp_gap, x, "fp_", conv)
    return dict(f_gap=f_gap, fp_gap=fp_gap, f_law=f.get("law"), f_lp=f.get("lp"),
                fp_law=fp.get("law"), fp_lp=fp.get("lp"))


# --------------------------------------------------------------------------- #
# The reference's loops, step by step
# --------------------------------------------------------------------------- #
def _ref_prediction_walk(x, f_gap, fp_gap, until: bool, trust: bool = False):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    f_kw = _law_kw(f_gap, x, "f_", jnp.asarray)
    fp_kw = _law_kw(fp_gap, x, "fp_", jnp.asarray)
    inf, nan = jnp.inf, jnp.nan

    def tp_consume(m, ctr, tm, t0, ft, tc):
        act = m
        while bool(jnp.any(act)):
            ctr, tm = JK.stream_advance(act, ctr, tm, (j["f_key"],), j["f_mean"],
                                        j["horizon"], **f_kw)
            u_coin, u_off = JK.counter_uniform2((j["tc_key"],), ctr, jnp.float64)
            vis = u_coin < j["recall"]
            if trust:
                vis &= JK.counter_uniform((j["tt_key"],), ctr, jnp.float64) < j["q_eff"]
            alive = jnp.isfinite(tm)
            good = act & vis & alive
            t0 = jnp.where(good, jnp.maximum(0.0, tm - u_off * j["window"]), t0)
            ft = jnp.where(good, tm, ft)
            tc = jnp.where(good, ctr, tc)
            dead = act & ~alive
            t0 = jnp.where(dead, inf, t0)
            ft = jnp.where(dead, nan, ft)
            act = act & ~(good | dead)
        return ctr, tm, t0, ft, tc

    def fp_consume(m, ctr, tm):
        act = m
        while bool(jnp.any(act)):
            ctr, tm = JK.stream_advance(act, ctr, tm, (j["fp_key"],), j["fp_mean"],
                                        j["horizon"], **fp_kw)
            if trust:
                vis = JK.counter_uniform((j["ft_key"],), ctr, jnp.float64) < j["q_eff"]
            else:
                vis = jnp.ones_like(act)
            act = act & ~vis & jnp.isfinite(tm)
        return ctr, tm

    c = [j[k] for k in K.PREDICTION_CURSORS]
    if not until:
        c[:5] = tp_consume(j["mask"], *c[:5])
        c[5:] = fp_consume(j["fp_mask"], *c[5:])
    else:
        while True:
            head = jnp.minimum(c[2], c[6])
            adv = j["mask"] & (head - j["lead_act"] < j["t"])
            if not bool(jnp.any(adv)):
                break
            use_tp = adv & (c[2] <= c[6])
            c[:5] = tp_consume(use_tp, *c[:5])
            c[5:] = fp_consume(adv & ~use_tp, *c[5:])
    return dict(zip(K.PREDICTION_CURSORS, (np.asarray(v) for v in c)))


def _ref_strike_walk(x, gap, has_mig: bool):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    kw = _law_kw(gap, x, "f_", jnp.asarray)
    t, ctr, tm, nf = j["t"], j["sf_ctr"], j["sf_time"], j["n_faults"]

    def is_cancelled(c):
        return (c == j["cancel0"]) | (c == j["cancel1"]) | (c == j["cancel2"])

    while True:
        stale = tm < t
        if has_mig:
            stale |= is_cancelled(ctr)
        if not bool(jnp.any(j["res"] & stale)):
            break
        if has_mig:
            cc = is_cancelled(ctr)
            stepm = j["res"] & (cc | (tm < t))
            hit = stepm & ~cc & (tm >= t - j["DR"])
        else:
            stepm = j["res"] & (tm < t)
            hit = stepm & (tm >= t - j["DR"])
        t = jnp.where(hit, tm + j["DR"], t)
        nf = nf + hit.astype(nf.dtype)
        ctr, tm = JK.stream_advance(stepm, ctr, tm, (j["key"],), j["mean"], j["horizon"],
                                    **kw)
    return {k: np.asarray(v) for k, v in
            (("t", t), ("sf_ctr", ctr), ("sf_time", tm), ("n_faults", nf))}


def _ref_silent_walk(x, gap):
    j = {k: jnp.asarray(v) for k, v in x.items()}
    kw = _law_kw(gap, x, "f_", jnp.asarray)
    silr, t, ctr, tm, cor = j["silr"], j["t"], j["sf_ctr"], j["sf_time"], j["corrupt"]
    while bool(jnp.any(silr & (tm <= t))):
        hit = silr & (tm <= t)
        cor = jnp.where(hit, jnp.minimum(cor, tm), cor)
        ctr, tm = JK.stream_advance(hit, ctr, tm, (j["key"],), j["mean"], j["horizon"], **kw)
    return {k: np.asarray(v) for k, v in
            (("sf_ctr", ctr), ("sf_time", tm), ("corrupt", cor))}


def _assert_same(got: dict, want: dict, dates, atol: float = 0.0):
    for k, w in want.items():
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        if k in dates:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=k)
            np.testing.assert_allclose(g, w, rtol=1e-13, atol=atol, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


# --------------------------------------------------------------------------- #
# Plain walks against the reference's loops
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("until", [True, False], ids=["until", "refill"])
@pytest.mark.parametrize("law", list(LAWS))
def test_prediction_walk_matches_reference_loop(law, until):
    f_gap, fp_gap = LAWS[law]
    x = _state(40)
    tx = K.lane_state_tensors(x, "cpu")
    want = _ref_prediction_walk(x, f_gap, fp_gap, until)
    got = K.prediction_walk(
        tx["mask"], None if until else tx["fp_mask"], *(tx[k] for k in K.PREDICTION_CURSORS),
        *(tx[k] for k in ("f_key", "f_mean", "tc_key", "recall", "window", "fp_key",
                          "fp_mean", "horizon")),
        **_walk_kw(tx, f_gap, fp_gap, lambda v: v),
        until=(tx["t"], tx["lead_act"]) if until else None,
    )
    got = dict(zip(K.PREDICTION_CURSORS, got))
    _assert_same(got, want, DATES)
    # the lanes cover what the walk must handle
    steps = got["la_ctr"].numpy() - x["la_ctr"]
    fp_steps = got["fp_ctr"].numpy() - x["fp_ctr"]
    assert steps.max() >= 4 and (steps > 0).sum() > L // 10
    assert (fp_steps > 0).any()
    died = np.isinf(got["tp_t0"].numpy()) & np.isfinite(x["tp_t0"])
    assert died.any()  # cursors retired past the horizon in the walk
    hit = steps > 0
    for r in (0.3, 0.85):
        assert (hit & (x["recall"] == r) & np.isfinite(got["tp_t0"].numpy())).any()
    idle = ~x["mask"] if until else ~(x["mask"] | x["fp_mask"])
    for k in K.PREDICTION_CURSORS:  # lanes outside the masks are untouched
        np.testing.assert_array_equal(got[k].numpy()[idle], x[k][idle])


@pytest.mark.parametrize("has_mig", [True, False], ids=["migration", "plain"])
@pytest.mark.parametrize("law", ["exponential", "weibull", "lognormal", "indexed"])
def test_strike_walk_matches_reference_loop(law, has_mig):
    gap = LAWS[law][0]
    x = _state(41)
    tx = K.lane_state_tensors(x, "cpu")
    want = _ref_strike_walk(x, gap, has_mig)
    kw = _law_kw(gap, tx, "f_", lambda v: v)
    got = K.strike_walk(
        tx["res"], tx["t"], tx["sf_ctr"], tx["sf_time"], tx["n_faults"], tx["DR"],
        tx["key"], tx["mean"], tx["horizon"], **kw,
        cancels=(tx["cancel0"], tx["cancel1"], tx["cancel2"]) if has_mig else None,
    )
    got = dict(zip(("t", "sf_ctr", "sf_time", "n_faults"), got))
    _assert_same(got, want, ("t", "sf_time"))
    steps = got["sf_ctr"].numpy() - x["sf_ctr"]
    hits = got["n_faults"].numpy() - x["n_faults"]
    assert steps.max() >= 3 and (hits > 0).any() and (steps > hits).any()
    if has_mig:  # a cancelled current fault is skipped without a hit
        cancelled = x["res"] & (x["sf_ctr"] == x["cancel0"]) & (x["sf_time"] >= x["t"])
        assert cancelled.any() and (steps[cancelled] >= 1).all()


@pytest.mark.parametrize("until", [True, False], ids=["until", "refill"])
@pytest.mark.parametrize("law", ["exponential", "weibull", "lognormal", "indexed"])
def test_trust_prediction_walk_matches_reference_loop(law, until):
    """The trust coins: visible true positives and false predictions
    thinned per event where ``0 < q_eff < 1``, no thinning where
    ``q_eff = 1``.  As in the engine, whose priming masks them out, no
    lane of ``q_eff = 0`` walks here (the card tests walk them to the
    stream's end, kernel against plain version).  Dates: rtol 1e-13 and
    atol 1e-8 s, since ``sample_walk_state`` starts some lookahead
    cursors below date 0, where a step can land near 0 and carry the
    rounding of a gap of up to 1e5 s."""
    f_gap, fp_gap = LAWS[law]
    x = _state(44)
    x["mask"] &= x["q_eff"] > 0.0
    x["fp_mask"] &= x["q_eff"] > 0.0
    tx = K.lane_state_tensors(x, "cpu")
    want = _ref_prediction_walk(x, f_gap, fp_gap, until, trust=True)
    args = (tx["mask"], None if until else tx["fp_mask"],
            *(tx[k] for k in K.PREDICTION_CURSORS), *_consts(tx))
    kw = dict(**_walk_kw(tx, f_gap, fp_gap, lambda v: v),
              until=(tx["t"], tx["lead_act"]) if until else None)
    got = dict(zip(K.PREDICTION_CURSORS, K.prediction_walk(
        *args, **kw, tt_key=tx["tt_key"], ft_key=tx["ft_key"], q_eff=tx["q_eff"])))
    _assert_same(got, want, DATES, atol=1e-8)
    # q = 1 lanes walk as without coins; lower trust walks further
    plain = dict(zip(K.PREDICTION_CURSORS, K.prediction_walk(*args, **kw)))
    one = x["q_eff"] == 1.0
    for k in K.PREDICTION_CURSORS:
        torch.testing.assert_close(got[k][one], plain[k][one], rtol=0, atol=0, equal_nan=True)
    frac = (x["q_eff"] > 0.0) & (x["q_eff"] < 1.0)
    extra = (got["la_ctr"] - plain["la_ctr"]).numpy() + (got["fp_ctr"] - plain["fp_ctr"]).numpy()
    assert (extra[frac] > 0).sum() > 50 and (extra >= 0).all()


@pytest.mark.parametrize("law", ["exponential", "weibull", "lognormal", "indexed"])
def test_silent_walk_matches_reference_loop(law):
    gap = LAWS[law][0]
    x = _state(45)
    tx = K.lane_state_tensors(x, "cpu")
    want = _ref_silent_walk(x, gap)
    got = K.silent_walk(tx["silr"], tx["t"], tx["sf_ctr"], tx["sf_time"], tx["corrupt"],
                        tx["key"], tx["mean"], tx["horizon"], **_law_kw(gap, tx, "f_", lambda v: v))
    got = dict(zip(("sf_ctr", "sf_time", "corrupt"), got))
    _assert_same(got, want, ("sf_time",))
    np.testing.assert_array_equal(got["corrupt"].numpy(), want["corrupt"])  # bit for bit
    steps = got["sf_ctr"].numpy() - x["sf_ctr"]
    assert steps.max() >= 3 and (steps[~x["silr"]] == 0).all()
    hit = steps > 0
    # the earliest latent corruption: the first struck date, or an earlier one
    np.testing.assert_array_equal(got["corrupt"].numpy()[hit],
                                  np.minimum(x["corrupt"], x["sf_time"])[hit])
    assert (hit & np.isinf(x["corrupt"])).any() and (hit & np.isfinite(x["corrupt"])).any()


# --------------------------------------------------------------------------- #
# Wrappers on the CPU: the plain version in place, no launches; input checks
# --------------------------------------------------------------------------- #
class _Count:
    syncs = 0

    def any(self, mask):
        self.syncs += 1
        return bool(mask.any())


def _consts(s):
    return [s[k] for k in ("f_key", "f_mean", "tc_key", "recall", "window", "fp_key",
                           "fp_mean", "horizon")]


@pytest.mark.parametrize("law", ["exponential", "indexed"])
def test_walk_wrappers_take_plain_path_in_place_on_cpu(law):
    f_gap, fp_gap = LAWS[law]
    for fn in (K.masked_prediction_walk, K.masked_strike_walk):
        fn.launches = fn.indexed_launches = 0
    tx = K.lane_state_tensors(_state(42), "cpu")
    for until in (True, False):
        args = dict(until=(tx["t"], tx["lead_act"])) if until else {}
        fp_mask = None if until else tx["fp_mask"]
        want = K.prediction_walk(tx["mask"], fp_mask, *(tx[k] for k in K.PREDICTION_CURSORS),
                                 *_consts(tx), **_walk_kw(tx, f_gap, fp_gap, lambda v: v),
                                 **args)
        s = {k: v.clone() for k, v in tx.items()}
        tally = _Count()
        got = K.masked_prediction_walk(
            s["mask"], None if until else s["fp_mask"],
            *(s[k] for k in K.PREDICTION_CURSORS), *_consts(s),
            **_walk_kw(s, f_gap, fp_gap, lambda v: v),
            until=(s["t"], s["lead_act"]) if until else None, tally=tally,
        )
        assert tally.syncs >= 3  # the plain loops' conditions are counted
        for g, w, k in zip(got, want, K.PREDICTION_CURSORS):
            assert g is s[k]  # updated in place
            torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    kw = _law_kw(f_gap, tx, "f_", lambda v: v)
    cancels = (tx["cancel0"], tx["cancel1"], tx["cancel2"])
    want = K.strike_walk(tx["res"], tx["t"], tx["sf_ctr"], tx["sf_time"], tx["n_faults"],
                         tx["DR"], tx["key"], tx["mean"], tx["horizon"], **kw, cancels=cancels)
    s = {k: v.clone() for k, v in tx.items()}
    tally = _Count()
    got = K.masked_strike_walk(
        s["res"], s["t"], s["sf_ctr"], s["sf_time"], s["n_faults"], s["DR"], s["key"],
        s["mean"], s["horizon"], **_law_kw(f_gap, s, "f_", lambda v: v),
        cancels=(s["cancel0"], s["cancel1"], s["cancel2"]), tally=tally,
    )
    assert tally.syncs >= 3
    for g, w, k in zip(got, want, ("t", "sf_ctr", "sf_time", "n_faults")):
        assert g is s[k]
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for fn in (K.masked_prediction_walk, K.masked_strike_walk):
        assert fn.launches == fn.indexed_launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "device", "fp_mask_with_until",
                                 "no_fp_mask", "law", "cancels"])
def test_walk_wrappers_reject_bad_inputs(bad):
    s = K.lane_state_tensors(_state(43), "cpu")
    f_gap = fp_gap = ("exponential", 0.0)
    until, fp_mask, cancels = (s["t"], s["lead_act"]), None, (s["cancel0"], s["cancel1"],
                                                              s["cancel2"])
    law_kw = _walk_kw(s, f_gap, fp_gap, lambda v: v)
    strike_kw = dict(kind="exponential", param=0.0)
    if bad == "dtype":
        s["la_ctr"] = s["la_ctr"].to(torch.int64)
        s["n_faults"] = s["n_faults"].to(torch.int32)
    elif bad == "shape":
        s["tp_t0"] = s["tp_t0"][:100]
        s["sf_time"] = s["sf_time"][:100]
    elif bad == "stride":
        s["fp_time"] = torch.zeros(2 * L, dtype=torch.float64)[::2]
        s["t"] = torch.zeros(2 * L, dtype=torch.float64)[::2]
        until = (s["t"], s["lead_act"])
    elif bad == "device":
        s["recall"] = torch.empty(L, dtype=torch.float64, device="meta")
        s["mean"] = torch.empty(L, dtype=torch.float64, device="meta")
    elif bad == "fp_mask_with_until":
        fp_mask = s["fp_mask"]
        cancels = cancels[:2]
    elif bad == "no_fp_mask":
        until = None
        s["DR"] = s["DR"].to(torch.float32)
    elif bad == "law":
        law_kw = _walk_kw(s, ("weibull", 0.7), fp_gap, lambda v: v)
        law_kw["f_law"] = s["f_law"]  # a per-lane law on a single-law stream
        strike_kw = dict(kind="indexed", param=0.0, law=s["f_law"])  # no slots
    else:
        cancels = cancels[:2]
        until = (s["t"].to(torch.float32), s["lead_act"])
    with pytest.raises((TypeError, ValueError)):
        K.masked_prediction_walk(s["mask"], fp_mask, *(s[k] for k in K.PREDICTION_CURSORS),
                                 *_consts(s), **law_kw, until=until)
    with pytest.raises((TypeError, ValueError)):
        K.masked_strike_walk(s["res"], s["t"], s["sf_ctr"], s["sf_time"], s["n_faults"],
                             s["DR"], s["key"], s["mean"], s["horizon"], **strike_kw,
                             cancels=cancels)



def test_silent_and_trust_wrappers_take_plain_path_in_place_on_cpu():
    K.masked_silent_walk.launches = K.masked_silent_walk.indexed_launches = 0
    K.masked_prediction_walk.launches = K.masked_prediction_walk.indexed_launches = 0
    tx = K.lane_state_tensors(_state(46), "cpu")
    sil = ("silr", "t", "sf_ctr", "sf_time", "corrupt", "key", "mean", "horizon")
    want = K.silent_walk(*(tx[k] for k in sil), kind="weibull", param=0.7)
    s = {k: v.clone() for k, v in tx.items()}
    tally = _Count()
    got = K.masked_silent_walk(*(s[k] for k in sil), kind="weibull", param=0.7, tally=tally)
    assert tally.syncs >= 3
    for g, w, k in zip(got, want, ("sf_ctr", "sf_time", "corrupt")):
        assert g is s[k]
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    trust = dict(tt_key=tx["tt_key"], ft_key=tx["ft_key"], q_eff=tx["q_eff"])
    kw = _walk_kw(tx, ("exponential", 0.0), ("exponential", 0.0), lambda v: v)
    want = K.prediction_walk(tx["mask"], tx["fp_mask"], *(tx[k] for k in K.PREDICTION_CURSORS),
                             *_consts(tx), **kw, **trust)
    s = {k: v.clone() for k, v in tx.items()}
    got = K.masked_prediction_walk(s["mask"], s["fp_mask"],
                                   *(s[k] for k in K.PREDICTION_CURSORS), *_consts(s), **kw,
                                   **trust)
    for g, w, k in zip(got, want, K.PREDICTION_CURSORS):
        assert g is s[k]
        torch.testing.assert_close(g, w, rtol=0, atol=0, equal_nan=True)
    for fn in (K.masked_silent_walk, K.masked_prediction_walk):
        assert fn.launches == fn.indexed_launches == 0


@pytest.mark.parametrize("bad", ["partial_trust", "trust_dtype", "silent_dtype",
                                 "silent_shape", "silent_law"])
def test_silent_and_trust_wrappers_reject_bad_inputs(bad):
    s = K.lane_state_tensors(_state(47), "cpu")
    trust = dict(tt_key=s["tt_key"], ft_key=s["ft_key"], q_eff=s["q_eff"])
    sil_kw = dict(kind="exponential", param=0.0)
    if bad == "partial_trust":
        trust["ft_key"] = None
    elif bad == "trust_dtype":
        trust["q_eff"] = trust["q_eff"].to(torch.float32)
    elif bad == "silent_dtype":
        s["corrupt"] = s["corrupt"].to(torch.float32)
    elif bad == "silent_shape":
        s["silr"] = s["silr"][:100]
    else:
        sil_kw = dict(kind="indexed", param=0.0, law=s["f_law"])  # no slots
    sil = ("silr", "t", "sf_ctr", "sf_time", "corrupt", "key", "mean", "horizon")
    call = {
        "partial_trust": lambda: K.masked_prediction_walk(
            s["mask"], s["fp_mask"], *(s[k] for k in K.PREDICTION_CURSORS), *_consts(s),
            **_walk_kw(s, ("exponential", 0.0), ("exponential", 0.0), lambda v: v), **trust),
        "silent": lambda: K.masked_silent_walk(*(s[k] for k in sil), **sil_kw),
    }
    with pytest.raises((TypeError, ValueError)):
        call["partial_trust" if "trust" in bad else "silent"]()
