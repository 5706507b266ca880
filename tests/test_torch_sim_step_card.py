"""On a CUDA card: the port's hot-step kernels (``csrc/sim_step.cu``)
against their plain PyTorch versions, both the single-law and the
law-indexed variant, and each law's lanes of the indexed launch against
the single-law launch; the same for the cursor walks (the prediction
walk also with the trust coins of fractional trust, and the silent
walk), whose launch counters must move by one a call.  Imports neither JAX nor the
reference, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_sim_step_card.py

Without a card every test skips.

Tolerances: every output equal to the plain version's except the cursor
dates (``tm``; the walks' ``la_time``, ``tp_t0``, ``tp_ft``, ``fp_time``,
``t`` and ``sf_time``: libdevice against ATen transcendentals, within 4
ulp, ``nan`` and ``inf`` in the same places); on each law's lanes the
indexed launch gives the single-law launch's bits (0 ulp)."""

import pytest
import torch

from repro_torch.kernels import sim_step as K

LAWS = [("exponential", 0.0), ("weibull", 0.7), ("weibull", 0.5),
        ("lognormal", 1.0), ("uniform", 0.0)]

_PRIM_ARGS = ("prim", "cont", "target", "ckend", "nf", "t", "saved",
              "unsaved", "pw", "W", "DR")


def _lane_inputs(L: int, seed: int) -> dict:
    return K.sample_lane_state(L, seed)


def _torch_args(x: dict) -> dict:
    return K.lane_state_tensors(x, "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = (a.view(torch.int64) - b.view(torch.int64)).abs()
    return int(torch.where(same, torch.zeros_like(d), d).max())


@pytest.mark.cuda
@pytest.mark.parametrize("kind,param", LAWS)
def test_kernels_match_plain_versions_on_card(cuda_device, kind, param):
    tx = {k: v.to(cuda_device) for k, v in _torch_args(_lane_inputs(100_000, 12)).items()}
    s = {k: v.clone() for k, v in tx.items()}
    stream = lambda d: (d["key"], d["ctr"], d["nf"], d["mean"], d["horizon"])  # noqa: E731
    want = K.primitive_update(*(tx[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                              stream=stream(tx), gap=(kind, param))
    got = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                                    stream=stream(s), gap=(kind, param))
    for g, w in zip(got[:6], want[:6]):
        assert torch.equal(g, w)
    assert _ulps(got[6], want[6]) <= 4
    s = {k: v.clone() for k, v in tx.items()}
    wc, wt = K.stream_advance(tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"],
                              tx["horizon"], kind=kind, param=param)
    gc, gt = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                     s["horizon"], kind=kind, param=param)
    assert torch.equal(gc, wc)
    assert _ulps(gt, wt) <= 4


def _indexed_lanes(dev, L: int, seed: int, block: int):
    x = {**K.sample_lane_state(L, seed), **K.sample_lane_laws(L, seed + 1, block)}
    return {k: v.to(dev) for k, v in K.lane_state_tensors(x, "cpu").items()}


def _indexed_run(tx, plain: bool):
    s = {k: v.clone() for k, v in tx.items()}
    prim = K.primitive_update if plain else K.masked_primitive_update
    adv = K.stream_advance if plain else K.masked_stream_advance
    p = prim(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1, gap=("indexed", 0.0),
             stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"],
                     s["law"], s["s1"], s["s2"]))
    s = {k: v.clone() for k, v in tx.items()}
    a = adv(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
            kind="indexed", param=0.0, law=s["law"], lp=(s["s1"], s["s2"]))
    return p, a


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 1000])
def test_indexed_kernels_match_plain_versions_on_card(cuda_device, block):
    tx = _indexed_lanes(cuda_device, 100_000, 13, block)
    n0 = (K.masked_primitive_update.indexed_launches, K.masked_stream_advance.indexed_launches)
    (gp, ga), (wp, wa) = _indexed_run(tx, False), _indexed_run(tx, True)
    assert (K.masked_primitive_update.indexed_launches,
            K.masked_stream_advance.indexed_launches) == (n0[0] + 1, n0[1] + 1)
    for g, w in zip(gp[:6], wp[:6]):
        assert torch.equal(g, w)
    assert _ulps(gp[6], wp[6]) <= 4
    assert torch.equal(ga[0], wa[0]) and _ulps(ga[1], wa[1]) <= 4


@pytest.mark.cuda
@pytest.mark.parametrize("li", range(len(K.SAMPLE_LAWS)))
def test_indexed_kernels_give_single_law_bits_on_card(cuda_device, li):
    kind, param = K.SAMPLE_LAWS[li]
    tx = _indexed_lanes(cuda_device, 100_000, 14, 1)
    gp, ga = _indexed_run(tx, False)
    s = {k: v.clone() for k, v in tx.items()}
    sp = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                                   stream=(s["key"], s["ctr"], s["nf"], s["mean"],
                                           s["horizon"]), gap=(kind, param))
    s = {k: v.clone() for k, v in tx.items()}
    sa = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                 s["horizon"], kind=kind, param=param)
    on = tx["pick"] == li
    for g, w in zip(gp + ga, sp + sa):
        assert torch.equal(g[on], w[on])  # 0 ulp on this law's lanes


# --------------------------------------------------------------------------- #
# The cursor walks
# --------------------------------------------------------------------------- #
_CONSTS = ("f_key", "f_mean", "tc_key", "recall", "window", "fp_key", "fp_mean", "horizon")
_STRIKE = ("t", "sf_ctr", "sf_time", "n_faults")
#: (fault gap, false-prediction gap) of the law-indexed cases
_INDEXED = {"both": (("indexed", 0.0), ("indexed", 0.0)),
            "fault": (("indexed", 0.0), ("exponential", 0.0))}


def _walk_lanes(dev, L: int, seed: int) -> dict:
    x = K.sample_walk_state(L, seed)
    for prefix, s in (("f_", seed + 1), ("fp_", seed + 2)):
        laws = K.sample_lane_laws(L, s, 1000)
        x.update({f"{prefix}pick": laws["pick"], f"{prefix}law": laws["law"],
                  f"{prefix}s1": laws["s1"], f"{prefix}s2": laws["s2"]})
    return K.lane_state_tensors(x, dev)


def _laws(gap, s, prefix):
    if gap[0] != "indexed":
        return None, None
    return s[f"{prefix}law"], (s[f"{prefix}s1"], s[f"{prefix}s2"])


def _walks(tx, f_gap, fp_gap, plain: bool, trust: bool = False) -> dict:
    """The skip walk, a refill and the strike walk (with cancel slots) on
    copies of ``tx``: {name: outputs}; ``trust`` adds the trust coins to
    the prediction walks."""
    pred = K.prediction_walk if plain else K.masked_prediction_walk
    strike = K.strike_walk if plain else K.masked_strike_walk
    out = {}
    for mode in ("until", "refill"):
        s = {k: v.clone() for k, v in tx.items()}
        f_law, f_lp = _laws(f_gap, s, "f_")
        fp_law, fp_lp = _laws(fp_gap, s, "fp_")
        until = mode == "until"
        coins = ({k: s[k] for k in ("tt_key", "ft_key", "q_eff")} if trust else {})
        got = pred(s["mask"], None if until else s["fp_mask"],
                   *(s[k] for k in K.PREDICTION_CURSORS), *(s[k] for k in _CONSTS),
                   f_gap=f_gap, fp_gap=fp_gap, f_law=f_law, f_lp=f_lp, fp_law=fp_law,
                   fp_lp=fp_lp, until=(s["t"], s["lead_act"]) if until else None, **coins)
        out[mode] = dict(zip(K.PREDICTION_CURSORS, got))
    s = {k: v.clone() for k, v in tx.items()}
    law, lp = _laws(f_gap, s, "f_")
    got = strike(s["res"], s["t"], s["sf_ctr"], s["sf_time"], s["n_faults"], s["DR"],
                 s["key"], s["mean"], s["horizon"], kind=f_gap[0], param=f_gap[1],
                 law=law, lp=lp, cancels=(s["cancel0"], s["cancel1"], s["cancel2"]))
    out["strike"] = dict(zip(_STRIKE, got))
    torch.cuda.synchronize()
    return out


def _walk_counts():
    return [getattr(fn, a) for fn in (K.masked_prediction_walk, K.masked_strike_walk)
            for a in ("launches", "indexed_launches")]


def _assert_walks_close(got: dict, want: dict):
    for mode, outs in want.items():
        for k, w in outs.items():
            g = got[mode][k]
            if w.dtype.is_floating_point:
                assert torch.equal(torch.isnan(g), torch.isnan(w)), (mode, k)
                assert _ulps(g, w) <= 4, (mode, k)
            else:
                assert torch.equal(g, w), (mode, k)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,param", LAWS)
def test_walk_kernels_match_plain_versions_on_card(cuda_device, kind, param):
    tx = _walk_lanes(cuda_device, 100_000, 15)
    n0 = _walk_counts()
    got = _walks(tx, (kind, param), (kind, param), plain=False)
    assert _walk_counts() == [n0[0] + 2, n0[1], n0[2] + 1, n0[3]]
    want = _walks(tx, (kind, param), (kind, param), plain=True)
    _assert_walks_close(got, want)
    steps = got["until"]["la_ctr"] - tx["la_ctr"]
    assert int(steps.max()) >= 4 and int((got["strike"]["sf_ctr"] - tx["sf_ctr"]).max()) >= 3


@pytest.mark.cuda
@pytest.mark.parametrize("streams", list(_INDEXED))
def test_indexed_walk_kernels_match_plain_versions_on_card(cuda_device, streams):
    f_gap, fp_gap = _INDEXED[streams]
    tx = _walk_lanes(cuda_device, 100_000, 16)
    n0 = _walk_counts()
    got = _walks(tx, f_gap, fp_gap, plain=False)
    assert _walk_counts() == [n0[0], n0[1] + 2, n0[2], n0[3] + 1]
    _assert_walks_close(got, _walks(tx, f_gap, fp_gap, plain=True))


@pytest.mark.cuda
@pytest.mark.parametrize("li", range(len(K.SAMPLE_LAWS)))
def test_indexed_walks_give_single_law_bits_on_card(cuda_device, li):
    """On the lanes whose both streams draw law ``li``, the law-indexed
    walks give the single-law walks' bits."""
    gap = K.SAMPLE_LAWS[li]
    tx = _walk_lanes(cuda_device, 100_000, 17)
    tx["fp_law"], tx["fp_s1"], tx["fp_s2"] = tx["f_law"], tx["f_s1"], tx["f_s2"]
    got = _walks(tx, ("indexed", 0.0), ("indexed", 0.0), plain=False)
    want = _walks(tx, gap, gap, plain=False)
    on = tx["f_pick"] == li
    assert int(on.sum()) > 1000
    for mode, outs in want.items():
        for k, w in outs.items():
            g = got[mode][k]
            if w.dtype.is_floating_point:  # 0 ulp, nan for nan
                g, w = g.view(torch.int64), w.view(torch.int64)
            assert torch.equal(g[on], w[on]), (mode, k)


# --------------------------------------------------------------------------- #
# Fractional trust and the silent walk
# --------------------------------------------------------------------------- #
_TRUST = {"exponential": (("exponential", 0.0),) * 2, "weibull": (("weibull", 0.7),) * 2,
          "indexed": _INDEXED["both"]}


@pytest.mark.cuda
@pytest.mark.parametrize("law", list(_TRUST))
def test_trust_walk_kernels_match_plain_versions_on_card(cuda_device, law):
    """The prediction walk with trust coins (q_eff 0, 0.3, 0.5, 1; q = 0
    lanes walk to the stream's end) against its plain version; on the
    q = 1 lanes it gives the coin-free walk's bits."""
    f_gap, fp_gap = _TRUST[law]
    tx = _walk_lanes(cuda_device, 100_000, 19)
    n0 = _walk_counts()
    got = _walks(tx, f_gap, fp_gap, plain=False, trust=True)
    indexed = law == "indexed"
    assert _walk_counts() == [n0[0] + 2 * (not indexed), n0[1] + 2 * indexed,
                              n0[2] + (not indexed), n0[3] + indexed]
    _assert_walks_close(got, _walks(tx, f_gap, fp_gap, plain=True, trust=True))
    free = _walks(tx, f_gap, fp_gap, plain=False)
    one = tx["q_eff"] == 1.0
    for mode in ("until", "refill"):
        for k, w in free[mode].items():
            g = got[mode][k]
            if w.dtype.is_floating_point:
                g, w = g.view(torch.int64), w.view(torch.int64)
            assert torch.equal(g[one], w[one]), (mode, k)
    extra = got["refill"]["la_ctr"] - free["refill"]["la_ctr"]
    assert int((extra[(tx["q_eff"] > 0.0) & ~one] > 0).sum()) > 1000


_SILENT = ("sf_ctr", "sf_time", "corrupt")


def _silent(tx, gap, plain: bool) -> dict:
    s = {k: v.clone() for k, v in tx.items()}
    law, lp = _laws(gap, s, "f_")
    fn = K.silent_walk if plain else K.masked_silent_walk
    got = fn(s["silr"], s["t"], s["sf_ctr"], s["sf_time"], s["corrupt"], s["key"], s["mean"],
             s["horizon"], kind=gap[0], param=gap[1], law=law, lp=lp)
    torch.cuda.synchronize()
    return dict(zip(_SILENT, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,param", LAWS + [("indexed", 0.0)])
def test_silent_walk_kernel_matches_plain_version_on_card(cuda_device, kind, param):
    """Counters and the latent corruption bit-equal, the cursor date
    within 4 ulp; lanes outside ``silr`` untouched."""
    tx = _walk_lanes(cuda_device, 100_000, 18)
    fn = K.masked_silent_walk
    n0 = (fn.launches, fn.indexed_launches)
    got = _silent(tx, (kind, param), plain=False)
    indexed = kind == "indexed"
    assert (fn.launches, fn.indexed_launches) == (n0[0] + (not indexed), n0[1] + indexed)
    want = _silent(tx, (kind, param), plain=True)
    assert torch.equal(got["sf_ctr"], want["sf_ctr"])
    assert torch.equal(got["corrupt"].view(torch.int64), want["corrupt"].view(torch.int64))
    assert _ulps(got["sf_time"], want["sf_time"]) <= 4
    steps = got["sf_ctr"] - tx["sf_ctr"]
    assert int(steps.max()) >= 3 and bool((steps[~tx["silr"]] == 0).all())
    assert torch.equal(got["sf_time"][~tx["silr"]], tx["sf_time"][~tx["silr"]])


# --------------------------------------------------------------------------- #
# The host trace mode: the trace-fed primitive and the slab walks
# --------------------------------------------------------------------------- #
@pytest.mark.cuda
def test_trace_fed_primitive_matches_plain_version_on_card(cuda_device):
    """The no-stream launch (``gen == 0``): every output bit-equal to the
    plain version's, counted in ``.host_launches`` alone."""
    tx = {k: v.to(cuda_device) for k, v in _torch_args(_lane_inputs(100_000, 25)).items()}
    s = {k: v.clone() for k, v in tx.items()}
    fn = K.masked_primitive_update
    n0 = (fn.launches, fn.indexed_launches, fn.host_launches)
    want = K.primitive_update(*(tx[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1)
    got = fn(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1)
    assert (fn.launches, fn.indexed_launches, fn.host_launches) == (n0[0], n0[1], n0[2] + 1)
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int64) if g.dtype == torch.float64 else g,
                           w.view(torch.int64) if w.dtype == torch.float64 else w)
    assert torch.equal(s["nf"], tx["nf"]) and torch.equal(s["ctr"], tx["ctr"])
    assert bool((got[4] & K.FLAG_FAULTED).ne(0).any())


def _slab_walks(tx: dict, plain: bool) -> dict:
    """The three slab walks (the strike walk with and without migration)
    on copies of ``tx``; returns every output."""
    s = {k: v.clone() for k, v in tx.items()}
    fns = ((K.slab_prediction_skip, K.slab_strike_walk, K.slab_silent_walk) if plain else
           (K.masked_slab_prediction_skip, K.masked_slab_strike_walk,
            K.masked_slab_silent_walk))
    out = {"pi": fns[0](s["mask"], s["t"], s["lead_act"], s["P0"], s["pi"].clone())}
    for mig in (False, True):
        fc = s["Fcancel"].clone()
        kw = dict(Fcancel=fc, can=s["can"], ep_ft=s["ep_ft"]) if mig else {}
        t, fi, nflt = fns[1](s["res"], s["t"].clone(), s["fi"].clone(),
                             s["n_faults"].clone(), s["rc"], s["F"], **kw)
        out.update({f"t{mig}": t, f"fi{mig}": fi, f"n_faults{mig}": nflt})
        if mig:
            out["Fcancel"] = fc
    out["silent_fi"], out["corrupt"] = fns[2](s["silr"], s["t"], s["fi"].clone(),
                                              s["corrupt"].clone(), s["F"])
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 40, 1200])
def test_slab_walk_kernels_match_plain_versions_on_card(cuda_device, rows):
    """Every output bit-equal (the walks only compare and add), each
    wrapper's counter up by one a call."""
    tx = K.lane_state_tensors(K.sample_slab_state(20_000 if rows == 1200 else 100_000,
                                                  rows, 26), cuda_device)
    names = ("masked_slab_prediction_skip", "masked_slab_strike_walk",
             "masked_slab_silent_walk")
    n0 = [getattr(K, n).launches for n in names]
    got = _slab_walks(tx, plain=False)
    assert [getattr(K, n).launches for n in names] == [n0[0] + 1, n0[1] + 2, n0[2] + 1]
    want = _slab_walks(tx, plain=True)
    for k, w in want.items():
        g = got[k]
        if w.dtype == torch.float64:
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w), k
    if rows > 1:
        assert int((got["pi"] - tx["pi"]).max()) >= 3
        assert int((got["fiTrue"] - tx["fi"]).max()) >= 3
        assert bool((got["Fcancel"] & ~tx["Fcancel"]).any())


@pytest.mark.cuda
def test_slab_walks_reject_bad_inputs_on_card(cuda_device):
    tx = K.lane_state_tensors(K.sample_slab_state(512, 16, 27), cuda_device)
    with pytest.raises(TypeError):
        K.masked_slab_prediction_skip(tx["mask"], tx["t"], tx["lead_act"], tx["P0"],
                                      tx["pi"].to(torch.int32))
    with pytest.raises(ValueError):
        K.masked_slab_strike_walk(tx["res"], tx["t"], tx["fi"], tx["n_faults"], tx["rc"],
                                  tx["F"].t().contiguous().t())
    with pytest.raises(ValueError):
        K.masked_slab_silent_walk(tx["silr"], tx["t"], tx["fi"], tx["corrupt"],
                                  tx["F"].cpu())
