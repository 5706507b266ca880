"""The port's hot-step module (repro_torch.kernels.sim_step) against the
JAX reference (repro.kernels.sim_step, Pallas in interpret mode) and the
NumPy RNG of repro.core.events.

Inputs are made with seeded numpy and handed to both sides.  Tolerances:
the RNG, the primitive update and the counters are integer or
add/compare/select arithmetic and must be bit-exact; the gap transform
goes through libm (torch) versus XLA transcendentals (jnp), which may
differ by a few ulp, hence rtol 1e-13 on event dates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as E
from repro.kernels import sim_step as JK
from repro_torch.core import events as PE
from repro_torch.kernels import sim_step as K

LAWS = [("exponential", 0.0), ("weibull", 0.7), ("weibull", 0.5),
        ("lognormal", 1.0), ("uniform", 0.0)]

#: Random123 known-answer vectors for Threefry-2x32, 20 rounds
TF_KATS = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]

#: SplitMix64 reference outputs for seed 0 (Vigna's splitmix64.c)
SM_KATS = [0xE220A8397B1DCDAF, 0x6E789E6AA1B965F4, 0x06C45D188009454F]


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))


def _u64_bits(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint64).view(np.int64))


_lane_inputs = K.sample_lane_state


def _torch_args(x: dict) -> dict:
    return K.lane_state_tensors(x, "cpu")


_PRIM_ARGS = ("prim", "cont", "target", "ckend", "nf", "t", "saved",
              "unsaved", "pw", "W", "DR")


# --------------------------------------------------------------------------- #
# Counter-based RNG
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kat", TF_KATS)
def test_threefry_known_answers(kat):
    (k0, k1), (c0, c1), want = kat
    x0, x1 = K.threefry2x32(*(torch.tensor([v]) for v in (k0, k1, c0, c1)))
    assert (int(x0), int(x1)) == want


@pytest.mark.parametrize("i", range(len(SM_KATS)))
def test_splitmix_known_answers(i):
    hi, lo = K.splitmix64(torch.tensor([0]), torch.tensor([i], dtype=torch.int32))
    assert (int(hi) << 32) | int(lo) == SM_KATS[i]


@pytest.mark.parametrize("rounds", [13, 20])
def test_threefry_matches_numpy_reference(rounds):
    rng = np.random.default_rng(3)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, 257, dtype=np.uint32) for _ in range(4))
    a = E.threefry2x32(k0, k1, c0, c1, rounds=rounds)
    b = K.threefry2x32(*(_i64(v) for v in (k0, k1, c0, c1)), rounds=rounds)
    for wa, wb in zip(a, b):
        np.testing.assert_array_equal(wa.astype(np.int64), wb.numpy())


def test_splitmix_and_uniform24_match_numpy_reference():
    rng = np.random.default_rng(4)
    key = rng.integers(0, 2**64, 1025, dtype=np.uint64)
    ctr = rng.integers(0, 2**20, 1025).astype(np.int64)
    a = E.splitmix64(key, ctr)
    b = K.splitmix64(_u64_bits(key), torch.from_numpy(ctr))
    for wa, wb in zip(a, b):
        np.testing.assert_array_equal(wa.astype(np.int64), wb.numpy())
        np.testing.assert_array_equal(E.uniform24(wa), K.uniform24(wb).numpy())


@pytest.mark.parametrize("kind", range(6))
def test_subkeys_match_reference(kind):
    stream = np.arange(0, 5000, 7, dtype=np.int64) + (3 << 33)
    want = E.stream_key64_np(11, stream, kind)
    np.testing.assert_array_equal(PE.stream_key64_np(11, stream, kind), want)
    k0, k1 = E.stream_subkey_np(11, stream, kind)
    got = K.stream_key(_i64(k0), _i64(k1))
    np.testing.assert_array_equal(got.numpy(), want.view(np.int64))


def test_counter_uniforms_match_jnp():
    key = E.stream_key64_np(5, np.arange(300), E.STREAM_TP_COIN)
    ctr = np.arange(300, dtype=np.int32) * 3
    ja, jb = JK.counter_uniform2((jnp.asarray(key),), jnp.asarray(ctr), jnp.float64)
    ta, tb = K.counter_uniform2(_u64_bits(key), torch.from_numpy(ctr))
    np.testing.assert_array_equal(np.asarray(ja), ta.numpy())
    np.testing.assert_array_equal(np.asarray(jb), tb.numpy())
    np.testing.assert_array_equal(
        np.asarray(JK.counter_uniform((jnp.asarray(key),), jnp.asarray(ctr), jnp.float64)),
        K.counter_uniform(_u64_bits(key), torch.from_numpy(ctr)).numpy(),
    )


# --------------------------------------------------------------------------- #
# Gap transform, stream advance, primitive update
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,param", LAWS)
def test_gap_transform_matches_jnp_and_numpy(kind, param):
    rng = np.random.default_rng(5)
    x0 = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    x1 = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    mean = rng.uniform(1e2, 3e5, 4096)
    got = K.gap_transform(kind, param, torch.from_numpy(mean), _i64(x0), _i64(x1)).numpy()
    want_np = E.gap_transform_np(kind, param, mean, x0, x1)
    want_jnp = np.asarray(JK.gap_transform(
        kind, param, jnp.asarray(mean), jnp.asarray(x0), jnp.asarray(x1), jnp.float64
    ))
    np.testing.assert_allclose(got, want_np, rtol=1e-13, atol=0)
    np.testing.assert_allclose(got, want_jnp, rtol=1e-13, atol=0)


@pytest.mark.parametrize("kind,param", LAWS)
def test_stream_advance_matches_jnp_and_pallas(kind, param):
    x = _lane_inputs(512, 6)
    tx = _torch_args(x)
    got_c, got_t = K.stream_advance(
        tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"], tx["horizon"],
        kind=kind, param=param,
    )
    jargs = (jnp.asarray(x["mask"]), jnp.asarray(x["ctr"]), jnp.asarray(x["nf"]),
             (jnp.asarray(x["key"]),), jnp.asarray(x["mean"]), jnp.asarray(x["horizon"]))
    for fn, kw in ((JK.stream_advance, {}), (JK.masked_stream_advance, {"interpret": True})):
        wc, wt = fn(*jargs, kind=kind, param=param, **kw)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(wc))
        np.testing.assert_allclose(got_t.numpy(), np.asarray(wt), rtol=1e-13, atol=0)


@pytest.mark.parametrize("gen", [False, True])
@pytest.mark.parametrize("kind,param", LAWS)
def test_primitive_update_matches_jnp_and_pallas(kind, param, gen):
    x = _lane_inputs(512, 7)
    tx = _torch_args(x)
    kw = dict(eps=1e-6, reg_cont=1)
    tkw, jkw = dict(kw), dict(kw)
    if gen:
        tkw.update(stream=(tx["key"], tx["ctr"], tx["nf"], tx["mean"], tx["horizon"]),
                   gap=(kind, param))
        nf = jnp.asarray(x["nf"])
        jkw.update(stream=((jnp.asarray(x["key"]),), jnp.asarray(x["ctr"]), nf,
                           jnp.asarray(x["mean"]), jnp.asarray(x["horizon"])),
                   gap=(kind, param))
    got = K.primitive_update(*(tx[k] for k in _PRIM_ARGS), **tkw)
    jargs = [jnp.asarray(x[k]) for k in _PRIM_ARGS]
    if gen:
        jargs[4] = nf
    for fn, extra in ((JK.primitive_update, {}),
                      (JK.masked_primitive_update, {"interpret": True})):
        want = fn(*jargs, **jkw, **extra)
        assert len(got) == len(want)
        for g, w in zip(got[:6], want[:6]):  # t, saved, unsaved, pw, flags, ctr
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        if gen:
            np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]),
                                       rtol=1e-13, atol=0)
    flags = got[4].numpy()
    assert (flags & K.FLAG_FAULTED).any() and (flags & K.FLAG_REG).any()
    assert (flags & K.FLAG_FIN).any()


# --------------------------------------------------------------------------- #
# Wrappers on the CPU: plain path, in place, no launches; input checks
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("kind,param", LAWS[:2])
def test_wrappers_take_plain_path_in_place_on_cpu(kind, param):
    K.masked_primitive_update.launches = 0
    K.masked_stream_advance.launches = 0
    tx = _torch_args(_lane_inputs(256, 8))
    want = K.primitive_update(
        *(tx[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
        stream=(tx["key"], tx["ctr"], tx["nf"], tx["mean"], tx["horizon"]),
        gap=(kind, param),
    )
    s = {k: v.clone() for k, v in tx.items()}
    got = K.masked_primitive_update(
        *(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
        stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"]),
        gap=(kind, param),
    )
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, name in zip(got, ("t", "saved", "unsaved", "pw", None, "ctr", "nf")):
        if name is not None:
            assert g is s[name]  # updated in place
    wc, wt = K.stream_advance(tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"],
                              tx["horizon"], kind=kind, param=param)
    s = {k: v.clone() for k, v in tx.items()}
    gc, gt = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                     s["horizon"], kind=kind, param=param)
    assert gc is s["ctr"] and gt is s["nf"]
    torch.testing.assert_close(gc, wc, rtol=0, atol=0)
    torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    assert K.masked_primitive_update.launches == 0
    assert K.masked_stream_advance.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride", "alias"])
def test_wrappers_reject_bad_inputs(bad):
    s = _torch_args(_lane_inputs(64, 9))
    stream_nf = s["nf"]
    if bad == "dtype":
        s["ctr"] = s["ctr"].to(torch.int64)
        s["t"] = s["t"].to(torch.float32)
    elif bad == "shape":
        s["ctr"] = s["ctr"][:32]
        s["t"] = s["t"][:32]
    elif bad == "stride":
        s["ctr"] = torch.zeros(128, dtype=torch.int32)[::2]
        s["t"] = torch.zeros(128, dtype=torch.float64)[::2]
    else:
        stream_nf = s["nf"].clone()
    with pytest.raises((TypeError, ValueError)):
        K.masked_primitive_update(
            *(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
            stream=(s["key"], s["ctr"], stream_nf, s["mean"], s["horizon"]),
            gap=("exponential", 0.0),
        )
    if bad != "alias":
        with pytest.raises((TypeError, ValueError)):
            K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                    s["horizon"], kind="exponential", param=0.0)


# --------------------------------------------------------------------------- #
# Cell multiplexing
# --------------------------------------------------------------------------- #
def test_cell_gather_and_segment_sums_match_jnp():
    rng = np.random.default_rng(10)
    n_cells, L = 13, 700
    cidx = rng.integers(0, n_cells, L).astype(np.int32)
    tabs = {"a": rng.random(n_cells), "m": rng.integers(0, 5, n_cells).astype(np.int32)}
    got = K.cell_gather({k: torch.from_numpy(v) for k, v in tabs.items()},
                        torch.from_numpy(cidx), ("a", "m", "absent"))
    want = JK.cell_gather({k: jnp.asarray(v) for k, v in tabs.items()},
                          jnp.asarray(cidx), ("a", "m", "absent"))
    for k in tabs:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    vals = [rng.random(L) * 1e6, rng.integers(0, 100, L), rng.random(L) < 0.3]
    got = K.segment_cell_sums([torch.from_numpy(v) for v in vals],
                              torch.from_numpy(cidx), n_cells + 3)
    want = JK.segment_cell_sums(
        [jnp.asarray(v.astype(np.float64)) for v in vals], jnp.asarray(cidx), n_cells + 3
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13, atol=0)
    np.testing.assert_array_equal(got.numpy()[:, 1:], np.asarray(want)[:, 1:])


# --------------------------------------------------------------------------- #
# The host trace mode: the trace-fed primitive and the slab walks
# --------------------------------------------------------------------------- #
def test_trace_fed_wrapper_matches_step_kernel():
    """Without a stream the wrapper runs the trace-fed body: on the CPU
    its plain version, in place, equal to the reference's ``_step_kernel``
    (interpret mode); no launch is counted."""
    x = _lane_inputs(512, 21)
    s = _torch_args(x)
    n0 = (K.masked_primitive_update.launches, K.masked_primitive_update.host_launches)
    got = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1)
    assert len(got) == 5 and all(g is s[k] for g, k in zip(got, ("t", "saved", "unsaved",
                                                                   "pw")))
    want = JK.masked_primitive_update(*(jnp.asarray(x[k]) for k in _PRIM_ARGS), eps=1e-6,
                                      reg_cont=1, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (K.masked_primitive_update.launches,
            K.masked_primitive_update.host_launches) == n0


def _np_skip(mask, t, lead, P0, pi):
    """The reference's host-mode skip loop (``jax_sim.py`` l.460-467)."""
    pi, lanes = pi.copy(), np.arange(pi.shape[0])
    while True:
        adv = mask & (P0[pi, lanes] - lead < t)
        if not adv.any():
            return pi
        pi += adv


def _np_strike(res, t, fi, nflt, rc, F, Fcancel=None, can=None, ep_ft=None):
    """The reference's host-mode migration cancel (l.547-569) and
    stale-fault loop (l.689-716)."""
    t, fi, nflt = t.copy(), fi.copy(), nflt.copy()
    lanes, rows = np.arange(fi.shape[0]), np.arange(F.shape[0])[:, None]
    if Fcancel is not None:
        Fcancel = Fcancel.copy()
        m = (F == ep_ft[None, :]) & (rows >= fi[None, :]) & ~Fcancel
        cj, setm = np.argmax(m, axis=0), can & m.any(axis=0)
        Fcancel[cj[setm], lanes[setm]] = True
    while True:
        cf = F[fi, lanes]
        cc = Fcancel[fi, lanes] if Fcancel is not None else np.zeros_like(res)
        stepm = res & (cc | (cf < t))
        if not stepm.any():
            return t, fi, nflt, Fcancel
        hit = stepm & ~cc & (cf >= t - rc)
        t = np.where(hit, cf + rc, t)
        nflt += hit
        fi += stepm


def _np_silent(silr, t, fi, corrupt, F):
    """The reference's host-mode silent-strike loop (l.812-829)."""
    fi, corrupt, lanes = fi.copy(), corrupt.copy(), np.arange(fi.shape[0])
    while True:
        cf = F[fi, lanes]
        hit = silr & (cf <= t)
        if not hit.any():
            return fi, corrupt
        corrupt = np.where(hit, np.minimum(corrupt, cf), corrupt)
        fi += hit


@pytest.mark.parametrize("E_rows", [1, 24])
def test_slab_walks_match_reference_loops(E_rows):
    x = K.sample_slab_state(700, E_rows, 22)
    s = K.lane_state_tensors(x, "cpu")
    tally = []

    class Tally:
        def any(self, m):
            tally.append(1)
            return bool(m.any())

    got = K.slab_prediction_skip(s["mask"], s["t"], s["lead_act"], s["P0"], s["pi"],
                                 tally=Tally())
    want = _np_skip(x["mask"], x["t"], x["lead_act"], x["P0"], x["pi"])
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != x["pi"]).any() or E_rows == 1
    for mig in (False, True):
        kw = dict(Fcancel=s["Fcancel"].clone(), can=s["can"], ep_ft=s["ep_ft"]) if mig else {}
        out = K.slab_strike_walk(s["res"], s["t"], s["fi"], s["n_faults"], s["rc"], s["F"],
                                 **kw)
        ref = _np_strike(x["res"], x["t"], x["fi"], x["n_faults"], x["rc"], x["F"],
                         *((x["Fcancel"], x["can"], x["ep_ft"]) if mig else ()))
        for g, w in zip(out, ref[:3]):
            np.testing.assert_array_equal(g.numpy(), w)
        if mig:
            np.testing.assert_array_equal(kw["Fcancel"].numpy(), ref[3])
            new = ref[3] & ~x["Fcancel"]
            assert new.any() or E_rows == 1
        assert (ref[2] != x["n_faults"]).any() or E_rows == 1
    fi, cor = K.slab_silent_walk(s["silr"], s["t"], s["fi"], s["corrupt"], s["F"])
    wfi, wcor = _np_silent(x["silr"], x["t"], x["fi"], x["corrupt"], x["F"])
    np.testing.assert_array_equal(fi.numpy(), wfi)
    np.testing.assert_array_equal(cor.numpy(), wcor)
    assert tally  # the plain loops count their conditions


def test_slab_wrappers_take_plain_path_in_place_on_cpu():
    names = ("masked_slab_prediction_skip", "masked_slab_strike_walk",
             "masked_slab_silent_walk")
    for n in names:
        getattr(K, n).launches = 0
    x = K.sample_slab_state(300, 20, 23)
    s = K.lane_state_tensors(x, "cpu")
    pi = s["pi"].clone()
    assert K.masked_slab_prediction_skip(s["mask"], s["t"], s["lead_act"], s["P0"], pi) is pi
    np.testing.assert_array_equal(pi.numpy(), _np_skip(x["mask"], x["t"], x["lead_act"],
                                                       x["P0"], x["pi"]))
    st = [s[k].clone() for k in ("t", "fi", "n_faults")]
    Fc = s["Fcancel"].clone()
    out = K.masked_slab_strike_walk(s["res"], *st[:2], st[2], s["rc"], s["F"], Fcancel=Fc,
                                    can=s["can"], ep_ft=s["ep_ft"])
    assert all(a is b for a, b in zip(out, st))
    ref = _np_strike(x["res"], x["t"], x["fi"], x["n_faults"], x["rc"], x["F"],
                     x["Fcancel"], x["can"], x["ep_ft"])
    for g, w in zip(st + [Fc], ref):
        np.testing.assert_array_equal(g.numpy(), w)
    fi, cor = s["fi"].clone(), s["corrupt"].clone()
    out = K.masked_slab_silent_walk(s["silr"], s["t"], fi, cor, s["F"])
    assert out[0] is fi and out[1] is cor
    for g, w in zip(out, _np_silent(x["silr"], x["t"], x["fi"], x["corrupt"], x["F"])):
        np.testing.assert_array_equal(g.numpy(), w)
    assert all(getattr(K, n).launches == 0 for n in names)


@pytest.mark.parametrize("bad", ["dtype", "slab_shape", "slab_stride", "partial_mig"])
def test_slab_wrappers_reject_bad_inputs(bad):
    s = K.lane_state_tensors(K.sample_slab_state(64, 8, 24), "cpu")
    F, P0, fi, pi = s["F"], s["P0"], s["fi"], s["pi"]
    mig = dict(Fcancel=s["Fcancel"], can=s["can"], ep_ft=s["ep_ft"])
    if bad == "dtype":
        fi, pi = fi.to(torch.int32), pi.to(torch.int32)
    elif bad == "slab_shape":
        F, P0 = F[:, :32].contiguous(), P0[:, :32].contiguous()
    elif bad == "slab_stride":
        F, P0 = F.t().contiguous().t(), P0.t().contiguous().t()
    else:
        mig.pop("can")
    with pytest.raises((TypeError, ValueError)):
        K.masked_slab_strike_walk(s["res"], s["t"], fi, s["n_faults"], s["rc"], F, **mig)
    if bad != "partial_mig":
        with pytest.raises((TypeError, ValueError)):
            K.masked_slab_prediction_skip(s["mask"], s["t"], s["lead_act"], P0, pi)
        with pytest.raises((TypeError, ValueError)):
            K.masked_slab_silent_walk(s["silr"], s["t"], fi, s["corrupt"], F)
