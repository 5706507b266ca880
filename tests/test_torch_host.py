"""The port's copies of the reference host code, held against the
reference: rate identities, laws, periods, strategies, lane codes,
per-lane packing, the fused layout, the chunk packers and the host
checkpoint codec.  Everything
here is NumPy or Python doubles on both sides, so every comparison is
exact."""

import math

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import codec as RCodec
from repro.configs import paper as RP
from repro.core import batch_sim as RB
from repro.core import events as RE
from repro.core import jax_sim as RJ
from repro.core import periods as RPer
from repro.experiments import GridSpec as RGridSpec
from repro.experiments.paper_grid import paper_grid_cells as ref_cells
from repro.experiments.runner import build_fused_layout as ref_layout
from repro_torch.checkpoint import codec as PCodec
from repro_torch.configs import paper as PP
from repro_torch.core import batch_sim as PB
from repro_torch.core import events as PE
from repro_torch.core import periods as PPer
from repro_torch.core import torch_sim as PT
from repro_torch.experiments import GridSpec, paper_grid_cells
from repro_torch.experiments.runner import build_fused_layout


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _grids(preset="full", ref_law=None, port_law=None, n_runs=3):
    ref = RGridSpec(tuple(ref_cells(preset, fault_dist=ref_law)), n_runs=n_runs, seed=5)
    port = GridSpec(tuple(paper_grid_cells(preset, fault_dist=port_law)),
                    n_runs=n_runs, seed=5)
    return ref, port


# --------------------------------------------------------------------------- #
# events / waste / periods / configs
# --------------------------------------------------------------------------- #
RATES = [(7200.0, 0.85, 0.82), (3600.0, 0.7, 0.4), (1e5, 0.0, 1.0),
         (500.0, 1.0, 0.5), (1e4, 0.3, 1.0)]


@pytest.mark.parametrize("mu,r,p", RATES)
def test_rate_identities_match(mu, r, p):
    for name in ("mu_p", "mu_e", "false_prediction_mtbf"):
        assert getattr(PE, name)(mu, r, p) == getattr(RE, name)(mu, r, p)
    assert PE.mu_np(mu, r) == RE.mu_np(mu, r)


def test_false_prediction_batch_matches():
    rng = np.random.default_rng(0)
    mu = rng.uniform(1e2, 1e6, 200)
    r = np.where(rng.random(200) < 0.2, 0.0, rng.random(200))
    p = np.where(rng.random(200) < 0.2, 1.0, rng.random(200))
    np.testing.assert_array_equal(
        PE.false_prediction_mtbf_batch(mu, r, p), RE.false_prediction_mtbf_batch(mu, r, p)
    )


@pytest.mark.parametrize("name,args", [
    ("exponential", ()), ("weibull", (0.7,)), ("weibull", (0.5,)),
    ("lognormal", (1.0,)), ("uniform", ()),
])
def test_laws_match(name, args):
    a, b = getattr(PE, name)(*args), getattr(RE, name)(*args)
    assert (a.name, a.kind, a.param) == (b.name, b.kind, b.param)
    assert PE.LAW_INDEX[a.kind] == RE.LAW_INDEX[b.kind]


def test_rng_constants_match():
    for name in ("_TF_PARITY", "_TF_ROTATIONS", "THREEFRY_ROUNDS", "_SM_GAMMA",
                 "_SM_MIX1", "_SM_MIX2", "STREAM_FAULT_GAP", "STREAM_TP_COIN",
                 "STREAM_FP_GAP", "STREAM_TP_TRUST", "STREAM_FP_TRUST",
                 "STREAM_TIER", "LAW_EXPONENTIAL", "LAW_WEIBULL", "LAW_LOGNORMAL",
                 "LAW_UNIFORM"):
        assert getattr(PE, name) == getattr(RE, name), name


def test_numpy_rng_matches():
    rng = np.random.default_rng(1)
    k0, k1, c0, c1 = (rng.integers(0, 2**32, 300, dtype=np.uint32) for _ in range(4))
    for a, b in zip(PE.threefry2x32(k0, k1, c0, c1), RE.threefry2x32(k0, k1, c0, c1)):
        np.testing.assert_array_equal(a, b)
    key = rng.integers(0, 2**64, 300, dtype=np.uint64)
    ctr = rng.integers(0, 2**30, 300)
    for a, b in zip(PE.splitmix64(key, ctr), RE.splitmix64(key, ctr)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(PE.uniform24(a), RE.uniform24(b))
    stream = rng.integers(0, 2**40, 300)
    for kind in range(6):
        for a, b in zip(PE.stream_subkey_np(9, stream, kind),
                        RE.stream_subkey_np(9, stream, kind)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mu,C,r,q", [(7200.0, 600.0, 0.0, 0.0), (3600.0, 600.0, 0.85, 1.0),
                                      (1e4, 60.0, 1.0, 1.0), (2e5, 600.0, 0.7, 0.5)])
def test_periods_match(mu, C, r, q):
    assert PPer._t_extr(mu, C, r, q) == RPer._t_extr(mu, C, r, q)
    assert PPer._t_daly(mu, 600.0, C) == RPer._t_daly(mu, 600.0, C)


@pytest.mark.parametrize("C,p,I", [(600.0, 0.82, 1200.0), (600.0, 0.4, 6000.0),
                                   (600.0, 0.4, 300.0), (60.0, 0.9, 6000.0),
                                   (600.0, 1.0, 600.0)])
def test_proactive_periods_match(C, p, I):
    assert PPer._t_p_extr(C, p, I) == RPer._t_p_extr(C, p, I)
    assert PPer._t_p_opt(C, p, I) == RPer._t_p_opt(C, p, I)


@pytest.mark.parametrize("n", PP.N_RANGE)
def test_paper_platforms_match(n):
    assert PP.N_RANGE == RP.N_RANGE
    a, b = PP.platform(n, M=300.0), RP.platform(n, M=300.0)
    assert (a.mu, a.C, a.D, a.R, a.M) == (b.mu, b.C, b.D, b.R, b.M)


# --------------------------------------------------------------------------- #
# cells, strategies, lane codes, per-lane packing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("preset", ["validation", "bench", "full"])
def test_paper_grid_strategies_match(preset):
    ref, port = ref_cells(preset), paper_grid_cells(preset)
    assert [c.label for c in port] == [c.label for c in ref]
    for a, b in zip(port, ref):
        sa, sb = a.strategy, b.strategy
        assert (sa.name, sa.T_R, sa.T_P, sa.q, sa.mode) == (sb.name, sb.T_R, sb.T_P, sb.q, sb.mode)
        assert (a.work, a.horizon_factor, a.platform.mu, a.platform.M) == (
            b.work, b.horizon_factor, b.platform.mu, b.platform.M)
        pa, pb = a.predictor, b.predictor
        assert (pa.recall, pa.precision, pa.lead, pa.window, pa.e_f) == (
            pb.recall, pb.precision, pb.lead, pb.window, pb.e_f)
        assert a.dist.name == b.dist.name


def test_lane_codes_match():
    assert PB.MODE_CODES == RB.MODE_CODES
    for name in dir(RB):
        if name.startswith(("_M_", "_PH_", "_PR_", "_C_")):
            assert getattr(PB, name) == getattr(RB, name), name
    np.testing.assert_array_equal(PB._CONT2PH, RB._CONT2PH)
    np.testing.assert_array_equal(PB._MODE2PH, RB._MODE2PH)
    assert PB._CONT2PH.dtype == RB._CONT2PH.dtype


def test_lane_params_match():
    ref, port = ref_cells("full"), paper_grid_cells("full")
    n = len(ref)
    work = np.linspace(1e5, 1e6, n)
    a = PB._lane_params(work, [c.platform for c in port], [c.strategy for c in port], n)
    b = RB._lane_params(work, [c.platform for c in ref], [c.strategy for c in ref], n)
    for x, y in zip(a, b[:9]):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


@pytest.mark.parametrize("n,fill", [(5, 0.0), (8, np.inf), (9, -1.0)])
def test_pad_lane_axis_matches(n, fill):
    a = np.arange(5, dtype=np.float64)
    np.testing.assert_array_equal(PB.pad_lane_axis(a, n, fill), RB.pad_lane_axis(a, n, fill))


# --------------------------------------------------------------------------- #
# fused layout and chunk packers
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("law", ["exponential", "weibull"])
def test_fused_layout_matches(law):
    laws = {"exponential": (None, None), "weibull": (RE.weibull(0.7), PE.weibull(0.7))}
    ref, port = _grids("full", *laws[law], n_runs=4)
    a, b = build_fused_layout(port), ref_layout(ref, "device")
    assert a.cell_order == b.cell_order and len(a.specs) == len(b.specs) == 1
    np.testing.assert_array_equal(a.runs_o, b.runs_o)
    np.testing.assert_array_equal(a.offs, b.offs)
    np.testing.assert_array_equal(a.cidx, b.cidx)
    np.testing.assert_array_equal(a.work_c, b.work_c)
    sa, sb = a.specs[0], b.specs[0]
    np.testing.assert_array_equal(sa.stream, sb.stream)
    np.testing.assert_array_equal(sa.cell_index, sb.cell_index)
    np.testing.assert_array_equal(sa.fp_mean, sb.fp_mean)
    for k in ("horizon", "mtbf", "recall", "precision", "window", "lead"):
        np.testing.assert_array_equal(getattr(sa, k), getattr(sb, k))
    assert sa.seed == sb.seed and sa.n_cells == sb.n_cells
    assert (sa.fault_dist.kind, sa.fault_dist.param) == (sb.fault_dist.kind, sb.fault_dist.param)


def _packed(n_runs=5):
    """The same fused chunk packed by both packers (reference and port),
    with padding lanes."""
    ref, port = _grids("validation", n_runs=n_runs)
    la, lb = build_fused_layout(port), ref_layout(ref, "device")
    spec_a, spec_b = la.specs[0], lb.specs[0]
    n_cells = spec_b.n_cells
    n_tab = max(8, 1 << n_cells.bit_length())
    W, C, D, R, M, T_R, T_P, mode, q = PB._lane_params(
        la.work_c, la.plats_c, la.strats_c, n_cells)
    q_eff = np.where(mode == PB._M_NONE, 0.0, np.clip(q, 0.0, 1.0))
    args = (n_cells, n_tab, np.float64, W, C, D, R, M, T_R, T_P, mode,
            spec_b.horizon, spec_b.window)
    ta = PT._cell_tables(*args, spec_a.mtbf, spec_a.fp_mean, spec_a.recall, q_eff)
    tb = RJ._cell_tables(*args, -1.0, mtbf=spec_b.mtbf, fp_mean=spec_b.fp_mean,
                         recall=spec_b.recall, q_eff=q_eff)
    sl = slice(7, 7 + 100)
    pa = PT._pack_chunk_spec_cells(ta, spec_a, spec_a.cell_index, n_cells, sl, 128,
                                   np.float64, np.int64)
    pb = RJ._pack_chunk_spec_cells(tb, spec_b, spec_b.cell_index, n_cells, sl, 128,
                                   np.float64, np.int64)
    return spec_b, ta, tb, pa, pb


def test_cell_tables_match():
    _, ta, tb, _, _ = _packed()
    assert set(ta) == set(PT._CELL_TABLE_KEYS) <= set(RJ._CELL_TABLE_KEYS)
    for k, v in ta.items():
        np.testing.assert_array_equal(v, tb[k])
        assert v.dtype == tb[k].dtype, k


def test_chunk_packers_match():
    spec, _, _, (ca, sa), (cb, sb) = _packed()
    assert set(ca) <= set(cb)
    for k, v in ca.items():
        np.testing.assert_array_equal(v, cb[k])
        assert v.dtype == cb[k].dtype, k
    for k in PT._STREAM_WORDS:
        np.testing.assert_array_equal(
            PT._stream_consts(spec, slice(3, 50), 64)[k],
            RJ._stream_consts(spec, slice(3, 50), 64)[k])
    assert set(sa) == set(sb)
    for k, v in sa.items():
        np.testing.assert_array_equal(v, sb[k])
        assert v.dtype == sb[k].dtype, k


def test_tables_from_numpy_round_trips():
    spec, _, _, _, (cb, sb) = _packed()
    got = PT.tables_from_numpy(cb, "cpu")
    for k, v in cb.items():
        if k in PT._STREAM_WORDS:
            assert k not in got
            continue
        assert got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), v)
        assert got[k].numpy().dtype == v.dtype, k
    # the stream words become the per-lane 64-bit SplitMix keys (of the
    # 100 real lanes; padding lanes carry zero words and never draw)
    for name, kind in (("fg_key", RE.STREAM_FAULT_GAP), ("tc_key", RE.STREAM_TP_COIN),
                       ("fp_key", RE.STREAM_FP_GAP)):
        assert got[name].dtype == torch.int64 and got[name].shape == (128,)
        want = RE.stream_key64_np(spec.seed, spec.stream[7:107], kind)
        np.testing.assert_array_equal(got[name].numpy()[:100], want.view(np.int64))
    # tensors own their memory: the engine updates state in place
    state = PT._to_device(sb, "cpu")
    state["t"][0] = math.pi
    assert state["saved"][0] == 0.0 and sb["t"][0] == 0.0


# --------------------------------------------------------------------------- #
# checkpoint/codec.py
# --------------------------------------------------------------------------- #
def _codec_arrays():
    rng = np.random.default_rng(11)
    x = rng.standard_normal(17_280).astype(np.float32)
    x[5], x[300], x[301] = np.nan, np.inf, -0.0
    return {
        "f32": x,
        "f16": rng.standard_normal((30, 576)).astype(np.float16),
        "tiny": np.zeros(256 * 3, np.float32),
        "scaled": (rng.standard_normal((4, 2048)) * 1e-30).astype(np.float32),
    }


@pytest.mark.parametrize("delta", [False, True])
def test_checkpoint_codec_copy_matches(delta):
    arrays = _codec_arrays()
    rng = np.random.default_rng(12)
    prev = ({k: (v * (1 + 1e-3 * rng.standard_normal(v.shape))).astype(v.dtype)
             for k, v in arrays.items()} if delta else None)
    with np.errstate(invalid="ignore"):
        enc_p, enc_r = PCodec.encode_tree(arrays, prev), RCodec.encode_tree(arrays, prev)
        assert list(enc_p) == list(enc_r)
        for k, (pay, meta) in enc_p.items():
            np.testing.assert_array_equal(pay, enc_r[k][0])
            assert meta == enc_r[k][1], k
        dec_p, dec_r = PCodec.decode_tree(enc_p, prev), RCodec.decode_tree(enc_r, prev)
    for k, v in dec_p.items():
        assert v.dtype == dec_r[k].dtype and v.shape == dec_r[k].shape
        np.testing.assert_array_equal(v.view(np.uint8), dec_r[k].view(np.uint8))
    assert PCodec.__all__ == RCodec.__all__ and PCodec._BLOCK == RCodec._BLOCK
