"""The port's copies of the reference host code, held against the
reference: rate identities, laws, periods, strategies, lane codes,
per-lane packing, the fused layout, the chunk packers, the mixed-law
layout (law tables, concatenated specs, law columns) and the host
checkpoint codec.  Everything
here is NumPy or Python doubles on both sides, so every comparison is
exact."""

import math
from dataclasses import replace

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
# the mixed-law layout
# --------------------------------------------------------------------------- #
#: (reference law, port law) pairs of every family and both Weibull
#: strength reductions
MIXED = [(RE.exponential(), PE.exponential()), (RE.weibull(0.7), PE.weibull(0.7)),
         (RE.weibull(0.5), PE.weibull(0.5)), (RE.weibull(2.0), PE.weibull(2.0)),
         (RE.lognormal(1.0), PE.lognormal(1.0)), (RE.lognormal(0.5), PE.lognormal(0.5)),
         (RE.uniform(), PE.uniform())]


def _mixed_grids(laws, preset="validation", n_runs=3):
    ref = [replace(c, label=f"{i}/{c.label}", fault_dist=r)
           for i, (r, _) in enumerate(laws) for c in ref_cells(preset)]
    port = [replace(c, label=f"{i}/{c.label}", fault_dist=p)
            for i, (_, p) in enumerate(laws) for c in paper_grid_cells(preset)]
    return RGridSpec(tuple(ref), n_runs=n_runs, seed=5), GridSpec(tuple(port), n_runs=n_runs, seed=5)


def _same_spec(a, b):
    for k in ("horizon", "mtbf", "recall", "precision", "window", "lead", "stream",
              "cell_index", "fp_mean"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
        assert getattr(a, k).dtype == getattr(b, k).dtype, k
    assert a.seed == b.seed
    for k in ("fault_dist", "false_pred_dist"):
        da, db = getattr(a, k), getattr(b, k)
        assert isinstance(da, tuple) == isinstance(db, tuple), k
        da, db = (da, db) if isinstance(da, tuple) else ((da,), (db,))
        assert [(d.kind, d.param) for d in da] == [(d.kind, d.param) for d in db], k


def test_law_table_matches():
    ref, port = zip(*(MIXED * 2))
    la, lpa = PE.law_table(port)
    lb, lpb = RE.law_table(ref)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(lpa, lpb)
    assert la.dtype == lb.dtype and lpa.dtype == lpb.dtype
    # the slots are the single-law kernels' folded constants, bit for bit
    from repro_torch.kernels.sim_step import law_constants
    for d, code, row in zip(port, la, lpa):
        assert law_constants(d.kind, d.param) == (code, row[1], row[2])


def test_gap_transform_indexed_np_matches():
    rng = np.random.default_rng(13)
    law, lp = RE.law_table([r for r, _ in MIXED])
    pick = rng.integers(0, len(MIXED), 5000)
    x0, x1 = (rng.integers(0, 2**32, 5000, dtype=np.uint32) for _ in range(2))
    mean = np.where(rng.random(5000) < 0.05, np.inf, rng.uniform(1e2, 3e5, 5000))
    args = (law[pick], lp[pick, 1], lp[pick, 2], mean, x0, x1)
    np.testing.assert_array_equal(PE.gap_transform_indexed_np(*args),
                                  RE.gap_transform_indexed_np(*args))


def test_require_inverse_cdf_matches():
    for r, p in MIXED:
        PE.require_inverse_cdf(p)
        RE.require_inverse_cdf(r)
    with pytest.raises(ValueError, match="inverse-CDF"):
        PE.require_inverse_cdf(PE.Distribution("custom", "custom"))


def test_mixed_trace_specs_match():
    """The mixed-law layout's specs: concat_cells of the per-family specs,
    indexed(), and make_trace_spec given one law per cell."""
    ref, port = _mixed_grids(MIXED[:3])
    a, b = build_fused_layout(port), ref_layout(ref, "device")
    assert a.n_groups == b.n_groups == 3
    _same_spec(a.concat_spec(), b.concat_spec())
    _same_spec(PE.TraceSpec.concat_cells(a.specs), RE.TraceSpec.concat_cells(b.specs))
    for sa, sb in zip(a.specs, b.specs):
        _same_spec(sa, sb)
        _same_spec(sa.indexed(), sb.indexed())
        _same_spec(sa.indexed().indexed(), sb.indexed())
    spec = a.concat_spec()
    assert isinstance(spec.fault_dist, tuple) and len(spec.fault_dist) == spec.n_cells
    laws_p = tuple(PE.weibull(0.5 + 0.1 * i) for i in range(4))
    laws_r = tuple(RE.weibull(0.5 + 0.1 * i) for i in range(4))
    kw = dict(horizon=1e6, mtbf=[1e3, 2e3, 3e3, 4e3], recall=0.5, precision=0.7,
              stream=np.arange(10) + 7, cell_index=np.arange(10) % 4, seed=3)
    _same_spec(PE.make_trace_spec(10, fault_dist=laws_p, **kw),
               RE.make_trace_spec(10, fault_dist=laws_r, **kw))
    _same_spec(PE.make_trace_spec(10, fault_dist=laws_p, false_pred_dist=PE.uniform(), **kw),
               RE.make_trace_spec(10, fault_dist=laws_r, false_pred_dist=RE.uniform(), **kw))
    with pytest.raises(ValueError, match="one entry per cell"):
        PE.make_trace_spec(10, fault_dist=laws_p[:3], **kw)
    with pytest.raises(ValueError, match="shared seed"):
        PE.TraceSpec.concat_cells([a.specs[0], replace(a.specs[1], seed=6)])


def test_mixed_cell_tables_match():
    """The law columns of the cell tables (fault and false-prediction
    streams; padding rows exponential with zero slots) and their chunk."""
    ref, port = _mixed_grids(MIXED[1:5], n_runs=2)
    la, lb = build_fused_layout(port), ref_layout(ref, "device")
    sa, sb = la.concat_spec(), lb.concat_spec()
    n_cells = sb.n_cells
    n_tab = max(8, 1 << n_cells.bit_length())
    W, C, D, R, M, T_R, T_P, mode, q = PB._lane_params(la.work_c, la.plats_c, la.strats_c, n_cells)
    q_eff = np.where(mode == PB._M_NONE, 0.0, np.clip(q, 0.0, 1.0))
    args = (n_cells, n_tab, np.float64, W, C, D, R, M, T_R, T_P, mode, sb.horizon, sb.window)
    laws = dict(fault_laws=PE.law_table(sa.fault_dist), fp_laws=PE.law_table(sa.false_pred_dist))
    ta = PT._cell_tables(*args, sa.mtbf, sa.fp_mean, sa.recall, q_eff, **laws)
    tb = RJ._cell_tables(*args, -1.0, mtbf=sb.mtbf, fp_mean=sb.fp_mean, recall=sb.recall,
                         q_eff=q_eff, fault_laws=RE.law_table(sb.fault_dist),
                         fp_laws=RE.law_table(sb.false_pred_dist))
    assert set(ta) == set(PT._CELL_TABLE_KEYS + PT._LAW_TABLE_KEYS) <= set(RJ._CELL_TABLE_KEYS)
    for k, v in ta.items():
        np.testing.assert_array_equal(v, tb[k], err_msg=k)
        assert v.dtype == tb[k].dtype, k
    assert (ta["fault_law"][n_cells:] == 0).all() and (ta["fp_s2"][n_cells:] == 0).all()
    sl = slice(5, 5 + 300)
    ca, _ = PT._pack_chunk_spec_cells(ta, sa, sa.cell_index, n_cells, sl, 384,
                                      np.float64, np.int64)
    cb, _ = RJ._pack_chunk_spec_cells(tb, sb, sb.cell_index, n_cells, sl, 384,
                                      np.float64, np.int64)
    for k in PT._LAW_TABLE_KEYS + ("cidx",):
        np.testing.assert_array_equal(ca[k], cb[k], err_msg=k)


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
