"""The port's mixed-law sweep against the JAX reference: the law-indexed
variant of both hot-step kernels (plain versions and wrappers on the CPU)
and a paper grid over five failure laws in one dispatch
(``repro_torch.experiments.run_grid``) against the reference's fused
mixed-law ``run_grid`` (JAX engine, device trace mode).

Inputs are made with seeded numpy and handed to both sides.  Tolerances:
the law-indexed transform and event dates rtol 1e-13 against the jnp /
NumPy twins (libm versus XLA transcendentals); counters, flags and the
primitive update exact; each law's lanes of the indexed transform
bit-equal to the port's single-law transform (the gate of the fused
dispatch).  Whole grid: integer per-cell columns exact, moments and CIs
rtol 1e-9, per-lane makespans rtol 1e-9; the port's fused run bit-equal,
lane for lane, to its per-family run; chunk sizes 1e-12 on moments.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as RE
from repro.core.engine import EngineConfig
from repro.experiments import GridSpec as RGridSpec
from repro.experiments import run_grid as ref_run_grid
from repro.experiments.paper_grid import paper_grid_cells as ref_cells
from repro.kernels import sim_step as JK
from repro_torch.core import events as PE
from repro_torch.experiments import GridSpec, paper_grid_cells, run_grid
from repro_torch.kernels import sim_step as K

N_RUNS, SEED = 8, 5
INT_KEYS = ("n", "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts",
            "mean_migrations")
FLOAT_KEYS = ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan")
#: the grid's laws: (label prefix, reference law, port law)
GRID_LAWS = (
    ("exp", None, None),
    ("weibull0.7", RE.weibull(0.7), PE.weibull(0.7)),
    ("weibull0.5", RE.weibull(0.5), PE.weibull(0.5)),  # s2 = 2.0: x * x
    ("lognormal0.5", RE.lognormal(0.5), PE.lognormal(0.5)),  # Box-Muller
    ("uniform", RE.uniform(), PE.uniform()),
)
_PRIM_ARGS = ("prim", "cont", "target", "ckend", "nf", "t", "saved",
              "unsaved", "pw", "W", "DR")


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The CPU lane machine issues thousands of small elementwise ops, which
    run faster on one thread than split over a pool (the results are the
    same: every op here is elementwise or a sequential CPU reduction)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i64(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int64))


def _lanes(L: int, seed: int, block: int = 1):
    """Seeded lane states with per-lane laws (numpy, and as CPU tensors)."""
    x = {**K.sample_lane_state(L, seed), **K.sample_lane_laws(L, seed + 1, block)}
    return x, K.lane_state_tensors(x, "cpu")


def _draws(n: int, seed: int):
    rng = np.random.default_rng(seed)
    laws = K.sample_lane_laws(n, seed + 1)
    x0 = rng.integers(0, 2**32, n, dtype=np.uint32)
    x1 = rng.integers(0, 2**32, n, dtype=np.uint32)
    return laws, rng.uniform(1e2, 3e5, n), x0, x1


# --------------------------------------------------------------------------- #
# The plain law-indexed transform
# --------------------------------------------------------------------------- #
def test_gap_transform_indexed_matches_jnp_and_numpy():
    laws, mean, x0, x1 = _draws(6000, 20)
    got = K.gap_transform_indexed(
        torch.from_numpy(laws["law"]), torch.from_numpy(laws["s1"]),
        torch.from_numpy(laws["s2"]), torch.from_numpy(mean), _i64(x0), _i64(x1),
    ).numpy()
    want_np = RE.gap_transform_indexed_np(laws["law"], laws["s1"], laws["s2"], mean, x0, x1)
    want_jnp = np.asarray(JK.gap_transform_indexed(
        jnp.asarray(laws["law"]), jnp.asarray(laws["s1"]), jnp.asarray(laws["s2"]),
        jnp.asarray(mean), jnp.asarray(x0), jnp.asarray(x1), jnp.float64,
    ))
    np.testing.assert_allclose(got, want_np, rtol=1e-13, atol=0)
    np.testing.assert_allclose(got, want_jnp, rtol=1e-13, atol=0)
    np.testing.assert_array_equal(  # the port's NumPy copy is the reference's
        PE.gap_transform_indexed_np(laws["law"], laws["s1"], laws["s2"], mean, x0, x1),
        want_np)


@pytest.mark.parametrize("li", range(len(K.SAMPLE_LAWS)))
def test_gap_transform_indexed_gives_single_law_bits(li):
    kind, param = K.SAMPLE_LAWS[li]
    laws, mean, x0, x1 = _draws(6000, 21)
    got = K.gap_transform_indexed(
        torch.from_numpy(laws["law"]), torch.from_numpy(laws["s1"]),
        torch.from_numpy(laws["s2"]), torch.from_numpy(mean), _i64(x0), _i64(x1),
    )
    want = K.gap_transform(kind, param, torch.from_numpy(mean), _i64(x0), _i64(x1))
    on = torch.from_numpy(laws["pick"] == li)
    assert int(on.sum()) > 500
    assert torch.equal(got[on], want[on])  # bit for bit, strength reductions included


# --------------------------------------------------------------------------- #
# Plain indexed stream advance and primitive update against the Pallas kernels
# --------------------------------------------------------------------------- #
def test_stream_advance_indexed_matches_jnp_and_pallas():
    x, tx = _lanes(512, 22)
    got_c, got_t = K.stream_advance(
        tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"], tx["horizon"],
        kind="indexed", param=0.0, law=tx["law"], lp=(tx["s1"], tx["s2"]),
    )
    jargs = (jnp.asarray(x["mask"]), jnp.asarray(x["ctr"]), jnp.asarray(x["nf"]),
             (jnp.asarray(x["key"]),), jnp.asarray(x["mean"]), jnp.asarray(x["horizon"]))
    jkw = dict(kind="indexed", param=0.0, law=jnp.asarray(x["law"]),
               lp=(jnp.asarray(x["s1"]), jnp.asarray(x["s2"])))
    for fn, kw in ((JK.stream_advance, {}), (JK.masked_stream_advance, {"interpret": True})):
        wc, wt = fn(*jargs, **jkw, **kw)
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(wc))
        np.testing.assert_allclose(got_t.numpy(), np.asarray(wt), rtol=1e-13, atol=0)


def test_primitive_update_indexed_matches_jnp_and_pallas():
    x, tx = _lanes(512, 23)
    kw = dict(eps=1e-6, reg_cont=1, gap=("indexed", 0.0))
    got = K.primitive_update(
        *(tx[k] for k in _PRIM_ARGS), **kw,
        stream=(tx["key"], tx["ctr"], tx["nf"], tx["mean"], tx["horizon"],
                tx["law"], tx["s1"], tx["s2"]),
    )
    jargs = [jnp.asarray(x[k]) for k in _PRIM_ARGS]
    stream = ((jnp.asarray(x["key"]),), jnp.asarray(x["ctr"]), jargs[4],
              jnp.asarray(x["mean"]), jnp.asarray(x["horizon"]),
              jnp.asarray(x["law"]), jnp.asarray(x["s1"]), jnp.asarray(x["s2"]))
    for fn, extra in ((JK.primitive_update, {}),
                      (JK.masked_primitive_update, {"interpret": True})):
        want = fn(*jargs, **kw, stream=stream, **extra)
        assert len(got) == len(want) == 7
        for g, w in zip(got[:6], want[:6]):  # t, saved, unsaved, pw, flags, ctr
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_allclose(got[6].numpy(), np.asarray(want[6]), rtol=1e-13, atol=0)
    faulted = (got[4].numpy() & K.FLAG_FAULTED) != 0
    assert all(faulted[x["pick"] == li].any() for li in range(len(K.SAMPLE_LAWS)))


# --------------------------------------------------------------------------- #
# Wrappers on the CPU: the plain version in place, no launches; input checks
# --------------------------------------------------------------------------- #
def _indexed_stream(s, nf=None):
    return (s["key"], s["ctr"], s["nf"] if nf is None else nf, s["mean"], s["horizon"],
            s["law"], s["s1"], s["s2"])


def test_indexed_wrappers_take_plain_path_in_place_on_cpu():
    for fn in (K.masked_primitive_update, K.masked_stream_advance):
        fn.launches = fn.indexed_launches = 0
    _, tx = _lanes(256, 24)
    kw = dict(eps=1e-6, reg_cont=1, gap=("indexed", 0.0))
    want = K.primitive_update(*(tx[k] for k in _PRIM_ARGS), **kw, stream=_indexed_stream(tx))
    s = {k: v.clone() for k, v in tx.items()}
    got = K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), **kw,
                                    stream=_indexed_stream(s))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, name in zip(got, ("t", "saved", "unsaved", "pw", None, "ctr", "nf")):
        if name is not None:
            assert g is s[name]
    lp = (tx["s1"], tx["s2"])
    wc, wt = K.stream_advance(tx["mask"], tx["ctr"], tx["nf"], tx["key"], tx["mean"],
                              tx["horizon"], kind="indexed", param=0.0, law=tx["law"], lp=lp)
    s = {k: v.clone() for k, v in tx.items()}
    gc, gt = K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                     s["horizon"], kind="indexed", param=0.0,
                                     law=s["law"], lp=(s["s1"], s["s2"]))
    assert gc is s["ctr"] and gt is s["nf"]
    torch.testing.assert_close(gc, wc, rtol=0, atol=0)
    torch.testing.assert_close(gt, wt, rtol=0, atol=0)
    for fn in (K.masked_primitive_update, K.masked_stream_advance):
        assert fn.launches == fn.indexed_launches == 0


@pytest.mark.parametrize("bad", ["law_dtype", "slot_dtype", "length", "device",
                                 "missing", "kind"])
def test_indexed_wrappers_reject_bad_law_inputs(bad):
    _, s = _lanes(64, 25)
    law, s1, s2 = s["law"], s["s1"], s["s2"]
    if bad == "law_dtype":
        law = law.to(torch.int64)
    elif bad == "slot_dtype":
        s2 = s2.to(torch.float32)
    elif bad == "length":
        s1 = s1[:32]
    elif bad == "device":
        law = torch.empty(64, dtype=torch.int32, device="meta")
    adv_kw = dict(kind="indexed", param=0.0, law=law, lp=(s1, s2))
    stream = (s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"], law, s1, s2)
    gap = ("indexed", 0.0)
    if bad == "missing":
        adv_kw["law"] = None
        stream = stream[:5]
    elif bad == "kind":
        adv_kw["kind"] = "weibull"
        gap = ("weibull", 0.7)
    with pytest.raises((TypeError, ValueError)):
        K.masked_primitive_update(*(s[k] for k in _PRIM_ARGS), eps=1e-6, reg_cont=1,
                                  stream=stream, gap=gap)
    with pytest.raises((TypeError, ValueError)):
        K.masked_stream_advance(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"],
                                s["horizon"], **adv_kw)


# --------------------------------------------------------------------------- #
# The slice as a whole: the five-law paper grid in one dispatch
# --------------------------------------------------------------------------- #
def _grids(laws=GRID_LAWS, preset="validation", **kw):
    ref = [replace(c, label=f"{p}/{c.label}", fault_dist=d)
           for p, d, _ in laws for c in ref_cells(preset, **kw)]
    port = [replace(c, label=f"{p}/{c.label}", fault_dist=d)
            for p, _, d in laws for c in paper_grid_cells(preset, **kw)]
    return (RGridSpec(tuple(ref), n_runs=N_RUNS, seed=SEED),
            GridSpec(tuple(port), n_runs=N_RUNS, seed=SEED))


@pytest.fixture(scope="module")
def runs():
    """Each sweep of the five-law grid once per module, on demand."""
    cache = {}

    def get(side, collect="stats", **kw):
        key = (side, collect, tuple(sorted(kw.items())))
        if key not in cache:
            ref_grid, port_grid = _grids()
            with jax.enable_x64(True):
                if side == "ref":
                    cache[key] = ref_run_grid(ref_grid, EngineConfig(
                        engine="jax", trace_mode="device", collect=collect))
                else:
                    cache[key] = run_grid(port_grid, device="cpu", collect=collect, **kw)
        return cache[key]

    return get


def test_mixed_grid_cells_match_reference(runs):
    ref, port = runs("ref"), runs("port", chunk_lanes=None)
    assert port.meta["dispatch"] == "fused" and port.meta["dispatches"] == 1
    assert port.meta["sampler"] == "indexed" and port.meta["n_chunks"] == 1
    assert port.labels() == ref.labels() and len(port.cells) == 5 * 54
    for a, b in zip(ref.cells, port.cells):
        assert b.n_runs == N_RUNS and b.n_exhausted == a.n_exhausted, a.cell.label
        for k in INT_KEYS:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-9, atol=0,
                                       err_msg=f"{a.cell.label} {k}")


def test_mixed_grid_lanes_match_reference(runs):
    ref, port = runs("ref", "lanes"), runs("port", "lanes")
    assert port.labels() == ref.labels()
    for a, b in zip(ref.cells, port.cells):
        for f in ("n_faults", "n_proactive_ckpts", "n_regular_ckpts", "n_migrations"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=a.cell.label)
        np.testing.assert_allclose(b.makespan, a.makespan, rtol=1e-9, atol=0,
                                   err_msg=a.cell.label)
        assert b.n_exhausted == a.n_exhausted


def test_fused_equals_perfamily_lane_for_lane(runs):
    fused, fam = runs("port", "lanes"), runs("port", "lanes", dispatch="perfamily")
    assert (fused.meta["dispatches"], fam.meta["dispatches"]) == (1, len(GRID_LAWS))
    assert fam.meta["dispatch"] == "perfamily" and fam.meta["sampler"] == "indexed"
    assert fam.labels() == fused.labels()
    for a, b in zip(fused.cells, fam.cells):
        for f in ("makespan", "waste", "n_faults", "n_proactive_ckpts",
                  "n_regular_ckpts", "n_migrations"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.cell.label, f)
        assert a.n_exhausted == b.n_exhausted


def test_mixed_grid_chunk_size_invariance(runs):
    one, small = runs("port", chunk_lanes=None), runs("port", chunk_lanes=128)
    assert one.meta["n_chunks"] == 1 and small.meta["n_chunks"] == 17
    for a, b in zip(one.cells, small.cells):
        assert b.n_exhausted == a.n_exhausted
        for k in INT_KEYS:
            assert b.stats[k] == a.stats[k], (a.cell.label, k)
        for k in FLOAT_KEYS:
            np.testing.assert_allclose(b.stats[k], a.stats[k], rtol=1e-12, atol=0)


@pytest.mark.parametrize("law", [1, 2])
def test_single_law_grid_keeps_law_specialized_sampler(law):
    """One family: "fused" launches the single-law kernels, "perfamily"
    the law-indexed ones, and the lanes are the same bits."""
    _, grid = _grids(GRID_LAWS[law:law + 1], n_list=[2**14])
    fused = run_grid(grid, device="cpu", collect="lanes")
    fam = run_grid(grid, device="cpu", collect="lanes", dispatch="perfamily")
    assert fused.meta["sampler"] == "single-law" and fam.meta["sampler"] == "indexed"
    for a, b in zip(fused.cells, fam.cells):
        assert np.array_equal(a.makespan, b.makespan) and np.array_equal(a.n_faults, b.n_faults)


def test_run_grid_rejects_unknown_dispatch():
    _, grid = _grids(GRID_LAWS[:1], n_list=[2**14])
    with pytest.raises(ValueError, match="dispatch"):
        run_grid(grid, device="cpu", dispatch="percell")
