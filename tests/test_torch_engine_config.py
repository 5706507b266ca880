"""The port's engine selection against the reference's.

``repro_torch.core.engine.EngineConfig`` / ``resolve_engine_config`` take
the reference's inputs and give its results and errors, with the engine
name "jax" read as "torch"; the port has no ``mesh`` field.  Where the
port differs on purpose it is pinned here: its default engine is
"torch", ``validate()`` refuses ``collect="stats"`` on a host engine,
and ``run_grid`` / ``run_cells`` keep their historical keyword defaults
(device trace mode, per-cell stats) beside ``EngineConfig()``'s (host
traces, per-run lanes).  Every call into ``repro`` sits inside
``jax.enable_x64(True)``.
"""

import warnings
from dataclasses import asdict, fields

import jax
import numpy as np
import pytest

from repro.core import engine as RE
from repro_torch.core import engine as PE
from repro_torch.core.engine import UNSET, EngineConfig
from repro_torch.experiments import GridSpec, paper_grid_cells, run_cells, run_grid


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _port(name):
    return "torch" if name == "jax" else name


def _same(ref_cfg, port_cfg):
    want = {k: v for k, v in asdict(ref_cfg).items() if k != "mesh"}
    want["engine"] = _port(want["engine"])
    assert asdict(port_cfg) == want


def _outcome(fn):
    """(result, error type, deprecation warnings) of ``fn()``."""
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        try:
            out, err = fn(), None
        except (ValueError, TypeError) as e:
            out, err = None, type(e)
    dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    return out, err, len(dep)


def test_fields_are_the_reference_fields_but_mesh():
    ref = [f.name for f in fields(RE.EngineConfig)]
    assert [f.name for f in fields(EngineConfig)] == [n for n in ref if n != "mesh"]
    # every default but the engine is the reference's
    _same(RE.EngineConfig(engine="jax"), EngineConfig())


#: (config, loose keywords) inputs of resolve_engine_config; "jax" is read
#: as "torch" on the port side
RESOLVE_CASES = [
    (None, {}),
    ("batch", {}),
    ("jax", {}),
    ("scalar", {"trace_mode": "device"}),
    ("batch", {"engine": "scalar"}),
    (None, {"engine": "jax", "chunk_lanes": 64, "collect": "stats"}),
    (None, {"trace_mode": "device", "dispatch": "percell"}),
    (None, {"devices": 2, "engine": "jax"}),
    ("cfg", {}),
    ("cfg", {"engine": "batch"}),
    ("cfg", {"chunk_lanes": None}),
    (42, {}),
]


@pytest.mark.parametrize("config, legacy", RESOLVE_CASES)
def test_resolve_engine_config_matches_reference(config, legacy):
    def args(side):
        mod = RE if side == "ref" else PE
        name = (lambda n: n) if side == "ref" else _port
        if config == "cfg":
            cfg = mod.EngineConfig(engine=name("jax"), trace_mode="device")
        else:
            cfg = name(config) if isinstance(config, str) else config
        kw = {k: name(v) if k == "engine" else v for k, v in legacy.items()}
        return mod, cfg, kw

    def call(side):
        mod, cfg, kw = args(side)
        return _outcome(lambda: mod.resolve_engine_config(cfg, "caller", **kw))

    (r_out, r_err, r_dep), (p_out, p_err, p_dep) = call("ref"), call("port")
    assert p_err == r_err and p_dep == r_dep
    if r_err is None:
        if config is None and "engine" not in legacy:
            # the port's default engine is torch, the reference's batch
            assert r_out.engine == "batch" and p_out.engine == "torch"
            _same(r_out.replace(engine="jax"), p_out)
        else:
            _same(r_out, p_out)


@pytest.mark.parametrize("kw, raises", [
    ({}, None),
    ({"engine": "batch", "devices": 2}, "devices="),
    ({"engine": "scalar", "devices": ["cpu"]}, "devices="),
    ({"trace_mode": "disk"}, "trace_mode"),
    ({"collect": "everything"}, "collect"),
    ({"engine": "jax", "collect": "stats", "devices": "all"}, None),
    ({"engine": "batch", "trace_mode": "device"}, None),
])
def test_validate_matches_reference(kw, raises):
    def run(mod, name):
        c = {k: name(v) if k == "engine" else v for k, v in kw.items()}
        return _outcome(lambda: mod.EngineConfig(**c).validate())

    (r_out, r_err, _), (p_out, p_err, _) = run(RE, lambda n: n), run(PE, _port)
    assert p_err == r_err
    if raises:
        with pytest.raises(ValueError, match=raises):
            EngineConfig(**{k: _port(v) if k == "engine" else v
                            for k, v in kw.items()}).validate()


def test_validate_refuses_stats_on_host_engines():
    """The port's one extra rule: ``collect="stats"`` is reduced on the
    device, so it needs the torch engine (the reference checks it only in
    ``run_grid``)."""
    RE.EngineConfig(engine="batch", collect="stats").validate()
    for engine in ("batch", "scalar", "legacy"):
        with pytest.raises(ValueError, match="collect='stats' requires engine='torch'"):
            EngineConfig(engine=engine, collect="stats").validate()
    EngineConfig(engine="torch", collect="stats").validate()


def test_unset_is_a_sentinel():
    assert UNSET is PE.UNSET and UNSET is not None and repr(UNSET)


def _grid():
    return GridSpec(tuple(paper_grid_cells("validation", n_list=[2**16])[:4]),
                    n_runs=3, seed=5)


def test_run_grid_keyword_defaults_are_kept():
    """A call without an EngineConfig keeps the port's keyword defaults:
    device trace mode and per-cell stats, bit for bit the explicit
    config's; the loose keywords warn, the keyword-free call does not."""
    grid = _grid()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        plain = run_grid(grid, device="cpu")
    assert plain.meta["trace_mode"] == "device" and plain.collect == "stats"
    explicit = run_grid(grid, EngineConfig(trace_mode="device", collect="stats"),
                        device="cpu")
    with pytest.warns(DeprecationWarning, match="EngineConfig"):
        loose = run_grid(grid, device="cpu", trace_mode="device")
    for other in (explicit, loose):
        assert other.meta["trace_mode"] == "device" and other.collect == "stats"
        for a, b in zip(plain.cells, other.cells):
            assert a.stats == b.stats
    # EngineConfig()'s own defaults: host traces, per-run lanes
    default = run_grid(grid, EngineConfig(), device="cpu")
    assert default.meta["trace_mode"] == "host" and default.collect == "lanes"
    with pytest.warns(DeprecationWarning):
        host = run_cells(grid.cells, 3, 5, device="cpu", trace_mode="host")
    assert host.collect == "stats" and host.meta["trace_mode"] == "host"


def test_run_grid_errors_match_reference():
    from repro.experiments import GridSpec as RGridSpec
    from repro.experiments import run_grid as ref_run_grid
    from repro.experiments.paper_grid import paper_grid_cells as ref_paper

    rgrid = RGridSpec(tuple(ref_paper("validation", n_list=[2**16])[:4]), n_runs=3, seed=5)
    grid = _grid()
    cases = [
        dict(engine="quantum"),
        dict(engine="batch", devices=2),
        dict(engine="legacy", trace_mode="device"),
        dict(engine="legacy", dispatch="fused"),
        dict(engine="batch", dispatch="perfamily"),
        dict(engine="jax", trace_mode="host", dispatch="perfamily"),
        dict(engine="batch", collect="stats"),
        dict(engine="jax", collect="stats", dispatch="percell"),
        dict(engine="jax", dispatch="perlane"),
        dict(engine="jax", trace_mode="disk"),
    ]
    for kw in cases:
        with pytest.raises(ValueError) as ref_err:
            ref_run_grid(rgrid, RE.EngineConfig(**kw))
        port_kw = {k: _port(v) if k == "engine" else v for k, v in kw.items()}
        with pytest.raises(ValueError) as port_err:
            run_grid(grid, EngineConfig(**port_kw), device=None if kw.get(
                "engine") != "jax" else "cpu")
        # the port's devices rule also names its device= keyword; the
        # reference's names mesh=
        want = str(ref_err.value).replace("jax", "torch").replace("/mesh=", "")
        got = str(port_err.value).replace("devices=/device=", "devices=")
        assert got == want, kw
    with pytest.raises(ValueError, match="not both"):
        run_grid(grid, EngineConfig(), engine="batch")
    with pytest.raises(ValueError, match="device="):
        run_grid(grid, EngineConfig(engine="batch"), device="cpu")


def test_host_engines_need_no_device():
    """The host engines run without CUDA and without a device; their
    sweeps carry per-run lanes."""
    grid = _grid()
    for engine in ("batch", "scalar"):
        res = run_grid(grid, EngineConfig(engine=engine))
        assert res.engine == engine and res.collect == "lanes"
        assert all(np.isfinite(c.mean_waste) for c in res.cells)
