"""The paper's table and figure drivers on the port against the reference's.

Each driver of ``repro_torch.paper`` runs at its quick size on the port,
on the lane machine (``engine="torch"``, on the CPU) and on the NumPy
engine, against the reference driver (``benchmarks.sim_tables``,
``benchmarks.waste_curves``, ``benchmarks.recall_precision`` at their
default batch engine; ``examples/simulate_cluster.py``, which has one
size): the same records in the same order, every emitted field but
``us_per_call`` equal at the drivers' own rounding (the simulate_cluster
table line for line, but the wall time of its last line).  Every call
into ``repro`` sits inside ``jax.enable_x64(True)``.
"""

import contextlib
import io
import runpy
from pathlib import Path

import jax
import pytest

from repro_torch.paper import common as PC
from repro_torch.paper import recall_precision, sim_tables, simulate_cluster, waste_curves

ROOT = Path(__file__).resolve().parents[1]
DRIVERS = {"sim_tables": sim_tables, "waste_curves": waste_curves,
           "recall_precision": recall_precision}


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def _records(run):
    PC.reset_records()
    with contextlib.redirect_stdout(io.StringIO()):
        run()
    return [(r["name"], r["derived"]) for r in PC.RECORDS]


@pytest.fixture(scope="module")
def reference():
    """Each reference driver's records at its default engine, quick."""
    import importlib

    from benchmarks import common as RC

    out = {}
    with jax.enable_x64(True):
        for name in DRIVERS:
            mod = importlib.import_module(f"benchmarks.{name}")
            RC.reset_records()
            with contextlib.redirect_stdout(io.StringIO()):
                mod.run(quick=True)
            out[name] = [(r["name"], r["derived"]) for r in RC.RECORDS]
    return out


@pytest.mark.parametrize("engine", ["torch", "batch"])
@pytest.mark.parametrize("name", list(DRIVERS))
def test_driver_records_match_reference(name, engine, reference):
    got = _records(lambda: DRIVERS[name].run(
        quick=True, engine=engine, device="cpu" if engine == "torch" else None))
    want = reference[name]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (label, g), (_, w) in zip(got, want):
        assert g == w, label


def test_sim_tables_cells_are_the_references():
    from benchmarks.sim_tables import build_cells as ref_build_cells

    for quick in (True, False):
        got, want = sim_tables.build_cells(quick), ref_build_cells(quick)
        assert len(got) == len(want) == (100 if quick else 120)
        for a, b in zip(got, want):
            assert a.label == b.label and a.n_components == b.n_components
            assert (a.work, a.horizon_factor, a.dist.name) == (b.work, b.horizon_factor,
                                                               b.dist.name)
            assert a.strategy.T_R == b.strategy.T_R and a.strategy.mode == b.strategy.mode


@pytest.mark.parametrize("engine", ["torch", "batch"])
def test_simulate_cluster_matches_reference(engine):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "simulate_cluster.py"), run_name="__main__")
    want = buf.getvalue().rstrip("\n").split("\n")
    with contextlib.redirect_stdout(io.StringIO()):
        got = "\n".join(simulate_cluster.run(
            engine=engine, device="cpu" if engine == "torch" else None)).split("\n")
    assert len(got) == len(want)
    assert got[:-1] == want[:-1]
    assert got[-1].split("[sweep:")[0] == want[-1].split("[sweep:")[0]
    assert "72 lanes" in got[-1]


def test_driver_engine_options():
    assert PC.engine_kwargs("batch", None)["config"].engine == "batch"
    assert PC.engine_kwargs("torch", "cpu")["device"] == "cpu"
    with pytest.raises(ValueError, match="--device"):
        PC.engine_kwargs("scalar", "cpu")
    args = PC.parser(waste_curves.__doc__).parse_args(["--engine", "legacy", "--quick"])
    assert args.engine == "legacy" and args.quick and args.device is None
