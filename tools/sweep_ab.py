"""A/B timing of the sweep's two main paths for two checkouts of the port.

    python3 tools/sweep_ab.py A_ROOT B_ROOT [--order abba]

Runs the full paper grid (108 cells x 1000 runs, seed 0: ``chip_smoke.py``
phase 4) and the mixed-law grid (the bench grid under the exponential,
Weibull 0.7 and lognormal 0.5 laws, 216 cells x 1000 runs, seed 5: phase
20) through ``repro_torch.experiments.run_grid`` on the card, once per
letter of ``--order`` (``a``: A_ROOT, ``b``: B_ROOT), each in its own
process with that checkout's ``src`` on the path and its kernels built
from that checkout's sources, after a small warm-up grid.  Then one more
process of each checkout traces the first ``PROFILE_ITERS`` outer
iterations of the full grid with ``torch.profiler``: the device kernels
per iteration and the device's busy share of the window (the profiler
adds host time per op, so the busy share it gives is a lower bound).  Needs one CUDA
card.  Prints the card's name and power limit, then one JSON line per run
(wall time, lanes/s, outer iterations, host syncs, launches of every
sim_step wrapper) and one line per trace.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

RUNS_PER_CELL = 1000
PROFILE_ITERS = 200
WRAPPERS = ("masked_primitive_update", "masked_stream_advance",
            "masked_prediction_walk", "masked_strike_walk", "masked_silent_walk")


def grids() -> dict:
    from dataclasses import replace

    from repro_torch.core.events import lognormal, weibull
    from repro_torch.experiments import GridSpec, paper_grid_cells

    laws = (("exp", None), ("weibull", weibull(0.7)), ("lognormal", lognormal(0.5)))
    mixed = [replace(c, label=f"{law}/{c.label}", fault_dist=d)
             for law, d in laws for c in paper_grid_cells("bench")]
    return {
        "full": GridSpec(tuple(paper_grid_cells("full")), n_runs=RUNS_PER_CELL, seed=0),
        "mixed": GridSpec(tuple(mixed), n_runs=RUNS_PER_CELL, seed=5),
    }


def launches(K) -> dict:
    """Every sim_step wrapper's launch counts (an older checkout lacks the
    walks' wrappers)."""
    out = {}
    for name in WRAPPERS:
        fn = getattr(K, name, None)
        if fn is not None:
            out[name] = fn.launches
            out[name + "[indexed]"] = fn.indexed_launches
    return out


def run(root: str) -> None:
    """One checkout's run of both grids (this process's ``src`` is
    ``root``'s)."""
    import torch
    from repro_torch.experiments import GridSpec, paper_grid_cells, run_grid
    from repro_torch.kernels import build
    from repro_torch.kernels import sim_step as K

    build.load("sim_step")
    run_grid(GridSpec(tuple(paper_grid_cells("validation")), n_runs=2), device="cuda")
    for name, grid in grids().items():
        for fn in (getattr(K, n) for n in WRAPPERS if hasattr(K, n)):
            fn.launches = fn.indexed_launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        res = run_grid(grid, device="cuda")
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        m = res.meta
        print(json.dumps({
            "root": root, "grid": name, "lanes": grid.n_lanes, "seconds": wall,
            "lanes_per_s": grid.n_lanes / wall, "outer_iters": m["outer_iters"],
            "host_syncs": m["host_syncs"], "ms_per_iter": 1e3 * wall / m["outer_iters"],
            "launches": launches(K),
        }), flush=True)


def profile(root: str) -> None:
    """Trace the first PROFILE_ITERS outer iterations of the full grid."""
    import torch
    from repro_torch.core import torch_sim as PT
    from repro_torch.experiments import build_fused_layout
    from repro_torch.kernels import build

    build.load("sim_step")
    layout = build_fused_layout(grids()["full"])
    args = (layout.work_c, layout.plats_c, layout.strats_c, layout.concat_spec())

    def window(n: int) -> None:
        try:
            PT.simulate_batch_torch(*args, device="cuda", max_iters=n)
        except RuntimeError as e:  # the window ends before the lanes do
            if "did not converge" not in str(e):
                raise
        torch.cuda.synchronize()

    window(8)  # warm-up
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.monotonic()
        window(PROFILE_ITERS)
        wall = time.monotonic() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(json.dumps({
        "root": root, "trace": "full", "outer_iters": PROFILE_ITERS, "wall_s": wall,
        "device_kernels": len(kernels), "kernels_per_iter": len(kernels) / PROFILE_ITERS,
        "device_busy_s": busy_us / 1e6, "busy_share": busy_us / 1e6 / wall,
        "top_kernels_us": dict(top),
    }), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("a_root", nargs="?")
    ap.add_argument("b_root", nargs="?")
    ap.add_argument("--order", default="abba")
    ap.add_argument("--run", help=argparse.SUPPRESS)
    ap.add_argument("--profile", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.run or a.profile:
        root = a.run or a.profile
        sys.path.insert(0, str(Path(root).resolve() / "src"))
        (run if a.run else profile)(root)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    roots = {"a": a.a_root, "b": a.b_root}
    me = str(Path(__file__).resolve())
    for letter in a.order:
        subprocess.run([sys.executable, me, "--run", roots[letter]], check=True)
    for letter in "ab":
        subprocess.run([sys.executable, me, "--profile", roots[letter]], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
