#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` into
``build/repro_torch/``, holds each kernel against its plain PyTorch
version on the card, drives the main path — the full paper grid (108
cells, 1000 Monte-Carlo runs each) through
``repro_torch.experiments.run_grid`` on CUDA — checks that both kernels
ran on it, checks the card's results against the port's CPU path on the
validation grid, and times each kernel.  Every phase prints one JSON
line; any failure exits non-zero before the last line, which is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; imports nothing
of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet peaks the bound is taken against
PEAK_BYTES_S = 3.35e12  # HBM3
PEAK_F64_S = 34e12  # FP64, outside the tensor cores

#: bytes the kernels must move on given data: every input a lane needs
#: read once, every output it changes written once.  Primitive update:
#: 80 B read (prim, cont 4 B; target, ckend, nf, t, saved, unsaved, pw, W,
#: DR 8 B) and 36 B written (t, saved, unsaved, pw; flags) per lane, and a
#: lane that faulted also reads its stream (key, ctr, mean, horizon: 28 B)
#: and writes the refilled cursor (ctr, tm: 12 B).  Stream advance: the
#: 1 B mask per lane; a masked lane reads ctr, tm, key, mean, horizon
#: (36 B) and writes ctr, tm (12 B).
BYTES_PRIM, BYTES_PRIM_FAULTED = 116, 40
BYTES_ADV, BYTES_ADV_MASKED = 1, 48
#: f64 operations, approximate: ~20 adds / compares / selects per lane of
#: the update, ~40 for one gap draw (uniform, log1p, scale, add, retire)
OPS_PRIM, OPS_GAP = 20, 40
#: the card's L2; timed calls cycle through input copies three times larger
L2_BYTES = 50e6
RUNS_PER_CELL = 1000

TM_ULPS = 4  # refilled cursor dates: libdevice transcendentals, same on both sides
LAWS = (("exponential", 0.0), ("weibull", 0.7), ("lognormal", 1.0), ("uniform", 0.0))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def ulp_dist(a, b):
    """Elementwise distance in units in the last place of two f64 tensors
    (0 where both are the same infinity)."""
    import torch

    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    ia, ib = a.view(torch.int64), b.view(torch.int64)
    d = (ia - ib).abs()
    return torch.where(same, torch.zeros_like(d), d)


def max_abs_err(pairs) -> float:
    import torch

    m = 0.0
    for a, b in pairs:
        fin = torch.isfinite(a) & torch.isfinite(b)
        if a.dtype.is_floating_point and bool(fin.any()):
            m = max(m, float((a[fin] - b[fin]).abs().max()))
    return m


def make_inputs(K, L: int, seed: int, dev):
    """Lane states of the kind the main path gives the kernels, on the card."""
    return K.lane_state_tensors(K.sample_lane_state(L, seed), dev)


def run_prim(K, x, kind, param, plain: bool):
    import torch

    s = {k: v.clone() for k, v in x.items()}
    args = [s[k] for k in ("prim", "cont", "target", "ckend", "nf", "t",
                           "saved", "unsaved", "pw", "W", "DR")]
    kw = dict(eps=1e-6, reg_cont=1,
              stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"]),
              gap=(kind, param))
    fn = K.primitive_update if plain else K.masked_primitive_update
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return dict(zip(("t", "saved", "unsaved", "pw", "flags", "ctr", "tm"), out))


def run_adv(K, x, kind, param, plain: bool):
    import torch

    s = {k: v.clone() for k, v in x.items()}
    fn = K.stream_advance if plain else K.masked_stream_advance
    out = fn(s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
             kind=kind, param=param)
    torch.cuda.synchronize()
    return dict(zip(("ctr", "tm"), out))


def eager_ms(fn, reps: int) -> float:
    """Mean time of one call issued from Python, CUDA events around
    ``reps`` back-to-back calls after a warm-up.  Where the host issues
    launches slower than the card runs them, this is the host's rate."""
    import torch

    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(calls, copies, src, samples: int = 10):
    """Median device time of one call, every call on the state the bound
    counts.  ``calls[i]`` works on ``copies[i]`` (together three times the
    L2, so each call finds its lanes in device memory); the calls are
    captured in one CUDA graph.  Before each timed replay a second graph
    rewrites every copy from ``src`` (the kernels update state in place)
    and then reads a buffer larger than the L2, so the rewritten lines are
    flushed before the timed span opens; the card is still busy with it
    when the timed replay is issued, so the span holds no host time.
    Returns the ms per call and the outputs of the first call of the last
    replay."""
    import torch

    flush = torch.ones(int(3 * L2_BYTES) // 4, dtype=torch.float32, device=src["t"].device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for f in calls:
            f()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    prep = torch.cuda.CUDAGraph()
    with torch.cuda.graph(prep):
        for c in copies:
            for k, v in c.items():
                v.copy_(src[k])
        flush.sum()
    prep.replay()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [f() for f in calls]
    ms = []
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(samples):
        prep.replay()
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b) / len(calls))
    return sorted(ms)[len(ms) // 2], outs[0]


def main() -> int:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2

    # ---- 1. environment ---------------------------------------------- #
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    emit("env", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=smi)

    # ---- 2. build ------------------------------------------------------ #
    from repro_torch.kernels import build

    t0 = time.monotonic()
    logs = build.build_all()
    ptxas = [ln.strip() for log in logs.values() for ln in log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=time.monotonic() - t0, built=sorted(logs),
         ptxas=ptxas)

    from repro_torch.kernels import sim_step as K

    # ---- 3. kernels against their plain versions, main-path lanes ------ #
    from repro_torch.experiments import GridSpec, paper_grid_cells, run_grid

    full = GridSpec(tuple(paper_grid_cells("full")), n_runs=RUNS_PER_CELL, seed=0)
    L = full.n_lanes
    err = {"masked_primitive_update": 0.0, "masked_stream_advance": 0.0}
    for li, (kind, param) in enumerate(LAWS):
        x = make_inputs(K, L, 100 + li, dev)
        got, want = run_prim(K, x, kind, param, False), run_prim(K, x, kind, param, True)
        for k in ("t", "saved", "unsaved", "pw", "flags", "ctr"):
            check(torch.equal(got[k], want[k]),
                  f"masked_primitive_update/{kind}: {k} differs from the plain version")
        u = int(ulp_dist(got["tm"], want["tm"]).max())
        check(u <= TM_ULPS, f"masked_primitive_update/{kind}: tm off by {u} ulp")
        check(int((x["prim"] != 0).sum()) > 0 and bool((got["flags"] & 1).any()),
              "primitive inputs exercised no fault")
        err["masked_primitive_update"] = max(err["masked_primitive_update"], max_abs_err(
            (got[k], want[k]) for k in ("t", "saved", "unsaved", "pw", "tm")))
        got, want = run_adv(K, x, kind, param, False), run_adv(K, x, kind, param, True)
        check(torch.equal(got["ctr"], want["ctr"]),
              f"masked_stream_advance/{kind}: ctr differs from the plain version")
        u2 = int(ulp_dist(got["tm"], want["tm"]).max())
        check(u2 <= TM_ULPS, f"masked_stream_advance/{kind}: tm off by {u2} ulp")
        err["masked_stream_advance"] = max(
            err["masked_stream_advance"], max_abs_err([(got["tm"], want["tm"])]))
        emit("kernel_check", law=kind, lanes=L, prim_tm_ulps=u, adv_tm_ulps=u2)

    # ---- 4. the main path: the full paper grid on the card ------------- #
    K.masked_primitive_update.launches = 0
    K.masked_stream_advance.launches = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    res = run_grid(full, device="cuda")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = {
        "masked_primitive_update": K.masked_primitive_update.launches,
        "masked_stream_advance": K.masked_stream_advance.launches,
    }
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the main path")
    meta = res.meta
    check(meta["device"].startswith("cuda"), f"main path ran on {meta['device']}")
    for c in res.cells:
        check(c.n_runs == RUNS_PER_CELL, f"{c.cell.label}: {c.n_runs} runs")
        check(0.0 < c.mean_waste < 1.0 and np.isfinite(c.ci95_waste),
              f"{c.cell.label}: waste {c.mean_waste}")
    anchors = {}
    for pk in ("p82r85", "p40r70"):
        y = res[f"{pk}/N65536/Young"].mean_waste
        e = res[f"{pk}/N65536/Exact"].mean_waste
        check(e < y, f"{pk}: ExactPrediction does not beat Young ({e} >= {y})")
        anchors[pk] = {"Young": y, "Exact": e}
    emit("main_path", cells=len(res.cells), runs_per_cell=RUNS_PER_CELL, lanes=L,
         seconds=wall, lanes_per_s=L / wall, outer_iters=meta["outer_iters"],
         host_syncs=meta["host_syncs"],
         syncs_per_iter=meta["host_syncs"] / max(meta["outer_iters"], 1),
         n_chunks=meta["n_chunks"], launches=launches, waste_N65536=anchors)

    # ---- 5. the card against the CPU, same port ------------------------ #
    val = GridSpec(tuple(paper_grid_cells("validation")), n_runs=8, seed=0)
    on_gpu = run_grid(val, device="cuda")
    on_cpu = run_grid(val, device="cpu")
    worst = 0.0
    for a, b in zip(on_gpu.cells, on_cpu.cells):
        n = a.stats["n"]
        ints_a = [a.n_exhausted, n] + [a.stats[k] * n for k in (
            "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts", "mean_migrations")]
        ints_b = [b.n_exhausted, b.stats["n"]] + [b.stats[k] * b.stats["n"] for k in (
            "mean_faults", "mean_proactive_ckpts", "mean_regular_ckpts", "mean_migrations")]
        check(ints_a == ints_b, f"{a.cell.label}: counters differ card vs CPU")
        for k in ("mean_waste", "ci95_waste", "mean_makespan", "ci95_makespan"):
            rel = abs(a.stats[k] - b.stats[k]) / abs(b.stats[k])
            worst = max(worst, rel)
            check(rel <= 1e-9, f"{a.cell.label}: {k} card vs CPU rel {rel}")
    emit("card_vs_cpu", cells=len(val.cells), lanes=val.n_lanes,
         max_rel_float=worst, rtol=1e-9)

    # ---- 6. times at the main path's lane count ------------------------ #
    # The bound counts the faulted and masked lanes of these inputs; every
    # timed call runs on them (device_ms restores the copies before each
    # replay), and the timed calls' outputs are held against the plain
    # version's on the same inputs.
    x = make_inputs(K, L, 7, dev)
    xs = make_inputs(K, 128, 8, dev)
    f_kind, f_param = "exponential", 0.0
    want_prim = run_prim(K, x, f_kind, f_param, True)
    want_adv = run_adv(K, x, f_kind, f_param, True)
    n_fault = int(want_prim["flags"].bitwise_and(1).ne(0).sum())
    n_mask = int(x["mask"].sum())

    def prim_call(s):
        return lambda: K.masked_primitive_update(
            s["prim"], s["cont"], s["target"], s["ckend"], s["nf"], s["t"],
            s["saved"], s["unsaved"], s["pw"], s["W"], s["DR"], eps=1e-6,
            reg_cont=1, stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"]),
            gap=(f_kind, f_param))

    def prim_plain(s):
        return lambda: K.primitive_update(
            s["prim"], s["cont"], s["target"], s["ckend"], s["nf"], s["t"],
            s["saved"], s["unsaved"], s["pw"], s["W"], s["DR"], eps=1e-6,
            reg_cont=1, stream=(s["key"], s["ctr"], s["nf"], s["mean"], s["horizon"]),
            gap=(f_kind, f_param))

    def adv_call(s):
        return lambda: K.masked_stream_advance(
            s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
            kind=f_kind, param=f_param)

    def adv_plain(s):
        return lambda: K.stream_advance(
            s["mask"], s["ctr"], s["nf"], s["key"], s["mean"], s["horizon"],
            kind=f_kind, param=f_param)

    def timed(make, src, n_copies, want=None, what=""):
        cs = [{k: v.clone() for k, v in src.items()} for _ in range(n_copies)]
        ms, out = device_ms([make(c) for c in cs], cs, src)
        for (k, w), g in zip((want or {}).items(), out):
            same = (int(ulp_dist(g, w).max()) <= TM_ULPS if k == "tm"
                    else torch.equal(g, w))
            check(same, f"{what}: a timed call's {k} is not the plain version's")
        return ms

    saved_counts = dict(launches)
    timing = {}
    for name, call, plain, want, nbytes, ops in (
        ("masked_primitive_update", prim_call, prim_plain, want_prim,
         BYTES_PRIM * L + BYTES_PRIM_FAULTED * n_fault,
         OPS_PRIM * L + OPS_GAP * n_fault),
        ("masked_stream_advance", adv_call, adv_plain, want_adv,
         BYTES_ADV * L + BYTES_ADV_MASKED * n_mask, OPS_GAP * n_mask),
    ):
        n_copies = math.ceil(3 * L2_BYTES / nbytes)
        timing[name] = {
            "ms": timed(call, x, n_copies, want, name),
            "plain_ms": timed(plain, x, n_copies, want, name + " (plain)"),
            "launch_floor_ms": timed(call, xs, 64),
            "host_call_ms": eager_ms(call({k: v.clone() for k, v in x.items()}), 200),
            "bytes": nbytes, "ops": ops, "copies": n_copies,
        }
    replaces = {
        "masked_primitive_update": "src/repro/kernels/sim_step.py:516",
        "masked_stream_advance": "src/repro/kernels/sim_step.py:409",
    }
    kernels = []
    for name, tm in timing.items():
        t_bytes = tm["bytes"] / PEAK_BYTES_S * 1e3
        t_ops = tm["ops"] / PEAK_F64_S * 1e3
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sim_step.cu",
            "replaces": replaces[name], "launches": saved_counts[name],
            "max_abs_err": err[name], "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "launch_floor_ms": tm["launch_floor_ms"],
            "host_call_ms": tm["host_call_ms"], "lanes": L,
            "faulted_lanes": n_fault, "masked_lanes": n_mask,
        })
    kernel_s = sum(k["launches"] * k["ms"] for k in kernels) / 1e3
    wrapper_s = sum(k["launches"] * k["host_call_ms"] for k in kernels) / 1e3
    emit("split", main_path_s=wall, kernel_device_s_est=kernel_s,
         kernel_share=kernel_s / wall, wrapper_host_s_est=wrapper_s,
         glue_s_est=wall - kernel_s,
         launches_per_iter={k["name"]: k["launches"] / max(meta["outer_iters"], 1)
                            for k in kernels},
         note="estimates: main-path launches x the per-launch times of phase 6")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
